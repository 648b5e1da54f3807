"""Paged serving engine of the PyTorch port against the JAX package.

Both engines serve the same requests over the same numpy weights, paged
with 8-position pages: greedy token streams must be byte-identical, with
the same finish reasons and prefix-cache savings, and no page may leak.
The sampling filter is held mask-for-mask against the JAX filter.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fleetx_tpu.models.gpt.generation import (
    GenerationConfig as JaxGenerationConfig,
)
from fleetx_tpu.serving import ServingEngine as JaxServingEngine
from fleetx_tpu.serving.engine import filter_logits as jax_filter_logits
from fleetx_tpu_torch.models.gpt.convert import params_from_jax
from fleetx_tpu_torch.models.gpt.generation import GenerationConfig
from fleetx_tpu_torch.models.gpt.model import GPTConfig, GPTForPretraining
from fleetx_tpu_torch.serving import (
    PagePool,
    ServingEngine,
    filter_logits,
    sample_tokens,
)
from test_torch_gpt import TINY, tiny_jax_model, tiny_params

NO_EOS = 10**6
ENGINE = dict(slots=3, cache_len=48, page_size=8, prefill_bucket=4)


@pytest.fixture(scope="module")
def weights():
    tree = tiny_params(seed=4)
    cfg = GPTConfig(**TINY, dtype=torch.float32)
    return tree, cfg, params_from_jax(tree, cfg)


def _port_engine(weights, **kw):
    _, cfg, params = weights
    return ServingEngine(
        GPTForPretraining(cfg, device="meta"), params, device="cpu",
        gen_cfg=GenerationConfig(decode_strategy="greedy",
                                 eos_token_id=NO_EOS), **ENGINE, **kw)


def _requests():
    """Five greedy requests: 0 and 1 share a 10-token (one full page)
    prefix; lengths 2..20 tokens; budgets 5..12 new tokens."""
    rng = np.random.RandomState(7)
    prefix = rng.randint(0, 61, 10)
    prompts = [np.concatenate([prefix, rng.randint(0, 61, 3)]),
               np.concatenate([prefix, rng.randint(0, 61, 7)]),
               rng.randint(0, 61, 5), rng.randint(0, 61, 20),
               rng.randint(0, 61, 2)]
    return [dict(prompt=p, max_length=m)
            for p, m in zip(prompts, [6, 9, 12, 5, 7])]


def _serve(engine, requests):
    for r in requests:
        engine.submit(r["prompt"], max_length=r["max_length"],
                      eos_token_id=r.get("eos", NO_EOS))
    return engine.drain()


def test_greedy_streams_match_jax_engine(weights):
    tree, _, _ = weights
    jax_engine = JaxServingEngine(
        tiny_jax_model(), tree,
        gen_cfg=JaxGenerationConfig(decode_strategy="greedy",
                                    eos_token_id=NO_EOS),
        paged=True, **ENGINE)
    requests = _requests()
    # request 2 stops on EOS: its 4th greedy token (first occurrence)
    probe = _port_engine(weights)
    stream = _serve(probe, requests)[2].tokens.tolist()
    requests[2]["eos"] = stream[3]
    want = _serve(jax_engine, requests)
    port = _port_engine(weights)
    got = _serve(port, requests)
    assert sorted(got) == sorted(want) == list(range(5))
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens,
                                      err_msg=f"request {rid}")
        assert got[rid].finish_reason == want[rid].finish_reason, rid
    assert got[2].finish_reason == "eos" and len(got[2].tokens) <= 4
    assert got[0].finish_reason == "max_length"
    assert len(set(got[3].tokens.tolist())) > 1  # not a degenerate stream
    snap, ref = port.metrics.snapshot(), jax_engine.metrics.snapshot()
    assert snap["prefill_tokens_saved"] == ref["prefill_tokens_saved"] == 8
    assert snap["prefix_hits"] == ref["prefix_hits"] == 1
    assert port.cache_manager.pages_in_use == 0
    port.cache_manager.pool.check_invariants()
    assert snap["tokens_generated"] == sum(len(r.tokens)
                                           for r in got.values())


def test_int8_kv_streams_match_jax_int8_engine(weights, monkeypatch):
    """Both engines at ``kv_dtype="int8"``; the JAX one decodes through its
    Pallas int8 paged kernel (interpret mode), the port's through B10's
    plain version. Greedy streams are byte-identical, the shared prefix is
    reused, no page leaks, and the KV byte gauges match the JAX ones."""
    tree, cfg, _ = weights
    monkeypatch.setenv("FLEETX_FORCE_FLASH", "1")
    jax_engine = JaxServingEngine(
        tiny_jax_model(use_flash=True), tree,
        gen_cfg=JaxGenerationConfig(decode_strategy="greedy",
                                    eos_token_id=NO_EOS),
        paged=True, kv_dtype="int8", **ENGINE)
    requests = _requests()
    want = _serve(jax_engine, requests)
    port = _port_engine(weights, kv_dtype="int8")
    got = _serve(port, requests)
    assert sorted(got) == sorted(want) == list(range(5))
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens,
                                      err_msg=f"request {rid}")
        assert got[rid].finish_reason == want[rid].finish_reason, rid
    assert len(set(got[3].tokens.tolist())) > 1
    snap, ref = port.metrics.snapshot(), jax_engine.metrics.snapshot()
    assert snap["prefix_hits"] == ref["prefix_hits"] == 1
    assert port.cache_manager.pages_in_use == 0
    port.cache_manager.pool.check_invariants()
    assert snap["kv_dtype"] == ref["kv_dtype"] == "int8"
    assert snap["kv_bytes_per_token"] == ref["kv_bytes_per_token"]
    # the JAX tree also holds one int32 cache_index per layer
    assert snap["kv_cache_bytes"] == ref["kv_cache_bytes"] - 4 * cfg.num_layers
    full = _port_engine(weights).metrics.snapshot()
    d = cfg.head_dim
    assert full["kv_dtype"] == "bf16"  # the model's own (here fp32) dtype
    assert snap["kv_cache_bytes"] * (4 * d) == full["kv_cache_bytes"] * (d + 4)


def test_kv_dtype_env_var_is_honored(weights, monkeypatch):
    monkeypatch.setenv("FLEETX_SERVING_KV_DTYPE", "int8")
    engine = _port_engine(weights)
    assert engine.kv_dtype == "int8"
    cache = engine.cache_manager.cache
    assert set(cache) == {"key", "value", "key_scale", "value_scale"}
    assert cache["key"].dtype == torch.int8
    assert cache["value_scale"].dtype == torch.float32
    assert cache["key_scale"].shape == (*cache["key"].shape[:-1], 1)
    assert _port_engine(weights, kv_dtype="bf16").kv_dtype == "bf16"
    monkeypatch.setenv("FLEETX_SERVING_KV_DTYPE", "fp8")
    with pytest.raises(ValueError, match="FLEETX_SERVING_KV_DTYPE"):
        _port_engine(weights)


def test_min_length_bans_eos_like_jax(weights):
    """EOS = the request's own first greedy token, banned for 3 tokens;
    an out-of-vocab EOS never matches."""
    tree, _, _ = weights
    prompt = _requests()[3]["prompt"]
    first = _serve(_port_engine(weights),
                   [dict(prompt=prompt, max_length=1)])[0].tokens[0]
    jax_engine = JaxServingEngine(
        tiny_jax_model(), tree,
        gen_cfg=JaxGenerationConfig(decode_strategy="greedy",
                                    eos_token_id=NO_EOS),
        paged=True, **ENGINE)
    streams = []
    for engine in (jax_engine, _port_engine(weights)):
        engine.submit(prompt, max_length=8, min_length=3,
                      eos_token_id=int(first))
        engine.submit(prompt, max_length=4, min_length=2)  # eos 10**6
        streams.append(engine.drain())
    want, got = streams
    for rid in (0, 1):
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
        assert got[rid].finish_reason == want[rid].finish_reason
    assert got[0].tokens[0] != first and len(got[0].tokens) >= 3


def test_callbacks_stream_every_token(weights):
    engine = _port_engine(weights)
    seen = {}
    rids = [engine.submit(r["prompt"], max_length=r["max_length"],
                          on_token=lambda i, t, f: seen.setdefault(
                              i, []).append((t, f)))
            for r in _requests()[:3]]
    results = engine.drain()
    for rid in rids:
        assert [t for t, _ in seen[rid]] == results[rid].tokens.tolist()
        assert [f for _, f in seen[rid]][-1] is True
        assert engine.result(rid) is None and engine.take_result(rid) is None


def _knobs(n, rng):
    """Per-row temperature/top-k/top-p. No row asks for top_p = 1: there
    the bisection keeps ``mass >= 1``, which hinges on the last ulp of the
    softmax sum (1.0000001 in one framework, 1.0 in the other) and drops
    a different sub-1e-7 tail."""
    temperature = rng.uniform(0.5, 1.5, n).astype(np.float32)
    top_k = np.array([0, 1, 5, 20, 0, 64, 3, 0][:n], np.int32)
    top_p = np.array([0.97, 0.9, 0.5, 0.75, 0.3, 0.99, 0.95, 0.1][:n],
                     np.float32)
    return temperature, top_k, top_p


def test_filter_logits_masks_match_jax():
    rng = np.random.RandomState(0)
    logits = (rng.randn(8, 61) * 3).astype(np.float32)
    t, k, p = _knobs(8, rng)
    want = np.asarray(jax_filter_logits(
        jnp.asarray(logits), jnp.asarray(t), jnp.asarray(k), jnp.asarray(p),
        topk_cap=64))
    got = filter_logits(torch.tensor(logits), torch.tensor(t),
                        torch.tensor(k), torch.tensor(p), topk_cap=64).numpy()
    np.testing.assert_array_equal(got <= -1e8, want <= -1e8)
    kept = want > -1e8
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6)
    assert (~kept).any(axis=1)[1:].all()  # every filtering row removed some


def test_sampled_tokens_stay_in_filtered_support():
    rng = np.random.RandomState(1)
    logits = torch.tensor((rng.randn(8, 61) * 3).astype(np.float32))
    t, k, p = (torch.tensor(x) for x in _knobs(8, rng))
    greedy = torch.tensor([False] * 7 + [True])
    support = filter_logits(logits, t, k, p, topk_cap=64) > -1e8
    gens = [torch.Generator().manual_seed(i) for i in range(8)]
    drawn = [set() for _ in range(8)]
    for _ in range(200):
        tok = sample_tokens(logits, gens, greedy, t, k, p, topk_cap=64)
        assert tok.dtype == torch.int32
        for row, tk in enumerate(tok.tolist()):
            assert row == 7 or support[row, tk], (row, tk)
            drawn[row].add(tk)
    assert drawn[7] == {int(logits[7].argmax())}
    assert drawn[1] == {int(logits[1].argmax())}  # top_k = 1
    assert len(drawn[0]) > 1  # an unfiltered row really samples


def test_seeded_sampling_requests_are_reproducible(weights):
    def run(seed_b):
        engine = _port_engine(weights)
        prompt = _requests()[3]["prompt"]
        for seed in (11, seed_b):
            engine.submit(prompt, max_length=10, decode_strategy="sampling",
                          temperature=1.5, top_k=20, top_p=0.95, seed=seed)
        out = engine.drain()
        return [out[i].tokens.tolist() for i in (0, 1)]

    a, b = run(11), run(12)
    assert a[0] == a[1] == b[0]
    assert b[1] != b[0]


def test_page_pool_admission_and_reuse():
    pool = PagePool(num_pages=7, page_size=8, lanes=2, lane_pages=3)
    prompt = np.arange(17)
    assert pool.pages_needed(prompt) == 3 and pool.can_admit(prompt)
    assert pool.alloc(0, prompt) == 0
    pool.register_prefix(0, prompt)
    assert pool.alloc(1, prompt) == 16  # two full pages shared
    assert pool.pages_in_use == 4
    pool.free(0)
    pool.free(1)
    pool.check_invariants()
    assert pool.pages_in_use == 0 and pool.free_pages == 6


def test_engine_without_device_needs_cuda(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg, params = weights
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(GPTForPretraining(cfg, device="meta"), params)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(GPTForPretraining(cfg, device="meta"), params,
                      kv_dtype="int8")
    from fleetx_tpu_torch.models.gpt.convert import init_params

    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
