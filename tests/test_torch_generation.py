"""One-shot generation of the PyTorch port against the JAX package.

The same numpy weights go through the flax ``GPTForPretraining`` and,
through ``params_from_jax``, the port's module, in fp32. With
``FLEETX_FORCE_FLASH=1`` the JAX decode steps run the Pallas contiguous
decode kernels (B7, B9 at int8) in interpret mode; the port's decode steps
run the plain versions of its CUDA kernels. Greedy streams must be
byte-identical, the cache after the prefill equal to the JAX cache leaves,
and sampling must stay inside its top-k/top-p support and repeat under a
seed (the draws of ``jax.random`` and ``torch.Generator`` differ).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fleetx_tpu.models.gpt import generation as jax_gen
from fleetx_tpu_torch.models.gpt import generation as gen
from fleetx_tpu_torch.ops import decode_attention as da
from test_torch_gpt import tiny_jax_model, tiny_params, tiny_torch_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 61


@pytest.fixture(scope="module")
def tree():
    return tiny_params(seed=5)


@pytest.fixture
def force_flash(monkeypatch):
    monkeypatch.setenv("FLEETX_FORCE_FLASH", "1")


def _batch(seed=3, b=3, prompt_len=9):
    """Left-padded prompts: row 0 full, row 1 with 4 pads, row 2 with 1."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (b, prompt_len)).astype(np.int32)
    mask = np.ones((b, prompt_len), np.int32)
    mask[1, :4] = 0
    mask[2, :1] = 0
    ids[mask == 0] = 0
    return ids, mask


def _both_greedy(tree, kv, cfg_kw, ids, mask):
    decode = {} if kv is None else {"decode_kv_dtype": kv}
    jm = tiny_jax_model(use_flash=True, **decode)
    tm = tiny_torch_model(tree, **decode)
    cfg = dict(decode_strategy="greedy", max_length=12, pad_token_id=0,
               **cfg_kw)
    params = jax.tree.map(jnp.asarray, tree["params"])
    want = jax_gen.generate(jm, {"params": params}, jnp.asarray(ids),
                            jax_gen.GenerationConfig(**cfg),
                            attention_mask=jnp.asarray(mask))
    got = gen.generate(tm, torch.tensor(ids), gen.GenerationConfig(**cfg),
                       attention_mask=torch.tensor(mask))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("kv", [None, "int8"], ids=["fp32-kv", "int8-kv"])
def test_greedy_generate_matches_jax(tree, kv, force_flash):
    ids, mask = _batch()
    want, got = _both_greedy(tree, kv, {"eos_token_id": 10**6}, ids, mask)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 9 + 12) and got.dtype == np.int32
    assert len(set(got[0, 9:].tolist())) > 1  # not a degenerate stream


def test_greedy_generate_with_processors_matches_jax(tree, force_flash):
    """min_length, repetition penalty 1.3, forced EOS at the last slot, and
    an EOS that row 1 meets mid-stream (its later slots are padding)."""
    ids, mask = _batch(seed=4)
    kw = dict(min_length=3, repetition_penalty=1.3, forced_eos_token_id=7)
    want, probe = _both_greedy(tree, None, dict(kw, eos_token_id=10**6),
                               ids, mask)
    np.testing.assert_array_equal(probe, want)
    assert (probe[:, -1] == 7).all()  # forced at the last slot
    eos = int(probe[1, 9 + 4])
    want, got = _both_greedy(tree, None, dict(kw, eos_token_id=eos), ids,
                             mask)
    np.testing.assert_array_equal(got, want)
    stop = int(np.argmax(got[1, 9:] == eos))
    assert 3 <= stop <= 4 and (got[1, 9 + stop + 1:] == 0).all()


def _prefill_both(tree, kv):
    """One prefill of the left-padded batch into a fresh contiguous cache
    of 24 positions through both packages: (JAX logits, JAX attn cache
    leaves, port logits, port cache)."""
    decode = dict(decode_cache_len=24,
                  **({} if kv is None else {"decode_kv_dtype": kv}))
    jm = tiny_jax_model(use_flash=True, **decode)
    tm = tiny_torch_model(tree, **decode)
    ids, mask = _batch()
    kv_mask = np.concatenate([mask, np.ones((3, 15), np.int32)], 1).astype(
        bool)[:, None, None, :]
    pos = np.clip(np.cumsum(mask, 1) - 1, 0, None)
    jl, jcache = jax_gen.decode_step(
        jm, tree["params"], jax_gen.init_decode_cache(jm, 3),
        jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(kv_mask))
    tcache = gen.init_decode_cache(tm, 3, device="cpu")
    tl, _ = gen.decode_step(tm, tcache, torch.tensor(ids).long(),
                            torch.tensor(pos), torch.tensor(kv_mask))
    return (np.asarray(jl), jcache["gpt"]["layers"]["layer"]["attn"],
            tl.numpy(), tcache)


def test_prefill_cache_matches_jax_leaves(tree, force_flash):
    """After the prefill the contiguous cache equals the JAX tree leaf for
    leaf (layout, dtype, write offset). fp32 K/V agree to GEMM rounding.
    At int8 layer 0's values are the JAX ``quantize_kv`` of the port's own
    K/V byte for byte (scales bit for bit). Against the JAX cache the int8
    values are byte-equal too; its K/V come from other fp32 GEMMs, whose
    last-bit rounding moves some scales by a few ulp (ROADMAP Queue C)."""
    from fleetx_tpu.ops.quant import quantize_kv as jax_quantize_kv

    jl, leaves, tl, tcache = _prefill_both(tree, None)
    np.testing.assert_allclose(tl, jl, atol=2e-5, rtol=1e-5)
    assert tcache["index"] == 9
    assert (np.asarray(leaves["cache_index"]) == 9).all()
    for name in ("key", "value"):
        want = np.asarray(leaves["cached_" + name])
        got = tcache[name].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    fp32 = tcache
    jl, leaves, tl, tcache = _prefill_both(tree, "int8")
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    assert set(tcache) == {"index", "key", "value", "key_scale",
                           "value_scale"}
    for name in ("key", "value"):
        # layer 0's K/V do not depend on the cache precision (later
        # layers see attention over dequantized values)
        q8, scale = (np.asarray(x) for x in
                     jax_quantize_kv(jnp.asarray(fp32[name][0].numpy())))
        np.testing.assert_array_equal(tcache[name][0].numpy(), q8)
        np.testing.assert_array_equal(tcache[name + "_scale"][0].numpy(),
                                      scale)
        want_q8 = np.asarray(leaves["cached_" + name])
        want_scale = np.asarray(leaves[f"cached_{name}_scale"])
        assert tcache[name].dtype == torch.int8 and want_q8.dtype == np.int8
        assert tcache[name + "_scale"].shape == want_scale.shape
        np.testing.assert_array_equal(tcache[name].numpy(), want_q8)
        np.testing.assert_allclose(tcache[name + "_scale"].numpy(),
                                   want_scale, rtol=1e-6, atol=0)


def test_decode_step_with_per_row_positions_matches_jax(tree, force_flash):
    """Rows writing at their own offsets (the continuous-batching seam on
    the contiguous cache): logits, caches and the write offset agree."""
    decode = dict(decode_cache_len=16)
    jm = tiny_jax_model(use_flash=True, **decode)
    tm = tiny_torch_model(tree, **decode)
    jcache = jax_gen.init_decode_cache(jm, 3)
    tcache = gen.init_decode_cache(tm, 3, device="cpu")
    rng = np.random.RandomState(6)
    wpos = np.array([0, 0, 0], np.int32)
    for length in (5, 1, 1, 1):
        ids = rng.randint(0, VOCAB, (3, length)).astype(np.int32)
        pos = wpos[:, None] + np.arange(length)[None]
        jl, jcache = jax_gen.decode_step(
            jm, tree["params"], jcache, jnp.asarray(ids), jnp.asarray(pos),
            cache_positions=jnp.asarray(wpos))
        tl, _ = gen.decode_step(tm, tcache, torch.tensor(ids).long(),
                                torch.tensor(pos).long(),
                                cache_positions=torch.tensor(wpos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                                   rtol=1e-5)
        wpos = wpos + length + np.array([0, 2, 1], np.int32)
    leaves = jcache["gpt"]["layers"]["layer"]["attn"]
    np.testing.assert_allclose(tcache["key"].numpy(),
                               np.asarray(leaves["cached_key"]), atol=2e-5)
    assert tcache["index"] == int(np.asarray(leaves["cache_index"])[0])


def _support(logits, top_k, top_p, temperature=1.0):
    """The tokens a top-k then top-p (within the top-k) filter keeps, from
    the definition: the k largest, then the shortest prefix of them, in
    descending order, whose probability mass reaches top_p."""
    keep = []
    for row in logits / temperature:
        order = np.argsort(-row, kind="stable")[:top_k]
        vals = row[order]
        probs = np.exp(vals - vals.max())
        probs /= probs.sum()
        n = min(int((np.cumsum(probs) < top_p).sum()) + 1, top_k)
        keep.append(set(order[:n].tolist()))
    return keep


def test_sampling_stays_in_support_and_repeats_under_a_seed():
    rng = np.random.RandomState(0)
    logits = torch.tensor((rng.randn(4, VOCAB) * 3).astype(np.float32))
    cfg = gen.GenerationConfig(decode_strategy="sampling", top_k=8,
                               top_p=0.6, temperature=0.9)
    support = _support(logits.numpy(), 8, 0.6, 0.9)
    g = torch.Generator().manual_seed(1)
    drawn = [set() for _ in range(4)]
    for _ in range(300):
        for row, tok in enumerate(gen._sample(logits, g, cfg).tolist()):
            assert tok in support[row], (row, tok, support[row])
            drawn[row].add(tok)
    assert any(len(d) > 1 for d in drawn)  # really samples
    # top-k off: the bisected top-p threshold keeps the same kind of set
    nok = gen.GenerationConfig(decode_strategy="sampling", top_p=0.6)
    support = _support(logits.numpy(), VOCAB, 0.6)
    for _ in range(100):
        for row, tok in enumerate(gen._sample(logits, g, nok).tolist()):
            assert tok in support[row]


def test_sampled_generate_repeats_under_a_seed(tree):
    tm = tiny_torch_model(tree)
    ids, mask = _batch()
    cfg = gen.GenerationConfig(decode_strategy="sampling", top_k=20,
                               top_p=0.9, max_length=10, pad_token_id=0,
                               eos_token_id=10**6)

    def run(seed):
        return gen.generate(tm, torch.tensor(ids), cfg,
                            attention_mask=torch.tensor(mask),
                            generator=torch.Generator().manual_seed(seed))

    a, b, c = run(11), run(11), run(12)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[:, :9], torch.tensor(ids))


def test_generate_runs_the_decode_kernel_per_layer_and_step(tree,
                                                            monkeypatch):
    """On the CPU the wrapper takes the plain version and launches nothing;
    every decode step calls it once per layer."""
    tm = tiny_torch_model(tree)
    calls = []
    real = da.decode_attention
    from fleetx_tpu_torch.models.gpt import model as gpt_model

    monkeypatch.setattr(gpt_model, "decode_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    before = dict(da.launches)
    ids, mask = _batch()
    gen.generate(tm, torch.tensor(ids), gen.GenerationConfig(
        decode_strategy="greedy", max_length=6, eos_token_id=10**6),
        attention_mask=torch.tensor(mask))
    assert len(calls) == 5 * 2  # 5 decode steps x 2 layers
    assert da.launches == before


def test_beam_search_is_not_ported(tree):
    tm = tiny_torch_model(tree)
    with pytest.raises(NotImplementedError,
                       match='ROADMAP Queue A, "Beam search"'):
        gen.generate(tm, torch.zeros(1, 3, dtype=torch.int64),
                     gen.GenerationConfig(decode_strategy="beam_search"))


def test_generation_module_on_the_tiny_yaml_matches_jax():
    """``build_module`` with ``Model.module=GPTGenerationModule`` on the
    tiny config (dense attention, fp32) in both packages, the same weights:
    ``generate_ids`` gives the same greedy ids."""
    from fleetx_tpu.models import build_module as jax_build_module
    from fleetx_tpu.utils.config import get_config as jax_get_config
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.models.gpt.convert import params_from_jax
    from fleetx_tpu_torch.models.language_module_generation import (
        GPTGenerationModule,
    )
    from fleetx_tpu_torch.utils.config import get_config

    path = os.path.join(ROOT, "configs/tiny/pretrain_gpt_tiny_cpu.yaml")
    overrides = ["Model.module=GPTGenerationModule",
                 "Generation.decode_strategy=greedy",
                 "Generation.max_dec_len=6", "Generation.eos_token_id=1000",
                 "Generation.pad_token_id=0"]
    ours = build_module(get_config(path, overrides=overrides, nranks=1))
    theirs = jax_build_module(jax_get_config(path, overrides=overrides,
                                             nranks=1))
    assert isinstance(ours, GPTGenerationModule)
    variables = jax.tree.map(np.asarray, theirs.nets.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    from flax import linen as nn

    variables = jax.tree.map(np.asarray, nn.meta.unbox(variables))
    theirs.set_state(variables)
    with pytest.raises(RuntimeError, match="set_state"):
        ours.generate_ids(np.zeros((1, 4), np.int32))
    ours.set_state(params_from_jax(variables, ours.gpt_config),
                   device="cpu")
    ids = np.random.RandomState(2).randint(0, 128, (2, 5)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, :2] = 0
    want = theirs.generate_ids(ids, attention_mask=mask)
    got = ours.generate_ids(ids, attention_mask=mask)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 11)


def test_generation_module_needs_cuda_without_a_device(monkeypatch):
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.utils.config import get_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = os.path.join(ROOT, "configs/tiny/pretrain_gpt_tiny_cpu.yaml")
    module = build_module(get_config(
        path, overrides=["Model.module=GPTGenerationModule"], nranks=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        module.set_state({})
