"""GPT decode path of the PyTorch port against the JAX package.

The same numpy weights go through the flax ``GPTForPretraining`` and,
through ``params_from_jax``, the port's module; a paged prefill of two
prompts followed by three batched decode steps must give the same fp32
logits and page pools. The JAX side runs once on its dense path and once
with ``FLEETX_FORCE_FLASH=1``, where its decode steps go through the Pallas
paged kernel in interpret mode.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from fleetx_tpu.models.gpt import generation as jax_gen
from fleetx_tpu.models.gpt.model import GPTConfig as JaxGPTConfig
from fleetx_tpu.models.gpt.model import GPTForPretraining as JaxGPT
from fleetx_tpu_torch.models.gpt.convert import init_params, params_from_jax
from fleetx_tpu_torch.models.gpt.generation import (
    decode_step,
    init_decode_cache,
)
from fleetx_tpu_torch.models.gpt.model import GPTConfig, GPTForPretraining

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=61, hidden_size=32, num_layers=2,
            num_attention_heads=2, ffn_hidden_size=64,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
PAGE = 8


def tiny_jax_model(use_flash=False, **decode):
    return JaxGPT(JaxGPTConfig(**TINY, dtype=jnp.float32,
                               use_flash_attention=use_flash, **decode))


def tiny_params(seed=0, std=0.3):
    """A flax param tree of numpy fp32 arrays drawn from ``seed`` (wider
    than the 0.02 init so greedy streams do not collapse to one token)."""
    shapes = jax.eval_shape(
        lambda: nn.meta.unbox(tiny_jax_model().init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        noise = rng.normal(0.0, std, s.shape).astype(np.float32)
        return 1.0 + 0.1 * noise if name.endswith("['scale']") else noise

    return jax.tree_util.tree_map_with_path(draw, shapes)


def tiny_torch_model(jax_params, **decode):
    cfg = GPTConfig(**TINY, dtype=torch.float32, **decode)
    model = GPTForPretraining(cfg, device="meta")
    model.load_state_dict(params_from_jax(jax_params, cfg), assign=True)
    return model


def test_params_from_jax_fills_every_weight():
    """On the flax module's own ``init`` tree, unboxed to numpy."""
    tree = jax.tree.map(np.asarray, nn.meta.unbox(tiny_jax_model().init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))))
    cfg = GPTConfig(**TINY)
    params = params_from_jax(tree, cfg)
    want = GPTForPretraining(cfg, device="meta").state_dict()
    assert params.keys() == want.keys()
    for name, t in params.items():
        assert t.shape == want[name].shape and t.dtype == torch.float32, name
    layers = tree["params"]["gpt"]["layers"]["layer"]
    qkv = layers["attn"]["qkv_proj"]["kernel"][1]  # [E, nh, 3hd]
    w = params["gpt.layers.1.attn.qkv_proj.weight"].numpy()  # [nh*3hd, E]
    # head 1's v block: last hd columns of head 1 in flax, rows in torch
    hd = cfg.head_dim
    np.testing.assert_array_equal(w[5 * hd:6 * hd], qkv[:, 1, 2 * hd:].T)


def test_init_params_shapes_and_distributions():
    cfg = GPTConfig(**dict(TINY, hidden_size=64, ffn_hidden_size=256))
    params = init_params(cfg, seed=3, device="cpu")
    assert params.keys() == params_from_jax(
        {"params": _zero_tree(cfg)}, cfg).keys()
    again = init_params(cfg, seed=3, device="cpu")
    for name, t in params.items():
        assert torch.equal(t, again[name]), name
        if name.endswith(".scale"):
            assert torch.all(t == 1)
        elif name.endswith(".bias"):
            assert torch.all(t == 0)
        else:
            assert abs(t.std().item() - 0.02) < 0.004, name


def _zero_tree(cfg):
    L, E, nh, hd, F = (cfg.num_layers, cfg.hidden_size,
                       cfg.num_attention_heads, cfg.head_dim, cfg.ffn_size)
    z = np.zeros

    def norm():
        return {"scale": z((L, E)), "bias": z((L, E))}

    return {"gpt": {
        "word_embeddings": z((cfg.vocab_size, E)),
        "position_embeddings": z((cfg.max_position_embeddings, E)),
        "final_norm": {"scale": z(E), "bias": z(E)},
        "layers": {"layer": {
            "norm1": norm(), "norm2": norm(),
            "attn": {"qkv_proj": {"kernel": z((L, E, nh, 3 * hd)),
                                  "bias": z((L, nh, 3 * hd))},
                     "out_proj": {"kernel": z((L, nh, hd, E)),
                                  "bias": z((L, E))}},
            "mlp": {"up_proj": {"kernel": z((L, E, F)), "bias": z((L, F))},
                    "down_proj": {"kernel": z((L, F, E)), "bias": z((L, E))}},
        }}}}


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "pallas"])
def test_paged_prefill_and_decode_match_jax(flash, monkeypatch):
    """Two prompts prefilled batch-1 into their own pages (bucket-padded
    like the engine), then three batched decode steps over both rows and a
    free third row whose writes go to the trash page. Both models take the
    paged decode kernel exactly when ``use_flash_attention`` is on."""
    from fleetx_tpu.ops.pallas import decode_attention as pallas_da
    from fleetx_tpu_torch.models.gpt import model as gpt_model

    if flash:
        monkeypatch.setenv("FLEETX_FORCE_FLASH", "1")
    calls, port_calls = [], []
    real = pallas_da.flash_decode_paged_attention
    monkeypatch.setattr(pallas_da, "flash_decode_paged_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    port_real = gpt_model.paged_decode_attention
    monkeypatch.setattr(gpt_model, "paged_decode_attention",
                        lambda *a, **k: port_calls.append(1)
                        or port_real(*a, **k))
    decode = dict(decode_cache_len=32, decode_num_pages=9,
                  decode_page_size=PAGE)
    tree = tiny_params(seed=1)
    jm = tiny_jax_model(use_flash=flash, **decode)
    tm = tiny_torch_model(tree, use_flash_attention=flash, **decode)
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 0], [0, 0, 0, 0]], np.int32)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 61, 11), rng.randint(0, 61, 5)]

    jcache = jax_gen.init_decode_cache(jm, 3)
    tcache = init_decode_cache(tm, device="cpu")

    def both(ids, pos, wpos, tab):
        nonlocal jcache
        jl, jcache = jax_gen.decode_step(
            jm, tree["params"], jcache, jnp.asarray(ids, jnp.int32),
            jnp.asarray(pos, jnp.int32), None,
            cache_positions=jnp.asarray(wpos, jnp.int32),
            block_tables=jnp.asarray(tab))
        tl, _ = decode_step(
            tm, tcache, torch.tensor(ids), torch.tensor(pos),
            cache_positions=torch.tensor(wpos, dtype=torch.int32),
            block_tables=torch.tensor(tab))
        return np.asarray(jl), tl.numpy()

    for row, p in enumerate(prompts):
        ids = np.zeros((1, 16), np.int64)  # prompt right-padded to a bucket
        ids[0, :len(p)] = p
        jl, tl = both(ids, np.arange(16)[None], [0], tables[row:row + 1])
        np.testing.assert_allclose(tl[0, :len(p)], jl[0, :len(p)],
                                   atol=2e-5, rtol=1e-5)
    lengths = np.array([len(p) for p in prompts] + [31])
    for _ in range(3):
        ids = rng.randint(0, 61, (3, 1))
        pos = np.where(np.arange(3) < 2, lengths, 0)[:, None]
        jl, tl = both(ids, pos, lengths, tables)
        np.testing.assert_allclose(tl[:2], jl[:2], atol=2e-5, rtol=1e-5)
        lengths[:2] += 1
    assert (len(calls) > 0) == flash
    assert len(port_calls) == (3 * 2 if flash else 0)  # 3 steps x 2 layers
    jpool = jcache["gpt"]["layers"]["layer"]["attn"]
    for name, jname in (("key", "cached_key"), ("value", "cached_value")):
        np.testing.assert_allclose(tcache[name][:, 1:].numpy(),
                                   np.asarray(jpool[jname])[:, 1:],
                                   atol=2e-5, rtol=1e-5)


def test_decode_steps_on_the_card_take_the_kernels_or_raise():
    """On the card a single-query step never takes the dense path: it
    takes the decode kernels whatever ``use_flash_attention`` says, and a
    key mask they cannot read raises. On the CPU the JAX model's choice
    holds: the kernels' plain version under ``use_flash_attention`` with a
    readable mask over a buffer an 8-row tile divides, else dense."""
    from fleetx_tpu_torch.models.gpt.model import SelfAttention

    dense = SelfAttention(GPTConfig(**TINY, use_flash_attention=False),
                          device="meta")
    flash = SelfAttention(GPTConfig(**TINY), device="meta")
    mask = torch.ones(2, 1, 1, 32, dtype=torch.bool)
    for attn in (dense, flash):
        assert attn._takes_decode_kernel(True, mask, 32)
        assert attn._takes_decode_kernel(True, None, 36)  # wrapper raises
        assert attn._takes_decode_kernel(True, None, 64, page_size=8)
        for bad in (torch.ones(2, 1, 3, 32, dtype=torch.bool),
                    torch.ones(2, 1, 1, 16, dtype=torch.bool)):
            with pytest.raises(ValueError, match="key mask"):
                attn._takes_decode_kernel(True, bad, 32)
    assert not dense._takes_decode_kernel(False, mask, 32)
    assert flash._takes_decode_kernel(False, mask, 32)
    assert flash._takes_decode_kernel(False, None, 64, page_size=8)
    assert not flash._takes_decode_kernel(False, None, 36)
    assert not flash._takes_decode_kernel(
        False, torch.ones(2, 1, 1, 16, dtype=torch.bool), 32)


def test_decode_cache_layout():
    model = GPTForPretraining(GPTConfig(**TINY, decode_cache_len=32,
                                        decode_num_pages=9,
                                        decode_page_size=PAGE), device="meta")
    cache = init_decode_cache(model, device="cpu")
    assert cache["key"].shape == (2, 9, PAGE, 2, 16)
    assert cache["key"].dtype == torch.bfloat16 and not cache["key"].any()
    with pytest.raises(ValueError):
        init_decode_cache(GPTForPretraining(GPTConfig(**TINY), "meta"),
                          device="cpu")


def test_yaml_config_matches_jax_loader():
    from fleetx_tpu.utils.config import get_config as jax_get_config
    from fleetx_tpu_torch.utils.config import get_config

    path = os.path.join(ROOT, "configs/nlp/gpt/"
                        "generation_gpt_345M_single_card.yaml")
    ours, theirs = get_config(path, nranks=1), jax_get_config(path, nranks=1)
    assert dict(ours.Model) == dict(theirs.Model)
    cfg = GPTConfig.from_model_config(ours.Model)
    ref = JaxGPTConfig.from_model_config(theirs.Model)
    for f in dataclasses.fields(GPTConfig):
        # the JAX model takes its mp layout from the mesh, not its config
        if f.name not in ("dtype", "mp_degree"):
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_attention_heads,
            cfg.head_dim, cfg.vocab_size) == (24, 1024, 16, 64, 50304)
    assert cfg.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    with_dtype = GPTConfig.from_model_config(dict(ours.Model,
                                                  dtype="float32"))
    assert with_dtype.dtype == torch.float32


FAMILIES = "Other families and the rest of the toolkit"


# the ids name the items as ROADMAP numbered them when these cases were
# written; the MoE switches they refused are ported (parallel/moe.py)
@pytest.mark.parametrize("key,value,item", [
    pytest.param("num_experts", 8, FAMILIES, id="num_experts-8-A8"),
    pytest.param("expert_mode", True, FAMILIES, id="expert_mode-True-A8")])
def test_config_raises_on_switches_the_port_does_not_compute(key, value,
                                                             item):
    """The MoE switches load as the JAX loader reads them: every MoE field
    equal to JAX's (``num_experts`` above 1 sets ``expert_mode``), at the
    switch's value and at the JAX default; no switch of a ``Model``
    section raises any more."""
    base = dict(TINY)
    default = getattr(JaxGPTConfig(), key)
    for v in (value, default):
        got = GPTConfig.from_model_config({**base, key: v})
        want = JaxGPTConfig.from_model_config({**base, key: v})
        for f in ("num_experts", "expert_mode", "gate", "top_k",
                  "capacity_factor", "moe_dispatch", "balance_loss_weight"):
            assert getattr(got, f) == getattr(want, f), (v, f)
    assert GPTConfig.from_model_config({**base, key: value}).expert_mode
    assert GPTConfig.from_model_config({**base, key: default}) == \
        GPTConfig.from_model_config(base)


@pytest.mark.parametrize("cp", [1, 2, 8])
def test_config_reads_cp_degree_like_jax(cp):
    """``cp_degree`` is ported (ring attention, B11): it loads as the JAX
    loader reads it, at any degree."""
    got = GPTConfig.from_model_config({**TINY, "cp_degree": cp})
    assert got.cp_degree == cp
    assert JaxGPTConfig.from_model_config(
        {**TINY, "cp_degree": cp}).cp_degree == cp


@pytest.mark.parametrize("pp,v", [(1, 1), (1, 2), (2, 1), (2, 2), (4, 2)])
def test_config_reads_pp_degrees_like_jax(pp, v):
    """``pp_degree``, ``virtual_pp_degree`` and ``num_microbatches`` are
    ported (pipeline parallelism): they load as the JAX loader reads them;
    the virtual degree places layers only under pp (JAX reads it only
    then), and ``pp · v`` must divide the layers (JAX :282-284)."""
    model = {**TINY, "num_layers": 8, "pp_degree": pp,
             "virtual_pp_degree": v, "num_microbatches": 4}
    got = GPTConfig.from_model_config(model)
    ref = JaxGPTConfig.from_model_config(model)
    assert (got.pp_degree, got.virtual_pp_degree, got.num_microbatches) == \
        (ref.pp_degree, ref.virtual_pp_degree, ref.num_microbatches) == \
        (pp, v, 4)
    assert got.virtual_pp == (v if pp > 1 else 1)
    with pytest.raises(ValueError, match=r"num_layers 6 % \(pp"):
        GPTConfig.from_model_config({**model, "num_layers": 6,
                                     "pp_degree": 4})


def test_config_ignores_layout_switches_and_reads_recompute_keys():
    """Layout switches (and keys that are no JAX field) load and change
    nothing; the recompute and fused-CE keys become fields, lists as
    tuples as the JAX loader makes them. ``sequence_parallel`` and
    ``fast_dropout`` are fields too, read as JAX reads them."""
    base = GPTConfig.from_model_config(TINY)
    assert GPTConfig.from_model_config(
        {**TINY, "scan_layers": False, "moe_dispatch": "scatter",
         "module": "GPTModule"}) == base
    for key, value in (("sequence_parallel", True), ("fast_dropout", False)):
        got = GPTConfig.from_model_config({**TINY, key: value})
        assert getattr(got, key) == value == getattr(
            JaxGPTConfig.from_model_config({**TINY, key: value}), key)
    cfg = GPTConfig.from_model_config(
        {**TINY, "use_recompute": True, "recompute_granularity": "full",
         "no_recompute_layers": [0], "fused_ce": True,
         "recompute_extra_saves": "qkv_out,ffn_gelu"})
    want = JaxGPTConfig.from_model_config(
        {**TINY, "use_recompute": True, "recompute_granularity": "full",
         "no_recompute_layers": [0], "fused_ce": True,
         "recompute_extra_saves": "qkv_out,ffn_gelu"})
    for key in ("use_recompute", "recompute_granularity",
                "no_recompute_layers", "fused_ce", "recompute_extra_saves"):
        assert getattr(cfg, key) == getattr(want, key), key
    assert cfg.no_recompute_layers == (0,)


@pytest.mark.parametrize("granularity,extra,error,match", [
    pytest.param("full_attn", None, None, {"attn_out"},
                 id="full_attn-None-saves-attn_out"),
    pytest.param("core_attn", None, None, {"core_attn_out"},
                 id="core_attn-None-saves-core_attn_out"),
    pytest.param("full", ("qkv_out",), None, {"qkv_out"},
                 id="full-extra-saves-qkv_out"),
    ("bogus", None, ValueError, "unknown recompute_granularity"),
    ("full", ("qkv",), ValueError, "match no checkpoint_name site"),
    (None, None, None, set()), ("full", None, None, set())])
def test_recompute_policy_branches(granularity, extra, error, match):
    """Every JAX granularity is ported: ``full`` (the default) keeps no
    named tensor, ``full_attn`` keeps ``attn_out``, ``core_attn``
    ``core_attn_out``, and ``recompute_extra_saves`` add to any of them;
    an unknown granularity or save name raises ValueError as JAX's
    ``_remat_policy`` does; without use_recompute the granularity is not
    read."""
    from fleetx_tpu_torch.models.gpt.model import GPTModel, recompute_policy

    kw = dict(TINY, recompute_granularity=granularity,
              recompute_extra_saves=extra)
    off = GPTConfig(**kw)
    assert recompute_policy(off) is None
    GPTModel(off, device="meta")
    on = GPTConfig(**kw, use_recompute=True)
    if error is None:
        assert recompute_policy(on) == frozenset(match)
        GPTModel(on, device="meta")
    else:
        with pytest.raises(error, match=match):
            GPTModel(on, device="meta")


@pytest.mark.parametrize("name", [
    "nlp/gpt/pretrain_gpt_345M_single_card.yaml",
    "nlp/gpt/pretrain_gpt_1.3B_single_card.yaml",
    "nlp/gpt/generation_gpt_345M_single_card.yaml",
    "tiny/pretrain_gpt_tiny_cpu.yaml"])
def test_repo_yamls_still_load(name):
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.utils.config import get_config

    module = build_module(get_config(os.path.join(ROOT, "configs", name),
                                     nranks=1))
    assert all(p.device.type == "meta" for p in module.nets.parameters())
