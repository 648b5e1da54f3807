"""The GPT switches of the port against the JAX package: the split q/k/v
layout (``fuse_attn_qkv: False``, ``convert_qkv_layout``), flax's
threefry dropout (``fast_dropout: False``) and the recompute save-sets
(``full``, ``full_attn``, ``core_attn``, ``recompute_extra_saves``).

The model is test_remat_saves.py's (vocab 128, hidden 64, 4 heads, ffn
128, 2 layers, seq 32, fp32), its weights the JAX init bridged by
``params_from_jax``. Tolerances: 1e-5 on the loss and on every gradient
leaf against JAX; save-sets against the port's own run without
recompute: bit for bit (the same ops rerun on the same inputs with the
same dropout seeds).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from fleetx_tpu.models.gpt.model import GPTConfig as JaxGPTConfig
from fleetx_tpu.models.gpt.model import GPTForPretraining as JaxGPT
from fleetx_tpu.models.gpt.model import convert_qkv_layout as jax_convert
from fleetx_tpu_torch.models.gpt.convert import (
    convert_qkv_layout,
    params_from_jax,
    qkv_state_layout,
)
from fleetx_tpu_torch.models.gpt.model import (
    GPTConfig,
    GPTForPretraining,
    pretraining_loss,
)
from fleetx_tpu_torch.ops.dropout import FlaxDropout, threefry_keep
from fleetx_tpu_torch.parallel.mesh import set_mesh

ATOL = 1e-5
MODEL = dict(vocab_size=128, hidden_size=64, num_layers=2,
             num_attention_heads=4, ffn_hidden_size=128,
             max_position_embeddings=32, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0, use_flash_attention=False)
SAVE_SETS = [("full", None), ("full_attn", None), ("core_attn", None),
             ("full", ("ffn_gelu",)), ("core_attn", ("qkv_out", "ffn_gelu")),
             ("full_attn", ("qkv_out", "mlp_out"))]


@pytest.fixture(autouse=True)
def single_rank_mesh():
    set_mesh(None)
    yield
    set_mesh(None)


def _tokens():
    tokens = (np.arange(64).reshape(2, 32) * 7) % MODEL["vocab_size"]
    return tokens, np.roll(tokens, -1, axis=1)


def _jax(**kw):
    """JAX loss, gradients and init params of the model at ``kw``."""
    cfg = JaxGPTConfig(**{**MODEL, "dtype": jnp.float32, **kw})
    model = JaxGPT(cfg)
    tokens, labels = _tokens()
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens))

    def loss_fn(p):
        logits = model.apply(p, jnp.asarray(tokens))
        lp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(
            lp, jnp.asarray(labels)[..., None], axis=-1))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    unbox = lambda t: jax.tree.map(np.asarray, nn.meta.unbox(t))  # noqa
    return float(loss), unbox(grads), unbox(params)


@functools.lru_cache(maxsize=None)
def _jax_init():
    """The JAX init of the default model (computed once)."""
    return _jax()[2]


def _port(cfg, params, dropout=False, seed=1):
    """The port's loss and gradients (by name) at ``cfg`` from
    ``params``; with ``dropout`` the training forward draws its masks
    from a generator seeded ``seed``."""
    model = GPTForPretraining(cfg, device="meta")
    model.load_state_dict({n: t.clone() for n, t in params.items()},
                          assign=True)
    tokens, labels = (torch.from_numpy(a) for a in _tokens())
    pos = torch.arange(tokens.shape[1])[None].expand_as(tokens)
    logits = model(tokens, pos, deterministic=not dropout,
                   generator=torch.Generator().manual_seed(seed))
    loss = pretraining_loss(logits, labels, torch.ones_like(labels))
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def _port_cfg(**kw):
    return GPTConfig(**{**MODEL, "dtype": torch.float32, **kw})


def _check_against_jax(loss, grads, jloss, jgrads, cfg):
    np.testing.assert_allclose(float(loss), jloss, rtol=0, atol=ATOL)
    want = params_from_jax(jgrads, cfg)
    assert want.keys() == grads.keys()
    for n, w in want.items():
        np.testing.assert_allclose(grads[n].numpy(), w.numpy(), rtol=0,
                                   atol=ATOL, err_msg=n)


@pytest.mark.parametrize("to_fused", [False, True], ids=["split", "fuse"])
def test_convert_qkv_layout_matches_jax_both_ways(to_fused):
    """On a scan-stacked tree ([L, E, nh, ·] kernels, [L, nh, ·] biases,
    nested under other keys) the port's numpy copy gives JAX's tree."""
    rng = np.random.RandomState(0)
    L, e, nh, hd = 3, 16, 2, 4
    if to_fused:
        attn = {n: {"kernel": rng.randn(L, e, nh, hd).astype(np.float32),
                    "bias": rng.randn(L, nh, hd).astype(np.float32)}
                for n in ("q_proj", "k_proj", "v_proj")}
    else:
        attn = {"qkv_proj": {
            "kernel": rng.randn(L, e, nh, 3 * hd).astype(np.float32),
            "bias": rng.randn(L, nh, 3 * hd).astype(np.float32)}}
    attn["out_proj"] = {"kernel": rng.randn(L, nh, hd, e).astype(np.float32)}
    tree = {"gpt": {"layers": {"layer": {"attn": attn}}, "other": 1.0}}
    got = convert_qkv_layout(tree, to_fused)
    want = jax_convert(tree, to_fused)
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa
    assert flat(got).keys() == flat(want).keys()
    for k, v in flat(want).items():
        np.testing.assert_array_equal(np.asarray(flat(got)[k]),
                                      np.asarray(v))


def test_unfused_qkv_model_matches_jax_and_the_fused_layout():
    """``fuse_attn_qkv: False``: q_proj, k_proj and v_proj bridged from
    JAX's split model give its loss and every gradient leaf; the same
    weights fused by ``qkv_state_layout`` give the fused model's loss."""
    jloss, jgrads, jparams = _jax(fuse_attn_qkv=False)
    cfg = _port_cfg(fuse_attn_qkv=False)
    params = params_from_jax(jparams, cfg)
    assert "gpt.layers.0.attn.q_proj.weight" in params
    loss, grads = _port(cfg, params)
    _check_against_jax(loss, grads, jloss, jgrads, cfg)
    fused = qkv_state_layout(params, cfg, to_fused=True)
    floss, _ = _port(_port_cfg(), fused)
    np.testing.assert_allclose(float(floss), float(loss), rtol=0, atol=1e-6)
    back = qkv_state_layout(fused, cfg, to_fused=False)
    for n, t in params.items():
        torch.testing.assert_close(back[n], t, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(3, 5, 7), (2, 64, 33), (4097,)])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_flax_dropout_mask_is_jax_bernoulli(shape, rate):
    """The keep mask of a raw key is ``jax.random.bernoulli(key, 1 -
    rate, shape)`` bit for bit (partitionable threefry), and the module's
    output is flax ``nn.Dropout``'s with that key."""
    key = jax.random.PRNGKey(1234 + len(shape))
    raw = tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    want = np.asarray(jax.random.bernoulli(key, 1.0 - rate, shape))
    idx = torch.arange(int(np.prod(shape))).view(shape)
    np.testing.assert_array_equal(threefry_keep(raw, idx, 1.0 - rate)
                                  .numpy(), want)
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    jout = nn.Dropout(rate).apply({}, jnp.asarray(x), deterministic=False,
                                  rng=key)
    got = FlaxDropout(rate)(torch.from_numpy(x), False, seed=raw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jout))


@pytest.mark.parametrize("granularity,extra", SAVE_SETS,
                         ids=[f"{g}-{'+'.join(e or ('none',))}"
                              for g, e in SAVE_SETS])
def test_save_sets_are_bit_equal_to_no_recompute(granularity, extra):
    """Each save-set, at dropout 0.1 with the hash masks and with flax's
    threefry ones: the loss and every gradient bit-equal to the run
    without recompute (one generator seed for both)."""
    for fast in (True, False):
        base = _port_cfg(hidden_dropout_prob=0.1,
                         attention_probs_dropout_prob=0.1,
                         fast_dropout=fast)
        params = params_from_jax(_jax_init(), base)
        ref_loss, ref = _port(base, params, dropout=True)
        cfg = dataclasses.replace(base, use_recompute=True,
                                  recompute_granularity=granularity,
                                  recompute_extra_saves=extra)
        loss, grads = _port(cfg, params, dropout=True)
        assert torch.equal(loss, ref_loss), fast
        for n, g in ref.items():
            assert torch.equal(grads[n], g), (fast, n)


@pytest.mark.parametrize("granularity,extra", [
    ("core_attn", None), ("core_attn", ("qkv_out", "ffn_gelu")),
    ("full", ("qkv_out", "attn_out"))], ids=["core_attn",
                                            "core_attn+qkv+gelu",
                                            "full+qkv+attn"])
def test_save_sets_match_jax_remat_policy(granularity, extra):
    """test_remat_saves.py's configurations: the port's loss and every
    gradient leaf as JAX's under ``_remat_policy`` at the same save-set."""
    kw = dict(use_recompute=True, recompute_granularity=granularity,
              recompute_extra_saves=extra)
    jloss, jgrads, jparams = _jax(**kw)
    cfg = _port_cfg(**kw)
    loss, grads = _port(cfg, params_from_jax(jparams, cfg))
    _check_against_jax(loss, grads, jloss, jgrads, cfg)
