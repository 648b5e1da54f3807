"""Tensor parallelism (mp) of the PyTorch port against the JAX package: the
vocab-parallel fused cross-entropy B12, the vocab-parallel logits loss,
the weight shards, and attention dropout over a heads shard.

The same numpy inputs go through the JAX function under an mp 2 mesh of
the virtual CPU devices (the Pallas kernels in interpret mode, as
``tests/test_ce_loss.py::test_mesh_vocab_parallel_matches_unsharded`` runs
them) and through the port on 2 spawned gloo ranks (``test_torch_mp_ranks.
py``), whose CPU path runs the plain versions of B4-B6 and B1-B3. Tiny
config: vocab 128 (a shard of 64 takes the 64-wide block), hidden 64, 4
heads, fp32. Tolerances (summation order only): 1e-5 on losses and
outputs, 1e-4 on gradients, as the cp gates; the weight shards and the
dropout masks bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from fleetx_tpu.models.gpt.model import GPTConfig as JaxGPTConfig
from fleetx_tpu.models.gpt.model import GPTForPretraining as JaxGPT
from fleetx_tpu.models.gpt.model import pretraining_loss as jax_pretraining_loss
from fleetx_tpu.ops.pallas import ce_loss as jce
from fleetx_tpu.ops.pallas import flash_attention as jfa
from fleetx_tpu.parallel.mesh import MeshConfig, build_mesh, use_mesh
from fleetx_tpu_torch.models.gpt.convert import (
    gather_params,
    init_params,
    params_from_jax,
    shard_params,
)
from fleetx_tpu_torch.models.gpt.model import GPTConfig, GPTForPretraining
from fleetx_tpu_torch.ops import flash_attention as tfa
from fleetx_tpu_torch.ops.ce_loss import fit_vocab_block
from fleetx_tpu_torch.parallel.tensor_parallel import (
    local_labels,
    mp_split_axes,
)
from test_torch_cp_ranks import run_ranks
from test_torch_mp_ranks import vp_ce, vp_loss_program

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2,
            num_attention_heads=4, ffn_hidden_size=128,
            max_position_embeddings=64)
KEY = jax.random.PRNGKey(11)
# the int32 seed the JAX flash entry draws from KEY (flash_attention.py:1000)
SEED = int(np.asarray(jax.random.bits(KEY, (1,), "uint32")
                      .astype(jnp.int32))[0])


def _ce_inputs(seed, n=32, e=64, v=128):
    rng = np.random.RandomState(seed)
    h = rng.randn(n, e).astype(np.float32)
    w = (rng.randn(v, e) * 0.3).astype(np.float32)
    labels = rng.randint(0, v, n).astype(np.int32)
    labels[:3] = [-1, 0, v - 1]  # off every shard, and both vocab ends
    g = rng.rand(n).astype(np.float32)  # a != -b: independent cotangents
    return h, w, labels, g


def test_b12_matches_jax_fused_linear_ce_under_mp2(eight_devices):
    """The port's mp 2 ``fused_linear_ce`` (B12 on 2 gloo ranks) against
    JAX ``fused_linear_ce`` under an mp 2 mesh: per-token loss, dh and each
    shard's dW, for the cotangent g (so B5/B6 see a = g·exp(lse_loc − lse)
    and b = −g, independent)."""
    h, w, labels, g = _ce_inputs(0)
    assert fit_vocab_block(w.shape[0] // 2) == 64
    mesh = build_mesh(MeshConfig(mp=2), eight_devices[:2])
    jl = jnp.asarray(labels)

    def loss(a, b):
        return (jce.fused_linear_ce(a, b, jl) * g).sum()

    with use_mesh(mesh):
        want = np.asarray(jce.fused_linear_ce(jnp.asarray(h), jnp.asarray(w),
                                              jl))
        jdh, jdw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(h),
                                                  jnp.asarray(w))
    got, dh, dw = vp_ce(h, w, labels, g)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dh, np.asarray(jdh), rtol=1e-4, atol=1e-6)
    for r in range(2):
        rows = slice(r * 64, (r + 1) * 64)
        np.testing.assert_allclose(dw[rows], np.asarray(jdw)[rows],
                                   rtol=1e-4, atol=1e-6,
                                   err_msg=f"dW shard {r}")


def test_local_labels_match_jax():
    """``local_labels`` equals JAX ``_local_labels`` on each shard (−1 off
    the shard, and for −1 itself)."""
    labels = np.array([-1, 0, 63, 64, 127, 5, 100], np.int32)
    for r in range(2):
        want = jax.vmap(lambda _: jce._local_labels(jnp.asarray(labels), 64,
                                                    "mp"),
                        axis_name="mp")(jnp.zeros(2))[r]
        got = local_labels(torch.from_numpy(labels), 64, r)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vocab_parallel_token_losses_match_jax_pretraining_loss():
    """The logits path under mp: ``vocab_parallel_token_losses`` over
    vocab-sharded logits on 2 gloo ranks, reduced with the loss mask,
    against JAX ``pretraining_loss`` on the global logits; and the
    gradient of each logits shard against JAX's gradient."""
    rng = np.random.RandomState(1)
    logits = (rng.randn(2, 16, 128) * 3).astype(np.float32)
    labels = rng.randint(0, 128, (2, 16)).astype(np.int32)
    mask = (rng.rand(2, 16) > 0.25).astype(np.float32)
    want, jgrad = jax.value_and_grad(jax_pretraining_loss)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    g = mask / mask.sum()  # the cotangent of the masked mean
    outs = run_ranks(vp_loss_program, 2, logits, labels, g, 2)
    for losses, _ in outs:
        np.testing.assert_allclose((losses * mask).sum() / mask.sum(),
                                   float(want), rtol=1e-5)
    grad = np.concatenate([d for _, d in outs], axis=-1)
    np.testing.assert_allclose(grad, np.asarray(jgrad), rtol=1e-4,
                               atol=1e-7)


def _jax_tree(seed=0):
    model = JaxGPT(JaxGPTConfig(**TINY, dtype=jnp.float32))
    return jax.tree.map(np.asarray, nn.meta.unbox(model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))))


def test_shard_params_round_trip_bit_exact():
    """``params_from_jax`` at mp 2 gives each rank the shapes of its mp 2
    model; ``gather_params`` of the two ranks' shards is the mp 1 state
    dict bit for bit; so is ``shard_params`` then ``gather_params`` of
    ``init_params``, whose mp 2 shards are the mp 1 draw's."""
    tree = _jax_tree()
    cfg1 = GPTConfig(**TINY)
    cfg2 = dataclasses.replace(cfg1, mp_degree=2)
    full = params_from_jax(tree, cfg1)
    shards = [params_from_jax(tree, cfg2, mp_rank=r) for r in range(2)]
    local = GPTForPretraining(cfg2, device="meta").state_dict()
    for shard in shards:
        assert {n: t.shape for n, t in shard.items()} == {
            n: t.shape for n, t in local.items()}
    for name, t in gather_params(shards, cfg2).items():
        assert torch.equal(t, full[name]), name
    drawn = init_params(cfg1, seed=5, device="cpu")
    parts = [init_params(cfg2, seed=5, device="cpu", mp_rank=r)
             for r in range(2)]
    for name, t in gather_params(parts, cfg2).items():
        assert torch.equal(t, drawn[name]), name
        assert torch.equal(shard_params(drawn, cfg2, 1)[name], parts[1][name])
    split = mp_split_axes(GPTForPretraining(cfg2, device="meta"))
    assert split == mp_split_axes(GPTForPretraining(cfg1, device="meta"))
    assert len(split) == 1 + 6 * 2 and split.keys() <= full.keys()


def test_shards_are_the_jax_logical_axes_split_over_mp():
    """Each rank's shard is the JAX param split along its logical mp axis
    (``parallel/sharding.py`` ``make_rules``: qkv ``heads``, out_proj
    ``heads``, up and down ``mlp``, the word embeddings ``vocab``),
    converted: the layout GSPMD gives mp rank r."""
    tree = _jax_tree(1)
    gpt = tree["params"]["gpt"]
    layer = gpt["layers"]["layer"]
    cfg2 = GPTConfig(**TINY, mp_degree=2)
    split = {("attn", "qkv_proj", "kernel"): 2, ("attn", "qkv_proj", "bias"): 1,
             ("attn", "out_proj", "kernel"): 1,
             ("mlp", "up_proj", "kernel"): 2, ("mlp", "up_proj", "bias"): 1,
             ("mlp", "down_proj", "kernel"): 1}  # axes after [L]
    for r in range(2):
        sub = jax.tree.map(lambda x: x, tree)
        sl = sub["params"]["gpt"]["layers"]["layer"]
        for (a, b, c), axis in split.items():
            x = layer[a][b][c]
            n = x.shape[axis] // 2
            sl[a][b][c] = np.take(x, np.arange(r * n, (r + 1) * n), axis=axis)
        v = gpt["word_embeddings"]
        sub["params"]["gpt"]["word_embeddings"] = v[r * 64:(r + 1) * 64]
        want = params_from_jax(sub, GPTConfig(**TINY))  # no split: as given
        got = params_from_jax(tree, cfg2, mp_rank=r)
        for name, t in got.items():
            assert torch.equal(t, want[name]), (r, name)


def test_attention_dropout_under_mp_is_the_mp1_mask(eight_devices):
    """Flash attention at dropout 0.2 over a heads shard with the global-head
    meta (b0, mp_rank·h_loc, h_loc, h, 0, 0): each rank's heads equal the
    port's unsharded call's bit for bit, and JAX's ``_sharded_flash``
    under an mp 2 mesh within 1e-5 (out) and 1e-4 (grads)."""
    b, s, h, d = 2, 128, 4, 16
    rng = np.random.RandomState(2)
    q, k, v, g = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(4))

    def run(lo, hi, meta):
        args = [torch.from_numpy(x[:, :, lo:hi].copy()).requires_grad_()
                for x in (q, k, v)]
        out = tfa.flash_attention(*args, causal=True, dropout_rate=0.2,
                                  seed=SEED, meta=meta)
        (out * torch.from_numpy(g[:, :, lo:hi].copy())).sum().backward()
        return [t.detach().numpy() for t in (out, *(a.grad for a in args))]

    whole = run(0, h, None)
    shards = [run(r * 2, r * 2 + 2, (0, r * 2, 2, h, 0, 0)) for r in range(2)]
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        got = np.concatenate([sh[i] for sh in shards], axis=2)
        np.testing.assert_array_equal(got, whole[i], err_msg=name)
    unsharded_wrong = run(2, 4, None)  # heads 2-3 keyed as heads 0-1
    assert not np.array_equal(unsharded_wrong[0], whole[0][:, :, 2:])

    mesh = build_mesh(MeshConfig(mp=2), eight_devices[:2])

    def f(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=True, dropout_rate=0.2,
                                  dropout_rng=KEY)
        return (out * g).sum(), out

    with use_mesh(mesh):
        (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                             has_aux=True)(
            *(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(whole[0], np.asarray(out), rtol=1e-5,
                               atol=1e-5)
    for name, a, want in zip(("dq", "dk", "dv"), whole[1:], grads):
        np.testing.assert_allclose(a, np.asarray(want), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
