"""Flash attention and hash dropout of the PyTorch port against the JAX
package.

The same numpy inputs and the same int32 seed go through the JAX
``flash_attention`` (the Pallas kernels in interpret mode, as
tests/test_flash_attention.py runs them on the CPU) and the port's
``flash_attention``, whose CPU path runs the plain versions of the three
CUDA kernels under the same autograd wiring. Tolerances: fp32 1e-5 for
the output and 1e-4 for the gradients (summation order only); bf16 2e-2
(the Pallas kernel takes p against the running max of its own 512-wide
tile, the port's plain version against 64-wide tiles, which moves a bf16
rounding of p by one ulp).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fleetx_tpu.ops.dropout import HashDropout as JaxHashDropout
from fleetx_tpu.ops.pallas import flash_attention as jfa
from fleetx_tpu_torch.ops import attention as tattn
from fleetx_tpu_torch.ops import flash_attention as tfa
from fleetx_tpu_torch.ops.dropout import HashDropout, draw_seed

KEY = jax.random.PRNGKey(7)
# the int32 seed the JAX entry draws from KEY (flash_attention.py:1000)
SEED = int(np.asarray(jax.random.bits(KEY, (1,), "uint32")
                      .astype(jnp.int32))[0])
TOL = {"fp32": (1e-5, 1e-4), "bf16": (2e-2, 2e-2)}


def _inputs(b, s, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(4)]


def _jax_run(q, k, v, g, *, causal, kv_lens, rate, dtype):
    jd = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    kvl = None if kv_lens is None else jnp.asarray(kv_lens, jnp.int32)

    def f(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, kv_lens=kvl,
                                  dropout_rate=rate,
                                  dropout_rng=KEY if rate else None)
        return (out.astype(jnp.float32) * g).sum(), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(
        *(jnp.asarray(x, jd) for x in (q, k, v)))
    return [np.asarray(x, np.float32) for x in (out, *grads)]


def _torch_run(q, k, v, g, *, causal, kv_lens, rate, dtype):
    td = torch.float32 if dtype == "fp32" else torch.bfloat16
    args = [torch.tensor(x).to(td).requires_grad_() for x in (q, k, v)]
    kvl = None if kv_lens is None else torch.tensor(kv_lens,
                                                    dtype=torch.int32)
    out = tfa.flash_attention(*args, causal=causal, kv_lens=kvl,
                              dropout_rate=rate, seed=SEED)
    (out.float() * torch.tensor(g)).sum().backward()
    return [t.detach().float().numpy()
            for t in (out, *(a.grad for a in args))]


@pytest.mark.parametrize("s,d,causal,kv_lens,rate,dtype", [
    (64, 16, True, None, 0.0, "fp32"),
    (128, 64, True, None, 0.0, "fp32"),
    (256, 16, False, None, 0.0, "fp32"),
    (128, 16, True, None, 0.1, "fp32"),
    (256, 64, True, None, 0.1, "fp32"),
    (256, 16, True, [0, 200], 0.0, "fp32"),
    (192, 64, False, [100, 192], 0.1, "fp32"),
    (128, 64, True, None, 0.0, "bf16"),
    (256, 16, True, [70, 256], 0.1, "bf16"),
], ids=lambda x: str(x))
def test_flash_forward_and_grads_match_pallas(s, d, causal, kv_lens, rate,
                                              dtype):
    """Output and dq/dk/dv of one loss; with kv_lens [0, ...] batch row 0
    is fully masked (zeros out, zero grads)."""
    q, k, v, g = _inputs(2, s, 2, d)
    kw = dict(causal=causal, kv_lens=kv_lens, rate=rate, dtype=dtype)
    want = _jax_run(q, k, v, g, **kw)
    got = _torch_run(q, k, v, g, **kw)
    out_tol, grad_tol = TOL[dtype]
    np.testing.assert_allclose(got[0], want[0], atol=out_tol, rtol=out_tol)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=grad_tol, rtol=grad_tol,
                                   err_msg=name)
    if kv_lens and kv_lens[0] == 0:
        assert not got[0][0].any() and not got[2][0].any()


@pytest.mark.parametrize("seed", [0, 1, -1, 2**31 - 1, -2**31, SEED,
                                  -1640531535])
def test_keep_mask_bit_identical_to_jax(seed):
    """The in-kernel keep mask on a (bh, q, k) grid, for seeds that set
    the sign bit (the logical-shift and wrap-around hazards)."""
    bh = np.arange(0, 300, 37, dtype=np.int32)[:, None, None]
    q = np.arange(0, 5000, 61, dtype=np.int32)[None, :, None]
    k = np.arange(0, 5000, 53, dtype=np.int32)[None, None, :]
    want = np.asarray(jfa.dropout_keep_scale(
        jnp.int32(seed), jnp.asarray(bh), jnp.asarray(q), jnp.asarray(k),
        0.1))
    got = tfa.dropout_keep_scale(seed, torch.tensor(bh), torch.tensor(q),
                                 torch.tensor(k), 0.1).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.08 < (got == 0).mean() < 0.12


@pytest.mark.parametrize("seed", [0, -7, 2**31 - 1, -2**31, 123456789])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_hash_dropout_bit_identical_to_jax(seed, rate):
    """HashDropout's mask equals the JAX ``dropout_keep_scale(seed, 0,
    idx, 0, rate)`` over the flat index, and the module output equals the
    JAX module's ``x * scale.astype(x.dtype)``."""
    shape = (3, 37, 41)
    idx = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    scale = np.asarray(jfa.dropout_keep_scale(
        jnp.int32(seed), jnp.int32(0), jnp.asarray(idx), jnp.int32(0), rate))
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jnp.asarray(x, jd) * jnp.asarray(scale).astype(jd),
                          np.float32)
        got = HashDropout(rate)(torch.tensor(x).to(td), deterministic=False,
                                seed=seed)
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_hash_dropout_module_seeds_like_jax():
    """The JAX module folds its ``'dropout'`` key into one int32 seed;
    given that seed the port's module drops the same elements."""
    keys = []

    class Probe(JaxHashDropout):
        def make_rng(self, name="params"):
            keys.append(super().make_rng(name))
            return keys[-1]

    want = np.asarray(Probe(0.1).apply(
        {}, jnp.ones((4, 64, 8)), deterministic=False,
        rngs={"dropout": KEY}))
    seed = int(np.asarray(jax.random.bits(keys[0], (), "uint32")
                          .astype(jnp.int32)))
    got = HashDropout(0.1)(torch.ones(4, 64, 8), deterministic=False,
                           seed=seed).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.05 < (got == 0).mean() < 0.15


def test_draw_seed_covers_the_int32_range():
    g = torch.Generator().manual_seed(0)
    seeds = [draw_seed(g) for _ in range(2000)]
    assert min(seeds) < -2**30 and max(seeds) > 2**30
    assert all(-2**31 <= s < 2**31 for s in seeds)
    g2 = torch.Generator().manual_seed(0)
    assert seeds[:5] == [draw_seed(g2) for _ in range(5)]


@pytest.mark.parametrize("s", [72, 128])
def test_causal_attention_pads_and_matches_jax(s, monkeypatch):
    """causal_attention pads a sequence that is not a multiple of the
    kernels' 64-row tile (72 -> 128, the padded keys masked through
    kv_lens); output and grads match the JAX routing under
    FLEETX_FORCE_FLASH=1 (one 72-row Pallas tile there)."""
    from fleetx_tpu.ops.attention import causal_attention as jax_attention

    monkeypatch.setenv("FLEETX_FORCE_FLASH", "1")
    calls = []
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape)
                        or tfa._FlashAttention.apply(
                            *a, k.get("kv_lens"), k["causal"],
                            k["dropout_rate"], k["seed"]))
    q, k, v, g = _inputs(2, s, 2, 16, seed=3)

    def f(q, k, v):
        out = jax_attention(q, k, v, causal=True)
        return (out * g).sum(), out

    (_, want), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                          has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    args = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
    out = tattn.causal_attention(*args, causal=True)
    (out * torch.tensor(g)).sum().backward()
    assert calls == [(2, s + (-s % 64), 2, 16)]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    for a, b in zip(args, grads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


def test_dense_path_with_explicit_mask_matches_jax():
    """An explicit mask takes the dense path on both sides."""
    from fleetx_tpu.ops.attention import causal_attention as jax_attention

    q, k, v, _ = _inputs(2, 24, 2, 16, seed=4)
    mask = np.random.RandomState(5).rand(2, 1, 24, 24) > 0.3
    want = jax_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=True,
                         attn_mask=jnp.asarray(mask))
    got = tattn.causal_attention(*(torch.tensor(x) for x in (q, k, v)),
                                 causal=True, attn_mask=torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("bad", ["seq", "dtype", "head_dim", "kv_lens"])
def test_kernel_contract_raises_on_every_device(bad):
    q = torch.zeros(1, 128, 2, 64)
    kw = {}
    if bad == "seq":
        q = torch.zeros(1, 100, 2, 64)
    elif bad == "dtype":
        q = q.half()
    elif bad == "head_dim":
        q = torch.zeros(1, 128, 2, 48)
    else:
        kw["kv_lens"] = torch.tensor([3], dtype=torch.int64)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, **kw)


@pytest.mark.parametrize("bad", ["do-two-bytes-off", "qkv-rows-ragged",
                                 "lse-one-float-off"])
def test_tma_check_refuses_views_off_16_bytes(bad):
    """The bf16 kernels at head dim 64/128 load their operands by TMA and
    dK/dV's lse and delta rows by bulk copies: ``_check_tma`` passes the
    model's strided views of a fused qkv and refuses, with ``ValueError``,
    a dO view two bytes off, a fused buffer whose rows are not a multiple
    of 16 bytes, and an lse one float (4 bytes) off."""
    b, s, h, d = 1, 128, 2, 64
    bf16 = torch.bfloat16
    q, k, v = torch.zeros(b, s, h, 3 * d, dtype=bf16).split(d, dim=-1)
    do = torch.zeros(b, s, h, d, dtype=bf16)
    lse = torch.zeros(b * h, s)
    ok = dict(q=q, k=k, v=v, do=do, lse=lse, delta=lse.clone())
    tfa._check_tma(*ok.items())
    if bad == "do-two-bytes-off":
        flat = torch.zeros(do.numel() + 8, dtype=bf16)
        ok["do"] = flat[1:1 + do.numel()].view(do.shape)
    elif bad == "qkv-rows-ragged":
        ok["q"], ok["k"], ok["v"] = torch.zeros(
            b, s, h, 3 * d + 4, dtype=bf16)[..., :3 * d].split(d, dim=-1)
    else:
        ok["lse"] = torch.zeros(lse.numel() + 4)[1:1 + lse.numel()].view(
            b * h, s)
    with pytest.raises(ValueError, match="16-byte"):
        tfa._check_tma(*ok.items())
