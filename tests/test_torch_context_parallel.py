"""Context parallelism of the PyTorch port against the JAX package: the
ring-CP pair entries (B11), the zig-zag order, hash dropout under cp, and
the ring at cp 2.

The same numpy inputs go through the JAX ``block_fwd_lse``/``block_dq``/
``block_dkv`` (the Pallas kernels in interpret mode with an explicit
``meta``) and the port's entries, whose CPU path runs the plain versions
of B1-B3 with the same global ids; fp32, held to 1e-5 (summation order
only). The ring runs on spawned gloo ranks (``test_torch_cp_ranks.py``)
against JAX ``ring_self_attention`` on the virtual CPU devices.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fleetx_tpu.ops.pallas import flash_attention as jfa
from fleetx_tpu.parallel import context_parallel as jcp
from fleetx_tpu.parallel.mesh import MeshConfig, build_mesh, use_mesh
from fleetx_tpu_torch.ops import flash_attention as tfa
from fleetx_tpu_torch.ops.dropout import HashDropout, Shard
from fleetx_tpu_torch.parallel import context_parallel as tcp
from test_torch_cp_ranks import ring

TOL = dict(rtol=1e-5, atol=1e-5)
SEED = -987654321


def _np(x):
    return np.asarray(x, np.float32)


# (label, causal, meta [b0, h0, h_local, h_total, q_off, k_off], kv_len, rate)
BLOCK_CASES = [
    ("diagonal-causal", True, (0, 0, 2, 2, 128, 128), 512, 0.0),
    ("diagonal-causal-drop-kvcut", True, (3, 2, 2, 8, 128, 128), 160, 0.2),
    ("below-diagonal-causal", True, (0, 0, 2, 2, 192, 64), 512, 0.2),
    ("off-diagonal-bidirectional", False, (1, 0, 2, 4, 64, 320), 512, 0.2),
    ("bidirectional-kvcut", False, (0, 4, 2, 6, 0, 128), 168, 0.0),
]


@pytest.mark.parametrize("causal,meta,kv_len,rate",
                         [c[1:] for c in BLOCK_CASES],
                         ids=[c[0] for c in BLOCK_CASES])
def test_block_entries_match_jax(causal, meta, kv_len, rate):
    """B11's three entries on one pair with global offsets (nonzero q_off
    and k_off, b0 and h0, a global kv_len below the end), causal and
    bidirectional, dropout 0 and 0.2: out, lse, dq, dk and dv as JAX's."""
    b, s, h, d = 2, 64, 2, 16
    rng = np.random.RandomState(1)
    q, k, v, do = (rng.randn(b, s, h, d).astype(np.float32)
                   for _ in range(4))
    kw = dict(causal=causal, dropout_rate=rate, kv_len=kv_len)
    jseed = jnp.asarray([SEED], jnp.int32)
    jmeta = jnp.asarray(meta, jnp.int32)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jout, jlse = jfa.block_fwd_lse(jq, jk, jv, jseed, jmeta, **kw)
    jdelta = jnp.sum(jdo * jout, axis=-1)
    jdq = jfa.block_dq(jq, jk, jv, jdo, jlse, jdelta, jseed, jmeta, **kw)
    jdk, jdv = jfa.block_dkv(jq, jk, jv, jdo, jlse, jdelta, jseed, jmeta,
                             **kw)

    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = tfa.block_fwd_lse(tq, tk, tv, SEED, meta, **kw)
    delta = (tdo * out).sum(-1)
    dq = tfa.block_dq(tq, tk, tv, tdo, lse, delta, SEED, meta, **kw)
    dk, dv = tfa.block_dkv(tq, tk, tv, tdo, lse, delta, SEED, meta, **kw)
    assert lse.shape == (b, s, h)
    for name, got, want in (("out", out, jout), ("lse", lse, jlse),
                            ("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        np.testing.assert_allclose(got.numpy(), _np(want), err_msg=name,
                                   **TOL)
    assert float(np.abs(_np(jdv)).mean()) > 1e-3  # not trivially zero


def test_identity_meta_leaves_the_plain_versions_bit_identical():
    """The identity meta (0, 0, h, h, 0, 0) and the block entries at zero
    offsets with kv_len = s compute exactly what the calls without a meta
    compute, with and without dropout."""
    b, s, h, d = 2, 128, 3, 16
    rng = np.random.RandomState(2)
    q, k, v, do = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
                   for _ in range(4))
    ident = tfa.identity_meta(h)
    for causal in (True, False):
        for rate in (0.0, 0.1):
            kw = dict(causal=causal, dropout_rate=rate, seed=SEED)
            out, lse = tfa.flash_fwd(q, k, v, **kw)
            out_m, lse_m = tfa.flash_fwd(q, k, v, meta=ident, **kw)
            assert torch.equal(out, out_m) and torch.equal(lse, lse_m)
            bout, blse = tfa.block_fwd_lse(q, k, v, SEED, ident,
                                           causal=causal, dropout_rate=rate,
                                           kv_len=s)
            assert torch.equal(bout, out)
            assert torch.equal(blse, lse.view(b, h, s).transpose(1, 2))
            delta = (do * out).sum(-1).transpose(1, 2).reshape(b * h, s)
            dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta.contiguous(), **kw)
            dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta.contiguous(),
                                       **kw)
            bkw = dict(causal=causal, dropout_rate=rate, kv_len=s)
            bdelta = (do * out).sum(-1)
            assert torch.equal(tfa.block_dq(q, k, v, do, blse, bdelta, SEED,
                                            ident, **bkw), dq)
            bdk, bdv = tfa.block_dkv(q, k, v, do, blse, bdelta, SEED, ident,
                                     **bkw)
            assert torch.equal(bdk, dk) and torch.equal(bdv, dv)


def test_block_entries_refuse_bad_meta():
    q = torch.zeros(1, 64, 2, 16)
    with pytest.raises(ValueError, match="meta"):
        tfa.block_fwd_lse(q, q, q, 0, (0, 0, 4, 4, 0, 0), causal=True,
                          dropout_rate=0.0, kv_len=64)
    with pytest.raises(ValueError, match="meta"):
        tfa.block_fwd_lse(q, q, q, 0, (0, 0, 2, 2, 0), causal=True,
                          dropout_rate=0.0, kv_len=64)


@pytest.mark.parametrize("cp", [1, 2, 4])
@pytest.mark.parametrize("axis", [1, 2])
def test_zigzag_split_and_merge_equal_jax_byte_for_byte(cp, axis):
    x = np.random.RandomState(cp).randn(2, 16, 24, 3).astype(np.float32)
    ids = np.arange(2 * 16 * 24, dtype=np.int32).reshape(2, 16, 24)
    for arr in (x, ids):
        want = np.asarray(jcp.zigzag_split(jnp.asarray(arr), cp, axis=axis))
        got = tcp.zigzag_split(torch.from_numpy(arr), cp, axis=axis).numpy()
        assert got.tobytes() == want.tobytes()
        back = tcp.zigzag_merge(torch.from_numpy(want.copy()), cp, axis=axis)
        assert back.numpy().tobytes() == arr.tobytes()
        wback = np.asarray(jcp.zigzag_merge(jnp.asarray(want), cp,
                                            axis=axis))
        assert wback.tobytes() == arr.tobytes()


def test_hash_dropout_under_cp_is_the_global_zigzag_mask():
    """dp 2 x cp 2: each rank's mask, keyed on its slice's global flat
    index, is its slice of the mask over the whole zig-zag-ordered batch,
    and that mask is the JAX module's (its hash over the global iota);
    the rank-local index would repeat one mask on every rank."""
    B, S, E, dp, cp, rate = 4, 32, 8, 2, 2, 0.1
    x = torch.ones(B, S, E)
    drop = HashDropout(rate)
    full = drop(x, deterministic=False, seed=SEED)
    iota = jnp.arange(B * S * E, dtype=jnp.int32).reshape(B, S, E)
    want = jfa.dropout_keep_scale(jnp.int32(SEED), jnp.int32(0), iota,
                                  jnp.int32(0), rate)
    assert full.numpy().tobytes() == _np(want).tobytes()
    b, s = B // dp, S // cp
    parts = []
    for d in range(dp):
        row = []
        for c in range(cp):
            local = x[d * b:(d + 1) * b, c * s:(c + 1) * s]
            row.append(drop(local, deterministic=False, seed=SEED,
                            shard=Shard(b0=d * b, batch=B, s0=c * s,
                                        seq=S)))
        parts.append(torch.cat(row, dim=1))
    assert torch.equal(torch.cat(parts, dim=0), full)
    local = drop(x[:b, :s], deterministic=False, seed=SEED)
    assert not torch.equal(local, full[:b, s:2 * s])


def jax_ring(q, k, v, do, cp, causal):
    """JAX ``ring_self_attention`` on ``cp`` virtual devices: the output
    and dq, dk, dv, natural order."""
    mesh = build_mesh(MeshConfig(cp=cp), jax.devices()[:cp])

    def f(q, k, v):
        qz, kz, vz = (jcp.zigzag_split(x, cp) for x in (q, k, v))
        with use_mesh(mesh):
            out = jcp.ring_self_attention(qz, kz, vz, mesh=mesh,
                                          causal=causal, expected_cp=cp)
        return jcp.zigzag_merge(out, cp)

    out, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(x) for x in (q, k, v)))
    return [_np(out)] + [_np(g) for g in vjp(jnp.asarray(do))]


def ring_case(cp, seed=0):
    rng = np.random.RandomState(seed)
    b, s, h, d = 2, 2 * cp * 64, 2, 16
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_matches_jax_ring_at_cp2(causal):
    """The port's ring on 2 spawned gloo ranks against JAX's on 2 virtual
    devices: forward and dq, dk, dv at 1e-5."""
    q, k, v, do = ring_case(2)
    got = ring(q, k, v, do, cp=2, causal=causal)
    want = jax_ring(q, k, v, do, 2, causal)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_ring_refuses_what_it_cannot_run():
    """A promised cp without a cp mesh raises (inputs are zig-zag ordered);
    dropout needs a seed; a block below the pair tile raises."""
    q = torch.zeros(1, 256, 2, 16)
    with pytest.raises(RuntimeError, match="cp_degree=2"):
        tcp.ring_self_attention(q, q, q, expected_cp=2)
    with pytest.raises(ValueError, match="seed"):
        tcp.ring_self_attention(q, q, q, dropout_rate=0.1)
    from fleetx_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="zig-zag blocks"):
        tcp.ring_attention(q[:, :96], q[:, :96], q[:, :96],
                           mesh=Mesh(1, 2, 0))
