"""Decode attention of the PyTorch port against the JAX package.

The port's plain versions are held against the Pallas kernels (run in
interpret mode on the CPU) on the same numpy inputs: ``decode_attention_ref``
against ``flash_decode_attention`` (B7, and B9 with int8 K/V and scales),
``paged_decode_attention_ref`` against ``flash_decode_paged_attention``
(B8, and B10 with int8 pools and scale pools). The CUDA kernels themselves
are held against the plain versions on the card, in ``test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fleetx_tpu.ops.pallas.decode_attention import (
    fit_decode_blocks as jax_fit_decode_blocks,
)
from fleetx_tpu.ops.pallas.decode_attention import (
    flash_decode_attention,
    flash_decode_paged_attention,
)
from fleetx_tpu_torch.ops import decode_attention as da
from test_torch_cuda import (
    _torch,
    contiguous_case,
    paged_case,
    quantize_np,
    split_windows,
)

# fp32: summation order only; bf16: both round p against the same per-tile
# running max, and one bf16 ulp at |out| < 1 covers an fp32 sum landing on
# the other side of a rounding tie
PALLAS_TOL = {"float32": 1e-5, "bfloat16": 4e-3}


@pytest.mark.parametrize("cache_len,block_k", [(296, 8), (512, 256)])
@pytest.mark.parametrize("end_kind", ["rows", "scalar"])
@pytest.mark.parametrize("quant", [False, True], ids=["B7", "B9"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contiguous_plain_version_matches_pallas_kernel(
        cache_len, block_k, end_kind, quant, dtype):
    """Windows with ``starts > 0``, ``end=1``, ends on tile borders, and
    garbage outside every window; ``fit_decode_blocks`` tiles 296 = 8 x 37
    at 8 and 512 at 256, as the JAX function does."""
    assert da.fit_decode_blocks(cache_len) == jax_fit_decode_blocks(
        cache_len)
    assert da.fit_decode_blocks(cache_len)[0] == block_k
    q, k, v, starts, ends = contiguous_case(
        cache_len, scalar_end=None if end_kind == "rows" else 201)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jkw = dict(end=jnp.asarray(ends), starts=jnp.asarray(starts))
    tkw = dict(end=ends if end_kind == "scalar" else _torch(ends),
               starts=_torch(starts))
    if quant:
        (k, ks), (v, vs) = quantize_np(k), quantize_np(v)
        jkw.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tkw.update(k_scale=_torch(ks), v_scale=_torch(vs))
        jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), _torch(k), _torch(v)
    else:
        jk, jv = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
        tk, tv = _torch(k, tdt), _torch(v, tdt)
    want = flash_decode_attention(jnp.asarray(q, jdt), jk, jv, **jkw)
    got = da.decode_attention_ref(_torch(q, tdt), tk, tv, **tkw)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=PALLAS_TOL[dtype], rtol=0)


@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_q8_plain_version_matches_pallas_kernel(page_size, dtype):
    """B10: int8 pools with fp32 scale pools gathered through the table."""
    q, k, v, tables, starts, ends = paged_case(page_size, seed=2)
    (k, ks), (v, vs) = quantize_np(k), quantize_np(v)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = flash_decode_paged_attention(
        jnp.asarray(q, jdt), jnp.asarray(k), jnp.asarray(v),
        tables=jnp.asarray(tables), end=jnp.asarray(ends),
        starts=jnp.asarray(starts), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    got = da.paged_decode_attention_ref(
        _torch(q, tdt), _torch(k), _torch(v), tables=_torch(tables),
        end=_torch(ends), starts=_torch(starts), k_scale=_torch(ks),
        v_scale=_torch(vs))
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=PALLAS_TOL[dtype], rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["B7", "B9"])
def test_contiguous_wrapper_takes_plain_version_on_cpu(quant):
    q, k, v, starts, ends = contiguous_case(64, seed=3)
    kw = dict(end=_torch(ends), starts=_torch(starts))
    if quant:
        (k, ks), (v, vs) = quantize_np(k), quantize_np(v)
        kw.update(k_scale=_torch(ks), v_scale=_torch(vs))
    args = (_torch(q), _torch(k), _torch(v))
    before = dict(da.launches)
    got = da.decode_attention(*args, **kw)
    assert da.launches == before
    torch.testing.assert_close(got, da.decode_attention_ref(*args, **kw),
                               rtol=0, atol=0)


def test_paged_q8_wrapper_takes_plain_version_on_cpu():
    q, k, v, tables, starts, ends = paged_case(8, seed=4)
    (k, ks), (v, vs) = quantize_np(k), quantize_np(v)
    args = (_torch(q), _torch(k), _torch(v))
    kw = dict(tables=_torch(tables), end=_torch(ends), starts=_torch(starts),
              k_scale=_torch(ks), v_scale=_torch(vs))
    before = dict(da.launches)
    got = da.paged_decode_attention(*args, **kw)
    assert da.launches == before
    torch.testing.assert_close(
        got, da.paged_decode_attention_ref(*args, **kw), rtol=0, atol=0)


@pytest.mark.parametrize("bad", [
    "one_scale", "int8_without_scales", "scales_without_int8",
    "scale_dtype", "scale_shape", "cache_len", "head_dim", "ends",
    "q_len"])
def test_contiguous_wrapper_rejects_what_the_kernels_do_not_take(bad):
    q, k, v, starts, ends = contiguous_case(64)
    (k8, ks), (v8, vs) = quantize_np(k), quantize_np(v)
    q, k, v, k8, v8, ks, vs = (_torch(x) for x in (q, k, v, k8, v8, ks, vs))
    kw = dict(end=_torch(ends), starts=_torch(starts))
    args = [q, k8, v8]
    kw.update(k_scale=ks, v_scale=vs)
    if bad == "one_scale":
        kw["v_scale"] = None
    elif bad == "int8_without_scales":
        kw.update(k_scale=None, v_scale=None)
    elif bad == "scales_without_int8":
        args = [q, k, v]
    elif bad == "scale_dtype":
        kw["k_scale"] = ks.double()
    elif bad == "scale_shape":
        kw["v_scale"] = vs[:, :32].contiguous()
    elif bad == "cache_len":
        args = [q, k8[:, :60].contiguous(), v8[:, :60].contiguous()]
        kw.update(k_scale=ks[:, :60].contiguous(),
                  v_scale=vs[:, :60].contiguous())
    elif bad == "head_dim":
        args = [x[..., :8].contiguous() for x in args]
    elif bad == "ends":
        kw["end"] = kw["end"][:2]
    elif bad == "q_len":
        args[0] = q.expand(-1, 2, -1, -1).contiguous()
    with pytest.raises(ValueError):
        da.decode_attention(*args, **kw)


def test_fit_decode_blocks_matches_jax():
    for cache_len in (8, 40, 64, 200, 296, 512, 712, 1000, 1024, 2048, 12):
        assert da.fit_decode_blocks(cache_len) == jax_fit_decode_blocks(
            cache_len), cache_len
        for want in (8, 64, 512):
            assert da.fit_decode_blocks(cache_len, want) == \
                jax_fit_decode_blocks(cache_len, want), (cache_len, want)


@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("dtype,atol", [
    ("float32", 1e-5),
    # both round p against the same per-page running max; one bf16 ulp at
    # |out| < 1 covers an fp32 sum landing on the other side of a tie
    ("bfloat16", 4e-3),
])
def test_plain_version_matches_pallas_kernel(page_size, dtype, atol):
    q, k, v, tables, starts, ends = paged_case(page_size)
    jdt = jnp.dtype(dtype)
    want = flash_decode_paged_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        tables=jnp.asarray(tables), end=jnp.asarray(ends),
        starts=jnp.asarray(starts))
    tdt = getattr(torch, dtype)
    got = da.paged_decode_attention_ref(
        _torch(q, tdt), _torch(k, tdt), _torch(v, tdt),
        tables=_torch(tables), end=_torch(ends), starts=_torch(starts))
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    q, k, v, tables, starts, ends = paged_case(8, seed=1)
    before = dict(da.launches)
    got = da.paged_decode_attention(_torch(q), _torch(k), _torch(v),
                                    tables=_torch(tables), end=_torch(ends),
                                    starts=_torch(starts))
    want = da.paged_decode_attention_ref(_torch(q), _torch(k), _torch(v),
                                         tables=_torch(tables),
                                         end=_torch(ends),
                                         starts=_torch(starts))
    assert da.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["head_dim", "page_size", "noncontig",
                                 "dtype", "tables", "ends"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v, tables, _, ends = paged_case(8)
    q, k, v, tables = _torch(q), _torch(k), _torch(v), _torch(tables)
    if bad == "ends":
        ends = ends[:2]
    elif bad == "head_dim":
        q, k, v = (x[..., :8].contiguous() for x in (q, k, v))
    elif bad == "page_size":
        k, v = k[:, :4].contiguous(), v[:, :4].contiguous()
    elif bad == "noncontig":
        k = k.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "tables":
        tables = tables.long()
    with pytest.raises(ValueError):
        da.paged_decode_attention(q, k, v, tables=tables, end=_torch(ends))


def test_paged_gather_kv_matches_jax():
    from fleetx_tpu.ops.pallas.decode_attention import (
        paged_gather_kv as jax_gather,
    )

    _, k, _, tables, _, _ = paged_case(16)
    want = np.asarray(jax_gather(jnp.asarray(k), jnp.asarray(tables)))
    got = da.paged_gather_kv(_torch(k), _torch(tables)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fault", ["p not rounded", "p against the final max"])
def test_decode_limit_passes_one_ulp_and_catches_rounding_faults(fault):
    """``DECODE_TOL`` at bf16, which holds B7/B9/B10 against their plain
    version on the card: one output moved by one ulp passes; the plain
    version with p rounded at another point (kept in fp32, or against the
    final max instead of each 8-wide tile's) moves too many outputs."""
    q, k, v, starts, ends = contiguous_case(296)
    q, k, v = (_torch(x, torch.bfloat16) for x in (q, k, v))
    kw = dict(end=_torch(ends), starts=_torch(starts))
    want = da.decode_attention_ref(q, k, v, **kw)
    moved = want.clone()
    moved.view(torch.int16).view(-1)[7] += 1  # the next bf16 value
    gaps = da.decode_gaps(moved, want)
    assert gaps["ok"] and 0 < gaps["moved_share"] <= 1 / want.numel()
    if fault == "p not rounded":
        bad = da._window_attention(q.float(), k.float(), v.float(),
                                   block_k=8, **kw).to(torch.bfloat16)
    else:
        bad = da._window_attention(q, k, v, block_k=296, **kw)
    gaps = da.decode_gaps(bad, want)
    assert not gaps["ok"] and gaps["moved_share"] > 0.05, gaps


def _split_form(q, k, v, starts, ends, *, block_k, cuts):
    """The CUDA template's order of work, in plain fp32: each row's window
    [start, min(end, L)) is cut at ``cuts`` into splits; for a split
    [lo, hi) the running max its first tile t0 starts from is the max of
    the window's scores before t0·block_k, each tile it touches has the
    max of all its window positions (some in other splits), m_final is
    the window's max; the split sums round(p)·exp(run_t − m_final)·v and
    p·exp(run_t − m_final) with p = exp(s − run_t), and the splits are
    added in order, then divided (an empty window by 1). ``k``/``v``
    [b, L, h, d] hold values in q's dtype (dequantized for int8)."""
    b, _, h, d = q.shape
    length = k.shape[1]
    s_all = torch.einsum("bhd,blhd->bhl", q[:, 0].float(), k.float()) * (
        1.0 / math.sqrt(d))
    out = torch.zeros(b, h, d)
    neg = torch.tensor(da.NEG_INF)
    for r in range(b):
        st, en = max(int(starts[r]), 0), min(int(ends[r]), length)
        if st >= en:
            continue
        bounds = sorted({st, en} | {c for c in cuts if st < c < en})
        for hh in range(h):
            s = s_all[r, hh]
            m_final = s[st:en].max()
            parts = []
            for lo, hi in zip(bounds, bounds[1:]):
                t0, t1 = lo // block_k, (hi - 1) // block_k
                run = s[st:t0 * block_k].max() if t0 * block_k > st else neg
                acc, l = torch.zeros(d), torch.zeros(())
                for t in range(t0, t1 + 1):
                    run = torch.maximum(run, s[max(st, t * block_k):min(
                        en, (t + 1) * block_k)].max())
                    c = torch.exp(run - m_final)
                    a, z = max(lo, t * block_k), min(hi, (t + 1) * block_k)
                    p = torch.exp(s[a:z] - run)
                    l = l + (p * c).sum()
                    acc = acc + ((p.to(q.dtype).float() * c)[:, None]
                                 * v[r, a:z, hh].float()).sum(0)
                parts.append((acc, l))
            o = sum(a for a, _ in parts)
            n = sum(n for _, n in parts)
            out[r, hh] = o / (n if n > 0 else 1.0)
    return out.to(q.dtype)[:, None]


# how _split_form cuts the windows: the kernels' 64-position splits (tile
# borders at block_k 8, mid-tile at 256), cuts inside tiles, and cuts on
# every tile border
SPLIT_CUTS = {
    "kernel": lambda bk, L: range(da.SPLIT_POSITIONS, L,
                                  da.SPLIT_POSITIONS),
    "mid-tile": lambda bk, L: range(bk // 2 + 3, L, max(bk, 24)),
    "borders": lambda bk, L: range(bk, L, bk),
}
# (cache_len or reach, block_k, page size or None)
SPLIT_LAYOUTS = {"contiguous-8": (296, 8, None),
                 "contiguous-256": (512, 256, None),
                 "paged-16": (320, 16, 16)}
_JAX_SPLIT_REFS = {}


def _split_inputs(layout, dtype):
    """Torch operands (K/V in q's dtype, dequantized for int8) and the
    JAX reference of one layout at one dtype, made once per module."""
    length, bk, page = SPLIT_LAYOUTS[layout]
    windows = split_windows(length)
    if page is None:
        q, k, v, starts, ends = contiguous_case(length, windows=windows)
        tables = None
    else:
        q, k, v, tables, starts, ends = paged_case(
            page, n_logical=length // page, windows=windows)
    quant = dtype == "int8"
    tdt = torch.bfloat16 if quant else getattr(torch, dtype)
    jdt = jnp.dtype("bfloat16" if quant else dtype)
    jkw = dict(end=jnp.asarray(np.minimum(ends, length)),
               starts=jnp.asarray(starts))
    if quant:
        (k, ks), (v, vs) = quantize_np(k), quantize_np(v)
        jkw.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = _torch(k), _torch(v)
        tks, tvs = _torch(ks), _torch(vs)
    else:
        jk, jv = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
        tk, tv = _torch(k, tdt), _torch(v, tdt)
    key = (layout, dtype)
    if key not in _JAX_SPLIT_REFS:
        if page is None:
            want = flash_decode_attention(jnp.asarray(q, jdt), jk, jv, **jkw)
        else:
            want = flash_decode_paged_attention(
                jnp.asarray(q, jdt), jk, jv, tables=jnp.asarray(tables),
                **jkw)
        _JAX_SPLIT_REFS[key] = torch.from_numpy(
            np.array(want.astype(jnp.float32))).to(tdt)
    if page is not None:
        tk, tv = (da.paged_gather_kv(x, _torch(tables)) for x in (tk, tv))
        if quant:
            tks, tvs = (da.paged_gather_kv(x, _torch(tables))
                        for x in (tks, tvs))
    if quant:
        tk, tv = (da.dequantize_kv(x, sc, tdt)
                  for x, sc in ((tk, tks), (tv, tvs)))
    return (_torch(q, tdt), tk, tv, starts, ends, bk,
            _JAX_SPLIT_REFS[key])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("cuts", sorted(SPLIT_CUTS))
@pytest.mark.parametrize("layout", sorted(SPLIT_LAYOUTS))
def test_split_form_matches_plain_version_and_pallas(layout, cuts, dtype,
                                                     monkeypatch):
    """The weights the CUDA template's second pass computes, with the
    window cut at the kernels' split points, inside tiles and on tile
    borders (``_split_form``), at block_k 8, 16 (a page) and 256, over
    windows of many splits, one position, a start inside a tile, an empty
    window and one clamped at the reach: against ``_window_attention``
    (the plain version) and JAX's Pallas kernels in interpret mode. fp32
    differs in the association of sums only (1e-6); bf16, and int8
    dequantized to bf16, round the same p and may flip an output's last
    bit (``DECODE_TOL``)."""
    monkeypatch.setenv("FLEETX_FORCE_FLASH", "1")
    q, k, v, starts, ends, bk, jax_want = _split_inputs(layout, dtype)
    got = _split_form(q, k, v, starts, ends, block_k=bk,
                      cuts=list(SPLIT_CUTS[cuts](bk, k.shape[1])))
    plain = da._window_attention(q, k, v, end=_torch(ends),
                                 starts=_torch(starts), block_k=bk)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.equal(got[4], torch.zeros_like(got[4]))  # the empty window
    for want in (plain, jax_want):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-6)
        else:
            gaps = da.decode_gaps(got, want)
            assert gaps["ok"], gaps


def test_split_plan_mirrors_the_kernel():
    """The wrapper's scratch plan and the CUDA template's split width
    (``kSplit``) agree: max(1, ceil(L / 64)) splits, and one fp32 word
    per score, per split's max, per split and column (+ the normaliser),
    per (row, head)'s arrival counter."""
    import re
    from pathlib import Path

    src = (Path(da.__file__).parent / "csrc" /
           "decode_attention.cu").read_text()
    assert int(re.search(r"constexpr int kSplit = (\d+);", src).group(1)) \
        == da.SPLIT_POSITIONS == 64
    assert da.split_plan(8, 16, 1024, 64) == (16, 128 * (1024 + 16 * 66 + 1))
    assert da.split_plan(8, 16, 512, 64)[0] == 8
    assert da.split_plan(4, 2, 296, 16)[0] == 5
    assert da.split_plan(2, 2, 0, 16) == (1, 4 * (0 + 18 + 1))
