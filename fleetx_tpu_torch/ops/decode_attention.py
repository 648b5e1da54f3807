"""Single-query decode attention: the CUDA kernels and their plain versions.

Port of the JAX package's decode kernels (ops/pallas/decode_attention.py).
A decode step is one query token per batch row attending the row's live
window ``[starts[b], end[b])`` of cached positions. Two cache layouts:

- contiguous ``[b, cache_len, h, d]`` buffers, the one-shot ``generate()``
  cache — ``flash_decode_attention`` (:361), kernels B7 (``_decode_kernel``
  :243) and, over int8 K/V with fp32 scales, B9 (``_decode_kernel_q8``
  :329);
- one shared pool of ``[num_pages, page_size, h, d]`` pages per layer, each
  row reaching its logical positions through a block table of page
  indices, the serving cache — ``flash_decode_paged_attention`` (:525),
  kernels B8 (``_paged_decode_kernel`` :465) and, at int8, B10
  (``_paged_decode_kernel_q8`` :479).

All four run one template, ``csrc/decode_attention.cu``, as the JAX kernels
share ``_decode_kernel``'s body (B8 is it with the page as its tile). It
splits each row's window over blocks of 64 positions in two launches
(scores, then the weighted values, the last block of a row adding the
splits in order) through a scratch the wrapper allocates
(:func:`split_plan`).
:func:`decode_attention` and :func:`paged_decode_attention` are the
wrappers: on CUDA tensors they launch the hand-written kernel or raise;
on CPU tensors they run the plain version
(:func:`decode_attention_ref`, :func:`paged_decode_attention_ref`), which
repeats the kernels' casts and is what the kernels are held against on
the card. :func:`paged_gather_kv` materialises each row's logical buffer
from a pool (the multi-token prefill path and the plain versions use it).

All of them take p against the running max as it stands after each
``block_k``-wide tile of positions, tiles aligned at multiples of
``block_k`` from position 0, and round p to the operand dtype before the
value product, as the TPU kernels do. ``block_k`` is the TPU kernels':
:func:`fit_decode_blocks` of the cache length (contiguous) or the page
size (paged). Int8 K/V are dequantized ``int8 → fp32 × scale`` and rounded
to the operand dtype before their products.

``launches`` counts kernel launches by kernel name (never plain-version
calls), so a run can show that its decode steps went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from fleetx_tpu_torch.ops import _build
from fleetx_tpu_torch.ops.quant import dequantize_kv

__all__ = ["DECODE_TOL", "KERNEL", "NAMES", "SPLIT_POSITIONS",
           "launches", "decode_attention", "decode_attention_ref",
           "decode_gaps", "fit_decode_blocks", "paged_decode_attention",
           "paged_decode_attention_ref", "paged_gather_kv", "split_plan"]

KERNEL = "decode_attention"  # csrc/decode_attention.cu: B7, B8, B9, B10
# kernel names, the keys of ``launches``: B8, B7, B9, B10
NAMES = ("paged_decode", "decode", "decode_q8", "paged_decode_q8")
NEG_INF = -1e30  # the TPU kernels' running-max sentinel
HEAD_DIMS = (16, 32, 64, 128)
# the TPU kernels' default tile width, and the widest tile the CUDA kernels
# take
MAX_BLOCK_K = 256
# positions of one split of a row's window (kSplit in the CUDA template)
SPLIT_POSITIONS = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# B7-B10 vs their plain version on the card, (atol, share) by
# dtype (see decode_gaps): the same fp32 summation-order gap, read two
# ways. A score one fp32 ulp off can flip the bf16 rounding of one p, so a
# few bf16 outputs move (by several ulps where they are small); a fault in
# where p or dequantized K/V are rounded moves a large share of them, by
# less than the largest sound move. bf16 readings of both are in PERF.md
DECODE_TOL = {torch.float32: (1e-5, 1.0), torch.bfloat16: (4e-3, 0.02)}

launches = {name: 0 for name in NAMES}  # kernel launches since import

IntArg = Union[int, torch.Tensor]


def fit_decode_blocks(cache_len: int, want_k: int = MAX_BLOCK_K,
                      want_major: int = 1024):
    """``(block_k, major)`` tiling ``cache_len``, or ``(None, None)`` when
    no 8-row tile divides it: the largest multiple of 8 dividing
    ``cache_len`` that is <= ``want_k``, and the largest multiple of it
    dividing ``cache_len`` that is <= ``want_major``. A copy of the JAX
    function (:106-125) at its default tile sizes (the port has no
    environment knob for them): its ``block_k`` sets where the kernels
    round p."""
    want_k = min(want_k, cache_len)
    block_k = next((bk for bk in range(want_k - want_k % 8, 7, -8)
                    if cache_len % bk == 0), None)
    if block_k is None:
        return None, None
    n = cache_len // block_k
    t = min(n, max(want_major // block_k, 1))
    while n % t:
        t -= 1
    return block_k, t * block_k


def decode_gaps(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How far a kernel's output ``got`` lies from its plain version's
    ``want``: ``max_abs_err``, ``moved_share`` (the share of elements that
    differ at all), and ``ok``: both within :data:`DECODE_TOL` of
    ``want``'s dtype."""
    atol, share = DECODE_TOL[want.dtype]
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    moved = (diff > 0).float().mean().item()
    return {"max_abs_err": err, "moved_share": moved,
            "ok": math.isfinite(err) and err <= atol and moved <= share}


def paged_gather_kv(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Each row's logical buffer ``[b, n_logical * page_size, h, X]``
    gathered from a pool ``[num_pages, page_size, h, X]`` through its block
    table ``[b, n_logical]`` (K/V pages, or their ``X = 1`` scale pages)."""
    b, n_logical = tables.shape
    gathered = pages[tables.long()]  # [b, n_logical, page_size, h, X]
    return gathered.reshape(b, n_logical * pages.shape[1], *pages.shape[2:])


def _row_ints(value: Optional[IntArg], b: int, device) -> torch.Tensor:
    """A scalar or ``[b]`` window bound (None = 0) as a contiguous ``[b]``
    int32 tensor on ``device``. A Python int is filled in on the device
    (a host-to-card copy of a scalar would wait for the stream)."""
    if value is None or isinstance(value, int):
        return torch.full((b,), 0 if value is None else value,
                          dtype=torch.int32, device=device)
    t = torch.as_tensor(value, dtype=torch.int32, device=device)
    if t.dim() == 0:
        return t.expand(b).contiguous()
    if tuple(t.shape) != (b,):
        raise ValueError(f"window bounds must be a scalar or [b={b}], got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def _window_attention(q, k, v, *, end, starts, block_k: int) -> torch.Tensor:
    """The plain online-softmax result over ``k``/``v`` ``[b, L, h, d]``
    (values in the operand dtype, ``L`` a multiple of ``block_k``): scores
    in fp32; p taken against the running max as it stands after each
    ``block_k`` tile and rounded to the operand dtype before the value
    product; masked positions contributing exactly 0; an empty window
    dividing by 1. Output ``[b, 1, h, d]`` in ``q``'s dtype."""
    b, _, h, d = q.shape
    ends = _row_ints(end, b, q.device).long()
    first = _row_ints(starts, b, q.device).long()
    pos = torch.arange(k.shape[1], device=q.device)
    valid = ((pos[None, :] >= first[:, None])
             & (pos[None, :] < ends[:, None]))[:, None, :]  # [b, 1, L]
    s = torch.einsum("bhd,blhd->bhl", q[:, 0].float(), k.float())
    s = torch.where(valid, s * (1.0 / math.sqrt(d)), NEG_INF)
    # running max after each tile [b, h, L / block_k], then per position
    run_max = torch.cummax(s.unflatten(-1, (-1, block_k)).amax(-1), -1).values
    p = torch.exp(s - run_max.repeat_interleave(block_k, -1))
    p = torch.where(valid, p, 0.0)
    # rescale each tile's terms from its running max to the final one
    rescale = torch.exp(run_max - run_max[..., -1:]).repeat_interleave(
        block_k, -1)
    l = (p * rescale).sum(dim=-1, keepdim=True)  # [b, h, 1]
    p = p.to(q.dtype).float() * rescale
    acc = torch.einsum("bhl,blhd->bhd", p, v.float())
    out = acc / torch.where(l > 0, l, 1.0)
    return out.to(q.dtype)[:, None]


def _paged_block_k(page_size: int) -> int:
    block_k, major = fit_decode_blocks(page_size, want_major=page_size)
    if block_k is None or major != page_size:
        raise ValueError(
            f"page_size must be a multiple of 8, got {page_size}")
    return block_k


def _contiguous_block_k(cache_len: int) -> int:
    block_k, _ = fit_decode_blocks(cache_len)
    if block_k is None:
        raise ValueError(
            f"cache_len {cache_len} not tileable (must be a multiple of 8)")
    return block_k


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, end: IntArg, starts: Optional[IntArg] = None,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version of :func:`decode_attention` (B7; B9 with scales),
    tiled at :func:`fit_decode_blocks` of the cache length, as the kernels
    and the TPU kernel tile."""
    block_k = _contiguous_block_k(k.shape[1])
    if k_scale is not None:
        k = dequantize_kv(k, k_scale, q.dtype)
        v = dequantize_kv(v, v_scale, q.dtype)
    return _window_attention(q, k, v, end=end, starts=starts,
                             block_k=block_k)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, *, tables: torch.Tensor,
                               end: IntArg, starts: Optional[IntArg] = None,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain version of :func:`paged_decode_attention` (B8; B10 with scale
    pools): gather each row's logical buffer (and scales), dequantize at
    int8, then the tiled softmax of :func:`decode_attention_ref` with
    ``block_k`` = the page size."""
    block_k = _paged_block_k(k_pages.shape[1])
    k = paged_gather_kv(k_pages, tables)
    v = paged_gather_kv(v_pages, tables)
    if k_scale is not None:
        k = dequantize_kv(k, paged_gather_kv(k_scale, tables), q.dtype)
        v = dequantize_kv(v, paged_gather_kv(v_scale, tables), q.dtype)
    return _window_attention(q, k, v, end=end, starts=starts,
                             block_k=block_k)


def _check(q, k, v, k_scale, v_scale, tables=None):
    """Raise on anything the kernels do not take: q [b, 1, h, d] bf16 or
    fp32; K/V of q's dtype, or int8 with both fp32 ``[..., h, 1]`` scale
    tensors; head_dim in 16/32/64/128; int32 tables; all on q's device,
    contiguous and 16-byte aligned."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [b, 1, h, d], got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         "both be rank 4 and of one shape")
    if tuple(k.shape[2:]) != (h, d):
        raise ValueError(f"K/V carry (h, d) = {tuple(k.shape[2:])}, q "
                         f"carries {(h, d)}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernels take bf16 or fp32 q, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 KV needs BOTH k_scale and v_scale")
    named = [("q", q), ("k", k), ("v", v)]
    if k_scale is None:
        if k.dtype != q.dtype or v.dtype != q.dtype:
            raise ValueError(f"K/V must have q's dtype {q.dtype} (or be "
                             f"int8 with scales), got {k.dtype}, {v.dtype}")
    else:
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise ValueError(f"with scales K/V must be int8, got {k.dtype}, "
                             f"{v.dtype}")
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.dtype != torch.float32 or tuple(s.shape) != (
                    *k.shape[:3], 1):
                raise ValueError(
                    f"{name} must be fp32 {(*k.shape[:3], 1)}, got "
                    f"{s.dtype} {tuple(s.shape)}")
            named.append((name, s))
    if tables is not None:
        if tables.dim() != 2 or tables.shape[0] != b:
            raise ValueError(f"tables must be [b={b}, n_logical], got "
                             f"{tuple(tables.shape)}")
        if tables.dtype != torch.int32:
            raise ValueError(f"tables must be int32, got {tables.dtype}")
        named.append(("tables", tables))
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_tile(width: int) -> None:
    """The paged kernels round p per ``block_k`` tile, the page itself,
    which the kernels take up to 256 positions wide (the TPU kernels'
    widest); wider pages raise."""
    if width > MAX_BLOCK_K:
        raise ValueError(f"the CUDA kernels tile at most {MAX_BLOCK_K} "
                         f"positions, got {width}")


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def split_plan(b: int, h: int, length: int, d: int):
    """``(splits, words)`` of the kernels' scratch for ``b`` rows of ``h``
    heads of ``d`` over a reach of ``length`` positions: each row's reach
    is cut into ``splits`` = max(1, ceil(length / 64)) splits, and the
    fp32 scratch holds the scores [b·h, length], each split's max score
    [b·h, splits] and sums [b·h, splits, d + 1], and one arrival counter
    per (row, head): ``words`` 4-byte words (266,368, about 1 MB, at
    GPT-345M's serving pools: 8 rows, 16 heads, 1024 positions, d 64)."""
    splits = max(1, -(-length // SPLIT_POSITIONS))
    return splits, b * h * (length + splits * (d + 2) + 1)


def _launch_decode(name, q, k, v, k_scale, v_scale, tables, first, ends,
                   out, length, n_logical, page_size, block_k) -> None:
    """Launch one of B7-B10 from ``csrc/decode_attention.cu``, with its
    scratch (:func:`split_plan`) allocated on the call's stream."""
    fn = _build.load(KERNEL).decode_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 7 + [ctypes.c_float,
                                               ctypes.c_void_p])
    b, _, h, d = q.shape
    quant = k_scale is not None
    null = None
    splits, words = split_plan(b, h, length, d)
    scratch = torch.empty(words, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(_DTYPE_CODES[q.dtype], int(quant), int(tables is not None),
                 d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 k_scale.data_ptr() if quant else null,
                 v_scale.data_ptr() if quant else null,
                 tables.data_ptr() if tables is not None else null,
                 first.data_ptr(), ends.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), b, h, length, n_logical, page_size,
                 block_k, splits, 1.0 / math.sqrt(d), _stream(q))
    _raise_on(err, name)
    launches[name] += 1


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     end: IntArg, starts: Optional[IntArg] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Single-query attention over the contiguous decode cache.

    ``q`` [b, 1, h, d]; ``k``/``v`` the full cache buffers [b, cache_len,
    h, d], of q's dtype (B7) or int8 with ``k_scale``/``v_scale`` [b,
    cache_len, h, 1] fp32 (B9); ``end`` (scalar or [b]) and ``starts``
    (optional, default 0) bound each row's window. ``cache_len`` must be a
    multiple of 8; :func:`fit_decode_blocks` of it is the tile width p is
    rounded at. Returns [b, 1, h, d] in q's dtype.

    The kernels' contract holds on every device (see :func:`_check`);
    anything else raises. CUDA tensors then launch
    ``csrc/decode_attention.cu``; CPU tensors take
    :func:`decode_attention_ref`."""
    _check(q, k, v, k_scale, v_scale)
    block_k = _contiguous_block_k(k.shape[1])
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, end=end, starts=starts,
                                    k_scale=k_scale, v_scale=v_scale)
    b = q.shape[0]
    out = torch.empty_like(q)
    if b == 0:
        return out
    _launch_decode("decode" if k_scale is None else "decode_q8", q, k, v,
                   k_scale, v_scale, None, _row_ints(starts, b, q.device),
                   _row_ints(end, b, q.device), out, k.shape[1], 0, 0,
                   block_k)
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, *, tables: torch.Tensor,
                           end: IntArg, starts: Optional[IntArg] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Single-query attention against a paged K/V pool.

    ``q`` [b, 1, h, d]; ``k_pages``/``v_pages`` [num_pages, page_size, h,
    d] of q's dtype (B8), or int8 with ``k_scale``/``v_scale`` scale pools
    [num_pages, page_size, h, 1] fp32 gathered through the same table
    (B10); ``tables`` [b, n_logical] int32; ``end`` (scalar or [b]) and
    ``starts`` (optional, default 0) bound each row's window in logical
    positions. Returns [b, 1, h, d] in q's dtype.

    The kernels' contract holds on every device (page_size a multiple of
    8, see :func:`_check` for the rest); anything else raises. CUDA
    tensors then launch ``csrc/decode_attention.cu`` (B8, B10); CPU
    tensors take :func:`paged_decode_attention_ref`."""
    _check(q, k_pages, v_pages, k_scale, v_scale, tables)
    page_size = k_pages.shape[1]
    block_k = _paged_block_k(page_size)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_pages, v_pages, tables=tables, end=end, starts=starts,
            k_scale=k_scale, v_scale=v_scale)
    _check_tile(page_size)
    b = q.shape[0]
    ends = _row_ints(end, b, q.device)
    first = _row_ints(starts, b, q.device)
    out = torch.empty_like(q)
    if b == 0:
        return out
    n_logical = tables.shape[1]
    _launch_decode("paged_decode" if k_scale is None else "paged_decode_q8",
                   q, k_pages, v_pages, k_scale, v_scale, tables, first,
                   ends, out, n_logical * page_size, n_logical, page_size,
                   block_k)
    return out
