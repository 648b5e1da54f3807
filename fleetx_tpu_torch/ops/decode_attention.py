"""Paged single-query decode attention: the CUDA kernel and its plain version.

Port of the JAX package's ``flash_decode_paged_attention``
(ops/pallas/decode_attention.py:525). The serving engine keeps K/V in one
shared pool of ``[num_pages, page_size, h, d]`` pages per layer; each batch
row reaches its logical positions through a block table of page indices.
A decode step is one query token per row attending the row's live window
``[starts[b], end[b])`` of logical positions.

- :func:`paged_decode_attention` is the wrapper: on CUDA tensors it
  launches the hand-written kernel ``csrc/paged_decode.cu`` (or raises);
  on CPU tensors it runs :func:`paged_decode_attention_ref`.
- :func:`paged_decode_attention_ref` is the plain PyTorch version with the
  kernel's casts: the CPU path, and what the kernel is held against on
  the card.
- :func:`paged_gather_kv` materialises each row's logical buffer from the
  pool (the multi-token prefill path and the plain version use it).

``launches`` counts kernel launches (never plain-version calls), so a run
can show that its decode steps went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from fleetx_tpu_torch.ops import _build

__all__ = ["KERNEL_TOL", "launches", "paged_decode_attention",
           "paged_decode_attention_ref", "paged_gather_kv"]

KERNEL = "paged_decode"
NEG_INF = -1e30  # the TPU kernel's running-max sentinel
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel vs plain version on the card, max abs error by dtype: both take p
# against the same per-page running max, so they differ in fp32 summation
# order only, which can move a bf16 rounding of p or of the output one ulp
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

launches = 0  # kernel launches since import (or since a caller reset it)

IntArg = Union[int, torch.Tensor]


def paged_gather_kv(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Each row's logical K/V buffer ``[b, n_logical * page_size, h, d]``
    gathered from the pool ``[num_pages, page_size, h, d]`` through its
    block table ``[b, n_logical]``."""
    b, n_logical = tables.shape
    gathered = pages[tables.long()]  # [b, n_logical, page_size, h, d]
    return gathered.reshape(b, n_logical * pages.shape[1], *pages.shape[2:])


def _row_ints(value: Optional[IntArg], b: int, device) -> torch.Tensor:
    """A scalar or ``[b]`` window bound (None = 0) as a contiguous ``[b]``
    int32 tensor on ``device``."""
    t = torch.as_tensor(0 if value is None else value, dtype=torch.int32,
                        device=device)
    if t.dim() == 0:
        return t.expand(b).contiguous()
    if tuple(t.shape) != (b,):
        raise ValueError(f"window bounds must be a scalar or [b={b}], got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, *, tables: torch.Tensor,
                               end: IntArg, starts: Optional[IntArg] = None
                               ) -> torch.Tensor:
    """Plain version of :func:`paged_decode_attention`: gather each row's
    logical buffer, then a masked softmax with the kernel's casts —
    scores in fp32 over operands in the input dtype; p taken against the
    running max as it stands after each page (the online softmax's
    reference point, which the TPU kernel keeps per page-sized tile too)
    and rounded to the operand dtype before the value product; masked
    positions contributing exactly 0; an empty window dividing by 1.
    Output ``[b, 1, h, d]`` in ``q``'s dtype."""
    b, _, h, d = q.shape
    ps = k_pages.shape[1]
    k = paged_gather_kv(k_pages, tables)
    v = paged_gather_kv(v_pages, tables)
    ends = _row_ints(end, b, q.device).long()
    first = _row_ints(starts, b, q.device).long()
    pos = torch.arange(k.shape[1], device=q.device)
    valid = ((pos[None, :] >= first[:, None])
             & (pos[None, :] < ends[:, None]))[:, None, :]  # [b, 1, L]
    s = torch.einsum("bhd,blhd->bhl", q[:, 0].float(), k.float())
    s = torch.where(valid, s * (1.0 / math.sqrt(d)), NEG_INF)
    # running max after each page [b, h, n_logical], then per position
    run_max = torch.cummax(s.unflatten(-1, (-1, ps)).amax(-1), -1).values
    p = torch.exp(s - run_max.repeat_interleave(ps, -1))
    p = torch.where(valid, p, 0.0)
    # rescale each page's terms from its running max to the final one
    rescale = torch.exp(run_max - run_max[..., -1:]).repeat_interleave(ps, -1)
    l = (p * rescale).sum(dim=-1, keepdim=True)  # [b, h, 1]
    p = p.to(q.dtype).float() * rescale
    acc = torch.einsum("bhl,blhd->bhd", p, v.float())
    out = acc / torch.where(l > 0, l, 1.0)
    return out.to(q.dtype)[:, None]


def _check(q, k_pages, v_pages, tables):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [b, 1, h, d], got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4:
        raise ValueError(
            f"k_pages {tuple(k_pages.shape)} and v_pages "
            f"{tuple(v_pages.shape)} must both be [num_pages, page_size, h, d]")
    if tuple(k_pages.shape[2:]) != (h, d):
        raise ValueError(f"pages carry (h, d) = {tuple(k_pages.shape[2:])}, "
                         f"q carries {(h, d)}")
    if tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(f"tables must be [b={b}, n_logical], got "
                         f"{tuple(tables.shape)}")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(
            f"the kernel takes bf16 or fp32 q and pages of q's dtype, got "
            f"q {q.dtype}, k {k_pages.dtype}, v {v_pages.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if k_pages.shape[1] % 8:
        raise ValueError(
            f"page_size must be a multiple of 8, got {k_pages.shape[1]}")
    if tables.dtype != torch.int32:
        raise ValueError(f"tables must be int32, got {tables.dtype}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, *, tables: torch.Tensor,
                           end: IntArg, starts: Optional[IntArg] = None
                           ) -> torch.Tensor:
    """Single-query attention against a paged K/V pool.

    ``q`` [b, 1, h, d]; ``k_pages``/``v_pages`` [num_pages, page_size, h, d]
    of q's dtype; ``tables`` [b, n_logical] int32; ``end`` (scalar or [b])
    and ``starts`` (optional, default 0) bound each row's window in logical
    positions. Returns [b, 1, h, d] in q's dtype.

    The kernel's contract holds on every device: bf16 or fp32, head_dim in
    16/32/64/128, page_size a multiple of 8, int32 tables, all contiguous;
    anything else raises. CUDA tensors then launch
    ``csrc/paged_decode.cu``; CPU tensors take
    :func:`paged_decode_attention_ref`."""
    global launches
    _check(q, k_pages, v_pages, tables)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, tables=tables,
                                          end=end, starts=starts)
    b, _, h, d = q.shape
    ends = _row_ints(end, b, q.device)
    first = _row_ints(starts, b, q.device)
    out = torch.empty_like(q)
    if b == 0:
        return out
    fn = _build.load(KERNEL).paged_decode_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(q.device):
        err = fn(_DTYPE_CODES[q.dtype], d, q.data_ptr(), k_pages.data_ptr(),
                 v_pages.data_ptr(), tables.data_ptr(), first.data_ptr(),
                 ends.data_ptr(), out.data_ptr(), b, h, tables.shape[1],
                 k_pages.shape[1], 1.0 / math.sqrt(d),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
