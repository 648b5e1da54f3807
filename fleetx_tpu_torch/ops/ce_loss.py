"""Fused LM head and cross-entropy: the CUDA kernels and their plain versions.

Port of the JAX package's ``fused_linear_ce`` (ops/pallas/ce_loss.py:326)
and its custom VJP (``_fused_ce``, :179-226): the per-token cross-entropy
of ``logits = hidden @ embᵀ`` without ever storing the ``[tokens, vocab]``
logits or their gradient. Three kernels in ``csrc/ce_loss.cu``:

- ``ce_fwd`` (B4, ``_fwd_kernel`` :86): per-token loss and log-sum-exp,
  an online log-sum-exp over vocab tiles;
- ``ce_dh`` (B5, ``_dh_kernel`` :119): dh = Σ_v dl·W;
- ``ce_dw`` (B6, ``_dw_kernel`` :150): dW = Σ_tokens dlᵀ·h;

where dl = a·exp(s − lse) + b·onehot(label) is recomputed from the saved
lse, and (a, b) = (g, −g) for the plain cross-entropy backward. In bf16
all three run one wgmma GEMM mainloop on the tensor cores. B4 is one
product, s = h·Wᵀ, whose epilogue reduces each 256-column tile of a row
to (max, Σ exp(s − max), label logit) in a scratch of one split per tile
(:func:`_fwd_splits`), which a small kernel folds into each token's lse.
B5 and B6 each run two GEMMs per chunk of output rows: s of the chunk
with dl in its epilogue, rounded to bf16 into a scratch, then dl times
the other operand. The wrappers size the scratches (B5/B6's at most 256
MB); fp32 keeps one CUDA-core kernel per output.
:func:`fused_linear_ce` is a ``torch.autograd.Function`` whose forward
launches B4 and whose backward launches B5 and B6. Each of
:func:`fused_ce_fwd`, :func:`fused_ce_dh` and :func:`fused_ce_dw` launches
its kernel on CUDA tensors (or raises) and runs its plain version
(``*_ref``) on CPU tensors. ``launches`` counts kernel launches by name,
never plain-version calls.

The casts follow the Pallas kernels: the products take bf16 operands when
the inputs are bf16 (else fp32) with fp32 accumulation; p = exp(s − lse)
and dl are fp32, and dl is rounded to the operand dtype before its
product; dh comes out in h's dtype and dW in W's. A label that matches no
column (−1, or out of range) contributes no label logit, so its loss is
the lse. The plain versions walk vocab blocks of :func:`fit_vocab_block`,
as Pallas does; the kernel's own tile moves only the fp32 rounding of the
lse, and dl depends on the final lse, not on the tile.

The vocab-parallel form (B12, JAX ``_local_labels``/``_vp_stats``,
:289-323, and the mp branch of ``fused_linear_ce``, :365-395) runs under
tensor parallelism: with an ``mp_group``, :func:`fused_linear_ce` maps the
global labels to this rank's vocab shard (:func:`local_labels`, −1 off
the shard), runs B4 on the shard through :func:`vp_stats`, whose forward
returns the shard's per-token (lse, label logit) and whose backward feeds
their cotangents (a, b) straight to B5 and B6 as dl = a·softmax_local +
b·onehot, and combines the shards outside the kernels
(``tensor_parallel.vocab_parallel_combine``). No new kernel body: B4
already gives an off-shard label no label logit, and B5/B6 take per-token
a and b. ``vp_launches`` counts B12's kernel launches by entry. The dp
token-sharding branch of the JAX entry is placement: each dp rank calls
this function on its own tokens.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from fleetx_tpu_torch.ops import _build
from fleetx_tpu_torch.parallel.tensor_parallel import (
    copy_to_mp,
    local_labels,
    vocab_parallel_combine,
)

__all__ = ["KERNEL", "NAMES", "VP_NAMES", "MAX_HIDDEN", "CE_TOL",
           "launches", "vp_launches", "ce_gaps", "grads_gaps",
           "kernel_readings", "fp64_checks", "fit_vocab_block",
           "fused_linear_ce", "fused_ce_fwd", "fused_ce_dh", "fused_ce_dw",
           "fused_ce_fwd_ref", "fused_ce_dh_ref", "fused_ce_dw_ref",
           "local_labels", "vp_stats", "vp_stats_ref"]

KERNEL = "ce_loss"  # csrc/ce_loss.cu
NAMES = ("ce_fwd", "ce_dh", "ce_dw")
VP_NAMES = ("vp_ce_fwd", "vp_ce_dh", "vp_ce_dw")  # B12's entries over B4-B6
# the fp32 B5 and B6 hold a [16, hidden] fp32 accumulator in shared
# memory, which with their operand tiles fits the card's 227 KB up to this
# width; the bf16 kernels (TMA + wgmma GEMMs over the hidden dim) take any
# multiple of 16
MAX_HIDDEN = 2048
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 B5 and B6 (two GEMMs per chunk, csrc/ce_loss.cu): the rows of
# the kernels' output tile (gemm::BM there: the two must agree), the
# 128x128 output tiles a chunk's second product should give to fill the
# card's 132 SMs about twice, and the most bytes of the bf16 dl scratch
_TILE_ROWS = 128
_WANT_TILES = 256
_SCRATCH_BYTES = 256 * 2 ** 20
# the bf16 B4's vocab tile (gemm::BN there): one split of its scratch each
_VOCAB_TILE = 256

# kernel vs plain version on the card (see :func:`ce_gaps`): ``stats`` for
# loss and lse (fp32 outputs), ``grads`` for dh and dW (in the operands'
# dtype), each (atol as a fraction of the largest |plain| value, rtol,
# share of elements allowed to differ at all). fp32: summation order only.
# bf16 grads: the tensor cores sum in another order than the plain
# version's fp32 GEMMs, which can move the final bf16 rounding of an output
# by one ulp (2**-8 relative; rtol is two ulps), but only where the fp32
# sum lies within that order's error of a rounding boundary, so few
# elements move (at GPT-1.3B's LM head: 1.0% of dh, 3.3% of dW, whose
# sums over 8192 tokens cancel); a fault in dl's rounding moves a small
# amount in most elements, which only the share sees
CE_TOL = {torch.float32: {"stats": (1e-6, 1e-5, 1.0),
                          "grads": (1e-5, 1e-4, 1.0)},
          torch.bfloat16: {"stats": (1e-6, 1e-5, 1.0),
                           "grads": (1e-3, 2.0**-7, 0.1)}}

launches: Dict[str, int] = {name: 0 for name in NAMES}
vp_launches: Dict[str, int] = {name: 0 for name in VP_NAMES}


def ce_gaps(got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype,
            kind: str, scale: Optional[torch.Tensor] = None) -> dict:
    """How far a kernel's output ``got`` lies from its plain version's
    ``want``, for operands of ``dtype`` and outputs of ``kind`` (``stats``
    or ``grads``): ``max_abs_err``, ``tol_ratio`` (the largest |got − want|
    over atol·max(scale) + rtol·scale, ``scale`` = |want| unless given;
    NaN anywhere gives inf), ``moved_share`` (the share of elements that
    differ at all), and ``ok``: ratio <= 1 and share within
    :data:`CE_TOL`. A sum of partial outputs rounded to the operands'
    dtype (B12's dh, summed over the vocab shards) takes ``scale`` = the
    partials' summed magnitudes plus the sum's own: each partial's
    rounding is relative to the partial, and the sum rounds once more."""
    atol_scale, rtol, share = CE_TOL[dtype][kind]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    scale = w.abs() if scale is None else scale.float()
    bound = atol_scale * scale.max() + rtol * scale
    ratio = (diff / bound.clamp_min(1e-30)).max().item()
    ratio = ratio if math.isfinite(ratio) else math.inf
    moved = (diff > 0).float().mean().item()
    return {"max_abs_err": diff.max().item(), "tol_ratio": ratio,
            "moved_share": moved, "ok": ratio <= 1.0 and moved <= share}


def grads_gaps(got: torch.Tensor, want: torch.Tensor, readings,
               scale: Optional[torch.Tensor] = None) -> dict:
    """:func:`ce_gaps` of a bf16 dh or dW (``grads``) made aware of dl's
    rounding flips. A bf16 kernel rounds dl = a·exp(s − lse) + b·onehot
    from an fp32 s a few bits off the plain version's, so where dl lies
    near a rounding boundary it may take the other bf16 neighbour of the
    exact dl: a one-step flip at a large p moves a whole output row by
    the step times |W| (or |h|), which can pass ``CE_TOL``'s atol. An
    element beyond the bound is therefore accepted only where both hold:
    every dl the output's row was multiplied from is a bf16 value within
    one bf16 step of the exact dl, and the element lies within
    ``CE_TOL``'s bound of the fp64 product of that dl. ``readings()``
    gives ``(rows_ok, product)`` (:func:`kernel_readings`) or, for a sum
    of partial outputs (see :func:`ce_gaps`' ``scale``), ``(rows_ok,
    product, product_scale)``; it is called only when some element is
    beyond the bound. A NaN or infinite element is beyond the bound and
    never accepted. The share of elements that move at all stays held to
    ``CE_TOL``, and the tolerance is not widened: a fault in dl's
    rounding, or in the product, still fails.

    Returns :func:`ce_gaps`' fields (``tol_ratio`` the strict one), with
    ``beyond`` (elements past the strict bound), ``accepted`` (those of
    them the flips explain) and ``ok``."""
    gap = ce_gaps(got, want, torch.bfloat16, "grads", scale=scale)
    atol_scale, rtol, share = CE_TOL[torch.bfloat16]["grads"]
    w = want.float()
    ref = w.abs() if scale is None else scale.float()
    # written as "not within" so that a NaN counts as beyond
    beyond = ~((got.float() - w).abs() <= atol_scale * ref.max() + rtol * ref)
    n_beyond = int(beyond.sum().item())
    accepted = 0
    if n_beyond:
        rows_ok, product, *rest = readings()
        ref_p = rest[0] if rest else product.abs()
        prod_bound = atol_scale * ref_p.max() + rtol * ref_p
        near = (got.double() - product).abs() <= prod_bound
        accepted = int((beyond & near & rows_ok[:, None]).sum().item())
    gap.update(beyond=n_beyond, accepted=accepted,
               ok=gap["moved_share"] <= share and accepted == n_beyond)
    return gap


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x| (fp64): 2^(floor(log2|x|) - 7)."""
    _, exp = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), exp - 8)


def _exact_dl(h, w, labels, a, b, lse, lo: int, hi: int) -> torch.Tensor:
    """dl of tokens lo..hi-1 over the whole vocab in fp64 [hi - lo, V]."""
    hd, wd = h[lo:hi].double(), w.double()
    col = torch.arange(w.shape[0], device=h.device)
    onehot = (labels[lo:hi].long()[:, None] == col).double()
    return (a[lo:hi].double()[:, None]
            * torch.exp(hd @ wd.t() - lse[lo:hi].double()[:, None])
            + b[lo:hi].double()[:, None] * onehot)


def _dl_readings(h, w, labels, a, b, lse, dl: torch.Tensor, wrt: str,
                 chunk: int = 1024):
    """What :func:`grads_gaps` needs of the dl [n, V] (tokens by vocab) an
    output was multiplied from: ``rows_ok`` (bool, one per output row: a
    token of dh for ``wrt="h"``, a vocab entry of dW for ``wrt="w"``),
    every dl of the row a bf16 value within one bf16 step of the exact
    dl; and ``product``, the fp64 product of dl with the other operand
    (dl·W or dlᵀ·h). Walks ``chunk`` tokens at a time, so that fp64 [chunk,
    V] blocks are the largest it holds."""
    n, v = dl.shape
    hd, wd = h.double(), w.double()
    ok_tokens = torch.ones(n, dtype=torch.bool, device=h.device)
    ok_vocab = torch.ones(v, dtype=torch.bool, device=h.device)
    product = torch.zeros((n if wrt == "h" else v, h.shape[1]),
                          dtype=torch.float64, device=h.device)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        exact = _exact_dl(h, w, labels, a, b, lse, lo, hi)
        own = dl[lo:hi].double()
        fine = ((own - exact).abs() <= _bf16_step(exact)) & (
            dl[lo:hi].to(torch.bfloat16).double() == own)
        ok_tokens[lo:hi] = fine.all(1)
        ok_vocab &= fine.all(0)
        if wrt == "h":
            product[lo:hi] = own @ wd
        else:
            product += own.t() @ hd[lo:hi]
    return (ok_tokens if wrt == "h" else ok_vocab), product


def fit_vocab_block(v: int, want: int = 512) -> Optional[int]:
    """Largest lane-aligned block dividing ``v`` and ``<= want``: a
    multiple of 128, else 64, else None (copy of the JAX function, :60-72,
    which decides whether the fused path applies)."""
    for bv in range(want - want % 128, 127, -128):
        if v % bv == 0:
            return bv
    if v % 64 == 0:
        return 64
    return None


def _fit_token_block(n: int, want: int = 256) -> Optional[int]:
    """Largest multiple of 8 dividing ``n`` and ``<= want`` (copy of the
    JAX function, :75-79)."""
    for bt in range(want - want % 8, 7, -8):
        if n % bt == 0:
            return bt
    return None


def _mm_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _plan_chunk(n: int, v: int, e: int, wrt: str) -> Tuple[int, int]:
    """The dl scratch of the bf16 B5 (``wrt="h"``) or B6 (``wrt="w"``) for
    n tokens, V vocab entries and hidden size E: (chunk, width). The
    kernels walk the output rows (tokens for dh, vocab entries for dW)
    ``chunk`` at a time, the last chunk ragged; width is the other
    operand's rows (V for dh, n for dW). A chunk is a multiple of the
    128-row tile chosen so that its second product (a [chunk, E] output)
    holds about ``_WANT_TILES`` 128x128 tiles (2048 rows at E 2048), at
    most what keeps the scratch within ``_SCRATCH_BYTES``, and all rows
    where fewer remain. The kernels' TMA loads need 16-byte row strides:
    raises ``ValueError`` unless 8 divides the width and E."""
    if wrt not in ("h", "w"):
        raise ValueError(f"wrt must be 'h' or 'w', got {wrt!r}")
    rows, width = (n, v) if wrt == "h" else (v, n)
    if width % 8 or e % 8:
        raise ValueError(
            f"the bf16 {'dh' if wrt == 'h' else 'dW'} kernel needs 8 | "
            f"{'V' if wrt == 'h' else 'n'} and 8 | E for 16-byte rows, got "
            f"{width} and {e}")
    want = _TILE_ROWS * -(-_WANT_TILES // -(-e // 128))
    room = _SCRATCH_BYTES // (2 * max(width, 1)) // _TILE_ROWS * _TILE_ROWS
    chunk = max(_TILE_ROWS, min(want, room))
    return (max(rows, 1) if chunk >= rows else chunk), width


# ----------------------------------------------------------- plain versions

def _vocab_blocks(v: int):
    block = fit_vocab_block(v)
    if block is None:
        raise ValueError(f"vocab {v} admits no lane-aligned block (need a "
                         "128-multiple <= 512 dividing it, or 64 | v)")
    return [(lo, lo + block) for lo in range(0, v, block)]


def _fwd_plain(h, w, labels, *, rescale: bool = True):
    """Plain B4. The products take operands rounded to the operand dtype
    in fp32 (exact products, fp32 sums: a bf16 product with fp32
    accumulation). ``rescale=False`` leaves the running sum unscaled when
    the running max moves: a planted fault for the card's checks."""
    mm = _mm_dtype(h.dtype)
    hm = h.to(mm).float()
    n = h.shape[0]
    m = torch.full((n,), -1e30, dtype=torch.float32, device=h.device)
    l = torch.zeros(n, dtype=torch.float32, device=h.device)
    lab = torch.zeros(n, dtype=torch.float32, device=h.device)
    labels = labels.long()
    for lo, hi in _vocab_blocks(w.shape[0]):
        s = hm @ w[lo:hi].to(mm).float().t()
        m_new = torch.maximum(m, s.amax(-1))
        scale = torch.exp(m - m_new) if rescale else 1.0
        l = l * scale + torch.exp(s - m_new[:, None]).sum(-1)
        m = m_new
        col = torch.arange(lo, hi, device=h.device)
        lab = lab + torch.where(labels[:, None] == col, s, 0.0).sum(-1)
    lse = m + torch.log(l)
    return lse - lab, lse


def _dl_block(hm, wm, labels, a, b, lse, lo: int, hi: int) -> torch.Tensor:
    """fp32 dl = a·exp(s − lse) + b·onehot of vocab columns lo..hi-1, s
    from the operands ``hm`` [n, E] and ``wm`` [hi - lo, E] (fp32 copies
    of the rounded operands)."""
    p = torch.exp(hm @ wm.t() - lse[:, None])
    col = torch.arange(lo, hi, device=hm.device)
    return a[:, None] * p + b[:, None] * (labels.long()[:, None] == col).float()


def _grad_plain(h, w, labels, a, b, lse, *, wrt: str, dl_dtype=None):
    """Plain B5 (``wrt="h"``) or B6 (``wrt="w"``). dl is rounded to
    ``dl_dtype`` before its product, the operand dtype unless a planted
    fault of the card's checks names another."""
    mm = _mm_dtype(h.dtype)
    dl_dtype = dl_dtype or mm
    hm = h.to(mm).float()
    out = torch.zeros(h.shape if wrt == "h" else w.shape,
                      dtype=torch.float32, device=h.device)
    for lo, hi in _vocab_blocks(w.shape[0]):
        wm = w[lo:hi].to(mm).float()
        dl = _dl_block(hm, wm, labels, a, b, lse, lo, hi)
        dl = dl.to(dl_dtype).float()
        if wrt == "h":
            out += dl @ wm
        else:
            out[lo:hi] = dl.t() @ hm
    return out.to(h.dtype if wrt == "h" else w.dtype)


def fused_ce_fwd_ref(h, w, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fused_ce_fwd`: ``(loss, lse)``, fp32 [n].
    Per vocab block: m_new = max(m, max s), l = l·exp(m − m_new) +
    Σ exp(s − m_new), label logit += Σ where(label == col, s, 0)."""
    return _fwd_plain(h, w, labels)


def fused_ce_dh_ref(h, w, labels, a, b, lse) -> torch.Tensor:
    """Plain version of :func:`fused_ce_dh`: dh [n, E] in h's dtype."""
    return _grad_plain(h, w, labels, a, b, lse, wrt="h")


def fused_ce_dw_ref(h, w, labels, a, b, lse) -> torch.Tensor:
    """Plain version of :func:`fused_ce_dw`: dW [V, E] in W's dtype."""
    return _grad_plain(h, w, labels, a, b, lse, wrt="w")


def vp_stats_ref(h, w, l_loc) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`vp_stats`' forward: the shard's per-token
    ``(lse_loc, lab_loc)``, fp32 [n], lab_loc = lse − loss (0 for a label
    off the shard). Its backward's plain versions are
    :func:`fused_ce_dh_ref` and :func:`fused_ce_dw_ref` with the
    cotangents as (a, b)."""
    loss, lse = fused_ce_fwd_ref(h, w, l_loc)
    return lse, lse - loss


# ------------------------------------------------------------ the kernels

class _CEParams(ctypes.Structure):
    """Mirror of ``CEParams`` in ``csrc/ce_loss.cu``."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "h", "w", "labels", "a", "b", "lse", "loss", "grad", "partial",
        "scratch")]
        + [(name, ctypes.c_int) for name in (
            "n", "vocab", "hidden", "splits", "chunk")])


def _lib():
    lib = _build.load(KERNEL)
    if lib.ce_fwd.argtypes is None:
        for name in NAMES:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(_CEParams), ctypes.c_int,
                           ctypes.c_void_p]
        lib.ce_fwd_splits.restype = ctypes.c_int
        lib.ce_fwd_splits.argtypes = [ctypes.c_int] * 3
        lib.ce_params_size.restype = ctypes.c_int
        if lib.ce_params_size() != ctypes.sizeof(_CEParams):
            raise RuntimeError(
                f"CEParams is {lib.ce_params_size()} bytes in the library, "
                f"{ctypes.sizeof(_CEParams)} in the wrapper")
    return lib


def _launch(name: str, h, w, labels, **tensors) -> None:
    """Fill the kernel's parameter block and launch ``name`` on h's device
    and current stream; raises on a CUDA error."""
    prm = _CEParams()
    for field, t in dict(h=h, w=w, labels=labels, **tensors).items():
        setattr(prm, field, None if t is None else t.data_ptr())
    prm.n, prm.hidden = h.shape
    prm.vocab = w.shape[0]
    partial, scratch = tensors.get("partial"), tensors.get("scratch")
    prm.splits = 0 if partial is None else partial.shape[1]
    prm.chunk = 0 if scratch is None else scratch.shape[0]
    with torch.cuda.device(h.device):
        err = getattr(_lib(), name)(
            ctypes.byref(prm), _DTYPE_CODES[h.dtype],
            torch.cuda.current_stream(h.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[name] += 1


def _check(h, w, labels, *rows) -> None:
    """Shapes, dtypes and devices every entry takes: h [n, E] and W [V, E]
    of one dtype (bf16 or fp32), int32 labels [n], fp32 [n] row vectors;
    on the card also contiguity, 16-byte alignment, E a multiple of 16
    (in fp32 up to MAX_HIDDEN)."""
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"h must be [n, E] and W [V, E], got "
                         f"{tuple(h.shape)} and {tuple(w.shape)}")
    n, e = h.shape
    if h.dtype not in _DTYPE_CODES or w.dtype != h.dtype:
        raise ValueError(f"h and W must share one dtype, bf16 or fp32; got "
                         f"{h.dtype} and {w.dtype}")
    if labels.dtype != torch.int32 or tuple(labels.shape) != (n,):
        raise ValueError(f"labels must be int32 [n={n}], got {labels.dtype} "
                         f"{tuple(labels.shape)}")
    for name, t in (("W", w), ("labels", labels)) + rows:
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
    for name, t in rows:
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be fp32 [n={n}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if h.device.type == "cpu":
        return
    if e % 16 or (h.dtype == torch.float32 and e > MAX_HIDDEN):
        raise ValueError(f"the kernels take a hidden size that is a "
                         f"multiple of 16 (in fp32 up to {MAX_HIDDEN}), got "
                         f"{e}")
    for name, t in (("h", h), ("W", w), ("labels", labels)) + rows:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _scratch(h, w, wrt: str) -> Optional[torch.Tensor]:
    """The bf16 dl scratch of one chunk of B5 (``wrt="h"``) or B6, shaped
    by :func:`_plan_chunk` (its rows are the chunk); None in fp32."""
    if h.dtype != torch.bfloat16:
        return None
    return torch.empty(_plan_chunk(h.shape[0], w.shape[0], h.shape[1], wrt),
                       dtype=torch.bfloat16, device=h.device)


def _fwd_splits(n: int, v: int, dtype: torch.dtype) -> int:
    """The vocab splits of B4's scratch ``partial`` [3, splits, n] (fp32:
    per split, each token's max, sum and label logit). In bf16 one per
    256-column tile of ``ce_stats_kernel``: 197 at the 1.3B head's vocab
    of 50304 (19.4 MB at 8192 tokens), 99 at its mp 2 shard of 25152; in
    fp32 the library's count, which depends on the card's SM count. The
    library refuses a count it did not plan."""
    if dtype == torch.bfloat16:
        return -(-v // _VOCAB_TILE)
    return _lib().ce_fwd_splits(n, v, _DTYPE_CODES[dtype])


def fused_ce_fwd(h, w, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4: ``(loss, lse)``, fp32 [n]. CUDA tensors launch ``ce_fwd``; CPU
    tensors take :func:`fused_ce_fwd_ref`."""
    _check(h, w, labels)
    if h.device.type == "cpu":
        return fused_ce_fwd_ref(h, w, labels)
    n = h.shape[0]
    loss = torch.empty(n, dtype=torch.float32, device=h.device)
    lse = torch.empty(n, dtype=torch.float32, device=h.device)
    partial = torch.empty((3, _fwd_splits(n, w.shape[0], h.dtype), n),
                          dtype=torch.float32, device=h.device)
    _launch("ce_fwd", h, w, labels, loss=loss, lse=lse, partial=partial)
    return loss, lse


def fused_ce_dh(h, w, labels, a, b, lse) -> torch.Tensor:
    """B5: dh [n, E] in h's dtype for the cotangent dl = a·softmax +
    b·onehot. CUDA tensors launch ``ce_dh``; CPU tensors take
    :func:`fused_ce_dh_ref`."""
    _check(h, w, labels, ("a", a), ("b", b), ("lse", lse))
    if h.device.type == "cpu":
        return fused_ce_dh_ref(h, w, labels, a, b, lse)
    dh = torch.empty(h.shape, dtype=h.dtype, device=h.device)
    _launch("ce_dh", h, w, labels, a=a, b=b, lse=lse, grad=dh,
            scratch=_scratch(h, w, "h"))
    return dh


def fused_ce_dw(h, w, labels, a, b, lse) -> torch.Tensor:
    """B6: dW [V, E] in W's dtype for the same cotangent. CUDA tensors
    launch ``ce_dw``; CPU tensors take :func:`fused_ce_dw_ref`."""
    _check(h, w, labels, ("a", a), ("b", b), ("lse", lse))
    if h.device.type == "cpu":
        return fused_ce_dw_ref(h, w, labels, a, b, lse)
    dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    _launch("ce_dw", h, w, labels, a=a, b=b, lse=lse, grad=dw,
            scratch=_scratch(h, w, "w"))
    return dw


def _one_chunk(h, w, labels, a, b, lse, wrt: str):
    """The bf16 B5 (``wrt="h"``) or B6 (``wrt="w"``) over one chunk of all
    output rows, its launch not counted: ``(output, dl)``, dl [n, V]
    (tokens by vocab, bf16) read from the scratch. Each dl element comes
    from the same sums at any chunking."""
    _check(h, w, labels, ("a", a), ("b", b), ("lse", lse))
    rows, width = ((h.shape[0], w.shape[0]) if wrt == "h"
                   else (w.shape[0], h.shape[0]))
    scratch = torch.empty((rows, width), dtype=torch.bfloat16,
                          device=h.device)
    grad = torch.empty(h.shape if wrt == "h" else w.shape, dtype=h.dtype,
                       device=h.device)
    counts = dict(launches)
    _launch("ce_dh" if wrt == "h" else "ce_dw", h, w, labels, a=a, b=b,
            lse=lse, grad=grad, scratch=scratch)
    launches.update(counts)
    return grad, (scratch if wrt == "h" else scratch.t())


def kernel_readings(h, w, labels, a, b, lse, wrt: str):
    """The readings :func:`grads_gaps` takes of the bf16 B5 (``wrt="h"``)
    or B6 (``wrt="w"``) on these inputs (:func:`_dl_readings` of the dl
    [n, V] the kernel multiplies, read from its scratch by a second call
    over one chunk; the launch counts are left as they were)."""
    dl = _one_chunk(h, w, labels, a, b, lse, wrt)[1]
    return _dl_readings(h, w, labels, a, b, lse, dl, wrt)


def fp64_checks(h, w, labels, a, b, lse, wrt):
    """The bf16 B5 (``wrt="h"``) or B6 (``wrt="w"``) against fp64 products,
    with the kernel's own dl, read as :func:`kernel_readings` reads it.
    Returns, with the output
    ``got``:

    - ``dl_steps``: the largest |dl_kernel − dl| over the bf16 spacing at
      |dl|, dl = a·exp(s − lse) + b·onehot in fp64 (<= 1: the kernel
      rounds dl to one of its two bf16 neighbours);
    - ``dl_flips``: the elements where dl_kernel is not dl rounded to
      nearest (an fp32 s a few bits off the fp64 s rounds the other way);
    - ``product_ratio``: the largest |got − P(dl_kernel)| over CE_TOL's
      bound (atol of the largest |value|, rtol of each), P the fp64
      product with the other operand (<= 1: the product sums in fp32 and
      rounds once);
    - ``beyond``, ``beyond_outside_flips``: the elements where the kernel
      lies farther from P(dl rounded to nearest) than the plain version's
      error plus CE_TOL's bound, and those of them in an output row (a
      token of dh, a vocab entry of dW) with no flip of dl_kernel;
    - ``whole_gap``: the kernel's largest error over the plain version's
      largest plus CE_TOL's bound at the largest |value| (<= 1);
    - ``same_at_one_chunk``: the one-chunk call's output equals ``got``;
    - ``vs_plain``: :func:`grads_gaps` of the kernel against its plain
      version, its dl the kernel's."""
    fn, plain = ((fused_ce_dh, fused_ce_dh_ref) if wrt == "h"
                 else (fused_ce_dw, fused_ce_dw_ref))
    got = fn(h, w, labels, a, b, lse)
    want = plain(h, w, labels, a, b, lse)
    again, dl_own = _one_chunk(h, w, labels, a, b, lse, wrt)
    dl_k = dl_own.double()
    dl = _exact_dl(h, w, labels, a, b, lse, 0, h.shape[0])
    dl_near = dl.to(torch.bfloat16).double()
    flips = dl_k != dl_near
    hd, wd = h.double(), w.double()

    def product(d):
        return d @ wd if wrt == "h" else d.t() @ hd

    atol, rtol, _ = CE_TOL[torch.bfloat16]["grads"]
    ref_k = product(dl_k)
    bound_k = atol * ref_k.abs().max() + rtol * ref_k.abs()
    ref = product(dl_near)
    kernel_err = (got.double() - ref).abs()
    plain_err = (want.double() - ref).abs()
    top = ref.abs().max()
    beyond = kernel_err > plain_err + atol * top + rtol * ref.abs()
    flip_rows = flips.any(1) if wrt == "h" else flips.any(0)
    return {
        "got": got,
        "same_at_one_chunk": bool(torch.equal(again, got)),
        "dl_steps": ((dl_k - dl).abs() / _bf16_step(dl)).max().item(),
        "dl_flips": int(flips.sum().item()),
        "product_ratio": ((got.double() - ref_k).abs() / bound_k).max().item(),
        "beyond": int(beyond.sum().item()),
        "beyond_outside_flips": int((beyond & ~flip_rows[:, None]).sum()
                                    .item()),
        "whole_gap": (kernel_err.max() / (plain_err.max()
                                          + (atol + rtol) * top)).item(),
        "vs_plain": grads_gaps(got, want, lambda: _dl_readings(
            h, w, labels, a, b, lse, dl_own, wrt)),
    }


class _FusedLinearCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, labels):
        loss, lse = fused_ce_fwd(h, w, labels)
        ctx.save_for_backward(h, w, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        g = g.float().contiguous()
        neg = -g
        dh = fused_ce_dh(h, w, labels, g, neg, lse)
        dw = fused_ce_dw(h, w, labels, g, neg, lse)
        return dh, dw, None


class _VPStats(torch.autograd.Function):
    """B12's stats entry (JAX ``_vp_stats``, :298-323)."""

    @staticmethod
    def forward(ctx, h, w, l_loc):
        with _counting("vp_ce_fwd", "ce_fwd"):
            loss, lse = fused_ce_fwd(h, w, l_loc)
        ctx.save_for_backward(h, w, l_loc, lse)
        return lse, lse - loss

    @staticmethod
    def backward(ctx, ca, cb):
        h, w, l_loc, lse = ctx.saved_tensors
        a, b = ((torch.zeros_like(lse) if c is None else c.float().contiguous())
                for c in (ca, cb))
        with _counting("vp_ce_dh", "ce_dh"):
            dh = fused_ce_dh(h, w, l_loc, a, b, lse)
        with _counting("vp_ce_dw", "ce_dw"):
            dw = fused_ce_dw(h, w, l_loc, a, b, lse)
        return dh, dw, None


@contextlib.contextmanager
def _counting(entry: str, kernel: str):
    """Count one launch of B12's ``entry`` if the call inside launched
    ``kernel`` (a plain version, on CPU tensors or swapped in, launches
    nothing and counts nothing)."""
    before = launches[kernel]
    yield
    if launches[kernel] > before:
        vp_launches[entry] += 1


def vp_stats(h: torch.Tensor, w: torch.Tensor, l_loc: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B12: the per-token ``(lse_loc, lab_loc)`` (fp32 [n]) of ``h`` [n, E]
    over the vocab shard ``w`` [V_loc, E] for shard-local int32 labels
    ``l_loc`` (−1 off the shard), differentiable in h and w: the forward
    launches B4, the backward B5 and B6 with the cotangents of (lse_loc,
    lab_loc) as (a, b). CPU tensors take the plain versions."""
    return _VPStats.apply(h.contiguous(), w.contiguous(),
                          l_loc.to(torch.int32).contiguous())


def fused_linear_ce(hidden: torch.Tensor, emb: torch.Tensor,
                    labels: torch.Tensor, mp_group=None,
                    sequence_parallel: bool = False) -> torch.Tensor:
    """Per-token cross-entropy [n] (fp32) of ``logits = hidden @ embᵀ``
    without storing the logits: ``hidden`` [n, E] and ``emb`` [V, E] of
    one dtype, integer ``labels`` [n]. Differentiable in hidden and emb;
    the forward launches B4, the backward B5 and B6 (plain versions on CPU
    tensors). Raises ``ValueError`` when the vocab admits no lane-aligned
    block (:func:`fit_vocab_block`) or 8 does not divide n, as the JAX
    entry does.

    With an ``mp_group`` of more than one rank, ``emb`` is this rank's
    vocab shard (rank r holds global rows r·V_loc ... (r + 1)·V_loc − 1)
    and ``labels`` are global: B12 (:func:`vp_stats` on the shard, the
    shards combined over the group); ``hidden``, replicated, passes
    ``copy_to_mp``, so that dh is summed over the shards, and dW is this
    rank's shard's. Under ``sequence_parallel`` the hidden states come from
    the sequence all-gather, whose backward sums dh over the group, so
    they pass as they are."""
    n, v = hidden.shape[0], emb.shape[0]
    if fit_vocab_block(v) is None:
        raise ValueError(
            f"fused_linear_ce: vocab {'shard ' if mp_group else ''}{v} "
            "admits no lane-aligned block (need a 128-multiple <= 512 "
            "dividing it, or 64 | v)")
    if _fit_token_block(n) is None:
        raise ValueError(f"fused_linear_ce: 8 must divide tokens {n}")
    if mp_group is None:
        return _FusedLinearCE.apply(hidden.contiguous(), emb.contiguous(),
                                    labels.to(torch.int32).contiguous())
    l_loc = local_labels(labels, v, dist.get_rank(mp_group))
    if not sequence_parallel:
        hidden = copy_to_mp(hidden, mp_group)
    lse_loc, lab_loc = vp_stats(hidden, emb, l_loc)
    return vocab_parallel_combine(lse_loc, lab_loc, mp_group)
