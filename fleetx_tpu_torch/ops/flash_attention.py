"""Flash attention for training: the CUDA kernels and their plain versions.

Port of the JAX package's ``flash_attention`` (ops/pallas/flash_attention.py:
954) and its custom VJP (``_flash``, :668-786). Three kernels in
``csrc/flash_attention.cu``:

- ``flash_fwd`` (B1, ``_fwd_kernel`` :287): out and the fp32 log-sum-exp;
- ``flash_bwd_dq`` (B2, ``_bwd_dq_kernel`` :397): dQ from lse and delta;
- ``flash_bwd_dkv`` (B3, ``_bwd_dkv_kernel`` :502): dK and dV.

At bf16 and head dim 64 or 128 (the training paths') all three are TMA +
wgmma kernels, whose operands must lie on 16 bytes (:func:`_check_tma`);
fp32, and bf16 at head dim 16 or 32, run CUDA-core kernels.

Each kernel and plain version takes a ``meta`` of global ids, ``(b0, h0,
h_local, h_total, q_off, k_off)`` (``_global_ids``, :273-284): the batch and
head offsets of the call's rows, their local and total head counts, and the
global positions of query and key row 0. The causal test, the skipping of
wholly masked tiles, ``kv_lens`` (a global key count) and the dropout hash
read global ids and positions; the identity meta ``(0, 0, h, h, 0, 0)``
(``meta=None``) leaves every call as it was, bit for bit. The ring-CP pair
entries :func:`block_fwd_lse`, :func:`block_dq` and :func:`block_dkv` (B11,
:820-863) run B1-B3 on one (q block, kv block) pair with such a meta, a
global ``kv_len`` and lse/delta in the ``[b, s, h]`` layout.

:func:`flash_attention` is a ``torch.autograd.Function`` whose forward
launches B1 and whose backward computes ``delta = rowsum(dO∘O)`` in fp32
(outside the kernels, as at :769-770) and launches B2 and B3. Each of
:func:`flash_fwd`, :func:`flash_bwd_dq` and :func:`flash_bwd_dkv` launches
its kernel on CUDA tensors (or raises) and runs its plain version
(``*_ref``) on CPU tensors. ``launches`` counts kernel launches by name,
never plain-version calls.

The plain versions repeat the kernels' casts and take the forward's p
against the running max after each ``TILE``-wide key tile, as the kernel
does, so kernel and plain agree within ``FLASH_TOL`` on the card; the
Pallas kernel uses its own tile (``fit_blocks``: 512 at s=1024), which
moves bf16 roundings of p, so against it the bf16 tolerance is looser.
The backward regenerates p = exp(s - lse) and does not depend on the
tile width.

Dropout scales the value path only (the normaliser sums the undropped p)
with the lowbias32 keep mask of :func:`dropout_keep_scale`, keyed on the
global (b·h, q, k) and an explicit int32 ``seed``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fleetx_tpu_torch.ops import _build

__all__ = ["KERNEL", "NAMES", "BLOCK_NAMES", "TILE", "FLASH_TOL",
           "launches", "block_launches", "dropout_keep_scale",
           "identity_meta", "flash_attention", "flash_fwd", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_attention_fwd_ref", "flash_bwd_dq_ref",
           "flash_bwd_dkv_ref", "block_fwd_lse", "block_dq", "block_dkv"]

KERNEL = "flash_attention"  # csrc/flash_attention.cu
NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
BLOCK_NAMES = ("block_fwd_lse", "block_dq", "block_dkv")  # B11's entries
TILE = 64  # the kernels' q and k tile rows; sequences are multiples of it
NEG_INF = -1e30  # the TPU kernels' masked score
HEAD_DIMS = (16, 32, 64, 128)
TMA_DIMS = (64, 128)  # head dims of the bf16 TMA + wgmma kernels
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel vs plain version on the card, |got - want| <= atol + rtol*|want|
# as (atol, rtol) by dtype. fp32: summation order only. bf16: the tensor
# cores sum in another order than the plain version's fp32 GEMMs, which
# can move the final rounding of an output, or of a p or dS before a
# product, by one bf16 ulp (2**-8 relative): rtol is two ulps
FLASH_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-2, 2.0**-7)}

launches: Dict[str, int] = {name: 0 for name in NAMES}
# launches made through B11's entries (each also counts in ``launches``
# under the kernel it runs)
block_launches: Dict[str, int] = {name: 0 for name in BLOCK_NAMES}

# lowbias32 mixing constants as wrapped int32 (the JAX module's _MIX1.._C3)
_MIX1 = int(np.int32(np.uint32(0x7FEB352D)))
_MIX2 = int(np.int32(np.uint32(0x846CA68B)))
_C1 = int(np.int32(np.uint32(0x9E3779B1)))
_C2 = int(np.int32(np.uint32(0x85EBCA77)))
_C3 = int(np.int32(np.uint32(0xC2B2AE3D)))


def wrap_int32(x: int) -> int:
    """``x`` wrapped into the int32 range (as a uint32 → int32 cast)."""
    return (int(x) + (1 << 31)) % (1 << 32) - (1 << 31)


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 ``x``: torch's ``>>`` is arithmetic,
    so the sign bits it shifts in are masked off."""
    return (x >> n) & ((1 << (32 - n)) - 1)


def _keep_threshold(rate: float) -> int:
    return int(rate * (1 << 31))


def _keep_value(rate: float) -> float:
    """1/(1-rate) as the JAX function computes it: a float32 division."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def dropout_keep_scale(seed, bh, q_pos, k_pos, rate: float) -> torch.Tensor:
    """Deterministic dropout scale in {0, 1/(1-rate)} (float32) for each
    (q, k) cell: the lowbias32 hash of (seed, bh, q_pos, k_pos) in int32
    arithmetic (multiplies and adds wrap, shifts are logical), kept iff its
    low 31 bits are ``>= int(rate * 2**31)``. Arguments are ints or int32
    tensors that broadcast; the result is on their device."""
    def i32(x):
        return x.to(torch.int32) if isinstance(x, torch.Tensor) \
            else wrap_int32(x)

    def mul(a, c):  # int32 multiply, wrapping
        return a * c if isinstance(a, torch.Tensor) else wrap_int32(a * c)

    def add(a, b):  # int32 add, wrapping (python ints fold on the host)
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            return a + b
        return wrap_int32(a + b)

    q, k, b, s = i32(q_pos), i32(k_pos), i32(bh), i32(seed)
    x = add(add(mul(q, _C1), add(mul(b, _C3), s)), mul(k, _C2))
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=torch.int32)
    x = x ^ _shr(x, 16)
    x = x * _MIX1
    x = x ^ _shr(x, 15)
    x = x * _MIX2
    x = x ^ _shr(x, 16)
    keep = (x & 0x7FFFFFFF) >= _keep_threshold(rate)
    return torch.where(keep, _keep_value(rate), 0.0).to(torch.float32)


# ----------------------------------------------------------- plain versions

def _to_bh(x: torch.Tensor) -> torch.Tensor:
    """[b, s, h, d] -> fp32 [b, h, s, d]."""
    return x.float().transpose(1, 2)


def _from_bh(x: torch.Tensor, dtype) -> torch.Tensor:
    """[b, h, s, d] -> [b, s, h, d] in ``dtype``, contiguous."""
    return x.transpose(1, 2).to(dtype).contiguous()


def identity_meta(h: int) -> Tuple[int, ...]:
    """The meta of an unsharded call: global ids are local, offsets 0."""
    return (0, 0, h, h, 0, 0)


def _meta(meta, h: int) -> Tuple[int, ...]:
    """``meta`` as six ints (the identity when None), checked."""
    if meta is None:
        return identity_meta(h)
    meta = tuple(int(x) for x in meta)
    if len(meta) != 6 or meta[2] != h or meta[3] < h or min(meta) < 0:
        raise ValueError(f"meta must be (b0, h0, h_local={h}, h_total >= "
                         f"{h}, q_off, k_off), non-negative; got {meta}")
    return meta


def _live(b: int, s: int, causal: bool, kv_lens, device,
          meta) -> torch.Tensor:
    """Bool [b, 1, s, s]: key k is live for query q (``kv_lens`` a global
    key count, the causal test on global positions)."""
    q_off, k_off = meta[4], meta[5]
    pos = torch.arange(s, device=device)
    lens = (torch.full((b,), s, device=device) if kv_lens is None
            else (kv_lens.to(device).long() - k_off).clamp(0, s))
    live = (pos[None, None, :] < lens[:, None, None])[:, None]  # [b,1,1,s]
    if causal:
        live = live & (pos[None, :] <= pos[:, None] + (q_off - k_off))[
            None, None]
    return live.expand(b, 1, s, s)


def _keep(seed: int, rate: float, b: int, h: int, s: int, device, meta):
    """fp32 [b, h, s, s] dropout keep scale on the global (b·h, q, k)."""
    b0, h0, h_local, h_total, q_off, k_off = meta
    bh = torch.arange(b * h, device=device, dtype=torch.int32)
    bh = (b0 + bh // h_local) * h_total + h0 + bh % h_local
    pos = torch.arange(s, device=device, dtype=torch.int32)
    keep = dropout_keep_scale(seed, bh[:, None, None],
                              (q_off + pos)[None, :, None],
                              (k_off + pos)[None, None, :], rate)
    return keep.view(b, h, s, s)


def _scores(q, k, live):
    """fp32 scores (q·kᵀ)·scale [b, h, s, s], masked to NEG_INF."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(_to_bh(q), _to_bh(k).transpose(-1, -2)) * scale
    return torch.where(live, s, NEG_INF)


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True, kv_lens=None,
                            dropout_rate: float = 0.0, seed: int = 0,
                            meta=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_fwd`: ``(out [b, s, h, d] in q's
    dtype, lse [b*h, s] fp32)``. p is taken against the running max after
    each ``TILE``-wide key tile and rounded to the operand dtype (after
    dropout) before the value product; l sums the undropped p."""
    b, s, h, d = q.shape
    meta = _meta(meta, h)
    live = _live(b, s, causal, kv_lens, q.device, meta)
    sc = _scores(q, k, live)
    nt = s // TILE
    tile_max = sc.view(b, h, s, nt, TILE).amax(-1)
    run_max = torch.cummax(tile_max, -1).values  # [b, h, s, nt]
    p = torch.exp(sc - run_max.repeat_interleave(TILE, -1))
    p = torch.where(live, p, 0.0)
    # each tile's terms move from its running max to the final one
    rescale = torch.exp(run_max - run_max[..., -1:]).repeat_interleave(
        TILE, -1)
    l = (p * rescale).sum(-1, keepdim=True)
    if dropout_rate > 0.0:
        p = p * _keep(seed, dropout_rate, b, h, s, q.device, meta)
    p = p.to(q.dtype).float() * rescale
    l_safe = torch.where(l > 0, l, 1.0)  # fully masked rows emit zeros
    out = torch.matmul(p, _to_bh(v)) / l_safe
    lse = run_max[..., -1] + torch.log(l_safe[..., 0])
    return _from_bh(out, q.dtype), lse.reshape(b * h, s).contiguous()


def _probs_and_dp(q, k, v, do, lse, *, causal, kv_lens, dropout_rate, seed,
                  meta):
    """(p, dP, keep): p = exp(s - lse) with masked cells 0, dP = dO·Vᵀ
    (times the keep mask under dropout), all fp32 [b, h, s, s]."""
    b, s, h, _ = q.shape
    meta = _meta(meta, h)
    live = _live(b, s, causal, kv_lens, q.device, meta)
    sc = _scores(q, k, live)
    p = torch.where(live, torch.exp(sc - lse.view(b, h, s, 1)), 0.0)
    dp = torch.matmul(_to_bh(do), _to_bh(v).transpose(-1, -2))
    keep = None
    if dropout_rate > 0.0:
        keep = _keep(seed, dropout_rate, b, h, s, q.device, meta)
        dp = dp * keep
    return p, dp, keep


def flash_bwd_dq_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                     kv_lens=None, dropout_rate: float = 0.0, seed: int = 0,
                     meta=None) -> torch.Tensor:
    """Plain version of :func:`flash_bwd_dq`: dQ [b, s, h, d] in q's
    dtype. dS = p∘(dP − delta) is rounded to the operand dtype before
    dS·K, and the scale lands on the fp32 sum."""
    b, s, h, d = q.shape
    p, dp, _ = _probs_and_dp(q, k, v, do, lse, causal=causal,
                             kv_lens=kv_lens, dropout_rate=dropout_rate,
                             seed=seed, meta=meta)
    ds = (p * (dp - delta.view(b, h, s, 1))).to(q.dtype).float()
    dq = torch.matmul(ds, _to_bh(k)) * (1.0 / math.sqrt(d))
    return _from_bh(dq, q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                      kv_lens=None, dropout_rate: float = 0.0, seed: int = 0,
                      meta=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_bwd_dkv`: ``(dK, dV)`` [b, s, h, d].
    dV takes p∘keep, dS the undropped p; both are rounded to the operand
    dtype before their products."""
    b, s, h, d = q.shape
    p, dp, keep = _probs_and_dp(q, k, v, do, lse, causal=causal,
                                kv_lens=kv_lens, dropout_rate=dropout_rate,
                                seed=seed, meta=meta)
    p_v = p if keep is None else p * keep
    dv = torch.matmul(p_v.to(q.dtype).float().transpose(-1, -2), _to_bh(do))
    ds = (p * (dp - delta.view(b, h, s, 1))).to(q.dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), _to_bh(q)) * (1.0 / math.sqrt(d))
    return _from_bh(dk, k.dtype), _from_bh(dv, v.dtype)


# ------------------------------------------------------------ the kernels

class _FlashParams(ctypes.Structure):
    """Mirror of ``FlashParams`` in ``csrc/flash_attention.cu``."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "q", "k", "v", "dout", "out", "dq", "dk", "dv", "lse", "delta",
        "kv_lens")]
        + [(name, ctypes.c_longlong * 3) for name in (
            "q_strides", "k_strides", "v_strides", "do_strides")]
        + [("batch", ctypes.c_int), ("heads", ctypes.c_int),
           ("seq", ctypes.c_int), ("causal", ctypes.c_int),
           ("scale", ctypes.c_float), ("dropout", ctypes.c_int),
           ("threshold", ctypes.c_uint), ("keep_scale", ctypes.c_float),
           ("seed", ctypes.c_int)]
        + [(name, ctypes.c_int) for name in (
            "b0", "h0", "h_local", "h_total", "q_off", "k_off", "pad_")])


def _lib():
    lib = _build.load(KERNEL)
    if lib.flash_fwd.argtypes is None:
        for name in NAMES:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(_FlashParams), ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
        lib.flash_params_size.restype = ctypes.c_int
        if lib.flash_params_size() != ctypes.sizeof(_FlashParams):
            raise RuntimeError(
                f"FlashParams is {lib.flash_params_size()} bytes in the "
                f"library, {ctypes.sizeof(_FlashParams)} in the wrapper")
    return lib


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))


def _launch(name: str, q, k, v, *, causal, kv_lens, dropout_rate, seed,
            meta, **tensors) -> None:
    """Fill the kernel's parameter block from the tensors and launch
    ``name`` on q's device and current stream; raises on a CUDA error."""
    b, s, h, d = q.shape
    prm = _FlashParams()
    for field, t in dict(q=q, k=k, v=v, kv_lens=kv_lens, **tensors).items():
        setattr(prm, field, None if t is None else t.data_ptr())
    prm.q_strides, prm.k_strides = _strides(q), _strides(k)
    prm.v_strides = _strides(v)
    if tensors.get("dout") is not None:
        prm.do_strides = _strides(tensors["dout"])
    prm.batch, prm.heads, prm.seq, prm.causal = b, h, s, int(bool(causal))
    prm.scale = 1.0 / math.sqrt(d)
    prm.dropout = int(dropout_rate > 0.0)
    if dropout_rate > 0.0:
        prm.threshold = _keep_threshold(dropout_rate)
        prm.keep_scale = _keep_value(dropout_rate)
    prm.seed = wrap_int32(seed)
    (prm.b0, prm.h0, prm.h_local, prm.h_total, prm.q_off,
     prm.k_off) = _meta(meta, h)
    fn = getattr(_lib(), name)
    with torch.cuda.device(q.device):
        err = fn(ctypes.byref(prm), _DTYPE_CODES[q.dtype], d,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[name] += 1


def _check(q, k, v, kv_lens, *others):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [b, s, h, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"the kernels take bf16 or fp32 q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if s % TILE:
        raise ValueError(f"sequence length {s} must be a multiple of the "
                         f"{TILE}-row tile (causal_attention pads)")
    for name, t in (("q", q), ("k", k), ("v", v)) + others:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dim() == 4 and t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    if kv_lens is not None:
        if kv_lens.dtype != torch.int32 or tuple(kv_lens.shape) != (b,):
            raise ValueError(f"kv_lens must be int32 [b={b}], got "
                             f"{kv_lens.dtype} {tuple(kv_lens.shape)}")
        if kv_lens.device != q.device:
            raise ValueError(f"kv_lens is on {kv_lens.device}, q on "
                             f"{q.device}")


def _tma(q: torch.Tensor) -> bool:
    """Whether a call on q runs the TMA + wgmma kernels."""
    return q.is_cuda and q.dtype == torch.bfloat16 and q.shape[-1] in TMA_DIMS


def _check_tma(*named) -> None:
    """The bf16 kernels at d 64 and 128 load their operands by TMA (and
    dK/dV its lse and delta rows by bulk copies), which take a base and
    strides (over the dimensions of more than one row, all but the last)
    on 16 bytes: raises ``ValueError`` for any other view (no other kernel
    takes it instead)."""
    for name, t in named:
        strides = [st for st, n in zip(t.stride()[:-1], t.shape[:-1])
                   if n > 1]
        if t.data_ptr() % 16 or any(st * t.element_size() % 16
                                    for st in strides):
            raise ValueError(
                f"{name}: the bf16 kernels at head_dim {TMA_DIMS} load by "
                f"TMA and need a 16-byte aligned base and strides, got "
                f"data_ptr % 16 = {t.data_ptr() % 16}, strides "
                f"{tuple(t.stride())}")


def flash_fwd(q, k, v, *, causal: bool = True, kv_lens=None,
              dropout_rate: float = 0.0, seed: int = 0, meta=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1: ``(out [b, s, h, d], lse [b*h, s] fp32)``. CUDA tensors launch
    ``flash_fwd`` (at bf16, d 64 and 128, the TMA + wgmma kernel, whose
    operands must lie on 16 bytes: see :func:`_check_tma`); CPU tensors
    take :func:`flash_attention_fwd_ref`."""
    _check(q, k, v, kv_lens)
    if _tma(q):
        _check_tma(("q", q), ("k", k), ("v", v))
    kw = dict(causal=causal, kv_lens=kv_lens, dropout_rate=dropout_rate,
              seed=seed, meta=_meta(meta, q.shape[2]))
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, **kw)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, k, v, out=out, lse=lse, **kw)
    return out, lse


def _bwd_inputs(q, k, v, do, lse, delta, kv_lens):
    _check(q, k, v, kv_lens, ("do", do), ("lse", lse), ("delta", delta))
    b, s, h, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must match q, got {do.dtype} "
                         f"{tuple(do.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b * h, s) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 [b*h, s], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if _tma(q):
        _check_tma(("q", q), ("k", k), ("v", v), ("do", do), ("lse", lse),
                   ("delta", delta))


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                 kv_lens=None, dropout_rate: float = 0.0, seed: int = 0,
                 meta=None) -> torch.Tensor:
    """B2: dQ [b, s, h, d] from the forward's lse and delta = rowsum(dO∘O)
    (both fp32 [b*h, s]). CUDA tensors launch ``flash_bwd_dq`` (at bf16, d
    64 and 128, the TMA + wgmma kernel: see :func:`_check_tma`); CPU
    tensors take :func:`flash_bwd_dq_ref`."""
    _bwd_inputs(q, k, v, do, lse, delta, kv_lens)
    kw = dict(causal=causal, kv_lens=kv_lens, dropout_rate=dropout_rate,
              seed=seed, meta=_meta(meta, q.shape[2]))
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("flash_bwd_dq", q, k, v, dout=do, lse=lse, delta=delta, dq=dq,
            **kw)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                  kv_lens=None, dropout_rate: float = 0.0, seed: int = 0,
                  meta=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3: ``(dK, dV)`` [b, s, h, d]. CUDA tensors launch
    ``flash_bwd_dkv`` (at bf16, d 64 and 128, the TMA + wgmma kernel: see
    :func:`_check_tma`); CPU tensors take :func:`flash_bwd_dkv_ref`."""
    _bwd_inputs(q, k, v, do, lse, delta, kv_lens)
    kw = dict(causal=causal, kv_lens=kv_lens, dropout_rate=dropout_rate,
              seed=seed, meta=_meta(meta, q.shape[2]))
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("flash_bwd_dkv", q, k, v, dout=do, lse=lse, delta=delta, dk=dk,
            dv=dv, **kw)
    return dk, dv


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, causal, dropout_rate, seed, *meta):
        # meta is optional (the identity when left out)
        meta = meta[0] if meta else None
        out, lse = flash_fwd(q, k, v, causal=causal, kv_lens=kv_lens,
                             dropout_rate=dropout_rate, seed=seed, meta=meta)
        ctx.save_for_backward(q, k, v, out, lse, kv_lens)
        ctx.opts = dict(causal=causal, dropout_rate=dropout_rate, seed=seed,
                        meta=meta)
        ctx.n_args = 7 if meta is None else 8
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_lens = ctx.saved_tensors
        b, s, h, _ = q.shape
        do = do.to(q.dtype).contiguous()
        # delta = rowsum(dO∘O) in fp32, outside the kernels
        delta = (do.float() * out.float()).sum(-1)  # [b, s, h]
        delta = delta.transpose(1, 2).reshape(b * h, s).contiguous()
        kw = dict(kv_lens=kv_lens, **ctx.opts)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return (dq, dk, dv) + (None,) * (ctx.n_args - 3)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    kv_lens: Optional[torch.Tensor] = None,
                    dropout_rate: float = 0.0, seed: int = 0, meta=None
                    ) -> torch.Tensor:
    """Flash attention over ``[b, s, h, d]`` q, k, v (bf16 or fp32, head
    dim 16/32/64/128 and contiguous, s a multiple of 64): softmax(q·kᵀ/√d)
    under causal ∧ ``k < kv_lens[b]`` (``kv_lens`` int32 [b], optional),
    with hash dropout of rate ``dropout_rate`` keyed on the int32 ``seed``
    on the value path; ``meta`` gives the global ids the hash and masks
    read (the identity when None). Differentiable in q, k and v; the
    forward launches B1 and the backward B2 and B3 (plain versions on CPU
    tensors)."""
    return _FlashAttention.apply(q, k, v, kv_lens, bool(causal),
                                 float(dropout_rate), int(seed),
                                 _meta(meta, q.shape[2]))


# ------------------------------------------------- ring-CP pair entries (B11)

def _lse_to_bsh(lse: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """[b*h, s] fp32 -> [b, s, h]."""
    return lse.view(b, h, -1).transpose(1, 2)


def _lse_from_bsh(lse: torch.Tensor) -> torch.Tensor:
    """[b, s, h] fp32 -> contiguous [b*h, s]."""
    b, s, h = lse.shape
    return lse.float().transpose(1, 2).reshape(b * h, s).contiguous()


def _block_kw(q, seed, meta, causal, dropout_rate, kv_len) -> dict:
    """The kernel keywords of a pair call; on the card a block must be a
    multiple of the kernels' 64-row tile (the JAX entries take multiples
    of 8)."""
    b, s, h, _ = q.shape
    if q.is_cuda and s % TILE:
        raise ValueError(f"ring block of {s} rows: the kernels take "
                         f"multiples of their {TILE}-row tile")
    kv_lens = torch.full((b,), int(kv_len), dtype=torch.int32,
                         device=q.device)
    return dict(causal=bool(causal), kv_lens=kv_lens,
                dropout_rate=float(dropout_rate), seed=int(seed),
                meta=_meta(meta, h))


def _count_block(name: str, q: torch.Tensor) -> None:
    if q.is_cuda:
        block_launches[name] += 1


def block_fwd_lse(q, k, v, seed, meta, *, causal: bool,
                  dropout_rate: float, kv_len: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1 on one (q block, kv block) pair of the ring (JAX
    ``block_fwd_lse``, :820): ``(out [b, s, h, d], lse [b, s, h] fp32)``.
    ``meta`` holds the global ids and the blocks' positions; ``kv_len`` is
    the global key count (keys at or past it are masked). A causal pair
    sits on the diagonal (q_off == k_off) in the ring, which calls pairs
    across blocks with ``causal=False``."""
    b, _, h, _ = q.shape
    out, lse = flash_fwd(q, k, v, **_block_kw(q, seed, meta, causal,
                                              dropout_rate, kv_len))
    _count_block("block_fwd_lse", q)
    return out, _lse_to_bsh(lse, b, h)


def block_dq(q, k, v, do, lse, delta, seed, meta, *, causal: bool,
             dropout_rate: float, kv_len: int) -> torch.Tensor:
    """B2 on one pair (JAX ``block_dq``, :836): dq of the q block against
    the MERGED lse and delta ([b, s, h] fp32) of its rows, so each hop's
    dq is taken against the global softmax statistics."""
    dq = flash_bwd_dq(q, k, v, do, _lse_from_bsh(lse), _lse_from_bsh(delta),
                      **_block_kw(q, seed, meta, causal, dropout_rate,
                                  kv_len))
    _count_block("block_dq", q)
    return dq


def block_dkv(q, k, v, do, lse, delta, seed, meta, *, causal: bool,
              dropout_rate: float, kv_len: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3 on one pair (JAX ``block_dkv``, :852): ``(dk, dv)`` of the kv
    block given the merged lse and delta of the q rows."""
    dk, dv = flash_bwd_dkv(q, k, v, do, _lse_from_bsh(lse),
                           _lse_from_bsh(delta),
                           **_block_kw(q, seed, meta, causal, dropout_rate,
                                       kv_len))
    _count_block("block_dkv", q)
    return dk, dv
