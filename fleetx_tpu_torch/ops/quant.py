"""Int8 serving quantization: the KV cache, the weights, and the
serving-precision knob.

Port of the serving half of the JAX package's ``ops/quant.py`` (:47-224):

- the KV cache: per-vector absmax int8 with one fp32 scale per cached
  (position, head) vector (:func:`quantize_kv`);
- the weights (weight-only PTQ, :func:`quantize_tree_int8`): each dense
  kernel and embedding table becomes int8 values with one fp32 scale per
  channel, the channel being the LAST axis of the flax kernel (the output
  features; for the fused qkv kernel ``[E, heads, 3·hd]`` the 3·hd axis,
  shared by the heads; for an embedding table the hidden axis, shared by
  the rows). JAX scans the decoder layers into one ``[L, ...]`` leaf, so a
  layer kernel's absmax runs over every layer too. The port keeps its own
  ``Linear`` layout (``name_q8`` beside ``name_scale``, the scale shaped to
  broadcast against the weight, :func:`dequantize_int8`), and its values
  and scales are JAX's bit for bit;
- the ``bf16|int8`` knob parser behind ``FLEETX_SERVING_KV_DTYPE`` and
  ``FLEETX_SERVING_WEIGHT_DTYPE``, and the prefix-tolerance contract
  quantized greedy streams are read by.

QAT (``fake_quant*``) is not ported (ROADMAP Queue A, "Other families and
the rest of the toolkit").

The int8 values and scales equal the JAX functions' bit for bit: both
divide in fp32 by ``max(scale, 1e-12)`` and round half to even
(``torch.round`` and ``jnp.round`` agree).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["QUANT_PREFIX_BUDGET", "common_prefix_len", "dequantize_int8",
           "dequantize_kv", "dequantize_tree_int8", "quant_parity_frac",
           "quantize_int8", "quantize_kv", "quantize_tree_int8",
           "resolve_serving_dtype", "serving_weight_params"]

# A quantized greedy stream may diverge from its bf16 reference only in its
# trailing this-fraction of tokens (greedy decode is chaotic after a first
# argmax flip, so the longest common prefix is the measure).
QUANT_PREFIX_BUDGET = 0.25


def resolve_serving_dtype(value: Optional[str], env_var: Optional[str],
                          label: Optional[str] = None) -> str:
    """``"bf16"`` or ``"int8"``: an explicit ``value`` wins, else the
    environment variable ``env_var``, else bf16; anything else raises."""
    out = str(value or (os.environ.get(env_var) if env_var else "")
              or "bf16").lower()
    if out not in ("bf16", "int8"):
        raise ValueError(f"{label or env_var} must be bf16|int8, got {out!r}")
    return out


def common_prefix_len(got, want) -> int:
    """Length of the longest common leading run of two token streams."""
    got, want = np.asarray(got), np.asarray(want)
    n = min(len(got), len(want))
    neq = np.nonzero(got[:n] != want[:n])[0]
    return int(neq[0]) if len(neq) else n


def quant_parity_frac(got, want) -> float:
    """Common-prefix length over the reference length; 0.0 when the
    lengths differ (the budget tolerates diverging tails, not missing
    tokens). A stream passes when this is >= ``1 - QUANT_PREFIX_BUDGET``."""
    if len(got) != len(want):
        return 0.0
    return common_prefix_len(got, want) / max(len(want), 1)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(int8 values, fp32 scales [..., 1])``: absmax over the trailing
    (head_dim) axis, scale = absmax / 127, values = round(x / max(scale,
    1e-12)) clipped to ±127. The trailing 1 keeps scale tensors aligned
    with the K/V layout, so page scatters and gathers treat them alike."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(x32 / scale.clamp_min(1e-12)).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(int8 → fp32) × scale``, then cast to ``dtype``: the values every
    attention path (the dense prefill and the decode kernels) sees."""
    return (q.float() * scale).to(dtype)


# --------------------------------------------------------- weight PTQ

_LAYER = re.compile(r"^gpt\.layers\.\d+\.")


def _is_weight(name: str, t: torch.Tensor) -> bool:
    """A dense kernel or an embedding table (JAX ``_is_weight``, :186:
    >= 2-D and named kernel or embedding): the ``weight`` of a dense
    layer, and the word and position tables."""
    return t.dim() >= 2 and (name.endswith(".weight")
                             or name.endswith("embeddings"))


def _is_qdict(params: Dict[str, torch.Tensor], name: str) -> bool:
    """Whether ``name`` is the int8 half of an already-quantized pair
    (JAX ``_is_qdict``, :194)."""
    return name.endswith("_q8") and name[:-3] + "_scale" in params


def _scale_shape(name: str, shape, head_dim: int) -> Tuple[int, int]:
    """The scale of the weight ``name`` (of the port's ``shape``): one
    channel per entry of the flax kernel's last axis. A dense kernel's
    channel is its output row, a ``[C, 1]`` scale with C dividing the
    rows: the fused qkv's 3·hd (row ``h·3hd + j`` is channel j, shared by
    the heads), q/k/v's hd, every other kernel's rows. An embedding table
    keeps its columns: a ``[1, E]`` scale."""
    if name.endswith("embeddings"):
        return 1, int(shape[-1])
    if name.endswith("attn.qkv_proj.weight"):
        return 3 * head_dim, 1
    if re.search(r"attn\.[qkv]_proj\.weight$", name):
        return head_dim, 1
    return int(shape[0]), 1


def _grouped(w: torch.Tensor, scale_shape) -> torch.Tensor:
    """``w`` [rows, cols] viewed as ``[-1, s0, cols]``, against which a
    scale of ``scale_shape`` [s0, 1 or cols] broadcasts channel by
    channel."""
    return w.reshape(-1, scale_shape[0], w.shape[-1])


def quantize_int8(ws, scale_shape) -> Tuple[list, torch.Tensor]:
    """``([int8 values], fp32 scale)`` of the weights ``ws`` (one per
    layer of a scanned leaf, or one) with one absmax per channel over all
    of them (JAX ``quantize_int8``, :110): scale = absmax / 127, values =
    round(w / max(scale, 1e-12)) clipped to ±127."""
    parts = [_grouped(w.float(), scale_shape) for w in ws]
    dims = (0, 2) if scale_shape[1] == 1 else (0, 1)
    absmax = torch.stack([p.abs().amax(dim=dims) for p in parts]).amax(0)
    # a true division on every device (a CUDA tensor divided by a Python
    # number is multiplied by its reciprocal, which can round otherwise)
    scale = torch.div(absmax, torch.full_like(absmax, 127.0)).reshape(
        scale_shape)
    qs = [torch.round(p / scale.clamp_min(1e-12)).clamp(-127, 127)
          .to(torch.int8).reshape(w.shape) for p, w in zip(parts, ws)]
    return qs, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(int8 → fp32) × scale``, channel by channel, then cast to
    ``dtype`` (JAX ``dequantize_int8``, :121, which the model then casts
    to its compute dtype). Works on a shard of the weight too: a shard of
    rows holds whole groups of channels, a shard of columns keeps every
    row's channel."""
    return (_grouped(q.float(), scale.shape) * scale).reshape(
        q.shape).to(dtype)


def quantize_tree_int8(params: Dict[str, torch.Tensor], head_dim: int
                       ) -> Dict[str, torch.Tensor]:
    """The whole model's state dict with each weight (:func:`_is_weight`)
    replaced by ``name_q8`` (int8, the weight's shape) and ``name_scale``
    (fp32, :func:`_scale_shape`), everything else as it is (JAX
    ``quantize_tree_int8``, :199). Each per-layer weight shares one scale
    over all the layers, as the absmax of JAX's scan-stacked ``[L, ...]``
    leaf does (its default ``scan_layers`` layout, the one
    ``convert.params_from_jax`` reads).
    Idempotent: an already-quantized pair passes through. Quantize the
    whole model before cutting its mp shards: a row-parallel kernel's
    absmax runs over its whole input axis."""
    groups: Dict[str, list] = {}
    for name, t in params.items():
        if _is_weight(name, t):
            groups.setdefault(_LAYER.sub("gpt.layers.*.", name),
                              []).append(name)
    pairs = {}
    for names in groups.values():
        qs, scale = quantize_int8(
            [params[n] for n in names],
            _scale_shape(names[0], params[names[0]].shape, head_dim))
        pairs.update((n, (q, scale.clone())) for n, q in zip(names, qs))
    out = {}
    for name, t in params.items():  # each pair where its weight stood
        if name in pairs:
            out[name + "_q8"], out[name + "_scale"] = pairs[name]
        else:
            out[name] = t
    return out


def dequantize_tree_int8(params: Dict[str, torch.Tensor],
                         dtype: torch.dtype = torch.float32
                         ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_tree_int8` (JAX ``dequantize_tree_int8``,
    :214): each pair back to one float weight of ``dtype``."""
    out = {}
    for name, t in params.items():
        if _is_qdict(params, name):
            out[name[:-3]] = dequantize_int8(t, params[name[:-3] + "_scale"],
                                             dtype)
        elif not (name.endswith("_scale") and name[:-6] + "_q8" in params):
            out[name] = t
    return out


def serving_weight_params(params: Dict[str, torch.Tensor], weight_dtype: str,
                          head_dim: int) -> Dict[str, torch.Tensor]:
    """The serving weight-only PTQ (JAX ``serving_weight_params``, :67): at
    ``"int8"`` the state dict quantized (idempotent); at ``"bf16"`` a float
    state dict as it is, but one that already holds int8 pairs raises —
    the bf16 path has no dequant seam."""
    if weight_dtype == "int8":
        return quantize_tree_int8(params, head_dim)
    if any(_is_qdict(params, n) for n in params):
        raise ValueError(
            "params are already int8-quantized (name_q8 / name_scale "
            f"pairs) but weight_dtype is {weight_dtype!r} — serve them with "
            "weight_dtype='int8' (the per-call dequant seam) or expand them "
            "with dequantize_tree_int8 first")
    return params
