"""Int8 KV-cache quantization and the serving-precision knob.

Port of the KV half of the JAX package's ``ops/quant.py`` (:47-151):
per-vector absmax int8 with one fp32 scale per cached (position, head)
vector, the ``bf16|int8`` knob parser behind ``FLEETX_SERVING_KV_DTYPE``,
and the prefix-tolerance contract quantized greedy streams are read by.
Weight PTQ and QAT are not ported.

The int8 values and scales equal the JAX function's bit for bit: both
divide in fp32 by ``max(scale, 1e-12)`` and round half to even
(``torch.round`` and ``jnp.round`` agree).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["QUANT_PREFIX_BUDGET", "common_prefix_len", "dequantize_kv",
           "quant_parity_frac", "quantize_kv", "resolve_serving_dtype"]

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
