"""Counter-hash dropout for the hidden activations.

Port of the JAX package's ``HashDropout`` (ops/dropout.py:41-73). The keep
decision of element i is the lowbias32 hash of the flash kernels
(:func:`fleetx_tpu_torch.ops.flash_attention.dropout_keep_scale`) keyed on
(seed, bh = 0, q = i, k = 0), i the flat element index, so the same int32
seed gives the JAX module's mask bit for bit. The seed of each call is one
int32 drawn from an explicit ``torch.Generator`` (the JAX module folds its
``'dropout'`` PRNG key into one). Plain PyTorch on every device: the JAX
module is pure jnp too, with no Pallas kernel behind it.

When the batch (dp) or the sequence (cp) is split over ranks, i is the
index the JAX module's ``iota`` over the GLOBAL array gives (:70-72): the
flat index of the element in the global ``[B, S, ...]`` activation, whose
sequence is in zig-zag order under cp. A :class:`Shard` says where the
rank's ``[b, s, ...]`` slice lies in it; with the rank-local index, two cp
ranks would draw one mask for two different parts of the sequence.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from fleetx_tpu_torch.ops.flash_attention import dropout_keep_scale

__all__ = ["HashDropout", "Shard", "draw_seed"]


@dataclasses.dataclass(frozen=True)
class Shard:
    """Where a rank's ``[b, s, ...]`` activation lies in the global
    ``[B, S, ...]`` one: rows from ``b0`` of ``batch`` (B), positions from
    ``s0`` of ``seq`` (S)."""
    b0: int
    batch: int
    s0: int
    seq: int


def draw_seed(generator: Optional[torch.Generator]) -> int:
    """One int32 seed from ``generator`` (a uint32 draw wrapped to int32, as
    the JAX package casts ``jax.random.bits(..., "uint32")``)."""
    u = int(torch.randint(0, 1 << 32, (1,), generator=generator,
                          dtype=torch.int64))
    return u - (1 << 32) if u >= (1 << 31) else u


class HashDropout(nn.Module):
    """``x`` with each element kept (and scaled by 1/(1-rate)) or zeroed by
    the hash of its flat index; identity when ``deterministic`` or
    ``rate == 0``. ``seed`` overrides the draw from ``generator``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                seed: Optional[int] = None,
                shard: Optional[Shard] = None) -> torch.Tensor:
        if deterministic or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        if shard is None:
            size = x.numel()
        else:
            b, s = x.shape[:2]
            inner = x.numel() // max(b * s, 1)
            size = shard.batch * shard.seq * inner  # the global activation's
        if size >= (1 << 31):
            raise ValueError(f"HashDropout supports < 2^31 elements per call; "
                             f"got {size} (local shape {tuple(x.shape)})")
        if seed is None:
            seed = draw_seed(generator)
        if shard is None:
            idx = torch.arange(x.numel(), dtype=torch.int32,
                               device=x.device).view(x.shape)
        else:  # the element's flat index in the global activation
            dev = x.device
            rows = ((shard.b0 + torch.arange(b, device=dev))[:, None]
                    * shard.seq + shard.s0 + torch.arange(s, device=dev))
            idx = (rows[..., None] * inner
                   + torch.arange(inner, device=dev)).to(torch.int32)
            idx = idx.view(x.shape)
        scale = dropout_keep_scale(seed, 0, idx, 0, self.rate)
        return x * scale.to(x.dtype)
