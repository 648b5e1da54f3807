"""Counter-hash dropout for the hidden activations.

Port of the JAX package's ``HashDropout`` (ops/dropout.py:41-73). The keep
decision of element i is the lowbias32 hash of the flash kernels
(:func:`fleetx_tpu_torch.ops.flash_attention.dropout_keep_scale`) keyed on
(seed, bh = 0, q = i, k = 0), i the flat element index, so the same int32
seed gives the JAX module's mask bit for bit. The seed of each call is one
int32 drawn from an explicit ``torch.Generator`` (the JAX module folds its
``'dropout'`` PRNG key into one). Plain PyTorch on every device: the JAX
module is pure jnp too, with no Pallas kernel behind it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fleetx_tpu_torch.ops.flash_attention import dropout_keep_scale

__all__ = ["HashDropout", "draw_seed"]


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
                seed: Optional[int] = None) -> torch.Tensor:
        if deterministic or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        if x.numel() >= (1 << 31):
            raise ValueError(f"HashDropout supports < 2^31 elements per call; "
                             f"got shape {tuple(x.shape)}")
        if seed is None:
            seed = draw_seed(generator)
        idx = torch.arange(x.numel(), dtype=torch.int32,
                           device=x.device).view(x.shape)
        scale = dropout_keep_scale(seed, 0, idx, 0, self.rate)
        return x * scale.to(x.dtype)
