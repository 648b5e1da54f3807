"""Counter-hash dropout for the hidden activations.

Port of the JAX package's ``HashDropout`` (ops/dropout.py:41-73). The keep
decision of element i is the lowbias32 hash of the flash kernels
(:func:`fleetx_tpu_torch.ops.flash_attention.dropout_keep_scale`) keyed on
(seed, bh = 0, q = i, k = 0), i the flat element index, so the same int32
seed gives the JAX module's mask bit for bit. The seed of each call is one
int32 drawn from an explicit ``torch.Generator`` (the JAX module folds its
``'dropout'`` PRNG key into one). Plain PyTorch on every device: the JAX
module is pure jnp too, with no Pallas kernel behind it.

When the batch (dp) or the sequence (cp, or mp under sequence
parallelism) is split over ranks, i is the index the JAX module's ``iota``
over the GLOBAL array gives (:70-72): the flat index of the element in
the global ``[B, S, ...]`` activation, whose sequence is in zig-zag order
under cp. A :class:`Shard` says where the rank's ``[b, s, ...]`` slice
lies in it; with the rank-local index, two ranks would draw one mask for
two different parts of the sequence.

:class:`FlaxDropout` is ``fast_dropout: False``: flax's ``nn.Dropout``,
whose keep mask is ``jax.random.bernoulli(key, 1 - rate, shape)`` over
the threefry2x32 PRNG (JAX ops/dropout.py:32-38). Its bits are computed
here in plain PyTorch (int64 tensors masked to 32 bits) in the layout of
``jax_threefry_partitionable``, which the JAX package pins on: element i
of the global array hashes the counter (i >> 32, i & 0xffffffff) under
the key, so a rank computes its own slice of the global mask directly.
The key of each call is drawn from the port's ``torch.Generator``
(:func:`draw_key`); the mask for a given raw key equals JAX's bit for
bit. Eager ops on every device: it is not a Pallas kernel in JAX either.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from fleetx_tpu_torch.ops.flash_attention import dropout_keep_scale

__all__ = ["FlaxDropout", "HashDropout", "Shard", "draw_key", "draw_seed",
           "draw_site", "dropout_layer", "threefry_keep", "threefry2x32"]


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


def draw_key(generator: Optional[torch.Generator]) -> Tuple[int, int]:
    """One raw threefry key (two uint32 words) from ``generator``."""
    w = torch.randint(0, 1 << 32, (2,), generator=generator,
                      dtype=torch.int64)
    return int(w[0]), int(w[1])


def draw_site(generator: Optional[torch.Generator], rate: float, *,
              hidden: bool, fast: bool = True, deterministic: bool = False):
    """The draw of one dropout site for one training forward: None where
    the site draws nothing (``deterministic``, a rate of 0, or a hidden
    rate of 1 or more); a raw threefry key for a hidden site at ``fast``
    False (:class:`FlaxDropout`); else an int32 seed (:class:`HashDropout`
    and the attention dropout of the flash kernels)."""
    if deterministic or rate <= 0.0 or (hidden and rate >= 1.0):
        return None
    if hidden and not fast:
        return draw_key(generator)
    return draw_seed(generator)


_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key: Tuple[int, int], x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of the counter words ``(x0, x1)`` (int64
    tensors holding uint32 values) under ``key``: JAX's
    ``_threefry2x32_lowering`` (20 rounds, a key injection every 4)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def threefry_keep(key: Tuple[int, int], idx: torch.Tensor,
                  keep_prob: float) -> torch.Tensor:
    """``jax.random.bernoulli(key, keep_prob, shape)`` at the flat indices
    ``idx`` (int64) of the global array, partitionable layout: the 32
    random bits of element i are the xor of the two threefry words of the
    counter (i >> 32, i & 0xffffffff); their top 23 bits make a float in
    [1, 2), minus 1 a uniform in [0, 1), kept where below ``keep_prob``
    (fp32)."""
    b0, b1 = threefry2x32(key, idx >> 32, idx & _M32)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    return u < torch.tensor(keep_prob, dtype=torch.float32)


def _flat_index(x: torch.Tensor, shard: Optional["Shard"]) -> torch.Tensor:
    """The flat index (int64) of each element of ``x`` in the global
    activation ``shard`` places it in (its own when None)."""
    dev = x.device
    if shard is None:
        return torch.arange(x.numel(), device=dev).view(x.shape)
    b, s = x.shape[:2]
    inner = x.numel() // max(b * s, 1)
    rows = ((shard.b0 + torch.arange(b, device=dev))[:, None] * shard.seq
            + shard.s0 + torch.arange(s, device=dev))
    return (rows[..., None] * inner
            + torch.arange(inner, device=dev)).view(x.shape)


class FlaxDropout(nn.Module):
    """flax ``nn.Dropout`` (``fast_dropout: False``): ``x / keep`` where
    the threefry mask of ``key`` keeps an element, else 0; identity when
    ``deterministic`` or ``rate == 0``, zeros at ``rate >= 1``. ``key``
    overrides the draw from ``generator``; ``shard`` places ``x`` in the
    global activation."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                seed: Optional[Tuple[int, int]] = None,
                shard: Optional["Shard"] = None) -> torch.Tensor:
        if deterministic or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        key = draw_key(generator) if seed is None else seed
        keep_prob = 1.0 - self.rate
        mask = threefry_keep(key, _flat_index(x, shard), keep_prob)
        # flax: lax.select(mask, x / keep_prob, 0), the division in x's
        # dtype (a weakly typed scalar)
        keep = torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


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


def dropout_layer(rate: float, fast: bool = True) -> nn.Module:
    """A hidden dropout: the counter hash, or flax's threefry
    ``nn.Dropout`` at ``fast`` False (JAX ``dropout_layer``,
    ops/dropout.py:31-38)."""
    return HashDropout(rate) if fast else FlaxDropout(rate)
