"""Multi-token attention: the flash routing of training and the dense path.

Port of the JAX package's ``causal_attention`` and ``_reference_attention``
(ops/attention.py:24-182). Training self-attention (no cache, q and k of
one length, no explicit mask) takes the flash kernels
(``ops/flash_attention.py``), padding the sequence to the kernels' tile
with ``kv_lens``; everything else — a paged prefill call with its explicit
mask — takes :func:`reference_attention`. Single-query decode steps take
the paged decode kernel instead (``ops/decode_attention.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from fleetx_tpu_torch.ops import flash_attention as fa

__all__ = ["NEG_INF", "causal_attention", "reference_attention"]

NEG_INF = -1e9  # large-but-finite; -inf breaks softmax when a row is all-masked


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True,
                     attn_mask: Optional[torch.Tensor] = None,
                     kv_lens: Optional[torch.Tensor] = None,
                     dropout_rate: float = 0.0, seed: Optional[int] = None,
                     deterministic: bool = True, use_flash: bool = True,
                     meta=None) -> torch.Tensor:
    """Scaled-dot-product attention over ``[b, s, h, d]`` tensors, routed
    as the JAX function routes it: the flash kernels when ``use_flash``,
    no ``attn_mask``, q and k of one length and (under dropout) a ``seed``;
    the sequence is padded to a multiple of the kernels' tile, the padded
    keys masked through ``kv_lens`` and the padded query rows sliced off.
    Otherwise the dense :func:`reference_attention`, whose dropout drops
    probabilities with the same hash mask (the JAX dense path draws its
    own bernoulli bits there). ``kv_lens`` int32 [b] masks right-padded
    keys. ``meta`` (``(b0, h0, h_local, h_total, 0, 0)``, the identity when
    None) gives the global batch and head ids that key the dropout hash
    when the batch or the heads are split over ranks. On CPU tensors the
    flash path runs the kernels' plain versions."""
    rate = 0.0 if deterministic else float(dropout_rate)
    s = q.shape[1]
    if (use_flash and attn_mask is None and k.shape[1] == s
            and (rate == 0.0 or seed is not None)):
        pad = -s % fa.TILE
        if pad:
            if kv_lens is None:
                kv_lens = torch.full((q.shape[0],), s, dtype=torch.int32,
                                     device=q.device)
            q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        if kv_lens is not None:
            kv_lens = kv_lens.to(device=q.device, dtype=torch.int32)
        out = fa.flash_attention(q, k, v, causal=causal, kv_lens=kv_lens,
                                 dropout_rate=rate, seed=seed or 0,
                                 meta=meta)
        return out[:, :s] if pad else out
    if rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 needs a seed")
    b, sk, h = k.shape[0], k.shape[1], k.shape[2]
    mask = attn_mask
    if causal:
        q_pos = torch.arange(s, device=q.device)[:, None] + (sk - s)
        tri = q_pos >= torch.arange(sk, device=q.device)[None, :]
        mask = tri if mask is None else mask.bool() & tri
    if kv_lens is not None:
        valid = (torch.arange(sk, device=q.device)[None, :]
                 < kv_lens.to(q.device)[:, None])[:, None, None, :]
        mask = valid if mask is None else mask.bool() & valid
    keep = None
    if rate > 0.0:
        dev = q.device
        b0, h0, h_local, h_total = fa.identity_meta(h)[:4] if meta is None \
            else meta[:4]
        bh = torch.arange(b * h, device=dev)
        bh = (b0 + bh // h_local) * h_total + h0 + bh % h_local
        keep = fa.dropout_keep_scale(
            seed, bh.view(b, h, 1, 1),
            torch.arange(s, device=dev)[:, None],
            torch.arange(sk, device=dev)[None, :], rate)
    return reference_attention(q, k, v, mask, keep=keep)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        attn_mask: Optional[torch.Tensor] = None,
                        keep: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v over ``[batch, seq, heads, head_dim]`` tensors
    (the kv sequence may be longer than the query's). Scores and softmax
    run in fp32 over operands in the input dtype; the probabilities are
    cast to ``v``'s dtype before the value product, and the result has
    ``v``'s dtype. ``attn_mask`` (True/1 = attend) broadcasts to
    ``[b, h, sq, sk]``; ``keep`` (fp32 dropout scales of the same shape)
    multiplies the probabilities before the cast."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(d))
    if attn_mask is not None:
        scores = torch.where(attn_mask.bool(), scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if keep is not None:
        probs = probs * keep
    probs = probs.to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(v.dtype)
