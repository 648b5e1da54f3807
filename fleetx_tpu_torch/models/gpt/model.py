"""GPT for the port: the training forward and the cached serving forward.

Port of the JAX package's GPT (models/gpt/model.py). Two forwards share
the modules:

- the no-cache training forward (``cache=None``): causal self-attention
  through ``causal_attention`` — the flash kernels — with hash dropout on
  the embeddings, after attention and after the MLP, seeded from an
  explicit ``torch.Generator``; :func:`pretraining_loss` on its logits;
- the cached forward the serving path takes — a multi-token prefill call
  or a single-token decode step writing K/V into a shared page pool.

Recompute, pipeline/context/expert parallelism and the fused LM-head loss
are not here.

Numerics follow the flax modules at the compute dtype (bf16 by default,
params fp32):

- :class:`Dense` casts its fp32 weight and bias to the compute dtype
  (``nn.DenseGeneral(dtype=..., param_dtype=float32)``);
- :class:`LayerNorm` (eps 1e-5) computes its statistics and affine in fp32
  and casts the result;
- the word and position embeddings are summed in fp32, then cast;
- the tied LM head multiplies the compute-dtype activations by the
  compute-dtype embedding table with fp32 accumulation (fp32 logits).

Weights live in PyTorch's ``Linear`` layout (``[out, in]``);
``convert.params_from_jax`` maps the flax tree onto it. Activations keep
the JAX layout ``[b, s, h, d]`` and the page pools ``[L, num_pages,
page_size, h, d]``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from fleetx_tpu_torch.ops.attention import (
    causal_attention,
    reference_attention,
)
from fleetx_tpu_torch.ops.decode_attention import (
    paged_decode_attention,
    paged_gather_kv,
)
from fleetx_tpu_torch.ops.dropout import HashDropout, draw_seed

__all__ = ["DTYPES", "GPTConfig", "GPTForPretraining", "GPTModel",
           "DecoderLayer", "SelfAttention", "MLP", "Dense", "LayerNorm",
           "masked_loss_mean", "pretraining_loss"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """GPT hyperparameters (the JAX ``GPTConfig`` fields the port reads).
    ``decode_*`` size the paged cache: ``decode_num_pages`` pages
    of ``decode_page_size`` positions shared by all rows, each row
    addressing a logical window of ``decode_cache_len`` positions."""
    vocab_size: int = 50304
    hidden_size: int = 1024
    num_layers: int = 24
    num_attention_heads: int = 16
    ffn_hidden_size: Optional[int] = None
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 1024
    initializer_range: float = 0.02
    fuse_attn_qkv: bool = True
    use_flash_attention: bool = True
    dtype: torch.dtype = torch.bfloat16  # compute dtype; params fp32
    decode_cache_len: Optional[int] = None
    decode_num_pages: Optional[int] = None
    decode_page_size: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def ffn_size(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def cache_len(self) -> int:
        """Logical positions a row can address in the decode cache."""
        return self.decode_cache_len or self.max_position_embeddings

    @classmethod
    def from_model_config(cls, model_cfg) -> "GPTConfig":
        """Build from a YAML ``Model`` section (unknown keys ignored, a
        dtype string mapped to its torch dtype)."""
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in dict(model_cfg).items()
              if k in known and v is not None}
        if isinstance(kw.get("dtype"), str):
            kw["dtype"] = DTYPES[kw["dtype"]]
        return cls(**kw)


def _param(*shape, device) -> nn.Parameter:
    # weights come from init_params / params_from_jax, never from here
    return nn.Parameter(torch.empty(*shape, device=device))


class Dense(nn.Module):
    """``y = x Wᵀ + b`` at the compute dtype; ``weight`` [out, in] and
    ``bias`` [out] are held in fp32 (or pre-cast to the compute dtype by
    an inference caller, which yields the same result)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = _param(out_features, in_features, device=device)
        self.bias = _param(out_features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-5)``: mean and E[x²]−mean² variance,
    normalisation and affine in fp32, result in the compute dtype."""

    def __init__(self, size: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = _param(size, device=device)
        self.bias = _param(size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (x - mean) * (torch.rsqrt(var + 1e-5) * self.scale.float())
        return (y + self.bias.float()).to(self.dtype)


class SelfAttention(nn.Module):
    """Fused-qkv self-attention: causal over the call's own tokens (the
    JAX ``SelfAttention`` no-cache branch, model.py:310-332) or over the
    paged decode cache (its decode branch with ``decode_num_pages``
    set)."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        if not cfg.fuse_attn_qkv:
            raise ValueError("the port serves the fused-qkv layout only; "
                             "fuse the q/k/v kernels before conversion")
        self.cfg = cfg
        nh, hd, e = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size
        self.qkv_proj = Dense(e, nh * 3 * hd, cfg.dtype, device)
        self.out_proj = Dense(nh * hd, e, cfg.dtype, device)

    def forward(self, x, k_pages=None, v_pages=None, *, cache_positions=None,
                block_tables=None, deterministic=True, generator=None):
        """``x`` [b, s, E]. Without pools: causal attention over the s
        tokens, attention dropout (unless ``deterministic``) seeded from
        ``generator``. With ``k_pages``/``v_pages`` (this layer's pools
        [num_pages, page_size, h, d]): row b writes its s new K/V at
        logical positions ``cache_positions[b]..`` through
        ``block_tables`` [b, n_logical] and attends ``[0,
        cache_positions[b] + i]`` for its query i."""
        cfg = self.cfg
        b, s, _ = x.shape
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        # per head the last axis holds q | k | v (flax kernel [E, nh, 3hd])
        q, k, v = self.qkv_proj(x).view(b, s, nh, 3 * hd).split(hd, dim=-1)
        if k_pages is None:
            rate = cfg.attention_probs_dropout_prob
            seed = None
            if rate > 0.0 and not deterministic:
                seed = draw_seed(generator)
            out = causal_attention(q, k, v, causal=True, dropout_rate=rate,
                                   seed=seed, deterministic=deterministic,
                                   use_flash=cfg.use_flash_attention)
            return self._out_proj(out)
        decode_end = self._update_paged_cache(
            k, v, k_pages, v_pages, cache_positions, block_tables)
        if decode_end is not None:
            # single-query step: the paged decode kernel reads only each
            # row's live pages
            out = paged_decode_attention(
                q.contiguous(), k_pages, v_pages, tables=block_tables,
                end=decode_end)
            return self._out_proj(out)
        # multi-token (prefill) call: gather each row's logical buffer and
        # run the dense masked attention under the absolute-position mask
        k_all = paged_gather_kv(k_pages, block_tables)
        v_all = paged_gather_kv(v_pages, block_tables)
        q_pos = cache_positions.long()[:, None] + torch.arange(
            s, device=x.device)
        k_pos = torch.arange(k_all.shape[1], device=x.device)
        causal = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]
        return self._out_proj(reference_attention(q, k_all, v_all, causal))

    def _out_proj(self, out: torch.Tensor) -> torch.Tensor:
        b, s = out.shape[:2]
        return self.out_proj(out.reshape(b, s, -1))

    def _update_paged_cache(self, k, v, k_pages, v_pages, cache_positions,
                            block_tables) -> Optional[torch.Tensor]:
        """Scatter this call's K/V into the pools; returns the per-row live
        length ``[b]`` int32 for a single-query step (the decode kernel's
        ``end``), else None.

        Positions clamp to the logical capacity: bucket-tail and inactive-
        lane writes land on a row's last logical slot or, through a zeroed
        table entry, on the trash page 0 — beyond every live window. The
        pools are updated in place (the JAX module returns new pools)."""
        cfg = self.cfg
        b, s, nh, hd = k.shape
        ps = k_pages.shape[1]
        max_len = cfg.cache_len
        if ps % 8 or max_len % ps:
            raise ValueError(
                f"page_size {ps} must be a multiple of 8 and divide the "
                f"cache length {max_len}")
        wpos = cache_positions.long()
        pos = (wpos[:, None] + torch.arange(s, device=k.device)).clamp_max(
            max_len - 1)
        page = block_tables.long().gather(1, pos // ps).reshape(-1)
        slot = (pos % ps).reshape(-1)
        k_pages[page, slot] = k.reshape(b * s, nh, hd)
        v_pages[page, slot] = v.reshape(b * s, nh, hd)
        return (wpos + 1).to(torch.int32) if s == 1 else None


class MLP(nn.Module):
    """up_proj → tanh-approximated gelu → down_proj."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.up_proj = Dense(cfg.hidden_size, cfg.ffn_size, cfg.dtype, device)
        self.down_proj = Dense(cfg.ffn_size, cfg.hidden_size, cfg.dtype,
                               device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.gelu(self.up_proj(x), approximate="tanh"))


class DecoderLayer(nn.Module):
    """Pre-LN decoder layer: x + drop(attn(norm1(x))), then
    + drop(mlp(norm2(x)))."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.norm1 = LayerNorm(cfg.hidden_size, cfg.dtype, device)
        self.attn = SelfAttention(cfg, device)
        self.attn_dropout = HashDropout(cfg.hidden_dropout_prob)
        self.norm2 = LayerNorm(cfg.hidden_size, cfg.dtype, device)
        self.mlp = MLP(cfg, device)
        self.mlp_dropout = HashDropout(cfg.hidden_dropout_prob)

    def forward(self, x, k_pages=None, v_pages=None, *, cache_positions=None,
                block_tables=None, deterministic=True, generator=None):
        y = self.attn(self.norm1(x), k_pages, v_pages,
                      cache_positions=cache_positions,
                      block_tables=block_tables,
                      deterministic=deterministic, generator=generator)
        x = x + self.attn_dropout(y, deterministic, generator)
        y = self.mlp(self.norm2(x))
        return x + self.mlp_dropout(y, deterministic, generator)


class GPTModel(nn.Module):
    """Embeddings, the decoder stack and the final LayerNorm; returns the
    hidden states [b, s, E] in the compute dtype."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = _param(cfg.vocab_size, cfg.hidden_size,
                                      device=device)
        self.position_embeddings = _param(cfg.max_position_embeddings,
                                          cfg.hidden_size, device=device)
        self.embed_dropout = HashDropout(cfg.hidden_dropout_prob)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm = LayerNorm(cfg.hidden_size, cfg.dtype, device)

    def forward(self, input_ids, position_ids, *,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_positions=None, block_tables=None, deterministic=True,
                generator: Optional[torch.Generator] = None):
        """``cache=None`` is the training forward (dropout unless
        ``deterministic``, every seed drawn from ``generator`` in call
        order); with a cache, the serving forward (no dropout)."""
        x = (self.word_embeddings[input_ids]
             + self.position_embeddings[position_ids]).to(self.cfg.dtype)
        if cache is not None:
            for i, layer in enumerate(self.layers):
                x = layer(x, cache["key"][i], cache["value"][i],
                          cache_positions=cache_positions,
                          block_tables=block_tables)
            return self.final_norm(x)
        x = self.embed_dropout(x, deterministic, generator)
        for layer in self.layers:
            x = layer(x, deterministic=deterministic, generator=generator)
        return self.final_norm(x)


class GPTForPretraining(nn.Module):
    """GPTModel plus the tied LM head: fp32 logits [b, s, vocab]."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.gpt = GPTModel(cfg, device)

    def forward(self, input_ids, position_ids, *, cache=None,
                cache_positions=None, block_tables=None, deterministic=True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.gpt(input_ids, position_ids, cache=cache,
                     cache_positions=cache_positions,
                     block_tables=block_tables, deterministic=deterministic,
                     generator=generator)
        emb = self.gpt.word_embeddings.to(self.cfg.dtype)
        # compute-dtype operands, fp32 accumulation and result
        if x.is_cuda and x.dtype == torch.bfloat16:
            return _Bf16LMHead.apply(x, emb)
        return torch.matmul(x.float(), emb.float().t())


class _Bf16LMHead(torch.autograd.Function):
    """bf16 logits = x·Wᵀ on the card as one bf16 GEMM with fp32 output
    (the flax einsum with ``preferred_element_type=float32``; an fp32 GEMM
    of the bf16 values would take several times longer). The backward
    rounds the fp32 cotangent to bf16 for its two products, as the TPU's
    default-precision matmul does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                        out_dtype=torch.float32).view(*x.shape[:-1],
                                                      w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1]).to(x.dtype)
        return (g @ w).view_as(x), g.t() @ x.reshape(-1, x.shape[-1])


def masked_loss_mean(token_loss: torch.Tensor,
                     loss_mask: torch.Tensor) -> torch.Tensor:
    """Loss-mask-weighted mean of per-token losses (model.py:976-980)."""
    mask = loss_mask.float().reshape(token_loss.shape)
    return (token_loss * mask).sum() / mask.sum().clamp_min(1.0)


def pretraining_loss(logits: torch.Tensor, labels: torch.Tensor,
                     loss_mask: torch.Tensor) -> torch.Tensor:
    """Masked LM cross-entropy in fp32 (model.py:983-991)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = logits.gather(-1, labels.long()[..., None])[..., 0]
    return masked_loss_mean(logz - label_logits, loss_mask)
