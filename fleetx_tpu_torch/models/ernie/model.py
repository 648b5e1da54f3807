"""ERNIE for the port: the bidirectional encoder, its pooler and heads.

Port of the JAX package's ERNIE (models/ernie/model.py:50-320): word,
position and token-type embeddings with a LayerNorm, a post-LN encoder
(self-attention, then a ``gelu_tanh`` MLP, each added to the stream and
normalised), a tanh pooler over the first token, the masked-LM head (the
fp32 logits on the tied word embedding at a fixed set of masked positions)
and the sentence-order (SOP) head; :class:`ErnieForSequenceClassification`
puts a classifier on the pooled output. The layers reuse the GPT port's
``Dense`` and ``LayerNorm``, as JAX reuses ``_dense``, ``_layer_norm`` and
``attn_out_dense``.

Attention is non-causal, under one of two masks (JAX :170-183):

- a dense key mask ``[b, s]`` (1 = attend) keeps its exact positional
  meaning and takes the dense path (``ops/attention.reference_attention``);
- per-row key lengths ``kv_lens`` [b] say that row b's keys are its first
  ``kv_lens[b]`` positions (a right-padded batch, JAX's
  ``right_padded_inputs`` form) and take the flash forward, B1, with
  ``causal=False`` (its plain version on CPU tensors). A row of length 0
  attends nothing and its attention output is zeros.

Without a mask, pad tokens (``pad_token_id``) are masked: as key lengths
when ``right_padded_inputs``, else densely. The serving forward here is
deterministic: dropout belongs to ERNIE training, which the port does not
have yet (ROADMAP Queue A, item 6), and ``deterministic=False`` raises.
Numerics follow the GPT port's: fp32 parameters, activations in the
compute dtype, LayerNorm statistics in fp32, the MLM logits in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fleetx_tpu_torch.models.gpt.model import DTYPES, LayerNorm, _param
from fleetx_tpu_torch.ops.attention import causal_attention
from fleetx_tpu_torch.parallel.tensor_parallel import Dense

__all__ = ["ErnieConfig", "ErnieModel", "ErnieForPretraining",
           "ErnieForSequenceClassification", "ErnieLMHead",
           "ernie_pretraining_loss", "refuse_training"]


@dataclasses.dataclass(frozen=True)
class ErnieConfig:
    """ERNIE hyperparameters (the JAX ``ErnieConfig`` fields the port
    reads; its dropouts and training switches are not here)."""
    vocab_size: int = 40000
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    ffn_hidden_size: Optional[int] = None
    max_position_embeddings: int = 512
    type_vocab_size: int = 4
    initializer_range: float = 0.02
    pad_token_id: int = 0
    hidden_act: str = "gelu_tanh"  # or "gelu" (erf)
    # pad masks derived from the ids become per-row key lengths (the flash
    # forward); only right-padded inputs may set it
    right_padded_inputs: bool = False
    dtype: torch.dtype = torch.bfloat16  # compute dtype; params fp32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def ffn_size(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def gelu_approximate(self) -> str:
        return "none" if self.hidden_act == "gelu" else "tanh"

    @classmethod
    def from_model_config(cls, model_cfg) -> "ErnieConfig":
        """The config from a ``Model`` section: known keys only, None
        values dropped, a dtype given by name."""
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in dict(model_cfg).items()
              if k in known and v is not None}
        if isinstance(kw.get("dtype"), str):
            kw["dtype"] = DTYPES[kw["dtype"]]
        return cls(**kw)


def refuse_training(deterministic: bool, family: str) -> None:
    """The port's encoders serve only: a training forward (dropout, drop
    path) raises until their training slice."""
    if not deterministic:
        raise NotImplementedError(
            f"{family} training (dropout) is not ported yet (ROADMAP Queue "
            "A, item 6: ERNIE and ViT training)")


Masks = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


class ErnieSelfAttention(nn.Module):
    """Bidirectional self-attention over a fused qkv projection (per head
    q | k | v on the last axis, the flax ``[E, nh, 3·hd]`` kernel)."""

    def __init__(self, cfg: ErnieConfig, device=None):
        super().__init__()
        self.cfg = cfg
        nh, hd, e = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size
        self.qkv_proj = Dense(e, nh * 3 * hd, cfg.dtype, device)
        self.out_proj = Dense(nh * hd, e, cfg.dtype, device)

    def forward(self, x: torch.Tensor, masks: Masks) -> torch.Tensor:
        """``masks``: ``(dense [b, 1, 1, s] mask, None)`` or ``(None,
        kv_lens [b])``."""
        b, s, _ = x.shape
        hd = self.cfg.head_dim
        q, k, v = self.qkv_proj(x).view(b, s, -1, 3 * hd).split(hd, dim=-1)
        mask4, kv_lens = masks
        out = causal_attention(q, k, v, causal=False, attn_mask=mask4,
                               kv_lens=kv_lens)
        return self.out_proj(out.reshape(b, s, -1))


class ErnieEncoderLayer(nn.Module):
    """Post-LN layer: norm1(x + attn(x)), then norm2(x + mlp(x))."""

    def __init__(self, cfg: ErnieConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, f = cfg.hidden_size, cfg.ffn_size
        self.attn = ErnieSelfAttention(cfg, device)
        self.norm1 = LayerNorm(e, cfg.dtype, device)
        self.linear1 = Dense(e, f, cfg.dtype, device)
        self.linear2 = Dense(f, e, cfg.dtype, device)
        self.norm2 = LayerNorm(e, cfg.dtype, device)

    def forward(self, x: torch.Tensor, masks: Masks) -> torch.Tensor:
        x = self.norm1(x + self.attn(x, masks))
        y = F.gelu(self.linear1(x), approximate=self.cfg.gelu_approximate)
        return self.norm2(x + self.linear2(y))


class ErnieModel(nn.Module):
    """Embeddings, the encoder and the pooler: ``(sequence [b, s, E],
    pooled [b, E])`` in the compute dtype."""

    def __init__(self, cfg: ErnieConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.hidden_size
        self.word_embeddings = _param(cfg.vocab_size, e, device=device)
        self.position_embeddings = _param(cfg.max_position_embeddings, e,
                                          device=device)
        self.token_type_embeddings = _param(cfg.type_vocab_size, e,
                                            device=device)
        self.embed_norm = LayerNorm(e, cfg.dtype, device)
        self.layers = nn.ModuleDict(
            (str(i), ErnieEncoderLayer(cfg, device))
            for i in range(cfg.num_layers))
        self.pooler = Dense(e, e, cfg.dtype, device)

    def masks(self, input_ids, attention_mask=None, kv_lens=None) -> Masks:
        """The attention mask in its two forms (module docstring): given
        ``kv_lens`` or, from the pad tokens, under
        ``right_padded_inputs``, key lengths; else a dense mask."""
        if kv_lens is not None:
            return None, kv_lens.to(device=input_ids.device,
                                    dtype=torch.int32)
        if attention_mask is None:
            attention_mask = (input_ids != self.cfg.pad_token_id).to(
                torch.int32)
            if self.cfg.right_padded_inputs:
                return None, attention_mask.sum(-1).to(torch.int32)
        return attention_mask[:, None, None, :], None

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, *, kv_lens=None, deterministic=True):
        refuse_training(deterministic, "ERNIE")
        masks = self.masks(input_ids, attention_mask, kv_lens)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            position_ids = torch.arange(
                input_ids.shape[1], device=input_ids.device)[None].expand(
                    input_ids.shape)
        x = (self.word_embeddings[input_ids]
             + self.position_embeddings[position_ids]
             + self.token_type_embeddings[token_type_ids])
        x = self.embed_norm(x.to(self.cfg.dtype))
        for layer in self.layers.values():
            x = layer(x, masks)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class ErnieLMHead(nn.Module):
    """The masked-LM head: the hidden states at ``masked_positions`` [b, P]
    through a dense, gelu and LayerNorm, then fp32 logits [b, P, V] on the
    tied word embedding plus ``decoder_bias``."""

    def __init__(self, cfg: ErnieConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.hidden_size
        self.transform = Dense(e, e, cfg.dtype, device)
        self.transform_norm = LayerNorm(e, cfg.dtype, device)
        self.decoder_bias = _param(cfg.vocab_size, device=device)

    def forward(self, sequence, word_embeddings, masked_positions):
        idx = masked_positions.long()[..., None].expand(
            -1, -1, sequence.shape[-1])
        h = self.transform(sequence.gather(1, idx))
        h = F.gelu(h, approximate=self.cfg.gelu_approximate)
        h = self.transform_norm(h)
        logits = torch.einsum("bph,vh->bpv", h.float(),
                              word_embeddings.float())
        return logits + self.decoder_bias


class ErnieForPretraining(nn.Module):
    """The encoder with its MLM and SOP heads: ``(mlm_logits [b, P, V],
    sop_logits [b, 2])``, both fp32. Without ``masked_positions`` the MLM
    head reads position 0 of every row."""

    def __init__(self, cfg: ErnieConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.ernie = ErnieModel(cfg, device)
        self.lm_head = ErnieLMHead(cfg, device)
        self.sop_head = Dense(cfg.hidden_size, 2, torch.float32, device)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, masked_positions=None, *, kv_lens=None,
                deterministic=True):
        seq, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                                 attention_mask, kv_lens=kv_lens,
                                 deterministic=deterministic)
        if masked_positions is None:
            masked_positions = torch.zeros(input_ids.shape[0], 1,
                                           dtype=torch.long,
                                           device=input_ids.device)
        mlm = self.lm_head(seq, self.ernie.word_embeddings,
                           masked_positions)
        return mlm, self.sop_head(pooled.float())


class ErnieForSequenceClassification(nn.Module):
    """The encoder with an fp32 classifier on the pooled output: logits
    [b, num_classes]."""

    def __init__(self, cfg: ErnieConfig, num_classes: int = 2, device=None):
        super().__init__()
        self.cfg = cfg
        self.num_classes = num_classes
        self.ernie = ErnieModel(cfg, device)
        self.classifier = Dense(cfg.hidden_size, num_classes, torch.float32,
                                device)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, *, kv_lens=None, deterministic=True):
        _, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                               attention_mask, kv_lens=kv_lens,
                               deterministic=deterministic)
        return self.classifier(pooled.float())


def ernie_pretraining_loss(mlm_logits, sop_logits, masked_labels,
                           masked_weights, sop_labels=None):
    """``(lm_loss, sop_loss)``: the weighted masked-token cross-entropy and
    the SOP cross-entropy (zero without ``sop_labels``), fp32 scalars."""
    logp = torch.log_softmax(mlm_logits.float(), dim=-1)
    tok = logp.gather(-1, masked_labels.long()[..., None])[..., 0]
    w = masked_weights.float()
    lm_loss = -(tok * w).sum() / w.sum().clamp_min(1.0)
    if sop_labels is None:
        return lm_loss, torch.zeros((), device=lm_loss.device)
    sop_logp = torch.log_softmax(sop_logits.float(), dim=-1)
    sop = sop_logp.gather(-1, sop_labels.long()[..., None])[..., 0]
    return lm_loss, -sop.mean()
