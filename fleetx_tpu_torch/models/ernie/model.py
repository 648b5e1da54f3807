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
  ``right_padded_inputs`` form) and take the flash kernels, B1 forward
  and B2/B3 backward, with ``causal=False`` (their plain versions on CPU
  tensors). A row of length 0 attends nothing and its attention output
  is zeros.

Without a mask, pad tokens (``pad_token_id``) are masked: as key lengths
when ``right_padded_inputs``, else densely.

The training forward (``deterministic=False``) has JAX's dropouts: after
the embedding LayerNorm (``embed_dropout``), on the attention and MLP
outputs before each residual add (``attn_dropout``, ``ffn_dropout``), the
attention probabilities' (``attention_probs_dropout_prob``, the flash
kernels' hash keyed on the int32 seed, the global batch row and head) and
the classifier's (``cls_dropout``). A hidden dropout is the counter hash
or, at ``fast_dropout: False``, flax's threefry ``nn.Dropout``
(``ops/dropout.dropout_layer``). Every site's seed is drawn from the
caller's ``torch.Generator`` before the first layer runs
(:meth:`ErnieModel.dropout_seeds`), so a layer recomputed in the backward
under ``use_recompute`` (JAX's ``nn.remat`` with ``nothing_saveable``,
:219-225: only the layer's input is kept) draws the forward's masks
again. A ``Shard`` places this rank's rows in the global batch, so that
the hashes key on the global element index and row (data parallelism).
The seeds themselves are the port's own draws, not flax's per-module key
derivation (ROADMAP Queue C, "Model-level dropout streams").
Numerics follow the GPT port's: fp32 parameters, activations in the
compute dtype, LayerNorm statistics in fp32, the MLM logits in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fleetx_tpu_torch.models.gpt.model import DTYPES, LayerNorm, _param
from fleetx_tpu_torch.ops.attention import causal_attention
from fleetx_tpu_torch.ops.dropout import Shard, draw_site, dropout_layer
from fleetx_tpu_torch.parallel.tensor_parallel import Dense

__all__ = ["ErnieConfig", "ErnieModel", "ErnieForPretraining",
           "ErnieForSequenceClassification", "ErnieLMHead",
           "ernie_pretraining_loss", "row_shard"]


@dataclasses.dataclass(frozen=True)
class ErnieConfig:
    """ERNIE hyperparameters (the JAX ``ErnieConfig`` fields but
    ``scan_layers``: the port's layers are always unrolled)."""
    vocab_size: int = 40000
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    ffn_hidden_size: Optional[int] = None
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 4
    initializer_range: float = 0.02
    pad_token_id: int = 0
    hidden_act: str = "gelu_tanh"  # or "gelu" (erf)
    # pad masks derived from the ids become per-row key lengths (the flash
    # forward); only right-padded inputs may set it
    right_padded_inputs: bool = False
    # hash-based hidden dropout (ops/dropout.py); False: flax's threefry
    fast_dropout: bool = True
    use_recompute: bool = False  # each layer recomputed in the backward
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


def row_shard(shard: Optional[Shard], x: torch.Tensor
              ) -> Optional[Shard]:
    """Where a ``[b, n]`` activation (one vector a row) lies in the global
    batch that ``shard`` places this rank's rows in (None: all of it)."""
    if shard is None:
        return None
    return Shard(b0=shard.b0, batch=shard.batch, s0=0, seq=x.shape[1])


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

    def forward(self, x: torch.Tensor, masks: Masks, *,
                deterministic: bool = True, seed: Optional[int] = None,
                shard: Optional[Shard] = None) -> torch.Tensor:
        """``masks``: ``(dense [b, 1, 1, s] mask, None)`` or ``(None,
        kv_lens [b])``; the probabilities' dropout (unless
        ``deterministic``) keyed on ``seed`` and the global batch row."""
        b, s, _ = x.shape
        cfg = self.cfg
        hd, nh = cfg.head_dim, cfg.num_attention_heads
        q, k, v = self.qkv_proj(x).view(b, s, -1, 3 * hd).split(hd, dim=-1)
        mask4, kv_lens = masks
        b0 = 0 if shard is None else shard.b0
        out = causal_attention(q, k, v, causal=False, attn_mask=mask4,
                               kv_lens=kv_lens,
                               dropout_rate=cfg.attention_probs_dropout_prob,
                               seed=seed, deterministic=deterministic,
                               meta=(b0, 0, nh, nh, 0, 0))
        return self.out_proj(out.reshape(b, s, -1))


class ErnieEncoderLayer(nn.Module):
    """Post-LN layer: norm1(x + drop(attn(x))), then
    norm2(x + drop(mlp(x)))."""

    def __init__(self, cfg: ErnieConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, f = cfg.hidden_size, cfg.ffn_size
        self.attn = ErnieSelfAttention(cfg, device)
        self.attn_dropout = dropout_layer(cfg.hidden_dropout_prob,
                                          cfg.fast_dropout)
        self.norm1 = LayerNorm(e, cfg.dtype, device)
        self.linear1 = Dense(e, f, cfg.dtype, device)
        self.linear2 = Dense(f, e, cfg.dtype, device)
        self.ffn_dropout = dropout_layer(cfg.hidden_dropout_prob,
                                         cfg.fast_dropout)
        self.norm2 = LayerNorm(e, cfg.dtype, device)

    def forward(self, x: torch.Tensor, masks: Masks, *,
                deterministic: bool = True, seeds=(None, None, None),
                shard: Optional[Shard] = None) -> torch.Tensor:
        """``seeds``: the attention's, ``attn_dropout``'s and
        ``ffn_dropout``'s draws (:meth:`ErnieModel.dropout_seeds`)."""
        attn_seed, attn_drop, ffn_drop = seeds
        y = self.attn(x, masks, deterministic=deterministic, seed=attn_seed,
                      shard=shard)
        y = self.attn_dropout(y, deterministic, seed=attn_drop, shard=shard)
        x = self.norm1(x + y)
        y = F.gelu(self.linear1(x), approximate=self.cfg.gelu_approximate)
        y = self.ffn_dropout(self.linear2(y), deterministic, seed=ffn_drop,
                             shard=shard)
        return self.norm2(x + y)


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
        self.embed_dropout = dropout_layer(cfg.hidden_dropout_prob,
                                           cfg.fast_dropout)
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

    def dropout_seeds(self, deterministic: bool,
                      generator: Optional[torch.Generator]):
        """``(embed_dropout's draw, [(attention, attn_dropout, ffn_dropout
        draws) per layer])`` for one training forward, drawn from
        ``generator`` in the order the sites run (None where a site draws
        nothing; ``ops/dropout.draw_site``). Drawn before any layer runs:
        a layer recomputed in the backward reuses its forward's masks, and
        the generator's stream is the same with recompute on or off."""
        cfg = self.cfg
        hidden = dict(hidden=True, fast=cfg.fast_dropout,
                      deterministic=deterministic)
        rate = cfg.hidden_dropout_prob
        embed = draw_site(generator, rate, **hidden)
        layers = [(draw_site(generator, cfg.attention_probs_dropout_prob,
                             hidden=False, deterministic=deterministic),
                   draw_site(generator, rate, **hidden),
                   draw_site(generator, rate, **hidden))
                  for _ in range(cfg.num_layers)]
        return embed, layers

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, *, kv_lens=None, deterministic=True,
                generator: Optional[torch.Generator] = None,
                shard: Optional[Shard] = None):
        """The encoder; unless ``deterministic``, with every dropout, its
        seeds drawn from ``generator``; ``shard`` places the rows in the
        global batch."""
        cfg = self.cfg
        masks = self.masks(input_ids, attention_mask, kv_lens)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            position_ids = torch.arange(
                input_ids.shape[1], device=input_ids.device)[None].expand(
                    input_ids.shape)
        embed_seed, layer_seeds = self.dropout_seeds(deterministic,
                                                     generator)
        x = (self.word_embeddings[input_ids]
             + self.position_embeddings[position_ids]
             + self.token_type_embeddings[token_type_ids])
        x = self.embed_norm(x.to(cfg.dtype))
        x = self.embed_dropout(x, deterministic, seed=embed_seed,
                               shard=shard)
        recompute = cfg.use_recompute and torch.is_grad_enabled()
        for layer, seeds in zip(self.layers.values(), layer_seeds):
            kw = dict(deterministic=deterministic, seeds=seeds, shard=shard)
            if recompute:
                # the seeds come in, so the rerun needs no RNG state
                x = checkpoint(layer, x, masks, use_reentrant=False,
                               preserve_rng_state=False, **kw)
            else:
                x = layer(x, masks, **kw)
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
                deterministic=True,
                generator: Optional[torch.Generator] = None,
                shard: Optional[Shard] = None):
        seq, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                                 attention_mask, kv_lens=kv_lens,
                                 deterministic=deterministic,
                                 generator=generator, shard=shard)
        if masked_positions is None:
            masked_positions = torch.zeros(input_ids.shape[0], 1,
                                           dtype=torch.long,
                                           device=input_ids.device)
        mlm = self.lm_head(seq, self.ernie.word_embeddings,
                           masked_positions)
        return mlm, self.sop_head(pooled.float())


class ErnieForSequenceClassification(nn.Module):
    """The encoder with an fp32 classifier on the pooled output, after its
    ``cls_dropout`` (whose draw follows the encoder's): logits [b,
    num_classes]."""

    def __init__(self, cfg: ErnieConfig, num_classes: int = 2, device=None):
        super().__init__()
        self.cfg = cfg
        self.num_classes = num_classes
        self.ernie = ErnieModel(cfg, device)
        self.cls_dropout = dropout_layer(cfg.hidden_dropout_prob,
                                         cfg.fast_dropout)
        self.classifier = Dense(cfg.hidden_size, num_classes, torch.float32,
                                device)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, *, kv_lens=None, deterministic=True,
                generator: Optional[torch.Generator] = None,
                shard: Optional[Shard] = None):
        cfg = self.cfg
        _, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                               attention_mask, kv_lens=kv_lens,
                               deterministic=deterministic,
                               generator=generator, shard=shard)
        seed = draw_site(generator, cfg.hidden_dropout_prob, hidden=True,
                         fast=cfg.fast_dropout, deterministic=deterministic)
        pooled = self.cls_dropout(pooled, deterministic, seed=seed,
                                  shard=row_shard(shard, pooled))
        return self.classifier(pooled.float())


def ernie_pretraining_loss(mlm_logits, sop_logits, masked_labels,
                           masked_weights, sop_labels=None, group=None):
    """``(lm_loss, sop_loss)``: the weighted masked-token cross-entropy and
    the SOP cross-entropy (zero without ``sop_labels``), fp32 scalars.

    With ``group`` (a process group whose ranks hold equal shares of one
    batch's rows: the data group) each is this rank's share of the global
    loss, summed over the group it is JAX's over the whole batch: the
    weighted sum over the group's summed weights, and the SOP sum over
    the group's rows (one all-reduce of the two counts)."""
    logp = torch.log_softmax(mlm_logits.float(), dim=-1)
    tok = logp.gather(-1, masked_labels.long()[..., None])[..., 0]
    w = masked_weights.float()
    counts = torch.stack([w.sum(), torch.tensor(
        float(sop_logits.shape[0]), device=w.device)])
    if group is not None:
        dist.all_reduce(counts, group=group)
    lm_loss = -(tok * w).sum() / counts[0].clamp_min(1.0)
    if sop_labels is None:
        return lm_loss, torch.zeros((), device=lm_loss.device)
    sop_logp = torch.log_softmax(sop_logits.float(), dim=-1)
    sop = sop_logp.gather(-1, sop_labels.long()[..., None])[..., 0]
    if group is None:
        return lm_loss, -sop.mean()
    return lm_loss, -sop.sum() / counts[1]
