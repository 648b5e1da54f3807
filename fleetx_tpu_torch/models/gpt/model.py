"""GPT for the port: the training forward and the cached serving forward.

Port of the JAX package's GPT (models/gpt/model.py). Two forwards share
the modules:

- the no-cache training forward (``cache=None``): causal self-attention
  through ``causal_attention`` — the flash kernels — with hash dropout on
  the embeddings, after attention and after the MLP, seeded from an
  explicit ``torch.Generator``; :func:`pretraining_loss` on its logits;
- the cached forward the decode paths take — a multi-token prefill call
  or a single-token decode step writing K/V into the decode cache: the
  contiguous ``[L, b, cache_len, h, d]`` buffers of one-shot
  ``generate()``, or the shared page pools of the serving engine; at
  ``decode_kv_dtype="int8"`` either stores int8 with fp32 scales.

The training forward recomputes each layer in the backward under
``use_recompute`` (the JAX ``_remat_policy``, :738-760), keeping the
layer's input and the tensors its granularity and
``recompute_extra_saves`` name (:func:`recompute_policy`), except the
layers in ``no_recompute_layers``; with ``fused_ce`` and labels,
:class:`GPTForPretraining` returns per-token losses through the fused
LM-head cross-entropy (``ops/ce_loss.py``, B4–B6) instead of logits.
Under ``cp_degree > 1`` the training forward's attention goes around the
cp ring (``parallel/context_parallel.py``, B11) on this rank's zig-zag
share of the sequence; a :class:`~fleetx_tpu_torch.ops.dropout.Shard`
gives the global batch and sequence offsets that the dropout hashes read
when the batch or the sequence is split over ranks. Under ``mp_degree >
1`` (tensor parallelism, ``parallel/tensor_parallel.py``) each rank holds
``heads/mp`` heads of every attention (the fused qkv rows of its heads,
or its rows of q, k and v, and the out_proj columns), ``ffn/mp`` columns
of every MLP and ``vocab/mp`` rows of the word embeddings; the
activations between the layers are replicated over the mp group, or
under ``sequence_parallel`` split along the sequence (each rank's ``[b,
s/mp, h]``: the embeddings' output, the LayerNorms, dropouts and
residuals, the final norm; Megatron sequence parallelism), and the
training forward returns this rank's vocab shard of the logits (or, with
``fused_ce``, the per-token losses through the vocab-parallel form B12)
over the whole sequence. The cached forward runs under mp too (mesh
serving): each rank writes and reads its ``heads/mp`` heads of the
decode cache (B7–B10 on those heads) and returns its vocab shard of the
logits, which :func:`serving_logits` all-gathers. Under ``pp_degree > 1``
(pipeline parallelism, ``parallel/pipeline.py``) a model is one stage's:
its chunks of the decoder layers (each layer keeps its global index in
its name and its dropout seeds), the embeddings on the first stage, the
final LayerNorm and the tied LM head on the last, which holds its own
copy of the word embedding; the trainer sums the two copies' gradients.
Under ``expert_mode`` (``num_experts > 1``) each decoder layer's MLP is
an :class:`~fleetx_tpu_torch.parallel.moe.MoEMLP` (GShard/Switch routing
over stacked experts), whose experts split over the data ranks
(``ep_world``: expert parallelism); the training forward collects each
layer's balance loss (:attr:`GPTModel.balance_losses`). The cached
forward of an MoE model raises ``NotImplementedError`` ("MoE serving").

The hidden dropouts are the counter hash (``fast_dropout``, the default)
or flax's threefry ``nn.Dropout`` (``fast_dropout: False``,
``ops/dropout.FlaxDropout``). ``fuse_attn_qkv: False`` holds q, k and v
as three column-parallel projections (JAX ``q_proj``/``k_proj``/
``v_proj``; ``convert.convert_qkv_layout`` maps the trees).

A model built with ``int8=True`` (int8 serving weights, the serving
engine's) holds every dense kernel and embedding table as int8 values
with fp32 per-channel scales (``ops/quant.py``) and dequantizes each on
its call, fp32 then the compute dtype.

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
the JAX layout ``[b, s, h, d]``; the decode cache is a dict of tensors
stacked over the layers (``models/gpt/generation.py`` builds it).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fleetx_tpu_torch.ops.attention import (
    causal_attention,
    reference_attention,
)
from fleetx_tpu_torch.ops.decode_attention import (
    decode_attention,
    fit_decode_blocks,
    paged_decode_attention,
    paged_gather_kv,
)
from fleetx_tpu_torch.ops.ce_loss import fused_linear_ce
from fleetx_tpu_torch.ops.dropout import (
    Shard,
    draw_key,
    draw_site,
    dropout_layer,
)
from fleetx_tpu_torch.ops.quant import (
    dequantize_int8,
    dequantize_kv,
    quantize_kv,
)
from fleetx_tpu_torch.parallel.context_parallel import ring_self_attention
from fleetx_tpu_torch.parallel.mesh import get_mesh
from fleetx_tpu_torch.parallel.moe import MoEMLP
from fleetx_tpu_torch.parallel.pipeline import stage_chunks, stage_layers
from fleetx_tpu_torch.parallel.tensor_parallel import (
    ColumnParallelDense,
    Dense,
    RowParallelDense,
    copy_to_mp,
    current_mp_group,
    gather_from_sequence,
    gather_vocab,
    vocab_parallel_embedding,
)

__all__ = ["DTYPES", "GPTConfig", "GPTForPretraining", "GPTModel",
           "DecoderLayer", "SelfAttention", "MLP", "Dense", "LayerNorm",
           "inference_params", "masked_loss_mean", "pad_starts",
           "serving_logits",
           "pretraining_loss", "recompute_policy", "refuse_moe_serving",
           "sequence_shard",
           "token_losses", "CHECKPOINT_NAMES"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """GPT hyperparameters (the JAX ``GPTConfig`` fields the port reads).
    ``decode_*`` shape the decode cache: with ``decode_num_pages`` set it
    is paged — ``decode_num_pages`` pages of ``decode_page_size``
    positions shared by all rows, each row addressing a logical window of
    ``decode_cache_len`` positions — else contiguous, one buffer per row.
    ``decode_kv_dtype="int8"`` stores K/V as int8 with one fp32 scale per
    (position, head) vector, quantized on write. Under ``mp_degree > 1``
    a decode-configured model (``decode_cache_len``
    set: the serving engine's copy) keeps the whole word table on every
    rank when mp does not divide the vocab (:attr:`vocab_split`)."""
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
    sequence_parallel: bool = False  # at mp > 1: activations split on s
    fast_dropout: bool = True  # False: flax's threefry nn.Dropout
    use_flash_attention: bool = True
    dtype: torch.dtype = torch.bfloat16  # compute dtype; params fp32
    decode_cache_len: Optional[int] = None
    decode_num_pages: Optional[int] = None
    decode_page_size: Optional[int] = None
    decode_kv_dtype: Optional[str] = None  # None (compute dtype) | "int8"
    use_recompute: bool = False
    recompute_granularity: Optional[str] = None  # full | full_attn | core_attn
    recompute_extra_saves: Optional[Tuple[str, ...]] = None  # CHECKPOINT_NAMES
    no_recompute_layers: Optional[Tuple[int, ...]] = None
    fused_ce: bool = False  # per-token loss through B4–B6, logits never stored
    cp_degree: int = 1  # > 1: attention around the cp ring (zig-zag inputs)
    mp_degree: int = 1  # > 1: heads, MLP and vocab split over the mp group
    pp_degree: int = 1  # > 1: the decoder layers split over pp stages
    num_microbatches: int = 1  # under pp: microbatches per step
    virtual_pp_degree: int = 1  # under pp: layer chunks per stage
    # MoE (parallel/moe.py), the JAX fields and defaults (model.py:78-96)
    num_experts: int = 1
    expert_mode: bool = False  # set by from_model_config at num_experts > 1
    gate: str = "gshard"  # naive | gshard | switch
    top_k: int = 2
    capacity_factor: float = 1.2
    # auto | einsum | scatter: validated, one index path computes them all,
    # so two configs that differ only here compute the same model
    moe_dispatch: str = dataclasses.field(default="auto", compare=False)
    balance_loss_weight: float = 0.01

    def __post_init__(self):
        stage_chunks(self.num_layers, self.pp_degree, self.virtual_pp)
        if self.sp and self.cp_degree > 1:
            # JAX maps act_seq to ("cp", "mp") (parallel/sharding.py:82)
            raise NotImplementedError(
                "Model.sequence_parallel with cp_degree > 1 is not ported "
                "yet (ROADMAP Queue A, \"Sequence parallel under cp\")")
        mp = self.mp_degree
        for name, size in (("num_attention_heads", self.num_attention_heads),
                           ("ffn_hidden_size", self.ffn_size),
                           ("vocab_size", self.vocab_size)):
            if name == "vocab_size" and self.decode_cache_len is not None:
                continue  # serving keeps a table mp does not divide whole
            if size % mp:
                raise ValueError(f"{name} {size} does not split over "
                                 f"mp_degree {mp}")

    @property
    def sp(self) -> bool:
        """Whether the activations are split along the sequence (Megatron
        sequence parallelism: the switch at mp > 1)."""
        return self.sequence_parallel and self.mp_degree > 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def vocab_split(self) -> bool:
        """Whether the word table (and the logits) are split over mp by
        vocab rows: at mp > 1 when mp divides the vocab (JAX's serving
        spec drops the axis otherwise, ``_fit_spec``)."""
        return self.mp_degree > 1 and self.vocab_size % self.mp_degree == 0

    @property
    def ffn_size(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def virtual_pp(self) -> int:
        """Layer chunks per stage: the virtual degree under pp (JAX reads
        it only then), 1 otherwise."""
        return max(self.virtual_pp_degree, 1) if self.pp_degree > 1 else 1

    @property
    def cache_len(self) -> int:
        """Logical positions a row can address in the decode cache."""
        return self.decode_cache_len or self.max_position_embeddings

    @classmethod
    def from_model_config(cls, model_cfg) -> "GPTConfig":
        """Build from a YAML ``Model`` section: a dtype string mapped to its
        torch dtype, list values of ``no_recompute_layers`` and
        ``recompute_extra_saves`` (or a ``"a,b"`` string) made tuples, and
        ``expert_mode`` set when ``num_experts`` is above 1, as the JAX
        ``from_model_config`` does. Keys that are no field of the JAX
        ``GPTConfig`` either (``module``, ``name``, ...) and the JAX
        switches that only lay the model out over devices (``scan_layers``,
        the pipeline tuning knobs) are ignored."""
        model_cfg = dict(model_cfg)
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in model_cfg.items()
              if k in known and v is not None}
        if isinstance(kw.get("dtype"), str):
            kw["dtype"] = DTYPES[kw["dtype"]]
        saves = kw.get("recompute_extra_saves")
        if isinstance(saves, str):
            kw["recompute_extra_saves"] = [x for x in saves.split(",") if x]
        for key in ("no_recompute_layers", "recompute_extra_saves"):
            if key in kw:
                kw[key] = tuple(kw[key])
        if (model_cfg.get("num_experts") or 1) > 1:
            kw["expert_mode"] = True
        return cls(**kw)


# every tensor a save-set can name (JAX ``_CHECKPOINT_NAMES``, :733-735),
# in the order the decoder layer makes them
CHECKPOINT_NAMES = ("qkv_out", "core_attn_out", "attn_out", "ffn_gelu",
                    "mlp_out")


def recompute_policy(cfg: GPTConfig) -> Optional[frozenset]:
    """The training forward's save-set (JAX ``_remat_policy``,
    :738-760): None without ``use_recompute``, else the named tensors each
    recomputed layer keeps for its backward besides its input:

    - ``full`` (the default): none; the layer reruns its whole forward;
    - ``full_attn``: ``attn_out``, the attention block's output after
      out_proj; the backward reruns the attention block (norm1, the q/k/v
      projection, B1, out_proj) and, from attn_out, the MLP block;
    - ``core_attn``: ``core_attn_out``, the attention's output before
      out_proj; the backward reruns norm1, the projection and B1, and
      from core_attn_out the rest of the layer;

    plus ``recompute_extra_saves`` (any of :data:`CHECKPOINT_NAMES`, on
    any granularity). Under ``expert_mode`` ``ffn_gelu`` and ``mlp_out``
    name no tensor (JAX's ``MoEMLP`` tags neither) and are dropped from
    the set: the MoE block is kept or rerun whole. The layer's forward is cut into segments at the
    kept tensors and each segment runs under ``torch.utils.checkpoint``
    (``DecoderLayer``): a segment's inputs are what is kept. B1's lse is
    not kept with ``core_attn_out`` (the flash forward's residuals are
    internal to the kernel's autograd function, as in JAX's custom VJP),
    so B1 reruns in the backward under every granularity, as under
    ``full``: 2 launches per layer per microbatch, against 1 without
    recompute. An unknown save name or granularity raises ``ValueError``."""
    if not cfg.use_recompute:
        return None
    granularity = cfg.recompute_granularity or "full"
    extra = tuple(cfg.recompute_extra_saves or ())
    unknown = set(extra) - set(CHECKPOINT_NAMES)
    if unknown:
        raise ValueError(
            f"recompute_extra_saves {sorted(unknown)} match no "
            f"checkpoint_name site; known: {sorted(CHECKPOINT_NAMES)}")
    base = {"full": (), "full_attn": ("attn_out",),
            "core_attn": ("core_attn_out",)}
    if granularity not in base:
        raise ValueError(f"unknown recompute_granularity {granularity!r}")
    saves = frozenset(base[granularity] + extra)
    return saves - _MLP_NAMES if cfg.expert_mode else saves


_MLP_NAMES = frozenset({"ffn_gelu", "mlp_out"})  # the dense MLP's tensors


def sequence_shard(shard: Optional[Shard], b: int, s_loc: int, mp: int,
                   mp_rank: int) -> Shard:
    """Where this rank's ``[b, s/mp]`` sequence shard lies in the global
    activation, for the hidden dropouts under sequence parallelism: its
    rows as ``shard`` places them (all of them when None), positions from
    ``mp_rank · s/mp``, so that the mask is the slice of the one an
    unsplit activation draws."""
    if shard is None:
        shard = Shard(b0=0, batch=b, s0=0, seq=s_loc * mp)
    return Shard(b0=shard.b0, batch=shard.batch,
                 s0=shard.s0 + mp_rank * s_loc, seq=shard.seq)


def _param(*shape, device) -> nn.Parameter:
    # weights come from init_params / params_from_jax, never from here
    return nn.Parameter(torch.empty(*shape, device=device))


def _scale_rows(int8: bool, channels: int) -> Optional[int]:
    """A dense layer's ``scale_rows`` (``tensor_parallel.Dense``): its int8
    channels over the whole layer, None for float weights."""
    return channels if int8 else None


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
    """Self-attention: causal over the call's own tokens (the JAX
    ``SelfAttention`` no-cache branch, model.py:310-332) or over the
    decode cache (its decode branch, :213-286): single-query steps go to
    the decode kernels — B7/B9 on the contiguous cache, B8/B10 on the
    paged pool — and every other cached call to the dense masked path.
    The projection is one fused qkv (``fuse_attn_qkv``) or q, k and v
    apart (JAX :202-210); the cache holds K and V either way."""

    def __init__(self, cfg: GPTConfig, device=None, int8: bool = False,
                 fp32_partials: bool = False):
        super().__init__()
        self.cfg = cfg
        nh, hd, e = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size
        mp, sp = cfg.mp_degree, cfg.sp
        if cfg.fuse_attn_qkv:
            # a heads shard of the fused qkv is a contiguous block of rows:
            # each head's q | k | v rows are adjacent; its int8 channels
            # are the 3·hd of one head, shared by the heads
            self.qkv_proj = ColumnParallelDense(
                e, nh * 3 * hd, mp, cfg.dtype, device, sp,
                _scale_rows(int8, 3 * hd))
        else:
            self.q_proj, self.k_proj, self.v_proj = (
                ColumnParallelDense(e, nh * hd, mp, cfg.dtype, device, sp,
                                    _scale_rows(int8, hd))
                for _ in range(3))
        self.out_proj = RowParallelDense(nh * hd, e, mp, cfg.dtype, device,
                                         sp, _scale_rows(int8, e),
                                         fp32_partials)

    def qkv(self, x: torch.Tensor):
        """``(q, k, v)`` [b, s, heads/mp, d] of ``x`` [b, s(/mp), E] (the
        JAX ``qkv_out``; under sequence parallelism over the gathered
        sequence)."""
        hd = self.cfg.head_dim
        if self.cfg.fuse_attn_qkv:
            qkv = self.qkv_proj(x)
            b, s = qkv.shape[:2]
            # per head the last axis holds q | k | v (flax [E, nh, 3hd])
            return qkv.view(b, s, -1, 3 * hd).split(hd, dim=-1)
        x = self.q_proj.take_input(x)  # one gather (or copy) for all three
        b, s = x.shape[:2]
        return tuple(Dense.forward(proj, x).view(b, s, -1, hd)
                     for proj in (self.q_proj, self.k_proj, self.v_proj))

    def core(self, q, k, v, *, deterministic=True,
             seed: Optional[int] = None, shard: Optional[Shard] = None,
             kv_mask=None) -> torch.Tensor:
        """Causal attention of the training forward (the JAX
        ``core_attn_out``), with attention dropout (unless
        ``deterministic``) keyed on the int32 ``seed`` and the global batch
        row ``shard.b0 + b``; under ``cp_degree > 1`` around the cp ring,
        q, k, v being this rank's zig-zag share of the sequence (JAX
        model.py:287-305)."""
        cfg = self.cfg
        nh_loc = q.shape[2]
        rate = cfg.attention_probs_dropout_prob
        b0 = 0 if shard is None else shard.b0
        # the global id of this rank's first head keys the dropout hash,
        # as JAX ``_sharded_flash`` builds its meta (:906-950)
        h0 = get_mesh().mp_rank * nh_loc
        nh = cfg.num_attention_heads
        if cfg.cp_degree > 1:
            if kv_mask is not None:
                raise NotImplementedError("context parallelism does not "
                                          "support a custom attn_mask")
            return ring_self_attention(
                q, k, v, causal=True, expected_cp=cfg.cp_degree,
                dropout_rate=0.0 if deterministic else rate, seed=seed,
                batch_offset=b0, head_offset=h0, heads_total=nh)
        return causal_attention(q, k, v, causal=True, dropout_rate=rate,
                                seed=seed, deterministic=deterministic,
                                use_flash=cfg.use_flash_attention,
                                meta=(b0, h0, nh_loc, nh, 0, 0))

    def forward(self, x, cache=None, *, cache_index=None,
                cache_positions=None, block_tables=None, kv_mask=None,
                kv_starts=None, decode_end=None, deterministic=True,
                seed: Optional[int] = None, shard: Optional[Shard] = None):
        """``x`` [b, s, E]. Without ``cache``: causal attention over the s
        tokens, with attention dropout (unless ``deterministic``) keyed on
        the int32 ``seed``, keyed on the global batch row ``shard.b0 +
        b``; under ``cp_degree > 1`` around the cp ring, x being this
        rank's zig-zag share of the sequence (JAX model.py:287-305). With
        ``cache`` (this layer's ``key``/``value`` and,
        at int8, ``key_scale``/``value_scale`` tensors): write the s new
        K/V, then attend. Row b writes at ``cache_positions[b]`` when
        given, else every row at ``cache_index``; paged caches route the
        writes through ``block_tables`` [b, n_logical]. Query i of row b
        attends cache positions ``<=`` its own, restricted by ``kv_mask``
        [b, 1, 1, cache_len] (True = a real token) when given.
        ``decode_end`` [b] int32 marks a single-query step: each row's
        live length after this step's write, the decode kernels' window
        end; ``kv_starts`` [b] is the window start, the mask's first True
        (:func:`pad_starts`)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = self.qkv(x)
        if cache is None:
            return self._out_proj(self.core(
                q, k, v, deterministic=deterministic, seed=seed,
                shard=shard, kv_mask=kv_mask))
        paged = cfg.decode_num_pages is not None
        quant = "key_scale" in cache
        if paged:
            self._update_paged_cache(k, v, cache, cache_positions,
                                     block_tables)
            page_size = cache["key"].shape[1]
            length = block_tables.shape[1] * page_size
        else:
            self._update_cache(k, v, cache, cache_index, cache_positions)
            page_size, length = None, cache["key"].shape[1]
        if decode_end is not None and self._takes_decode_kernel(
                q.is_cuda, kv_mask, length, page_size):
            # single-query step: B7/B9 read only the window [kv_starts,
            # end) of each row, B8/B10 only each row's live pages
            kw = dict(end=decode_end, starts=kv_starts,
                      k_scale=cache.get("key_scale"),
                      v_scale=cache.get("value_scale"))
            if paged:
                kw["tables"] = block_tables
                fn = paged_decode_attention
            else:
                fn = decode_attention
            out = fn(q.contiguous(), cache["key"], cache["value"], **kw)
            return self._out_proj(out)
        # everything else: dense attention under the absolute-position
        # mask, over each row's logical buffer (gathered from the pages)
        names = ("key", "value") + (("key_scale", "value_scale")
                                    if quant else ())
        parts = [paged_gather_kv(cache[n], block_tables) if paged
                 else cache[n] for n in names]
        k_all, v_all = parts[:2]
        if quant:
            k_all = dequantize_kv(k_all, parts[2], q.dtype)
            v_all = dequantize_kv(v_all, parts[3], q.dtype)
        offsets = torch.arange(s, device=x.device)
        q_pos = (int(cache_index) + offsets if cache_positions is None
                 else cache_positions.long()[:, None] + offsets)  # [(b,) s]
        k_pos = torch.arange(length, device=x.device)
        mask = (k_pos <= q_pos[..., None]).reshape(-1, 1, s, length)
        if kv_mask is not None:
            mask = kv_mask.bool() & mask
        return self._out_proj(reference_attention(q, k_all, v_all, mask))

    def _out_proj(self, out: torch.Tensor) -> torch.Tensor:
        b, s = out.shape[:2]
        return self.out_proj(out.reshape(b, s, -1))

    def _takes_decode_kernel(self, on_card: bool, kv_mask, length: int,
                             page_size: Optional[int] = None) -> bool:
        """Whether a single-query step over ``length`` cache positions goes
        to the decode kernels, else to the dense path.

        On the card it always does: a ``kv_mask`` the kernels cannot read
        raises here, and a cache no 8-row tile divides raises in the
        wrapper. On the CPU the step takes the path the JAX model's
        ``_flash_decode_ok`` (:559) picks, so that the parity tests hold
        each path against its JAX counterpart: the kernels' plain version
        under ``use_flash_attention`` with an absent or ``[b, 1, 1,
        length]`` mask over a buffer (the cache, or the page) that an 8-row
        tile divides."""
        mask_ok = kv_mask is None or (kv_mask.dim() == 4 and tuple(
            kv_mask.shape[1:]) == (1, 1, length))
        if on_card:
            if not mask_ok:
                raise ValueError(
                    f"the decode kernels read a [b, 1, 1, {length}] key "
                    f"mask, got {tuple(kv_mask.shape)}")
            return True
        return (self.cfg.use_flash_attention and mask_ok
                and fit_decode_blocks(page_size or length)[0] is not None)

    @staticmethod
    def _quantized(k, v, cache):
        """This call's K/V as the cache stores them: ``[(name, values)]``,
        with int8 values and their fp32 scales when the cache is int8."""
        if "key_scale" not in cache:
            return [("key", k), ("value", v)]
        k_w, k_s = quantize_kv(k)
        v_w, v_s = quantize_kv(v)
        return [("key", k_w), ("value", v_w), ("key_scale", k_s),
                ("value_scale", v_s)]

    def _update_cache(self, k, v, cache, cache_index, cache_positions):
        """Write this call's K/V into the contiguous cache ``[b,
        cache_len, h, *]`` (JAX ``_update_cache``, :339-459).

        Without ``cache_positions`` every row writes at the scalar
        ``cache_index``; with them row b writes at ``cache_positions[b]``.
        A write that would overhang the buffer is shifted back to end at
        its last slot, as ``dynamic_update_slice`` clamps its start. The
        cache is updated in place (the JAX module returns new leaves)."""
        b, s = k.shape[:2]
        max_len = cache["key"].shape[1]
        writes = self._quantized(k, v, cache)
        if cache_positions is None:
            at = min(max(int(cache_index), 0), max_len - s)
            for name, t in writes:
                cache[name][:, at:at + s] = t
            return
        at = (cache_positions.long().clamp(0, max_len - s)[:, None]
              + torch.arange(s, device=k.device))  # [b, s]
        rows = torch.arange(b, device=k.device)[:, None]
        for name, t in writes:
            cache[name][rows, at] = t

    def _update_paged_cache(self, k, v, cache, cache_positions,
                            block_tables):
        """Scatter this call's K/V (and, at int8, their scales) into the
        page pools (JAX ``_update_paged_cache``, :461-557).

        Positions clamp to the logical capacity: bucket-tail and inactive-
        lane writes land on a row's last logical slot or, through a zeroed
        table entry, on the trash page 0 — beyond every live window. The
        pools are updated in place (the JAX module returns new pools)."""
        cfg = self.cfg
        b, s, nh, hd = k.shape
        ps = cache["key"].shape[1]
        max_len = cfg.cache_len
        if ps % 8 or max_len % ps:
            raise ValueError(
                f"page_size {ps} must be a multiple of 8 and divide the "
                f"cache length {max_len}")
        if cache_positions is None or block_tables is None:
            raise ValueError("a paged decode cache needs cache_positions "
                             "AND block_tables")
        pos = (cache_positions.long()[:, None]
               + torch.arange(s, device=k.device)).clamp_max(max_len - 1)
        page = block_tables.long().gather(1, pos // ps).reshape(-1)
        slot = (pos % ps).reshape(-1)
        for name, t in self._quantized(k, v, cache):
            cache[name][page, slot] = t.reshape(b * s, nh, -1)


def refuse_moe_serving(cfg: GPTConfig) -> None:
    """Raise ``NotImplementedError`` naming "MoE serving" for an
    ``expert_mode`` model: no decode path (the cached forward,
    ``generate()``, the serving engine) runs one."""
    if cfg.expert_mode:
        raise NotImplementedError(
            "decoding an MoE model is not ported yet (ROADMAP Queue A, "
            "\"MoE serving\")")


def pad_starts(kv_mask: torch.Tensor) -> torch.Tensor:
    """Per-row first live cache position, int32 [b], from the ``[b, 1, 1,
    cache_len]`` key-validity mask (JAX ``_pad_starts``, :620-638): the
    first True, so left pads before it are outside the decode window and a
    right-padded mask is exact too."""
    return kv_mask[:, 0, 0, :].to(torch.int32).argmax(-1).to(torch.int32)


class MLP(nn.Module):
    """up_proj → tanh-approximated gelu → down_proj."""

    def __init__(self, cfg: GPTConfig, device=None, int8: bool = False,
                 fp32_partials: bool = False):
        super().__init__()
        mp, sp = cfg.mp_degree, cfg.sp
        self.up_proj = ColumnParallelDense(
            cfg.hidden_size, cfg.ffn_size, mp, cfg.dtype, device, sp,
            _scale_rows(int8, cfg.ffn_size))
        self.down_proj = RowParallelDense(
            cfg.ffn_size, cfg.hidden_size, mp, cfg.dtype, device, sp,
            _scale_rows(int8, cfg.hidden_size), fp32_partials)

    def gelu(self, x: torch.Tensor) -> torch.Tensor:
        """gelu(up_proj(x)) (the JAX ``ffn_gelu``)."""
        return F.gelu(self.up_proj(x), approximate="tanh")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(self.gelu(x))


def _dropout(cfg: GPTConfig) -> nn.Module:
    """A hidden dropout: the counter hash, or flax's threefry
    ``nn.Dropout`` at ``fast_dropout: False`` (JAX ``_dropout``,
    model.py:656-661)."""
    return dropout_layer(cfg.hidden_dropout_prob, cfg.fast_dropout)


class DecoderLayer(nn.Module):
    """Pre-LN decoder layer: x + drop(attn(norm1(x))), then
    + drop(mlp(norm2(x))).

    The training forward is six stages, the first five ending at the
    tensor JAX names (``CHECKPOINT_NAMES``): the q/k/v projection
    (``qkv_out``), attention (``core_attn_out``), out_proj
    (``attn_out``), the residual then norm2, up_proj and gelu
    (``ffn_gelu``), down_proj (``mlp_out``), and the MLP dropout; the
    last residual add follows them. Under ``expert_mode`` the fourth
    stage runs norm2 and the whole :class:`MoEMLP` and the fifth passes
    its output on. Under recompute the stages run in segments that end
    at the saved names, each under ``torch.utils.checkpoint``: the
    backward keeps each segment's inputs — the layer's input and the
    saved tensors — and reruns the rest; a rerun MoE block routes with
    the forward's key and records no second balance loss."""

    def __init__(self, cfg: GPTConfig, device=None, int8: bool = False,
                 fp32_partials: bool = False, ep_world: int = 1):
        super().__init__()
        self.cfg = cfg
        self.norm1 = LayerNorm(cfg.hidden_size, cfg.dtype, device)
        self.attn = SelfAttention(cfg, device, int8, fp32_partials)
        self.attn_dropout = _dropout(cfg)
        self.norm2 = LayerNorm(cfg.hidden_size, cfg.dtype, device)
        if cfg.expert_mode:
            self.moe_mlp = MoEMLP(cfg, device, ep_world)
        else:
            self.mlp = MLP(cfg, device, int8, fp32_partials)
        self.mlp_dropout = _dropout(cfg)

    def forward(self, x, cache=None, *, deterministic=True,
                seeds=(None, None, None, None),
                shard: Optional[Shard] = None,
                saves: Optional[frozenset] = None,
                aux: Optional[dict] = None, **decode):
        """``seeds``: the dropout seeds (keys at ``fast_dropout: False``)
        of the attention, attn_dropout and mlp_dropout, and the MoE
        routing key (see :meth:`GPTModel.dropout_seeds`); ``shard``: where
        x lies in the global activation; ``saves``: the training forward's
        save-set (:func:`recompute_policy`; None runs it without
        recompute); ``aux``: where an MoE layer records its balance loss
        (keyed by the layer); ``decode``: the cached-forward keywords of
        :meth:`SelfAttention.forward`."""
        if cache is not None:
            refuse_moe_serving(self.cfg)
            x = x + self.attn(self.norm1(x), cache, **decode)
            return x + self.mlp(self.norm2(x))
        ctx = dict(deterministic=deterministic, seeds=seeds, shard=shard,
                   aux=aux)
        if saves is None:
            x1, h = self._stages(0, len(_STAGES), x, (), ctx)
            return x1 + h[0]
        cuts = [i + 1 for i, name in enumerate(CHECKPOINT_NAMES)
                if name in saves]
        bounds = [0] + cuts + [len(_STAGES)]
        h, x_state = (), x
        for a, b in zip(bounds, bounds[1:]):
            if a <= _RESIDUAL:
                # the layer input goes in (kept anyway); once the residual
                # stage ran, the segment hands x + drop(attn) out as well
                out = checkpoint(self._segment, a, b, ctx, x, *h,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
                if b > _RESIDUAL:
                    x_state, h = out[0], out[1:]
                else:
                    h = out
            else:
                # past the residual: x + drop(attn) stays outside, its add
                # needs no saved value
                h = checkpoint(self._segment, a, b, ctx, None, *h,
                               use_reentrant=False, preserve_rng_state=False)
        return x_state + h[0]

    def _segment(self, a: int, b: int, ctx: dict, x, *h):
        """Stages ``[a, b)`` as one checkpointed function of its inputs:
        ``(x + drop(attn), *h)`` when the segment ran the residual stage,
        else ``h``."""
        x_out, h = self._stages(a, b, x, h, ctx)
        return (x_out, *h) if a <= _RESIDUAL < b else tuple(h)

    def _stages(self, a: int, b: int, x, h: tuple, ctx: dict):
        """Run stages ``[a, b)`` of the training forward on the residual
        stream ``x`` and the branch tensors ``h``; returns ``(x, h)``."""
        attn_seed, attn_drop_seed, mlp_drop_seed, route_key = ctx["seeds"]
        det, shard = ctx["deterministic"], ctx["shard"]
        for i in range(a, b):
            if i == 0:
                h = tuple(self.attn.qkv(self.norm1(x)))
            elif i == 1:
                h = (self.attn.core(*h, deterministic=det, seed=attn_seed,
                                    shard=shard),)
            elif i == 2:
                h = (self.attn._out_proj(h[0]),)
            elif i == 3:
                x = x + self.attn_dropout(h[0], det, seed=attn_drop_seed,
                                          shard=self._hidden_shard(shard,
                                                                   h[0]))
                if self.cfg.expert_mode:
                    h = (self._moe(self.norm2(x), route_key, shard,
                                   ctx["aux"]),)
                else:
                    h = (self.mlp.gelu(self.norm2(x)),)
            elif i == 4:
                if not self.cfg.expert_mode:
                    h = (self.mlp.down_proj(h[0]),)
            else:
                h = (self.mlp_dropout(h[0], det, seed=mlp_drop_seed,
                                      shard=self._hidden_shard(shard,
                                                               h[0])),)
        return x, h

    def _moe(self, y: torch.Tensor, key, shard: Optional[Shard],
             aux: Optional[dict]) -> torch.Tensor:
        """The MoE block on ``y`` [b, s, h]; its balance loss recorded in
        ``aux`` on the first run only (a recompute's rerun keeps the
        forward's)."""
        b, s = y.shape[:2]
        offset = 0 if shard is None else shard.b0 * s
        out, loss = self.moe_mlp(y, key=key, offset=offset)
        if aux is not None:
            aux.setdefault(self, loss)
        return out

    def _hidden_shard(self, shard: Optional[Shard], t: torch.Tensor
                      ) -> Optional[Shard]:
        """Where a hidden dropout's input ``t`` [b, s(/mp), E] lies in the
        global activation: ``shard``, or under sequence parallelism this
        rank's sequence shard of it (:func:`sequence_shard`)."""
        cfg = self.cfg
        if not cfg.sp:
            return shard
        return sequence_shard(shard, t.shape[0], t.shape[1], cfg.mp_degree,
                              get_mesh().mp_rank)


_STAGES = ("qkv_out", "core_attn_out", "attn_out", "ffn_gelu", "mlp_out",
           "mlp_dropout")
_RESIDUAL = 3  # the stage that adds the attention block to the stream


class GPTModel(nn.Module):
    """Embeddings, the decoder stack and the final LayerNorm; returns the
    hidden states [b, s, E] in the compute dtype (this rank's [b, s/mp,
    E] under sequence parallelism). Under ``pp_degree > 1``
    the stage ``pp_rank``'s part of it, its layers keyed by their global
    ids; the training forward of a stage is :meth:`embed`,
    :meth:`run_layers` and ``final_norm``, called by the pipeline's
    schedule."""

    def __init__(self, cfg: GPTConfig, device=None, pp_rank: int = 0,
                 int8: bool = False, fp32_partials: bool = False,
                 ep_world: int = 1):
        super().__init__()
        self.cfg = cfg
        self.int8 = int8
        self.recompute = recompute_policy(cfg)  # the save-set, or None
        # the last training forward's balance loss of each MoE layer, in
        # layer order
        self.balance_losses: list = []
        pp = cfg.pp_degree
        first, last = pp_rank == 0, pp_rank == pp - 1
        if first or last:
            # this rank's vocab rows under mp (the whole table where mp
            # does not divide it); the last stage's is the tied head's copy
            self._table("word_embeddings", cfg.vocab_size // cfg.mp_degree
                        if cfg.vocab_split else cfg.vocab_size, device)
            # convert.shard_params keeps a table mp does not divide whole
            self.mp_split = {"word_embeddings_q8" if int8
                             else "word_embeddings": 0}
        if first:
            self._table("position_embeddings", cfg.max_position_embeddings,
                        device)
            self.embed_dropout = _dropout(cfg)
        self.layers = nn.ModuleDict(
            (str(i), DecoderLayer(cfg, device, int8, fp32_partials,
                                  ep_world))
            for i in stage_layers(cfg.num_layers, pp, cfg.virtual_pp,
                                  pp_rank))
        if last:
            self.final_norm = LayerNorm(cfg.hidden_size, cfg.dtype, device)

    def forward(self, input_ids, position_ids, *,
                cache: Optional[Dict] = None, cache_positions=None,
                block_tables=None, kv_mask=None, kv_starts=None,
                deterministic=True,
                generator: Optional[torch.Generator] = None,
                shard: Optional[Shard] = None):
        """``cache=None`` is the training forward (dropout unless
        ``deterministic``, every seed drawn from ``generator`` before the
        first layer runs, :meth:`dropout_seeds`; each layer recomputed in
        the backward under :func:`recompute_policy` unless listed in
        ``no_recompute_layers``); with a cache (``generation.init_decode_cache``), the
        cached forward (no dropout), which updates the cache in place —
        a contiguous cache's ``index`` too (JAX ``cache_index``: the
        scalar write offset, advanced to the furthest write end).
        ``kv_starts`` [b], the decode window's start, defaults to
        :func:`pad_starts` of ``kv_mask``. ``shard`` places the training
        forward's ``[b, s]`` tokens in the global batch and sequence, for
        the dropout hashes (None: they are the whole of it). The whole
        model's forward: a pipeline stage runs its part through the
        schedule instead."""
        if self.cfg.pp_degree > 1:
            raise RuntimeError("a pipeline stage holds part of the model; "
                               "its forward runs through the schedule "
                               "(GPTModule.pipeline_loss)")
        if cache is not None:
            x = self._embed(input_ids, position_ids)
            b, s = input_ids.shape
            index = cache.get("index")
            if kv_starts is None and kv_mask is not None:
                kv_starts = pad_starts(kv_mask)
            decode_end = None
            if s == 1:  # each row's window end after this step's write
                decode_end = (
                    torch.full((b,), index + 1, dtype=torch.int32,
                               device=x.device) if cache_positions is None
                    else (cache_positions + 1).to(torch.int32))
            decode = dict(cache_index=index, cache_positions=cache_positions,
                          block_tables=block_tables, kv_mask=kv_mask,
                          kv_starts=kv_starts, decode_end=decode_end)
            tensors = [n for n, t in cache.items() if torch.is_tensor(t)]
            for i, layer in enumerate(self.layers.values()):
                x = layer(x, {n: cache[n][i] for n in tensors}, **decode)
            if index is not None:
                cache["index"] = (index + s if cache_positions is None
                                  else int(cache_positions.max()) + s)
            return self.final_norm(x)
        embed_seed, layer_seeds = self.dropout_seeds(deterministic,
                                                     generator)
        x = self.embed(input_ids, position_ids, deterministic=deterministic,
                       seed=embed_seed, shard=shard)
        aux = {} if self.cfg.expert_mode else None
        x = self.run_layers(x, range(self.cfg.num_layers), layer_seeds,
                            deterministic=deterministic, shard=shard,
                            aux=aux)
        self.balance_losses = list(aux.values()) if aux else []
        return self.final_norm(x)

    def _table(self, name: str, rows: int, device) -> None:
        """The embedding table ``name`` [rows, E]: an fp32 parameter, or
        at int8 weights the buffers ``name_q8`` and ``name_scale`` [1, E]
        (one channel per hidden column, ``ops/quant.py``)."""
        e = self.cfg.hidden_size
        if not self.int8:
            setattr(self, name, _param(rows, e, device=device))
            return
        self.register_buffer(name + "_q8", torch.empty(
            rows, e, dtype=torch.int8, device=device))
        self.register_buffer(name + "_scale", torch.empty(1, e,
                                                          device=device))

    def table(self, name: str, dtype: torch.dtype = torch.float32
              ) -> torch.Tensor:
        """The embedding table ``name`` in ``dtype``: dequantized at int8
        weights (a temporary of the call)."""
        if self.int8:
            return dequantize_int8(getattr(self, name + "_q8"),
                                   getattr(self, name + "_scale"), dtype)
        return getattr(self, name).to(dtype)

    def rows(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        """``table[ids]`` in fp32; at int8 weights the rows are gathered
        first and dequantized alone (the same values)."""
        if self.int8:
            return dequantize_int8(getattr(self, name + "_q8")[ids],
                                   getattr(self, name + "_scale"))
        return getattr(self, name)[ids]

    def _embed(self, input_ids, position_ids, sp: bool = False
               ) -> torch.Tensor:
        """Word plus position embeddings in the compute dtype; with ``sp``
        this rank's ``[b, s/mp, E]`` part of the sequence (the word rows
        reduce-scattered, the positions of that part)."""
        cfg = self.cfg
        # a table mp does not divide is whole on every rank: no group
        group = current_mp_group(cfg.mp_degree) if cfg.vocab_split else None
        words = vocab_parallel_embedding(
            functools.partial(self.rows, "word_embeddings"),
            cfg.vocab_size // cfg.mp_degree, input_ids, group,
            sequence_parallel=sp)
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None]
        if sp:
            s_loc = words.shape[1]
            position_ids = position_ids[:, get_mesh().mp_rank * s_loc:][
                :, :s_loc]
        return (words + self.rows("position_embeddings", position_ids)
                ).to(cfg.dtype)

    def embed(self, input_ids, position_ids, *, deterministic=True,
              seed=None, shard: Optional[Shard] = None) -> torch.Tensor:
        """The training forward's embeddings (the first stage's): word
        plus position embeddings in the compute dtype, then the embedding
        dropout keyed on ``seed``; under sequence parallelism this rank's
        part of the sequence (a ``seq % mp`` remainder raises
        ``ValueError``)."""
        cfg = self.cfg
        if cfg.sp and input_ids.shape[1] % cfg.mp_degree:
            raise ValueError(f"sequence parallelism: sequence "
                             f"{input_ids.shape[1]} does not split over "
                             f"mp_degree {cfg.mp_degree}")
        x = self._embed(input_ids, position_ids, sp=cfg.sp)
        if cfg.sp:
            shard = sequence_shard(shard, x.shape[0], x.shape[1],
                                   cfg.mp_degree, get_mesh().mp_rank)
        return self.embed_dropout(x, deterministic, seed=seed, shard=shard)

    def run_layers(self, x, layer_ids, layer_seeds, *, deterministic=True,
                   shard: Optional[Shard] = None,
                   aux: Optional[dict] = None) -> torch.Tensor:
        """``x`` through the decoder layers ``layer_ids`` (global ids, in
        order) of the training forward, layer i with ``layer_seeds[i]``,
        each recomputed in the backward under :func:`recompute_policy`
        unless listed in ``no_recompute_layers``. Under sequence
        parallelism ``x`` is this rank's sequence shard. MoE layers record
        their balance losses in ``aux``."""
        skip = set(self.cfg.no_recompute_layers or ())
        for i in layer_ids:
            # the layer draws nothing (its seeds come in), so a segment
            # rerun in the backward sees the forward's dropout masks
            # without saving or restoring any RNG state; under cp and
            # sequence parallelism its collectives rerun on every rank alike
            x = self.layers[str(i)](
                x, deterministic=deterministic, seeds=layer_seeds[i],
                shard=shard, saves=None if i in skip else self.recompute,
                aux=aux)
        return x

    def dropout_seeds(self, deterministic: bool,
                      generator: Optional[torch.Generator]):
        """``(embed seed, [(attention, attn_dropout, mlp_dropout seeds, MoE
        routing key) per layer])`` for one training forward, drawn from
        ``generator`` in the order the sites run (None where a site draws
        nothing: deterministic, or a rate of 0, or a hidden rate of 1 or
        more; the routing key, a raw threefry key, only for an MoE gate
        that draws: gshard at top k 2 or more, and switch). Drawn before any
        layer runs, so that a layer recomputed in the backward reuses its
        forward's seeds and the generator's stream is the same with
        recompute on or off.

        Under mp every rank draws the same seeds (one generator seeded
        alike on every rank): the hidden dropouts act on the activation
        that is replicated over the mp group, so every mp rank draws the
        same mask, as GSPMD's one mask over the global array; the
        attention dropout keys each head's bits on its global head id.
        Under pp every stage draws the whole model's seeds, in the order
        one stage would, and keeps its own layers': a pipeline then draws
        the masks of the unpipelined model at the same accumulation. At
        ``fast_dropout: False`` a hidden site takes a raw threefry key (two
        uint32 words) instead of a seed; flax's per-module key derivation
        (``make_rng``) is not copied (ROADMAP Queue C, "Model-level dropout
        streams")."""
        cfg = self.cfg

        def draw(rate: float, hidden: bool):
            return draw_site(generator, rate, hidden=hidden,
                             fast=cfg.fast_dropout,
                             deterministic=deterministic)

        routes = cfg.expert_mode and (cfg.gate == "switch" or (
            cfg.gate == "gshard" and cfg.top_k >= 2))

        def layer():
            attn = draw(cfg.attention_probs_dropout_prob, False)
            attn_drop = draw(hidden, True)
            key = (draw_key(generator) if routes and not deterministic
                   else None)
            return attn, attn_drop, draw(hidden, True), key

        hidden = cfg.hidden_dropout_prob
        embed = draw(hidden, True)
        layers = [layer() for _ in range(cfg.num_layers)]
        return embed, layers


class GPTForPretraining(nn.Module):
    """GPTModel plus the tied LM head: fp32 logits [b, s, vocab], or with
    ``fused_ce`` and labels the per-token cross-entropy [b, s]. Under mp
    the logits are this rank's vocab shard [b, s, vocab/mp]
    (``tensor_parallel.vocab_parallel_token_losses`` takes their loss) and
    the fused loss combines the shards' statistics (B12). ``int8``: the
    weights are int8 serving weights (module docstring); ``fp32_partials``:
    the row-parallel partials are summed in fp32 (the serving engine's
    copy, ``tensor_parallel.RowParallelDense``)."""

    def __init__(self, cfg: GPTConfig, device=None, pp_rank: int = 0,
                 int8: bool = False, fp32_partials: bool = False,
                 ep_world: int = 1):
        super().__init__()
        self.cfg = cfg
        self.int8 = int8
        self.fp32_partials = fp32_partials
        self.gpt = GPTModel(cfg, device, pp_rank, int8, fp32_partials,
                            ep_world)

    def forward(self, input_ids, position_ids, *, cache=None,
                cache_positions=None, block_tables=None, kv_mask=None,
                kv_starts=None, deterministic=True,
                generator: Optional[torch.Generator] = None,
                labels: Optional[torch.Tensor] = None,
                shard: Optional[Shard] = None) -> torch.Tensor:
        x = self.gpt(input_ids, position_ids, cache=cache,
                     cache_positions=cache_positions,
                     block_tables=block_tables, kv_mask=kv_mask,
                     kv_starts=kv_starts, deterministic=deterministic,
                     generator=generator, shard=shard)
        return self.lm_head(x, labels)

    def lm_head(self, x: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The tied head on the final-normed hidden states ``x`` [b, s, E]:
        fp32 logits, or with ``fused_ce`` and labels the per-token losses
        (the last stage's, under pp). Under sequence parallelism ``x`` is
        this rank's [b, s/mp, E] and is all-gathered first: the head and
        the loss see the whole sequence, and the gather's backward sums
        dx over the group (in place of ``copy_to_mp``)."""
        emb = self.gpt.table("word_embeddings", self.cfg.dtype)
        group = current_mp_group(self.cfg.mp_degree)
        sp = self.cfg.sp
        if sp:
            x = gather_from_sequence(x, group)
        if labels is not None and self.cfg.fused_ce:
            # JAX model.py:888-899: fp32 per-token losses [b, s] (callers
            # apply the loss mask); the [b, s, vocab] logits never exist.
            # dW comes back in the compute dtype and the cast carries it to
            # the fp32 table, beside the embedding lookup's gradient. Under
            # mp, B12 on this rank's vocab shard (its hidden input passes
            # copy_to_mp inside)
            b, s, e = x.shape
            return fused_linear_ce(x.reshape(b * s, e), emb,
                                   labels.reshape(-1), mp_group=group,
                                   sequence_parallel=sp).view(b, s)
        if not sp:
            x = copy_to_mp(x, group)  # each shard's logits give part of dx
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


def serving_logits(model: nn.Module, logits: torch.Tensor) -> torch.Tensor:
    """The whole vocab's logits of a cached forward: under mp with the
    vocab split, this rank's shard all-gathered over the current mesh's
    mp group (``tensor_parallel.gather_vocab``), so that every rank samples
    from the same bits; else ``logits``."""
    cfg = model.cfg
    if not cfg.vocab_split:
        return logits
    return gather_vocab(logits, current_mp_group(cfg.mp_degree))


def inference_params(model: nn.Module, params: Dict[str, torch.Tensor],
                     device) -> Dict[str, torch.Tensor]:
    """``params`` on ``device`` for a forward without gradients: fp32, with
    every :class:`Dense` weight and bias pre-cast to that layer's compute
    dtype (the forward casts them there anyway, so results are
    unchanged)."""
    dense = {f"{name}.{p}": mod.dtype for name, mod in model.named_modules()
             if isinstance(mod, Dense) for p in ("weight", "bias")}
    return {k: v.to(device, dense.get(k, torch.float32)
                    if v.is_floating_point() else v.dtype)
            for k, v in params.items()}


def masked_loss_mean(token_loss: torch.Tensor,
                     loss_mask: torch.Tensor) -> torch.Tensor:
    """Loss-mask-weighted mean of per-token losses (model.py:976-980)."""
    mask = loss_mask.float().reshape(token_loss.shape)
    return (token_loss * mask).sum() / mask.sum().clamp_min(1.0)


def token_losses(logits: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
    """Per-token LM cross-entropy in fp32: logsumexp − the label's logit."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = logits.gather(-1, labels.long()[..., None])[..., 0]
    return logz - label_logits


def pretraining_loss(logits: torch.Tensor, labels: torch.Tensor,
                     loss_mask: torch.Tensor) -> torch.Tensor:
    """Masked LM cross-entropy in fp32 (model.py:983-991)."""
    return masked_loss_mean(token_losses(logits, labels), loss_mask)
