"""Tensor (mp) parallelism: the Megatron layers that the JAX rules imply.

The JAX package gets tensor parallelism from GSPMD: ``parallel/sharding.py``
(:41-89, ``make_rules``) puts the logical axes ``vocab``, ``heads`` and
``mlp`` on the mesh's ``mp`` axis, the GPT params carry those axes (qkv
``("embed", "heads", "kv")``, out_proj ``("heads", "kv", "embed")``, up
``("embed", "mlp")``, down ``("mlp", "embed")``, the word embeddings
``("vocab", "embed")``) and XLA inserts the collectives. The port has no
GSPMD, so it writes the Megatron form out (the reference's
``hybrid_model.py:49-174``): every activation between the layers is
replicated over the mp group, and

- a column-parallel :class:`Dense` (qkv, up) holds a shard of the output
  rows and its own bias shard; its input passes :func:`copy_to_mp`
  (identity forward, the gradient all-reduced over the group);
- a row-parallel :class:`Dense` (out_proj, down) holds a shard of the input
  columns; the partial products are all-reduced (:func:`reduce_from_mp`:
  all-reduce forward, identity backward) and its bias, replicated, is
  added once after the sum;
- the word embeddings hold a shard of the vocab rows: a lookup gives 0 for
  an id off the shard and the shards' rows are all-reduced, a sum with one
  non-zero term, so exact (:func:`vocab_parallel_embedding`);
- the loss over vocab-sharded logits combines per-shard log-sum-exp and
  label logits (:func:`vocab_parallel_token_losses`;
  :func:`vocab_parallel_combine` is also the outside combine of the fused
  form, B12, in ``ops/ce_loss.py``).

Under Megatron sequence parallelism (``Model.sequence_parallel`` at mp >
1; JAX maps the activations' ``act_seq`` axis to ``mp``,
``parallel/sharding.py:80-86``) the activations between the
column-parallel inputs and the row-parallel outputs are split along the
sequence instead of replicated: each rank holds ``[b, s/mp, h]``, on
which the LayerNorms, dropouts and residuals run. A column-parallel
layer all-gathers its input along the sequence
(:func:`gather_from_sequence`: all-gather forward, reduce-scatter
backward), a row-parallel layer reduce-scatters its partial products
(:func:`reduce_scatter_to_sequence`: reduce-scatter forward, all-gather
backward) and adds its bias to its shard, and the vocab-parallel
embedding reduce-scatters its rows. :func:`scatter_to_sequence` (split
forward, all-gather backward) cuts a replicated tensor to this rank's
shard. The parameters that mp replicates (LayerNorms, row-parallel
biases, the position table) then see only this rank's positions: their
gradients are partial and the trainer sums them over the mp group.

Partials are reduced in the dtype they arrive in (bf16 on the card, as
GSPMD reduces the dot's output), unless a row-parallel layer is built
with ``fp32_partials`` (the serving engine's are): its partials are then
fp32 GEMM outputs, summed in fp32 and rounded once, as one GEMM over the
whole input rounds once. Over gloo (ranks that share a card) the
collectives stage tensors on the card through pinned host buffers, kept
between calls. Under mp, every rank computes the same
replicated loss and differentiates its own copy: that is why the backward
of a reduce is the identity and the backward of a copy a sum.

:func:`mp_split_axes` names the parameters split over mp and the axis along
which each is cut, as the modules that hold them declare it (``mp_split``);
``models/gpt/convert.py`` slices and gathers state dicts by it, and the
trainer counts the whole model's parameters and the global norm by it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from fleetx_tpu_torch.ops.quant import dequantize_int8
from fleetx_tpu_torch.parallel.mesh import get_mesh

__all__ = ["mp_split_axes", "current_mp_group", "copy_to_mp",
           "reduce_from_mp", "scatter_to_sequence", "gather_from_sequence",
           "reduce_scatter_to_sequence", "Dense",
           "ColumnParallelDense", "RowParallelDense", "local_labels",
           "vocab_parallel_embedding", "vocab_parallel_combine",
           "vocab_parallel_token_losses", "gather_vocab"]


def mp_split_axes(model: nn.Module) -> Dict[str, int]:
    """Every parameter of ``model`` that is split over mp, by name, with the
    axis along which it is cut. Each module declares its own in
    ``mp_split`` ({parameter name: axis}); the layers declare it at any
    degree, so a whole (mp 1) model names what a sharded one splits."""
    out = {}
    for prefix, module in model.named_modules():
        for name, axis in getattr(module, "mp_split", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = axis
    return out


def current_mp_group(mp: int):
    """The current mesh's mp group for a model built for ``mp`` ranks: None
    at mp 1; raises when the mesh has another mp axis (a shard run on the
    wrong layout would be silently wrong)."""
    mesh = get_mesh()
    if mesh.mp != mp:
        raise RuntimeError(f"model built for mp_degree={mp} but the mesh is "
                           f"{mesh}")
    return mesh.mp_group if mp > 1 else None


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """``t`` summed (or reduced by ``op``) over ``group``, in place; over
    gloo a tensor on the card goes through a pinned host buffer (gloo's own
    path for CUDA tensors took ~3 ms a call on the H100, even for a decode
    tick's few KB)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = _host("all_reduce", t)
        host.copy_(t)
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
        return t
    dist.all_reduce(t, op=op, group=group)
    return t


class _CopyToMP(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromMP(torch.autograd.Function):
    """All-reduce forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_mp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is, with its gradient summed over ``group`` (the input of
    a column-parallel layer: each rank's gradient is its shard's part)."""
    return x if group is None else _CopyToMP.apply(x, group)


def reduce_from_mp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (the output of a row-parallel layer); the
    gradient passes through unchanged."""
    return x if group is None else _ReduceFromMP.apply(x, group)


_STAGING: Dict[str, torch.Tensor] = {}  # pinned host buffers, by role


def _host(role: str, like: torch.Tensor) -> torch.Tensor:
    """The pinned host buffer ``role`` (grown when too small) shaped like
    ``like``."""
    buf = _STAGING.get(role)
    if buf is None or buf.numel() < like.numel() or buf.dtype != like.dtype:
        buf = torch.empty(like.numel(), dtype=like.dtype, pin_memory=True)
        _STAGING[role] = buf
    return buf[:like.numel()].view(like.shape)


def _collective(op, out: torch.Tensor, src: torch.Tensor, group) -> None:
    """``op(out, src)`` over ``group``; over gloo with tensors on the card
    through the pinned host buffers (the copies synchronous, so a buffer
    is free again when this returns)."""
    if not (src.is_cuda and dist.get_backend(group) == "gloo"):
        op(out, src, group=group)
        return
    host_src = _host(op.__name__ + ":in", src)
    host_src.copy_(src)
    host_out = _host(op.__name__ + ":out", out)
    op(host_out, host_src, group=group)
    out.copy_(host_out)


def _seq_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` [b, s/mp, ...] of every rank of ``group``, joined along the
    sequence: [b, s, ...]."""
    mp = dist.get_world_size(group)
    x = x.contiguous()
    flat = torch.empty((mp,) + tuple(x.shape), dtype=x.dtype,
                       device=x.device)
    _collective(dist.all_gather_into_tensor, flat.view(-1), x.view(-1),
                group)
    b, s = x.shape[:2]
    return flat.transpose(0, 1).reshape(b, mp * s, *x.shape[2:])


def _seq_reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``x`` [b, s, ...], this rank's part of the
    sequence: [b, s/mp, ...]."""
    mp = dist.get_world_size(group)
    b, s = x.shape[:2]
    rest = tuple(x.shape[2:])
    src = x.reshape(b, mp, s // mp, *rest).transpose(0, 1).contiguous()
    out = torch.empty((b, s // mp) + rest, dtype=x.dtype, device=x.device)
    _collective(dist.reduce_scatter_tensor, out.view(-1), src.view(-1),
                group)
    return out


def _seq_split(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's part of the sequence of ``x`` [b, s, ...] (a copy)."""
    mp, rank = dist.get_world_size(group), dist.get_rank(group)
    s = x.shape[1] // mp
    return x.narrow(1, rank * s, s).contiguous()


class _ScatterToSequence(torch.autograd.Function):
    """Split forward; all-gather backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_split(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_all_gather(g, ctx.group), None


class _GatherFromSequence(torch.autograd.Function):
    """All-gather forward; reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_reduce_scatter(g, ctx.group), None


class _ReduceScatterToSequence(torch.autograd.Function):
    """Reduce-scatter forward; all-gather backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_all_gather(g, ctx.group), None


def _check_seq(x: torch.Tensor, group, what: str) -> None:
    mp = dist.get_world_size(group)
    if x.shape[1] % mp:
        raise ValueError(f"sequence parallelism: {what} sequence "
                         f"{x.shape[1]} does not split over mp {mp}")


def scatter_to_sequence(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's ``[b, s/mp, ...]`` shard of the replicated ``x``; the
    gradient is all-gathered."""
    if group is None:
        return x
    _check_seq(x, group, "the")
    return _ScatterToSequence.apply(x, group)


def gather_from_sequence(x: torch.Tensor, group) -> torch.Tensor:
    """The whole ``[b, s, ...]`` from every rank's shard ``x``; the
    gradient is reduce-scattered (each rank's use of the whole sequence
    gives part of every shard's gradient)."""
    if group is None:
        return x
    return _GatherFromSequence.apply(x, group)


def reduce_scatter_to_sequence(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's shard of the sum over the group of the partials ``x``
    [b, s, ...] (a row-parallel output); the gradient is all-gathered."""
    if group is None:
        return x
    _check_seq(x, group, "the")
    return _ReduceScatterToSequence.apply(x, group)


class _BiasAdd(torch.autograd.Function):
    """``y + b`` in y's dtype (b cast to it, as flax adds a bias); the
    bias's gradient summed over the rows in fp32 and rounded once, so that
    it is the same whether the rows lie on one rank or are split over the
    sequence shards (a bf16 round of each shard's partial sum would move
    its last bits, and through AdamW every later step)."""

    @staticmethod
    def forward(ctx, y, b):
        ctx.b_dtype = b.dtype
        return y + b.to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        rows = tuple(range(g.dim() - 1))
        return g, g.float().sum(rows).to(ctx.b_dtype)


def _param(*shape, device) -> nn.Parameter:
    # weights come from init_params / params_from_jax, never from here
    return nn.Parameter(torch.empty(*shape, device=device))


class Dense(nn.Module):
    """``y = x Wᵀ + b`` at the compute dtype; ``weight`` [out, in] and
    ``bias`` [out] are held in fp32 (or pre-cast to the compute dtype by
    an inference caller, which yields the same result).

    With ``scale_rows`` (int8 serving weights, ``ops/quant.py``) the
    weight is held as the buffers ``weight_q8`` (int8 [out, in]) and
    ``weight_scale`` (fp32 [scale_rows, 1]: row ``r`` takes channel ``r %
    scale_rows``) and dequantized on each call, fp32 then the compute
    dtype (JAX ``_dequant_params``): the float weight is a temporary of
    the call, never a second copy of the model."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, device=None,
                 scale_rows: Optional[int] = None):
        super().__init__()
        self.dtype = dtype
        if scale_rows is None:
            self.weight = _param(out_features, in_features, device=device)
        else:
            self.register_buffer("weight_q8", torch.empty(
                out_features, in_features, dtype=torch.int8, device=device))
            self.register_buffer("weight_scale", torch.empty(
                scale_rows, 1, device=device))
        self.bias = _param(out_features, device=device)

    @property
    def int8(self) -> bool:
        return "weight_q8" in self._buffers

    def dense_weight(self) -> torch.Tensor:
        """The weight at the compute dtype (dequantized when int8)."""
        if self.int8:
            return dequantize_int8(self.weight_q8, self.weight_scale,
                                   self.dtype)
        return self.weight.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.dense_weight(),
                        self.bias.to(self.dtype))


def _weight_split(layer: Dense, axis: int, split_scale: bool
                  ) -> Dict[str, int]:
    """The ``mp_split`` entries of a layer's weight: the weight (or its
    int8 values) along ``axis``, and with ``split_scale`` its int8 scale
    (one channel per output row) along the rows with it. A scale shared by
    every head's rows (the fused qkv's 3·hd channels), or a row-parallel
    layer's, is whole on each rank, as JAX's ``_fit_spec`` drops an axis
    the scale does not divide (parallel/sharding.py:131)."""
    if not layer.int8:
        return {"weight": axis}
    return {"weight_q8": axis, **({"weight_scale": 0} if split_scale
                                  else {})}


class ColumnParallelDense(Dense):
    """A :class:`Dense` of ``out_features`` split over ``mp`` ranks: this
    rank's ``out_features / mp`` output rows and their bias. Its input is
    replicated (:func:`copy_to_mp`), or under ``sequence_parallel`` this
    rank's sequence shard, all-gathered (:func:`gather_from_sequence`);
    its output is this rank's shard of the features over the whole
    sequence. ``scale_rows`` holds the weight in int8 (:class:`Dense`;
    the channels of the whole layer, shared by the heads where fewer than
    its rows)."""

    def __init__(self, in_features: int, out_features: int, mp: int,
                 dtype: torch.dtype, device=None,
                 sequence_parallel: bool = False,
                 scale_rows: Optional[int] = None):
        split_scale = scale_rows == out_features  # one channel per row
        super().__init__(in_features, out_features // mp, dtype, device,
                         scale_rows // mp if split_scale else scale_rows)
        self.mp = mp
        self.sequence_parallel = sequence_parallel
        self.mp_split = {**_weight_split(self, 0, split_scale), "bias": 0}

    def take_input(self, x: torch.Tensor) -> torch.Tensor:
        """The input as the product reads it: ``x`` through the mp
        group's collective (a copy, or the sequence all-gather). Layers
        that share one input (q, k and v) take it once."""
        group = current_mp_group(self.mp)
        if self.sequence_parallel:
            return gather_from_sequence(x, group)
        return copy_to_mp(x, group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(self.take_input(x))


class RowParallelDense(Dense):
    """A :class:`Dense` of ``in_features`` split over ``mp`` ranks: this
    rank's ``in_features / mp`` input columns; the partial products are
    summed over the group, then the replicated bias is added once (adding
    it inside each rank's product would count it mp times). At mp 1 it is
    a :class:`Dense`. Under ``sequence_parallel`` the sum is
    reduce-scattered along the sequence and the bias added to this rank's
    shard. Over mp ranks the bias's gradient is summed over the rows in
    fp32 (:class:`_BiasAdd`): one rounding, with or without the sequence
    split. ``scale_rows`` holds the weight in int8 (:class:`Dense`; its
    per-row scale is whole on every rank). With ``fp32_partials`` (the
    serving engine's layers; no sequence split) the partial products are
    fp32 and summed in fp32, then cast to the compute dtype: the sum
    rounds once. Training keeps partials in the compute dtype, as GSPMD
    reduces them: its sequence split reduce-scatters the same partials,
    and its gates hold the two layouts to one semantics."""

    def __init__(self, in_features: int, out_features: int, mp: int,
                 dtype: torch.dtype, device=None,
                 sequence_parallel: bool = False,
                 scale_rows: Optional[int] = None,
                 fp32_partials: bool = False):
        super().__init__(in_features // mp, out_features, dtype, device,
                         scale_rows)
        if fp32_partials and sequence_parallel:
            raise ValueError("fp32_partials sums whole partials; the "
                             "sequence split reduce-scatters them")
        self.mp = mp
        self.sequence_parallel = sequence_parallel
        self.fp32_partials = fp32_partials
        self.mp_split = _weight_split(self, 1, False)  # the bias is whole

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = current_mp_group(self.mp)
        if group is None:
            return super().forward(x)
        x, w = x.to(self.dtype), self.dense_weight()
        if self.fp32_partials:
            y = reduce_from_mp(_fp32_product(x, w), group).to(self.dtype)
            return _BiasAdd.apply(y, self.bias)
        y = F.linear(x, w)
        if self.sequence_parallel:  # this rank's sequence shard of the sum
            y = reduce_scatter_to_sequence(y, group)
        else:
            y = reduce_from_mp(y, group)
        return _BiasAdd.apply(y, self.bias)


def _fp32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x Wᵀ`` with an fp32 result: a bf16 GEMM on the card writes its
    fp32 accumulator (``out_dtype``), other operands multiply in fp32."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype == torch.bfloat16:
        y = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        y = x2.float() @ w.float().t()
    return y.view(*x.shape[:-1], w.shape[0])


def local_labels(labels: torch.Tensor, v_loc: int, mp_rank: int
                 ) -> torch.Tensor:
    """Global ids → ids in vocab shard ``mp_rank`` of ``v_loc`` rows, −1
    off the shard (JAX ``_local_labels``, ops/pallas/ce_loss.py:289-296):
    −1 matches no column, so the shard's label logit is 0 and the sum over
    shards is exactly the owning shard's. int32."""
    loc = labels.to(torch.int32) - mp_rank * v_loc
    return torch.where((loc >= 0) & (loc < v_loc), loc, -1)


def vocab_parallel_embedding(lookup: Callable[[torch.Tensor], torch.Tensor],
                             v_loc: int, ids: torch.Tensor, group,
                             sequence_parallel: bool = False
                             ) -> torch.Tensor:
    """The rows of ``ids`` for a table split over ``group`` by vocab rows,
    ``v_loc`` a rank, whose rank-local rows ``lookup`` gathers (an int8
    table dequantizes only those): each rank looks up the ids of its
    shard (0 for the others) and the rows are summed over the group, which
    is exact (one non-zero term). Under ``sequence_parallel`` the sum is
    reduce-scattered: this rank's ``[b, s/mp, E]`` part of the
    sequence."""
    if group is None:
        return lookup(ids)
    loc = local_labels(ids, v_loc, dist.get_rank(group))
    rows = torch.where((loc >= 0)[..., None],
                       lookup(loc.clamp_min(0).long()), 0.0)
    if sequence_parallel:
        return reduce_scatter_to_sequence(rows, group)
    return reduce_from_mp(rows, group)


def vocab_parallel_combine(lse_loc: torch.Tensor, lab_loc: torch.Tensor,
                           group) -> torch.Tensor:
    """Per-token loss from each shard's fp32 log-sum-exp and label logit
    (JAX ``fused_linear_ce``'s mp branch, ops/pallas/ce_loss.py:393-395):
    logsumexp over the shards of ``lse_loc`` minus the sum of ``lab_loc``.
    The max is taken without gradient (a shift that cancels); the sums of
    exp and of the label logits go through one all-reduce, whose backward
    hands each rank its own cotangents: a = g·exp(lse_loc − lse) and
    b = −g."""
    if group is None:
        return lse_loc - lab_loc
    m = _all_reduce(lse_loc.detach().clone(), group, dist.ReduceOp.MAX)
    sums = reduce_from_mp(torch.stack([torch.exp(lse_loc - m), lab_loc]),
                          group)
    return m + torch.log(sums[0]) - sums[1]


def vocab_parallel_token_losses(logits: torch.Tensor, labels: torch.Tensor,
                                group) -> torch.Tensor:
    """Per-token cross-entropy (fp32, labels' shape) of logits split over
    ``group`` by vocab (``logits`` [..., V/mp], this rank's shard; global
    ``labels``): the plain PyTorch counterpart of JAX ``pretraining_loss``
    on vocab-sharded logits (models/gpt/model.py:983-991). Without a group
    (one rank) it is logsumexp minus the label's logit, as
    ``models.gpt.model.token_losses``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    rank = dist.get_rank(group) if group is not None else 0
    loc = local_labels(labels, logits.shape[-1], rank)
    lab = logits.gather(-1, loc.clamp_min(0).long()[..., None])[..., 0]
    return vocab_parallel_combine(lse, torch.where(loc >= 0, lab, 0.0),
                                  group)


def gather_vocab(logits: torch.Tensor, group) -> torch.Tensor:
    """The whole vocab's logits ``[..., V]`` from every rank's shard
    ``logits`` ``[..., V/mp]`` (in rank order) over ``group``: the serving
    calls' gather before sampling, GSPMD's implicit one. A copy of bytes,
    so every rank holds the same bits. Without a group, ``logits``."""
    if group is None:
        return logits
    mp = dist.get_world_size(group)
    x = logits.contiguous()
    flat = torch.empty((mp,) + tuple(x.shape), dtype=x.dtype,
                       device=x.device)
    _collective(dist.all_gather_into_tensor, flat.view(-1), x.view(-1),
                group)
    return torch.movedim(flat, 0, -2).reshape(*x.shape[:-1],
                                               mp * x.shape[-1])
