"""The ZeRO weight-update shard: gradients reduce-scattered, the AdamW
update and its state on a 1/N shard, the parameters all-gathered.

Port of the JAX package's ``zero_update_spec`` (parallel/sharding.py:
169-203) and of the train step the JAX ``Trainer`` builds around it
(core/engine.py:204-214, :399-491, :507-546). JAX constrains the gradients
and parameters to the weight-update layout inside its jitted step and lets
GSPMD insert the collectives; here each rank holds the whole parameters
(ZeRO stages 1 and 2) and :class:`ZeroShards` moves the data itself:

- :func:`zero_update_spec` is JAX's rule, copied: the free data axes
  ``("dp", "fsdp")`` fold onto the first dimension they divide (on top of
  the mp split of that dimension), the full product first, then each
  axis alone; a leaf that nothing divides stays replicated.
- :func:`plan_param` states the rule for one of this rank's parameters
  (its local mp shard): which dimension is split, over which axes, and
  which slice each rank of the zero group holds (:class:`ZeroPlan`).
- :meth:`ZeroShards.reduce_scatter` sums the gradients over the zero
  group and leaves each rank the sum of its own slices, in flat buckets
  (one ``reduce_scatter_tensor`` per bucket; a leaf split over only one
  of the axes, or not at all, is summed by all-reduce and sliced). Under
  cp the slices are then summed over the cp group: the cp ranks of one
  (dp, fsdp) coordinate hold the same slices.
- :meth:`ZeroShards.all_gather` writes every rank's updated slices back
  into the whole parameters (one ``all_gather_into_tensor`` per bucket).

A slice along dimension 0 of a contiguous parameter is a contiguous view,
so AdamW updates it in place and the all-gather fills in the rest: there
is no fp32 master copy. A slice along another dimension is staged in a
buffer of its own (:attr:`ZeroShards.staged`), refreshed from the
parameter before every update.

A bucket takes one ``reduce_scatter_tensor`` and one
``all_gather_into_tensor``. Over gloo (ranks on the CPU, or sharing one
card) tensors on the card go through pinned host buffers, kept between
steps and grown to the largest bucket. A backend that lacks either
collective raises; no other route is taken in its place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["AXES", "BUCKET_BYTES", "ZeroPlan", "ZeroShards",
           "all_reduce_sum", "plan_param", "zero_update_spec"]

AXES = ("dp", "fsdp")  # the data-parallel axes the update shard folds
BUCKET_BYTES = 256 << 20  # gradient/parameter collective bucket


def all_reduce_sum(tensors: List[torch.Tensor], group=None,
                   bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum ``tensors`` (of one dtype and device) over ``group`` (the world
    when None), in place, packed into flat buckets of at most
    ``bucket_bytes`` (a tensor larger than that goes alone), one
    all-reduce per bucket."""
    for bucket in _buckets(tensors, lambda t: t.numel() * t.element_size(),
                           bucket_bytes):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _buckets(items: Sequence, nbytes, limit: int) -> Iterable[list]:
    """``items`` in order, in runs of at most ``limit`` bytes (an item
    larger than that alone)."""
    bucket, size = [], 0
    for item in items:
        n = nbytes(item)
        if bucket and size + n > limit:
            yield bucket
            bucket, size = [], 0
        bucket.append(item)
        size += n
    if bucket:
        yield bucket


def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def zero_update_spec(spec: Optional[Sequence], shape: Sequence[int],
                     sizes: Dict[str, int],
                     axes: Sequence[str] = AXES) -> tuple:
    """The partition spec (a tuple of entries: None, an axis name or a
    tuple of names) of one parameter's weight-update shard; copy of JAX's
    rule (parallel/sharding.py:169-203) over a mesh of axis ``sizes``.

    Folds the not-yet-used data axes onto the first dimension of the
    global ``shape`` they divide evenly, on top of the split already in
    ``spec``, trying the full product first, then each axis alone. A leaf
    that no axis divides keeps ``spec`` (replicated over the axes)."""
    spec = tuple(spec) if spec is not None else ()
    if len(shape) == 0:
        return spec
    used = {a for entry in spec for a in _spec_axes(entry)}
    free = [a for a in axes
            if a in sizes and sizes[a] > 1 and a not in used]
    if not free:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    candidates = [tuple(free)]
    if len(free) > 1:
        candidates += [(a,) for a in free]
    for cand in candidates:
        factor = math.prod(int(sizes[a]) for a in cand)
        for i, dim in enumerate(shape):
            cur = _spec_axes(parts[i])
            cur_factor = math.prod(int(sizes[a]) for a in cur)
            if dim % (cur_factor * factor):
                continue
            merged = cur + cand
            parts[i] = merged if len(merged) > 1 else merged[0]
            return tuple(parts)
    return spec


@dataclasses.dataclass(frozen=True)
class ZeroPlan:
    """Where one parameter's update shard lies: ``dim`` (None: the whole
    parameter on every rank of the zero group), the data ``axes`` folded
    onto it, and ``slices[j]``, the slice along ``dim`` that zero-group
    rank j (data rank ``dp_rank · fsdp + fsdp_rank``) holds."""
    dim: Optional[int]
    axes: Tuple[str, ...]
    slices: Tuple[int, ...]

    @property
    def parts(self) -> int:
        """How many slices the parameter is cut into (1: replicated)."""
        return max(self.slices) + 1 if self.dim is not None else 1


def plan_param(shape: Sequence[int], mp_dim: Optional[int],
               sizes: Dict[str, int]) -> ZeroPlan:
    """The :class:`ZeroPlan` of a parameter whose local (this rank's mp
    shard) ``shape`` is split over mp along ``mp_dim`` (None: not split),
    on a mesh of axis ``sizes`` (``dp``, ``fsdp``, ``mp``):
    :func:`zero_update_spec` of its global shape and mp spec."""
    mp = int(sizes.get("mp", 1))
    spec = [None] * len(shape)
    global_shape = list(shape)
    if mp_dim is not None and mp > 1:
        spec[mp_dim] = "mp"
        global_shape[mp_dim] *= mp
    out = zero_update_spec(tuple(spec), global_shape, sizes)
    dp, fsdp = int(sizes.get("dp", 1)), int(sizes.get("fsdp", 1))
    replicated = ZeroPlan(None, (), (0,) * (dp * fsdp))
    for dim, entry in enumerate(out):
        axes = tuple(a for a in _spec_axes(entry) if a in AXES)
        if not axes:
            continue
        coords = [{"dp": j // fsdp, "fsdp": j % fsdp}
                  for j in range(dp * fsdp)]
        slices = []
        for c in coords:
            k = 0
            for a in axes:  # major to minor, as JAX's multi-axis spec
                k = k * int(sizes[a]) + c[a]
            slices.append(k)
        return ZeroPlan(dim, axes, tuple(slices))
    return replicated


def _slice(t: torch.Tensor, plan: ZeroPlan, k: int) -> torch.Tensor:
    """Slice ``k`` of ``t`` along the plan's dimension (a view)."""
    n = t.shape[plan.dim] // plan.parts
    return t.narrow(plan.dim, k * n, n)


def _by_slice(t: torch.Tensor, plan: ZeroPlan) -> torch.Tensor:
    """``t`` as [parts, numel / parts], row k its slice k (a view when
    the plan cuts dimension 0 of a contiguous tensor, else a copy)."""
    d, parts = plan.dim, plan.parts
    pre = math.prod(t.shape[:d])
    return t.reshape(pre, parts, -1).transpose(0, 1).reshape(parts, -1)


def _place(target: torch.Tensor, rows: torch.Tensor, plan: ZeroPlan
           ) -> None:
    """Write ``rows`` ([parts, numel / parts], row k slice k) into
    ``target``."""
    d, parts = plan.dim, plan.parts
    pre = math.prod(target.shape[:d])
    target.copy_(rows.reshape(parts, pre, -1).transpose(0, 1)
                 .reshape(target.shape))


class ZeroShards:
    """The weight-update shard of ``named_params`` (this rank's whole
    parameters, in order) on ``mesh``: the plans, the tensors AdamW steps
    (:attr:`shards`, one per parameter) and the collectives between the
    two. ``mp_split`` maps a parameter's name to the dimension it is split
    along over mp (``tensor_parallel.mp_split_axes``)."""

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]],
                 mp_split: Dict[str, int], mesh,
                 bucket_bytes: int = BUCKET_BYTES):
        self.group = mesh.zero_group
        self.cp_group = mesh.cp_group if mesh.cp > 1 else None
        self.world = mesh.zero_world
        self.rank = mesh.data_rank
        self.bucket_bytes = bucket_bytes
        sizes = {"dp": mesh.dp, "fsdp": mesh.fsdp, "mp": mesh.mp}
        self.names = [n for n, _ in named_params]
        self.params = [p.detach() for _, p in named_params]
        self.plans = [plan_param(tuple(p.shape), mp_split.get(n), sizes)
                      for n, p in named_params]
        self.shards: List[torch.Tensor] = []
        self.staged: List[bool] = []
        self._buffers: Dict[str, torch.Tensor] = {}  # pinned, by role
        for p, plan in zip(self.params, self.plans):
            if plan.dim is None:
                shard, staged = p, False
            elif plan.dim == 0 and p.is_contiguous():
                shard, staged = self._mine(p, plan), False
            else:
                shard = self._mine(p, plan).contiguous()
                staged = True
            self.shards.append(shard)
            self.staged.append(staged)

    # ------------------------------------------------------------ helpers
    def _mine(self, t: torch.Tensor, plan: ZeroPlan) -> torch.Tensor:
        return _slice(t, plan, plan.slices[self.rank])

    def shard_of(self, i: int, whole: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``whole``, a tensor shaped like parameter
        ``i`` (a contiguous copy)."""
        plan = self.plans[i]
        if plan.dim is None:
            return whole.clone()
        return self._mine(whole, plan).contiguous()

    def _host(self, role: str, t: torch.Tensor) -> torch.Tensor:
        """The pinned host buffer ``role`` (grown when too small) shaped
        like ``t``."""
        buf = self._buffers.get(role)
        if buf is None or buf.numel() < t.numel() or buf.dtype != t.dtype:
            buf = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
            self._buffers[role] = buf
        return buf[:t.numel()].view(t.shape)

    def _collective(self, op, out: torch.Tensor, src: torch.Tensor) -> None:
        """``op(out, src)`` over the zero group; over gloo with tensors on
        the card, through the pinned host buffers (the copies synchronous,
        so a buffer is free again when this returns)."""
        if not (src.is_cuda and dist.get_backend(self.group) == "gloo"):
            op(out, src, group=self.group)
            return
        host_src = self._host(op.__name__ + ":in", src)
        host_src.copy_(src)
        host_out = self._host(op.__name__ + ":out", out)
        op(host_out, host_src, group=self.group)
        out.copy_(host_out)

    def _reduce_scatter(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's row of the sum over the zero group of ``flat``
        [world, L], [L]."""
        out = torch.empty(flat.shape[1], dtype=flat.dtype, device=flat.device)
        self._collective(dist.reduce_scatter_tensor, out, flat.reshape(-1))
        return out

    def _all_gather(self, flat: torch.Tensor) -> torch.Tensor:
        """``flat`` [L] of every rank of the zero group: [world, L], row j
        zero-group rank j's."""
        out = torch.empty(self.world * flat.numel(), dtype=flat.dtype,
                          device=flat.device)
        self._collective(dist.all_gather_into_tensor, out, flat)
        return out.view(self.world, -1)

    def _rows(self, gathered: torch.Tensor, plan: ZeroPlan) -> torch.Tensor:
        """The [parts, n] rows of a parameter's slices from the gathered
        [world, n]: slice k from the first rank that holds it."""
        if plan.parts == self.world:
            return gathered
        first = [plan.slices.index(k) for k in range(plan.parts)]
        return gathered[first]

    # -------------------------------------------------------- collectives
    def reduce_scatter(self, grads: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """The sum over the zero group (and, under cp, the cp group) of
        ``grads`` (the whole gradients, aligned with the parameters), as
        this rank's slices: one contiguous tensor per parameter, shaped
        like its shard."""
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        whole = [i for i, p in enumerate(self.plans)
                 if p.parts == self.world]
        rest = [i for i, p in enumerate(self.plans)
                if p.parts != self.world]
        for bucket in _buckets(whole, lambda i: grads[i].numel()
                               * grads[i].element_size(), self.bucket_bytes):
            rows = [_by_slice(grads[i], self.plans[i]) for i in bucket]
            mine = self._reduce_scatter(torch.cat(rows, dim=1))
            offset = 0
            for i, r in zip(bucket, rows):
                n = r.shape[1]
                out[i] = mine[offset:offset + n].view(self.shards[i].shape)
                offset += n
        if rest:
            all_reduce_sum([grads[i] for i in rest], self.group,
                           self.bucket_bytes)
            for i in rest:
                plan = self.plans[i]
                out[i] = (grads[i] if plan.dim is None
                          else self._mine(grads[i], plan).contiguous())
        if self.cp_group is not None:
            all_reduce_sum(out, self.cp_group, self.bucket_bytes)
        return out

    def refresh_staged(self) -> None:
        """Copy the parameters' slices into the staged shards."""
        for p, plan, shard, staged in zip(self.params, self.plans,
                                          self.shards, self.staged):
            if staged:
                shard.copy_(self._mine(p, plan))

    def _gather_into(self, tensors: Sequence[torch.Tensor],
                     targets: Sequence[Optional[torch.Tensor]],
                     indices: Sequence[int]) -> None:
        """All-gather the slices ``tensors[i]`` of parameters ``indices``
        and write each whole into ``targets[i]`` (None: gather only, for a
        rank that keeps nothing)."""
        for bucket in _buckets(indices, lambda i: tensors[i].numel()
                               * tensors[i].element_size(),
                               self.bucket_bytes):
            gathered = self._all_gather(
                torch.cat([tensors[i].reshape(-1) for i in bucket]))
            offset = 0
            for i in bucket:
                n = tensors[i].numel()
                if targets[i] is not None:
                    rows = self._rows(gathered[:, offset:offset + n],
                                      self.plans[i])
                    _place(targets[i], rows.to(targets[i].device),
                           self.plans[i])
                offset += n

    @torch.no_grad()
    def all_gather(self) -> None:
        """Write every rank's updated shards into the whole parameters."""
        split = [i for i, p in enumerate(self.plans) if p.dim is not None]
        self._gather_into(self.shards, self.params, split)

    @torch.no_grad()
    def whole(self, tensors: Sequence[torch.Tensor],
              device: Optional[torch.device] = None,
              keep: bool = True) -> List[Optional[torch.Tensor]]:
        """The whole tensors of shard-shaped ``tensors`` (aligned with the
        parameters: moments, gradients) on ``device`` (theirs when None).
        A collective over the zero group; with ``keep`` False this rank
        takes part and keeps nothing (a list of None)."""
        out = []
        for t, p, plan in zip(tensors, self.params, self.plans):
            if not keep:
                out.append(None)
            elif plan.dim is None:
                out.append(t.detach().to(device or t.device, copy=True))
            else:
                out.append(torch.empty(p.shape, dtype=t.dtype,
                                       device=device or t.device))
        split = [i for i, p in enumerate(self.plans) if p.dim is not None]
        self._gather_into([t.detach() for t in tensors], out, split)
        return out
