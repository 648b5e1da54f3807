"""Mixture-of-Experts MLP with expert parallelism over the data ranks.

Port of the JAX package's ``parallel/moe.py`` (:36-241): the routing
(``compute_routing_indices``, ``compute_routing``, the balance loss) and
``MoEMLP``, the decoder layer's MLP under ``expert_mode``.

Routing, for ``n`` tokens and ``E`` experts (:36-131):

- the gate's fp32 logits (switch: times a jitter drawn uniform in [0.98,
  1.02]), an fp32 softmax, then the top k (top 1 for switch), ties to the
  lower expert id as ``lax.top_k``;
- gshard keeps each token's second expert where a uniform draw lies below
  twice its probability (random routing), else weighs it 0;
- the kept probabilities renormalised over the slots; the balance loss
  ``E · Σ_e mean(top-1 mask_e) · mean(prob_e)``;
- each (token, slot) takes the next queue position of its expert, slot 0
  of every token first, then slot 1 (GShard order); kept where its
  position is below the capacity ``max(1, int(cf · n · k / E))`` and its
  weight above 0.

The draws are JAX's bits for a raw threefry key (``jax.random.uniform``
in the partitionable layout the JAX package pins): element i of the draw
hashes its flat index in the GLOBAL array, so a rank draws its own part
of the one-device draw.

The layer (:134-241): a bias-free fp32 gate, expert weights stacked as
JAX stacks and names them (``w_up`` [E, h, f], ``b_up`` [E, f], ``w_down``
[E, f, h], ``b_down`` [E, h]; no ``bias`` in the names, so all four take
weight decay, as in JAX), the tokens and weights cast to the compute
dtype, batched expert GEMMs and a tanh GeLU. Dispatch and combine are
index gathers in JAX's scatter order (``moe_dispatch: scatter``; the
einsum mode computes the same function, JAX holds the two within 2e-5):
each expert slot gathers its one token, and each token sums its slots'
outputs times their weights, slot 0 first.

Expert parallelism (``data_world`` > 1, the data ranks of the mesh):
JAX shards the experts over its data axes and lets GSPMD route the
GLOBAL batch, so ``n`` is the global token count and the queue positions
run over the global token order, rank 0's rows first. The port does the
same: the gate's fp32 probabilities are all-gathered over the data group
(the other ranks' rows detached, so the balance loss's gradient reaches
each rank's own rows once) and every rank computes the same positions,
keep flags and capacity. Rank r holds experts ``[r·E/D, (r+1)·E/D)``;
tokens move to their experts' owners and the outputs back through two
all-to-alls (the reference's ``MoEScatter``/``MoEGather``), each an
autograd function whose backward is the reverse exchange. The split
sizes follow from the routing every rank holds, so no count is
exchanged. Over gloo (ranks sharing a card) the exchange is staged
through pinned host buffers; over NCCL it runs on the card.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from fleetx_tpu_torch.ops.dropout import threefry2x32
from fleetx_tpu_torch.parallel.mesh import get_mesh
from fleetx_tpu_torch.parallel.tensor_parallel import _collective, _host

__all__ = ["EXPERT_LEAVES", "MoEMLP", "balance_loss",
           "compute_routing", "compute_routing_indices", "expert_block",
           "is_expert_param", "moe_capacity", "route", "uniform"]

# the stacked expert parameters of an MoEMLP, named as JAX names them
EXPERT_LEAVES = ("w_up", "b_up", "w_down", "b_down")

_M32 = 0xFFFFFFFF


def is_expert_param(name: str) -> bool:
    """Whether the parameter ``name`` (a dotted state-dict path) is a
    stacked expert leaf ([E, ...], split over the data ranks under
    expert parallelism); the gate is not."""
    parts = name.split(".")
    return len(parts) > 1 and parts[-2] == "moe_mlp" and \
        parts[-1] in EXPERT_LEAVES


def expert_block(num_experts: int, world: int, rank: int) -> slice:
    """The experts data rank ``rank`` of ``world`` holds; ``ValueError``
    naming both numbers when ``world`` does not divide ``num_experts``."""
    if num_experts % world:
        raise ValueError(f"{num_experts} experts do not split over "
                         f"{world} data ranks")
    per = num_experts // world
    return slice(rank * per, (rank + 1) * per)


def uniform(key: Tuple[int, int], idx: torch.Tensor, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` at the
    flat indices ``idx`` (int64) of the global array, partitionable
    layout: the top 23 bits of the xor of the two threefry words of the
    counter (i >> 32, i & 0xffffffff) make a float in [1, 2), minus 1,
    scaled by ``maxval - minval``, shifted by ``minval`` and held at or
    above it, in fp32. XLA fuses the scale and shift into one fused
    multiply-add (one rounding): the product of two fp32 values is exact
    in fp64, so the fp64 sum rounded once to fp32 gives its bits."""
    b0, b1 = threefry2x32(key, idx >> 32, idx & _M32)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=idx.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=idx.device)
    scaled = (u.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def balance_loss(probs: torch.Tensor, top1: torch.Tensor) -> torch.Tensor:
    """GShard/Switch load-balance loss ``E · Σ_e mean(mask_e) ·
    mean(prob_e)`` of the probabilities [n, E] and the top-1 expert ids
    [n] (JAX ``_balance_loss``, :36-42)."""
    num_experts = probs.shape[-1]
    density = F.one_hot(top1, num_experts).float().mean(0)
    return num_experts * torch.sum(density * probs.mean(0))


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, equal values in
    the order of their index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def compute_routing_indices(gate_logits: torch.Tensor, top_k: int,
                            capacity: int, gate_type: str = "gshard",
                            key: Optional[Tuple[int, int]] = None,
                            offset: int = 0, probs=None):
    """Sparse routing of the tokens' gate logits [n, E] (JAX
    ``compute_routing_indices``, :45-103): ``(topk_idx [n, k] int64, pos
    [n, k] int64, weights [n, k] fp32, keep [n, k] bool, aux)``. ``key``
    (a raw threefry key) draws gshard's second-expert keep for the token
    at global index ``offset + i``. ``probs`` [n, E], when given, are the
    softmax of the logits already (expert parallelism gathers them)."""
    n, num_experts = gate_logits.shape
    if probs is None:
        probs = torch.softmax(gate_logits.float(), dim=-1)
    topk_probs, topk_idx = _top_k(probs, top_k)
    if gate_type == "gshard" and top_k >= 2 and key is not None:
        idx = torch.arange(n, device=probs.device) + offset
        keep2 = uniform(key, idx) < 2.0 * topk_probs[:, 1]
        topk_probs = torch.cat([topk_probs[:, :1], torch.where(
            keep2, topk_probs[:, 1], torch.zeros_like(topk_probs[:, 1]))[
                :, None], topk_probs[:, 2:]], dim=1)
    denom = topk_probs.sum(-1, keepdim=True).clamp_min(1e-9)
    weights = topk_probs / denom
    aux = balance_loss(probs, topk_idx[:, 0])
    pos, keep = _positions(topk_idx, weights, num_experts, capacity)
    return topk_idx, pos, weights, keep, aux


def _positions(topk_idx: torch.Tensor, weights: torch.Tensor,
               num_experts: int, capacity: int):
    """Each (token, slot)'s queue position in its expert, slot 0 of every
    token first, clipped to the capacity, and whether it is kept."""
    fill = torch.zeros(num_experts, dtype=torch.int64,
                       device=topk_idx.device)
    pos, keep = [], []
    for slot in range(topk_idx.shape[1]):
        e = topk_idx[:, slot]
        onehot = F.one_hot(e, num_experts)
        before = onehot.cumsum(0) - onehot + fill
        p = before.gather(1, e[:, None])[:, 0]
        keep.append((p < capacity) & (weights[:, slot] > 0))
        pos.append(p.clamp(0, capacity - 1))
        fill = fill + onehot.sum(0)
    return torch.stack(pos, 1), torch.stack(keep, 1)


def compute_routing(gate_logits: torch.Tensor, top_k: int, capacity: int,
                    gate_type: str = "gshard",
                    key: Optional[Tuple[int, int]] = None):
    """Dense form (JAX ``compute_routing``, :106-131): ``(dispatch [n, E,
    C] bool, combine [n, E, C] fp32, aux)`` from the sparse decisions."""
    n, num_experts = gate_logits.shape
    topk_idx, pos, weights, keep, aux = compute_routing_indices(
        gate_logits, top_k, capacity, gate_type, key)
    dispatch = torch.zeros(n, num_experts, capacity, dtype=torch.bool,
                           device=gate_logits.device)
    combine = torch.zeros(n, num_experts, capacity,
                          device=gate_logits.device)
    rows = torch.arange(n, device=gate_logits.device)
    for slot in range(topk_idx.shape[1]):
        e, p, k = topk_idx[:, slot], pos[:, slot], keep[:, slot]
        dispatch[rows, e, p] |= k
        combine[rows, e, p] += torch.where(k, weights[:, slot], 0.0)
    return dispatch, combine, aux


def moe_capacity(cfg, n: int) -> Tuple[int, int]:
    """``(k, capacity)`` of ``n`` routed tokens: the effective top k (1 for
    switch) and ``max(1, int(cf · n · k / E))`` (JAX :152-155)."""
    k = 1 if cfg.gate == "switch" else cfg.top_k
    return k, max(1, int(cfg.capacity_factor * n * k / cfg.num_experts))


def route(probs: torch.Tensor, cfg, key: Optional[Tuple[int, int]]):
    """The routing of the global batch's probabilities [n, E] (the same on
    every data rank): ``(topk_idx, pos, weights, keep, aux, capacity)``,
    ``capacity`` the length of each expert's buffer."""
    k, capacity = moe_capacity(cfg, probs.shape[0])
    gshard_key = key if cfg.gate == "gshard" else None
    out = compute_routing_indices(probs, k, capacity, cfg.gate, gshard_key,
                                  probs=probs)
    return out + (capacity,)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` with split sizes; the backward is the reverse
    exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, send: List[int], recv: List[int], group):
        ctx.send, ctx.recv, ctx.group = send, recv, group
        return _exchange(x, send, recv, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.recv, ctx.send,
                         ctx.group), None, None, None


def _exchange(x: torch.Tensor, send: List[int], recv: List[int],
              group) -> torch.Tensor:
    """Rows ``x`` [sum(send), h] sent in blocks of ``send`` to the ranks
    of ``group``; the rows received, [sum(recv), h], in rank order. Over
    gloo with tensors on the card through pinned host buffers (the
    copies synchronous); over NCCL on the card."""
    x = x.contiguous()
    out = torch.empty((sum(recv),) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    if x.is_cuda and dist.get_backend(group) == "gloo":
        host_in = _host("moe_a2a:in", x)
        host_in.copy_(x)
        host_out = _host("moe_a2a:out", out)
        dist.all_to_all_single(host_out, host_in, recv, send, group=group)
        out.copy_(host_out)
        return out
    dist.all_to_all_single(out, x, recv, send, group=group)
    return out


def _gather_probs(probs: torch.Tensor, group, rank: int) -> torch.Tensor:
    """[D·n, E]: every data rank's probabilities in rank order; this rank's
    slice is ``probs`` itself (its gradient flows), the others are
    detached copies."""
    world = dist.get_world_size(group)
    src = probs.detach().contiguous()
    whole = torch.empty((world,) + tuple(src.shape), dtype=src.dtype,
                        device=src.device)
    _collective(dist.all_gather_into_tensor, whole.view(-1), src.view(-1),
                group)
    parts = list(whole)
    parts[rank] = probs
    return torch.cat(parts, dim=0)


class _Gate(nn.Module):
    """The bias-free fp32 gate (JAX ``DenseGeneral(features=E,
    use_bias=False, dtype=float32)``): ``weight`` [E, h]."""

    def __init__(self, hidden: int, experts: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(experts, hidden,
                                               device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight.float())


class MoEMLP(nn.Module):
    """The decoder layer's MLP under ``expert_mode`` (JAX ``MoEMLP``,
    :134-241); holds ``num_experts / ep_world`` experts (the block of
    :func:`expert_block` for its data rank) when the experts are split
    over ``ep_world`` data ranks. :meth:`forward` returns ``(y, aux)``,
    aux the layer's balance loss (over the global batch)."""

    def __init__(self, cfg, device=None, ep_world: int = 1):
        super().__init__()
        if cfg.moe_dispatch not in ("auto", "einsum", "scatter"):
            raise ValueError(f"moe_dispatch={cfg.moe_dispatch!r}; choose "
                             "auto | einsum | scatter")
        self.cfg = cfg
        self.ep_world = ep_world
        e, h, f = cfg.num_experts, cfg.hidden_size, cfg.ffn_size
        per = expert_block(e, ep_world, 0).stop
        self.gate = _Gate(h, e, device)

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        self.w_up, self.b_up = param(per, h, f), param(per, f)
        self.w_down, self.b_down = param(per, f, h), param(per, h)

    def forward(self, x: torch.Tensor, key: Optional[Tuple[int, int]] = None,
                offset: int = 0):
        """``x`` [b, s, h] → ``(y [b, s, h], aux)``. ``key``: the layer's
        raw threefry key (training; None draws nothing); ``offset``: the
        global index of this rank's first token. Under expert
        parallelism the routing runs over the data group's tokens."""
        cfg = self.cfg
        b, s, h = x.shape
        tokens = x.reshape(b * s, h)
        logits = self.gate(tokens.float())
        if cfg.gate == "switch" and key is not None:
            n, e = logits.shape
            idx = ((torch.arange(n, device=x.device) + offset)[:, None] * e
                   + torch.arange(e, device=x.device))
            logits = logits * uniform(key, idx, 0.98, 1.02)
        probs = torch.softmax(logits.float(), dim=-1)
        mesh = get_mesh()
        world = self.ep_world
        if world > 1:
            if mesh.data_world != world:
                raise ValueError(f"the model's experts are split over "
                                 f"{world} data ranks, the mesh has "
                                 f"{mesh.data_world}")
            rank = mesh.data_rank
            probs = _gather_probs(probs, mesh.data_group, rank)
        else:
            rank = 0
        topk_idx, pos, weights, keep, aux, capacity = route(probs, cfg,
                                                            key)
        n_loc = b * s
        mine = slice(rank * n_loc, (rank + 1) * n_loc)
        dt = cfg.dtype
        if world == 1:
            y = self._local(tokens.to(dt), topk_idx, pos, keep, capacity)
        else:
            y = self._exchanged(tokens.to(dt), topk_idx, pos, keep, capacity,
                                rank, mesh.data_group)
        out = torch.zeros(n_loc, h, dtype=dt, device=x.device)
        w = (weights[mine] * keep[mine]).to(dt)
        for slot, ys in enumerate(y):
            out = out + ys * w[:, slot, None]
        return out.view(b, s, h), aux

    def _experts(self, expert_in: torch.Tensor) -> torch.Tensor:
        """The local experts' FFN on their buffers [E_loc, C, h], in the
        compute dtype: up, tanh GeLU, down; [E_loc·C, h]."""
        dt = self.cfg.dtype
        hidden = F.gelu(torch.bmm(expert_in, self.w_up.to(dt))
                        + self.b_up[:, None, :].to(dt), approximate="tanh")
        out = (torch.bmm(hidden, self.w_down.to(dt))
               + self.b_down[:, None, :].to(dt))
        return out.reshape(-1, out.shape[-1])

    def _local(self, tokens, topk_idx, pos, keep, capacity) -> list:
        """Every expert on this rank: each buffer slot gathers the token
        routed there (or a zero row), and each slot of a token gathers its
        expert output (the zero row where dropped)."""
        n, h = tokens.shape
        e = self.cfg.num_experts
        trash = e * capacity
        flat = torch.where(keep, topk_idx * capacity + pos,
                           torch.full_like(pos, trash))  # [n, k]
        owner = torch.full((trash + 1,), n, dtype=torch.int64,
                           device=tokens.device)
        rows = torch.arange(n, device=tokens.device)[:, None].expand_as(flat)
        owner.index_put_((flat.reshape(-1),), rows.reshape(-1))
        padded = torch.cat([tokens, tokens.new_zeros(1, h)])
        expert_in = padded[owner[:trash]].view(e, capacity, h)
        outs = torch.cat([self._experts(expert_in), tokens.new_zeros(1, h)])
        return [outs[flat[:, j]] for j in range(flat.shape[1])]

    def _exchanged(self, tokens, topk_idx, pos, keep, capacity, rank: int,
                   group) -> list:
        """Expert parallelism: this rank's kept (token, slot) entries sent
        to their experts' owners (by destination, then token, then slot),
        the entries routed to this rank's experts received (by source
        rank, then token, then slot), the outputs sent back the same way
        reversed."""
        n_loc, h = tokens.shape
        world = self.ep_world
        per = self.cfg.num_experts // world
        k = topk_idx.shape[1]
        dev = tokens.device
        owner_rank = topk_idx // per
        # what this rank sends: its tokens' kept entries, by destination
        mine = slice(rank * n_loc, (rank + 1) * n_loc)
        local_keep = keep[mine].reshape(-1)
        sel = local_keep.nonzero()[:, 0]
        dest = owner_rank[mine].reshape(-1)[sel]
        order = torch.sort(dest, stable=True).indices
        send_entries = sel[order]
        send = torch.bincount(dest, minlength=world)
        # what it receives: every rank's kept entries for its experts, in
        # global (source rank, token, slot) order
        recv_sel = (keep.reshape(-1)
                    & (owner_rank.reshape(-1) == rank)).nonzero()[:, 0]
        recv = torch.bincount(recv_sel // (k * n_loc), minlength=world)
        counts = torch.cat([send, recv]).tolist()
        send, recv = counts[:world], counts[world:]
        rows_in = _AllToAll.apply(tokens[send_entries // k], send, recv,
                                  group)
        m = rows_in.shape[0]
        slot_of = ((topk_idx.reshape(-1)[recv_sel] - rank * per) * capacity
                   + pos.reshape(-1)[recv_sel])
        owner = torch.full((per * capacity,), m, dtype=torch.int64,
                           device=dev)
        owner[slot_of] = torch.arange(m, device=dev)
        padded = torch.cat([rows_in, rows_in.new_zeros(1, h)])
        expert_out = self._experts(padded[owner].view(per, capacity, h))
        back = _AllToAll.apply(expert_out[slot_of], recv, send, group)
        # each local (token, slot) entry's row of ``back`` (or a zero row)
        at = torch.full((n_loc * k,), back.shape[0], dtype=torch.int64,
                        device=dev)
        at[send_entries] = torch.arange(back.shape[0], device=dev)
        outs = torch.cat([back, back.new_zeros(1, h)])
        at = at.view(n_loc, k)
        return [outs[at[:, j]] for j in range(k)]
