"""Ring-attention context parallelism over the ranks of a cp group.

Port of the flash ring of the JAX package's ``parallel/context_parallel.py``
(:160-572). The sequence stays split over the cp ranks through attention:
each rank holds two zig-zag blocks of queries, keys and values (block ids
``me`` and ``2·cp − 1 − me`` of ``2·cp`` equal slices, so every rank owns one
early and one late block and the causal triangle's work is balanced), and
the K/V blocks travel around the ring while each rank folds every hop's
(out, lse) into its running result. Each (q block, kv block) pair runs the
flash kernels through the ring-CP entries ``block_fwd_lse``, ``block_dq``
and ``block_dkv`` (B11) with global offsets, so causality and the dropout
hash read true positions: the realized mask equals the unsharded kernel's
for every cp.

``lax.ppermute`` becomes :func:`ring_shift`, chosen once from the group's
backend: NCCL exchanges device tensors with ``batch_isend_irecv``; gloo has
no send or receive of CUDA tensors, so there a CUDA tensor is staged
through pinned host memory (the route of ranks that share one card), and a
CPU tensor is sent as it is. On CPU tensors the pair entries run their
plain versions, on the card the kernels.

Not ported: the jnp online-softmax ring ``_ring_attention_local`` (:80-163),
which the JAX package takes under ``FLEETX_CP_FLASH=0`` or for blocks below
the flash tile (ROADMAP). A block here must be a multiple of the kernels'
64-row tile.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from fleetx_tpu_torch.ops import flash_attention as fa
from fleetx_tpu_torch.parallel.mesh import Mesh, get_mesh

__all__ = ["zigzag_split", "zigzag_merge", "zigzag_slice", "ring_shift",
           "ring_attention", "ring_self_attention"]

_NEG = -1e30


# ------------------------------------------------------------- zig-zag order

def _zigzag_order(cp: int) -> List[int]:
    order = []
    for i in range(cp):
        order += [i, 2 * cp - 1 - i]
    return order


def _permute_blocks(x: torch.Tensor, cp: int, axis: int,
                    invert: bool) -> torch.Tensor:
    s = x.shape[axis]
    if s % (2 * cp):
        raise ValueError(f"seq {s} not divisible by 2*cp={2 * cp}")
    order = _zigzag_order(cp)
    if invert:
        inv = [0] * (2 * cp)
        for pos, blk in enumerate(order):
            inv[blk] = pos
        order = inv
    blocks = x.unflatten(axis, (2 * cp, s // (2 * cp)))
    index = torch.tensor(order, device=x.device)
    return blocks.index_select(axis, index).flatten(axis, axis + 1)


def zigzag_split(x: torch.Tensor, cp: int, axis: int = 1) -> torch.Tensor:
    """Contiguous -> zig-zag order along ``axis`` (shape unchanged): the
    sequence cut into 2·cp blocks reordered to [b0, b_{2cp-1}, b1,
    b_{2cp-2}, ...], so an even split over cp ranks gives rank i its pair
    (b_i, b_{2cp-1-i})."""
    return _permute_blocks(x, cp, axis, invert=False)


def zigzag_merge(x: torch.Tensor, cp: int, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`zigzag_split`."""
    return _permute_blocks(x, cp, axis, invert=True)


def zigzag_slice(x: torch.Tensor, cp: int, cp_rank: int,
                 axis: int = 1) -> torch.Tensor:
    """Rank ``cp_rank``'s share of the zig-zag-ordered ``x``: its two
    blocks, contiguous."""
    z = zigzag_split(x, cp, axis)
    n = z.shape[axis] // cp
    return z.narrow(axis, cp_rank * n, n).contiguous()


# ------------------------------------------------------------- the exchange

def ring_shift(tensors: Sequence[torch.Tensor], mesh: Mesh
               ) -> List[torch.Tensor]:
    """Send each tensor to the next rank of this rank's cp ring and return
    the previous rank's (``lax.ppermute`` with perm r -> r + 1). Every rank
    of the ring must call it with tensors of the same shapes and dtypes.

    The route follows the group's backend, decided here from it and never
    from an error: NCCL takes device tensors as they are; on gloo a CUDA
    tensor is copied to pinned host memory, sent, received into pinned
    memory and copied back."""
    ranks = mesh.cp_ranks
    cp = len(ranks)
    if cp == 1:
        return list(tensors)
    me = ranks.index(mesh.rank)
    nxt, prv = ranks[(me + 1) % cp], ranks[(me - 1) % cp]
    group = mesh.cp_group
    if dist.get_backend(group) == "nccl":
        recv = [torch.empty_like(t, memory_format=torch.contiguous_format)
                for t in tensors]
        ops = []
        for t, r in zip(tensors, recv):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
            ops.append(dist.P2POp(dist.irecv, r, prv, group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv
    sends, recvs, reqs = [], [], []
    for tag, t in enumerate(tensors):
        if t.is_cuda:  # gloo sends host memory only: stage through pinned
            send = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            send.copy_(t)  # waits for the stream: the bytes are final
        else:
            send = t.contiguous()
        recv = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        reqs.append(dist.isend(send, nxt, group=group, tag=tag))
        reqs.append(dist.irecv(recv, prv, group=group, tag=tag))
        sends.append(send)
        recvs.append(recv)
    for req in reqs:
        req.wait()
    return [r.to(t.device, non_blocking=True) if t.is_cuda else r
            for r, t in zip(recvs, tensors)]


# ---------------------------------------------------------- the flash ring

def _block_meta(ids: Tuple[int, int, int], h: int, s_blk: int, q_id: int,
                k_id: int) -> Tuple[int, ...]:
    """Kernel meta of one pair (JAX ``_block_meta``, :166): ``ids`` = (the
    global batch offset, the global id of the first of the ``h`` local
    heads, the global head count), and the blocks' global positions from
    their zig-zag ids."""
    b0, h0, h_total = ids
    return (b0, h0, h, h_total, q_id * s_blk, k_id * s_blk)


def _merge_lse(res, lse, o, l):
    """Fold one normalized hop result (o, l) into the running (res, lse):
    res' = res·exp(lse − L') + o·exp(l − L'), L' = logaddexp(lse, l)."""
    m = torch.maximum(lse, l)
    l_new = m + torch.log(torch.exp(lse - m) + torch.exp(l - m))
    res_new = (res * torch.exp(lse - l_new)[..., None]
               + o.float() * torch.exp(l - l_new)[..., None])
    return res_new, l_new


def _t0_pairs(causal: bool):
    """(q_slot, kv_slot, diag) pairs of the self-hop (t = 0). Slot 0 is the
    early zig-zag block (global id me), slot 1 the late one."""
    if causal:
        # (A, A) and (B, B) on the diagonal; (B, A) fully ordered, B > A
        return ((0, 0, True), (1, 1, True), (1, 0, False))
    return ((0, 0, False), (0, 1, False), (1, 0, False), (1, 1, False))


def _hop_pairs(causal: bool, src: int, me: int):
    """(q_slot, kv_slot) pairs of a later hop whose K/V came from ``src``,
    in the JAX hop's order. Causal: src < me (no wrap) puts kv block C in
    both q blocks' past -> (A, C), (B, C); src > me puts only the late q
    block B after both kv blocks -> (B, C), (B, D)."""
    if not causal:
        return ((0, 0), (0, 1), (1, 0), (1, 1))
    return ((0, 0), (1, 0)) if src < me else ((1, 0), (1, 1))


class _RingFlash(torch.autograd.Function):
    """The ring's forward (JAX ``_ring_flash_fwd``, :207-273) and backward
    (``_ring_flash_bwd``, :276-383) over [b, 2, s_blk, h, d] blocks."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, causal, dropout_rate, seed, ids):
        cp, me = mesh.cp, mesh.cp_rank
        b, _, s_blk, h, d = q.shape
        q_ids = (me, 2 * cp - 1 - me)
        kw = dict(dropout_rate=dropout_rate, kv_len=2 * cp * s_blk)

        def call(qi, q_id, k_blk, v_blk, k_id, diag):
            return fa.block_fwd_lse(q[:, qi], k_blk, v_blk, seed,
                                    _block_meta(ids, h, s_blk, q_id, k_id),
                                    causal=diag, **kw)

        res = [q.new_zeros((b, s_blk, h, d), dtype=torch.float32)
               for _ in range(2)]
        lse = [q.new_full((b, s_blk, h), _NEG, dtype=torch.float32)
               for _ in range(2)]
        for qi, ki, diag in _t0_pairs(causal):
            o, l = call(qi, q_ids[qi], k[:, ki], v[:, ki], q_ids[ki], diag)
            res[qi], lse[qi] = _merge_lse(res[qi], lse[qi], o, l)
        k_cur, v_cur = k, v
        for t in range(1, cp):
            k_cur, v_cur = ring_shift((k_cur, v_cur), mesh)
            src = (me - t) % cp
            kv_ids = (src, 2 * cp - 1 - src)
            for qi, ki in _hop_pairs(causal, src, me):
                o, l = call(qi, q_ids[qi], k_cur[:, ki], v_cur[:, ki],
                            kv_ids[ki], False)
                res[qi], lse[qi] = _merge_lse(res[qi], lse[qi], o, l)
        out = torch.stack(res, dim=1).to(q.dtype)
        lse_all = torch.stack(lse, dim=1)  # [b, 2, s_blk, h]
        ctx.save_for_backward(q, k, v, out, lse_all)
        ctx.opts = (mesh, causal, dropout_rate, seed, ids)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse_all = ctx.saved_tensors
        mesh, causal, dropout_rate, seed, ids = ctx.opts
        cp, me = mesh.cp, mesh.cp_rank
        b, _, s_blk, h, d = q.shape
        q_ids = (me, 2 * cp - 1 - me)
        do = do.to(q.dtype)
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = (do.float() * out.float()).sum(-1)  # [b, 2, s_blk, h]
        kw = dict(dropout_rate=dropout_rate, kv_len=2 * cp * s_blk)

        def pair(qi, k_blk, v_blk, k_id):
            args = (q[:, qi], k_blk, v_blk, do[:, qi], lse_all[:, qi],
                    delta[:, qi], seed,
                    _block_meta(ids, h, s_blk, q_ids[qi], k_id))
            return args

        dq = [q.new_zeros((b, s_blk, h, d), dtype=torch.float32)
              for _ in range(2)]
        dk_cur = q.new_zeros((b, 2, s_blk, h, d), dtype=torch.float32)
        dv_cur = torch.zeros_like(dk_cur)
        for qi, ki, diag in _t0_pairs(causal):
            args = pair(qi, k[:, ki], v[:, ki], q_ids[ki])
            dq[qi] += fa.block_dq(*args, causal=diag, **kw)
            dk_c, dv_c = fa.block_dkv(*args, causal=diag, **kw)
            dk_cur[:, ki] += dk_c
            dv_cur[:, ki] += dv_c
        k_cur, v_cur = k, v
        for t in range(1, cp):
            # K/V take the forward's tour; the dk/dv accumulators ride
            # along so each contribution stays with its block
            k_cur, v_cur, dk_cur, dv_cur = ring_shift(
                (k_cur, v_cur, dk_cur, dv_cur), mesh)
            src = (me - t) % cp
            kv_ids = (src, 2 * cp - 1 - src)
            for qi, ki in _hop_pairs(causal, src, me):
                args = pair(qi, k_cur[:, ki], v_cur[:, ki], kv_ids[ki])
                dq[qi] += fa.block_dq(*args, causal=False, **kw)
                dk_c, dv_c = fa.block_dkv(*args, causal=False, **kw)
                dk_cur[:, ki] += dk_c
                dv_cur[:, ki] += dv_c
        # contributions made at hop t have travelled cp - 1 - t of the cp - t
        # shifts back to their block's rank: one more closes the ring
        dk, dv = ring_shift((dk_cur, dv_cur), mesh)
        dq_out = torch.stack(dq, dim=1)
        return (dq_out.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: Mesh, causal: bool = True,
                   dropout_rate: float = 0.0, seed: Optional[int] = None,
                   batch_offset: int = 0, head_offset: int = 0,
                   heads_total: Optional[int] = None) -> torch.Tensor:
    """Ring attention over this rank's share ``[b, s_local, h, d]`` of a
    zig-zag-ordered sequence (its two blocks, early then late), around
    ``mesh``'s cp ring. ``dropout_rate > 0`` needs an int32 ``seed``, the
    same on every rank; ``batch_offset`` is the global index of row 0 (dp
    shards the batch), ``head_offset`` the global id of local head 0 of
    ``heads_total`` (mp shards the heads; h when None): both key the
    dropout hash. Differentiable in q, k and v."""
    b, s_local, h, d = q.shape
    if s_local % 2 or (s_local // 2) % fa.TILE:
        raise ValueError(
            f"local seq {s_local} must hold two zig-zag blocks of a "
            f"multiple of {fa.TILE} rows (the flash ring's pair tile; the "
            "jnp ring for smaller blocks is not ported)")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("ring_attention: dropout_rate > 0 requires an "
                         "explicit seed (a silent default would reuse one "
                         "mask across every call)")
    blocks = [t.view(b, 2, s_local // 2, h, d) for t in (q, k, v)]
    out = _RingFlash.apply(*blocks, mesh, bool(causal), float(dropout_rate),
                           int(seed or 0),
                           (int(batch_offset), int(head_offset),
                            int(heads_total or h)))
    return out.view(b, s_local, h, d)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, mesh: Optional[Mesh] = None, causal: bool = True,
                        expected_cp: Optional[int] = None,
                        dropout_rate: float = 0.0,
                        seed: Optional[int] = None,
                        batch_offset: int = 0, head_offset: int = 0,
                        heads_total: Optional[int] = None) -> torch.Tensor:
    """Attention over this rank's share of a zig-zag-ordered sequence (the
    data path permutes each batch once, ``GPTModule.cp_prepare``), around
    the cp ring of ``mesh`` (the current mesh when None).

    ``expected_cp``: the cp degree the caller's config promises; a mesh
    without that cp axis raises instead of running plain attention on
    zig-zag-ordered, i.e. wrongly ordered, data. Without a cp axis and
    without a promise, the inputs are in natural order and plain causal
    attention is exact. ``dropout_rate > 0`` needs ``seed``; the offsets
    are :func:`ring_attention`'s."""
    from fleetx_tpu_torch.ops.attention import causal_attention

    mesh = mesh or get_mesh()
    have_cp = mesh.cp > 1
    if expected_cp and expected_cp > 1 and mesh.cp != expected_cp:
        raise RuntimeError(
            f"model configured with cp_degree={expected_cp} but the mesh is "
            f"{mesh}; ring attention needs the cp axis (inputs are zig-zag "
            "ordered: falling back would be silently wrong)")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    if not have_cp:
        h = q.shape[2]
        return causal_attention(q, k, v, causal=causal,
                                dropout_rate=dropout_rate, seed=seed,
                                deterministic=dropout_rate == 0.0,
                                meta=(batch_offset, head_offset, h,
                                      heads_total or h, 0, 0))
    return ring_attention(q, k, v, mesh=mesh, causal=causal,
                          dropout_rate=dropout_rate, seed=seed,
                          batch_offset=batch_offset, head_offset=head_offset,
                          heads_total=heads_total)
