"""Optimizer and gradient-clip construction.

Port of the JAX package's optims/optimizer.py: AdamW (``AdamW``,
``FusedAdamW``; ``Adam`` with no decay) whose weight decay skips the
LayerNorm scales and biases and every bias — the set the JAX decay mask
(``:62-68``) names ``norm1``, ``norm2``, ``final_norm`` and ``bias`` —
and the global-norm clip of ``optax.clip_by_global_norm``. Under tensor
and pipeline parallelism the norm is the whole model's, as JAX's norm of
the global arrays is (:func:`global_norm`); under the ZeRO weight-update
shard the norm, the clip and AdamW run on this rank's slices
(``parallel/sharding.py``). Momentum/SGD and the per-block and
by-value clips are not ported.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["build_optimizer", "build_grad_clip", "clip_by_global_norm",
           "decay_mask", "global_norm"]

_NO_DECAY = {"norm1", "norm2", "final_norm", "bias"}


def decay_mask(name: str) -> bool:
    """Whether the parameter named ``name`` (a dotted ``named_parameters``
    path) takes weight decay."""
    return not (_NO_DECAY & set(name.split(".")))


def global_norm(grads: List[torch.Tensor],
                sharded: Optional[Sequence[bool]] = None,
                group=None, stage_group=None,
                zero_parts: Optional[Sequence[int]] = None,
                zero_group=None) -> torch.Tensor:
    """The L2 norm (fp32, on the grads' device) of ``grads`` as one
    vector. With an mp ``group``, ``sharded[i]`` says whether ``grads[i]``
    is this rank's shard of a parameter split over the group: the shards'
    squares are summed over the group and the replicated gradients (the
    same on every rank) counted once. With a ``zero_group`` (the ZeRO
    weight-update shard, ``parallel/sharding.py``), ``zero_parts[i]`` is
    the number of slices parameter i is cut into over it (1: whole on
    every rank): the slices' squares are summed over the group, each
    slice counted once. With a pp ``stage_group`` (each rank one stage's
    gradients) the stages' squares are summed over it. Every rank gets
    the whole model's norm."""
    if group is None and stage_group is None and zero_group is None:
        return torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    sharded = sharded if sharded is not None else [False] * len(grads)
    zero = torch.zeros((), device=grads[0].device)
    if zero_group is None:
        squares = [sum((torch.linalg.vector_norm(g.float()) ** 2
                        for g, s in zip(grads, sharded) if s == want), zero)
                   for want in (True, False)]
    else:
        # [mp-split, replicated] squares of the slices, summed over the
        # zero group (a slice that k ranks hold weighs k / world: counted
        # once), then those of the leaves whole on every rank
        world = dist.get_world_size(zero_group)
        sliced = torch.stack([
            sum((torch.linalg.vector_norm(g.float()) ** 2
                 * (1.0 if z == world else z / world)
                 for g, s, z in zip(grads, sharded, zero_parts)
                 if s == want and z > 1), zero)
            for want in (True, False)])
        dist.all_reduce(sliced, group=zero_group)
        squares = [sliced[i] + sum((torch.linalg.vector_norm(g.float()) ** 2
                                    for g, s, z in zip(grads, sharded,
                                                       zero_parts)
                                    if s == want and z == 1), zero)
                   for i, want in enumerate((True, False))]
    if group is not None:
        dist.all_reduce(squares[0], group=group)
    total = squares[0] + squares[1]
    if stage_group is not None:
        dist.all_reduce(total, group=stage_group)
    return torch.sqrt(total)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: with ``n`` the global L2
    norm of ``grads`` (``norm`` when given, else :func:`global_norm`),
    leave them when ``n < max_norm`` and otherwise replace each g by ``g /
    n * max_norm`` (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``).
    Returns ``n`` (fp32, on the grads' device). The choice is made on the
    device, as optax's select is: every g is divided and multiplied by
    device scalars that are 1 when it is kept (exact), so the host never
    waits for the norm."""
    norm = global_norm(grads) if norm is None else norm
    keep = norm < max_norm
    one = torch.ones((), device=norm.device)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, max_norm))
    return norm


def build_grad_clip(clip_cfg) -> Optional[Callable[..., torch.Tensor]]:
    """ClipGradByGlobalNorm (and its MoE alias) by name, as a function of
    ``(grads, norm=None)``; None when the config names no clip."""
    if not clip_cfg or not clip_cfg.get("name"):
        return None
    name = clip_cfg["name"]
    if name in ("ClipGradByGlobalNorm", "ClipGradForMOEByGlobalNorm"):
        max_norm = float(clip_cfg.get("clip_norm", 1.0))
        return lambda grads, norm=None: clip_by_global_norm(grads, max_norm,
                                                            norm)
    raise NotImplementedError(f"grad clip {name!r} is not ported yet")


def build_optimizer(opt_cfg, named_params: Iterable[Tuple[str,
                                                          torch.nn.Parameter]]
                    ) -> torch.optim.Optimizer:
    """AdamW over two parameter groups (decayed / not, by
    :func:`decay_mask`) with the config's betas, epsilon and weight decay.
    The learning rate is set by the trainer before every step from its
    schedule. On CUDA parameters the fused implementation runs."""
    cfg = dict(opt_cfg or {})
    name = cfg.get("name", "AdamW")
    if name not in ("AdamW", "FusedAdamW", "Adam"):
        raise NotImplementedError(f"optimizer {name!r} is not ported yet")
    wd = cfg.get("weight_decay", 0.01) if name != "Adam" else 0.0
    decay, plain = [], []
    for pname, param in named_params:
        (decay if decay_mask(pname) else plain).append(param)
    groups = [{"params": decay, "weight_decay": wd},
              {"params": plain, "weight_decay": 0.0}]
    device = (decay + plain)[0].device
    return torch.optim.AdamW(
        groups, lr=0.0, betas=(cfg.get("beta1", 0.9), cfg.get("beta2", 0.999)),
        eps=cfg.get("epsilon", 1e-8), fused=device.type == "cuda")
