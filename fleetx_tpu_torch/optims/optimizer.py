"""Optimizer and gradient-clip construction.

Port of the JAX package's optims/optimizer.py:

- AdamW (``AdamW``, ``FusedAdamW``; ``Adam`` with no decay) whose weight
  decay skips the LayerNorm scales and biases and every bias — the set
  the JAX decay mask (``:62-68``) names ``norm1``, ``norm2``,
  ``final_norm`` and ``bias``. ``moment_dtype: bfloat16`` stores the
  first moment in bf16 as optax's ``mu_dtype`` does (:class:`AdamWMu`);
- ``Momentum`` and ``SGD`` (:69-84): SGD with the L2 decay coupled,
  ``wd · p`` added to the gradient under the same mask before the
  momentum buffer and the learning rate (optax ``add_decayed_weights``
  then ``sgd``, with ``momentum`` and ``use_nesterov``);
- the clips (:27-40): ``ClipGradByGlobalNorm`` (optax
  ``clip_by_global_norm``), ``ClipGradByNorm`` (optax
  ``clip_by_block_rms``: each parameter scaled by its own RMS, not its L2
  norm) and ``ClipGradByValue`` (optax ``clip``).

Under tensor and pipeline parallelism the global norm is the whole
model's, as JAX's norm of the global arrays is (:func:`global_norm`), and
a block's RMS is the whole parameter's (:class:`Blocks`); under the ZeRO
weight-update shard the norm, the clip and the update run on this rank's
slices (``parallel/sharding.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["AdamWMu", "Blocks", "GradClip", "build_optimizer",
           "build_grad_clip", "clip_by_block_rms", "clip_by_global_norm",
           "clip_by_value", "decay_mask", "global_norm", "moment_keys"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_NO_DECAY = {"norm1", "norm2", "final_norm", "bias"}


def decay_mask(name: str) -> bool:
    """Whether the parameter named ``name`` (a dotted ``named_parameters``
    path) takes weight decay."""
    return not (_NO_DECAY & set(name.split(".")))


def global_norm(grads: List[torch.Tensor],
                sharded: Optional[Sequence[bool]] = None,
                group=None, stage_group=None,
                zero_parts: Optional[Sequence[int]] = None,
                zero_group=None, ep: Optional[Sequence[bool]] = None,
                ep_group=None) -> torch.Tensor:
    """The L2 norm (fp32, on the grads' device) of ``grads`` as one
    vector. With an mp ``group``, ``sharded[i]`` says whether ``grads[i]``
    is this rank's shard of a parameter split over the group: the shards'
    squares are summed over the group and the replicated gradients (the
    same on every rank) counted once. With a ``zero_group`` (the ZeRO
    weight-update shard, ``parallel/sharding.py``), ``zero_parts[i]`` is
    the number of slices parameter i is cut into over it (1: whole on
    every rank): the slices' squares are summed over the group, each
    slice counted once. With an ``ep_group`` (expert parallelism: the data
    ranks), ``ep[i]`` says whether ``grads[i]`` is this rank's block of a
    stacked expert leaf: the blocks' squares are summed over the group
    (the MoE clip, ``ClipGradForMOEByGlobalNorm``, over the experts of
    every rank). With a pp ``stage_group`` (each rank one stage's
    gradients) the stages' squares are summed over it. Every rank gets
    the whole model's norm."""
    if (group is None and stage_group is None and zero_group is None
            and ep_group is None):
        return torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    experts = torch.zeros((), device=grads[0].device)
    if ep_group is not None:
        for g, e in zip(grads, ep):
            if e:
                experts = experts + torch.linalg.vector_norm(g.float()) ** 2
        dist.all_reduce(experts, group=ep_group)
        grads = [g for g, e in zip(grads, ep) if not e]
        if sharded is not None:
            sharded = [s for s, e in zip(sharded, ep) if not e]
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
    total = squares[0] + squares[1] + experts
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


@dataclasses.dataclass
class Blocks:
    """How this rank's gradients make whole parameters, for a per-block
    clip: ``sq_sum`` maps the per-gradient sums of squares ([n] fp32) to
    the whole parameters' (summed over the ranks that hold the other
    pieces), and ``numels`` are the whole parameters' sizes."""
    sq_sum: Callable[[torch.Tensor], torch.Tensor]
    numels: List[int]


def clip_by_block_rms(grads: List[torch.Tensor], threshold: float,
                      blocks: Optional[Blocks] = None) -> None:
    """optax's ``clip_by_block_rms``, in place: each g divided by
    ``max(1, rms(g) / threshold)``, rms the root mean square of the whole
    parameter's gradient (``blocks``; the tensors themselves when None)."""
    if not grads:
        return
    sq = torch.stack([g.float().square().sum() for g in grads])
    numels = [g.numel() for g in grads]
    if blocks is not None:
        sq, numels = blocks.sq_sum(sq), blocks.numels
    n = torch.tensor(numels, dtype=torch.float32, device=sq.device)
    rms = torch.sqrt(sq / n)
    denom = torch.clamp_min(rms / threshold, 1.0)
    for g, d in zip(grads, denom):
        g.div_(d)


def clip_by_value(grads: List[torch.Tensor], limit: float) -> None:
    """optax's ``clip``, in place: each element clamped to [-limit,
    limit]."""
    for g in grads:
        g.clamp_(-limit, limit)


class GradClip:
    """A gradient clip by config name, called as ``clip(grads, norm=None)``
    (in place; returns the global norm, ``norm`` when given). A per-block
    clip reads :attr:`blocks`, which the trainer sets before each call
    under mp or the update shard."""

    def __init__(self, name: str, limit: float):
        self.name = name
        self.limit = limit
        self.blocks: Optional[Blocks] = None

    @property
    def per_block(self) -> bool:
        """Whether the clip reads :attr:`blocks`."""
        return self.name == "ClipGradByNorm"

    def __call__(self, grads: List[torch.Tensor],
                 norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.name == "ClipGradByGlobalNorm":
            return clip_by_global_norm(grads, self.limit, norm)
        norm = global_norm(grads) if norm is None else norm
        if self.name == "ClipGradByNorm":
            clip_by_block_rms(grads, self.limit, self.blocks)
        else:
            clip_by_value(grads, self.limit)
        return norm


def build_grad_clip(clip_cfg) -> Optional[GradClip]:
    """ClipGradByGlobalNorm (and its MoE alias), ClipGradByNorm and
    ClipGradByValue by name (JAX :27-40); None when the config names no
    clip; an unknown name raises ``ValueError``."""
    if not clip_cfg or not clip_cfg.get("name"):
        return None
    name = clip_cfg["name"]
    if name in ("ClipGradByGlobalNorm", "ClipGradForMOEByGlobalNorm"):
        return GradClip("ClipGradByGlobalNorm",
                        float(clip_cfg.get("clip_norm", 1.0)))
    if name == "ClipGradByNorm":
        return GradClip(name, float(clip_cfg.get("clip_norm", 1.0)))
    if name == "ClipGradByValue":
        return GradClip(name, float(clip_cfg.get("clip_value", 1.0)))
    raise ValueError(f"unknown grad clip {name!r}")


def moment_keys(optimizer: torch.optim.Optimizer) -> List[str]:
    """The per-parameter state tensors shaped like their parameter
    (AdamW's ``exp_avg``/``exp_avg_sq``, Momentum's ``momentum_buffer``),
    which the update shard slices and a checkpoint gathers."""
    keys = set()
    for group in optimizer.param_groups:
        for p in group["params"]:
            for k, v in optimizer.state.get(p, {}).items():
                if torch.is_tensor(v) and v.shape == p.shape and v.dim():
                    keys.add(k)
    return sorted(keys)


class AdamWMu(torch.optim.Optimizer):
    """AdamW with the first moment stored in ``mu_dtype`` (optax
    ``scale_by_adam(mu_dtype=...)`` in ``optax.adamw``), as plain foreach
    ops: torch's fused AdamW keeps its moments in the parameters' dtype.
    In optax's order: the moment is updated in fp32 from the stored one
    (``b1`` times the stored moment in its own dtype, ``b1`` rounded to it,
    as JAX's weakly typed product is), the bias correction taken from the
    fp32 value, and the moment cast to ``mu_dtype`` for storage; the
    second moment stays fp32. The update is ``-lr · (m̂ / (√v̂ + eps) + wd
    · p)``, the decay added after the Adam scaling as in
    ``optax.adamw``."""

    def __init__(self, params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, mu_dtype=torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.mu_dtype = mu_dtype

    def load_state_dict(self, state_dict):
        # Optimizer.load_state_dict casts every state tensor to its
        # parameter's dtype; the first moment goes back to its own
        super().load_state_dict(state_dict)
        for s in self.state.values():
            if "exp_avg" in s:
                s["exp_avg"] = s["exp_avg"].to(self.mu_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in params:
                s = self.state[p]
                if not s:
                    s["step"] = torch.zeros((), dtype=torch.float32)
                    s["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    s["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=torch.float32)
                s["step"] += 1
            count = int(self.state[params[0]]["step"])
            grads = [p.grad.float() for p in params]
            b1_mu = torch.tensor(b1, dtype=self.mu_dtype)
            mu = [(self.state[p]["exp_avg"] * b1_mu.to(p.device)).float()
                  for p in params]
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
            nu = [self.state[p]["exp_avg_sq"] for p in params]
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1.0 - b2))
            c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** count)
            c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** count)
            den = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(mu, c1)
            torch._foreach_div_(upd, den)
            if wd:
                torch._foreach_add_(upd, torch._foreach_mul(params, wd))
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(params, upd)
            for p, m in zip(params, mu):
                self.state[p]["exp_avg"] = m.to(self.mu_dtype)
        return None


def build_optimizer(opt_cfg, named_params: Iterable[Tuple[str,
                                                          torch.nn.Parameter]]
                    ) -> torch.optim.Optimizer:
    """The config's optimizer over two parameter groups (decayed / not, by
    :func:`decay_mask`); the learning rate is set by the trainer before
    every step from its schedule.

    - AdamW (``AdamW``, ``FusedAdamW``, ``Adam``): the config's betas,
      epsilon and weight decay; on CUDA parameters the fused
      implementation runs, except at ``moment_dtype: bfloat16``
      (:class:`AdamWMu`);
    - ``Momentum`` (``momentum``, default 0.9; ``use_nesterov``) and
      ``SGD``: torch's SGD with the decay coupled (optax
      ``add_decayed_weights`` + ``sgd``; ``use_nesterov`` needs a
      momentum, as optax's trace).

    Another name raises ``ValueError``, as in JAX."""
    cfg = dict(opt_cfg or {})
    name = cfg.get("name", "AdamW")
    if name not in ("AdamW", "FusedAdamW", "Adam", "Momentum", "SGD"):
        raise ValueError(f"unknown optimizer {name!r}")
    wd = cfg.get("weight_decay", 0.01) if name != "Adam" else 0.0
    decay, plain = [], []
    for pname, param in named_params:
        (decay if decay_mask(pname) else plain).append(param)
    groups = [{"params": decay, "weight_decay": wd},
              {"params": plain, "weight_decay": 0.0}]
    device = (decay + plain)[0].device
    if name in ("Momentum", "SGD"):
        momentum = float(cfg.get("momentum", 0.9)) if name == "Momentum" \
            else 0.0
        return torch.optim.SGD(groups, lr=0.0, momentum=momentum,
                               nesterov=bool(cfg.get("use_nesterov"))
                               and momentum > 0)
    betas = (cfg.get("beta1", 0.9), cfg.get("beta2", 0.999))
    eps = cfg.get("epsilon", 1e-8)
    mu_dtype = cfg.get("moment_dtype")
    if mu_dtype:
        if str(mu_dtype) not in _DTYPES:
            raise ValueError(f"unknown moment_dtype {mu_dtype!r}")
        if _DTYPES[str(mu_dtype)] != torch.float32:
            return AdamWMu(groups, lr=0.0, betas=betas, eps=eps,
                           mu_dtype=_DTYPES[str(mu_dtype)])
    return torch.optim.AdamW(groups, lr=0.0, betas=betas, eps=eps,
                             fused=device.type == "cuda")
