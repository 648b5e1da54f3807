"""Learning-rate schedules as plain ``step -> lr`` functions.

Copy of the JAX package's optims/lr_scheduler.py (five schedules, the
reference's ppfleetx/optims/lr_scheduler.py:31-160), with Python math in
place of jnp. The trainer feeds update n (counted from 0) ``lr(n)``, as
optax's ``scale_by_learning_rate`` does: under linear warmup the first
update uses ``lr(0) = 0``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

__all__ = [
    "CosineAnnealingWithWarmupDecay",
    "LinearDecayWithWarmup",
    "ViTLRScheduler",
    "MultiStepDecay",
    "CosineDecay",
    "build_lr_scheduler",
]

Schedule = Callable[[int], float]


def _clip01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


def CosineAnnealingWithWarmupDecay(
    max_lr: float,
    min_lr: float = 0.0,
    warmup_rate: float = 0.01,
    decay_steps: int = 360000,
    warmup_steps: Optional[int] = None,
    **_,
) -> Schedule:
    """Megatron schedule: linear warmup to max_lr over
    warmup_rate*decay_steps, cosine decay to min_lr at decay_steps,
    constant min_lr after."""
    if warmup_steps is None:
        warmup_steps = int(warmup_rate * decay_steps)

    def schedule(step):
        step = float(step)
        if step < warmup_steps:
            return max_lr * step / max(warmup_steps, 1)
        frac = _clip01((step - warmup_steps)
                       / max(decay_steps - warmup_steps, 1))
        return min_lr + 0.5 * (max_lr - min_lr) * (1.0 + math.cos(
            math.pi * frac))

    return schedule


def LinearDecayWithWarmup(
    learning_rate: float = None,
    max_lr: float = None,
    total_steps: int = None,
    warmup: float = 0.1,
    **_,
) -> Schedule:
    """Linear warmup (fraction ``warmup`` of total) then linear decay to 0."""
    lr = max_lr if learning_rate is None else learning_rate
    if total_steps is None:
        raise ValueError(
            "LinearDecayWithWarmup needs Optimizer.lr.total_steps "
            "(reference GLUE configs set it to epochs * steps_per_epoch)"
        )
    warmup_steps = int(warmup * total_steps) if warmup < 1 else int(warmup)

    def schedule(step):
        step = float(step)
        if step < warmup_steps:
            return lr * step / max(warmup_steps, 1)
        return lr * _clip01((total_steps - step)
                            / max(total_steps - warmup_steps, 1))

    return schedule


def ViTLRScheduler(
    learning_rate: float,
    epochs: int,
    step_each_epoch: int,
    warmup_epochs: int = 0,
    decay_type: str = "cosine",
    **_,
) -> Schedule:
    """Linear warmup + cosine (or linear) decay used by the ViT configs."""
    total = epochs * step_each_epoch
    warmup_steps = warmup_epochs * step_each_epoch

    def schedule(step):
        step = float(step)
        if step < warmup_steps:
            return learning_rate * step / max(warmup_steps, 1)
        frac = _clip01((step - warmup_steps) / max(total - warmup_steps, 1))
        if decay_type == "cosine":
            return 0.5 * learning_rate * (1.0 + math.cos(math.pi * frac))
        return learning_rate * (1.0 - frac)

    return schedule


def MultiStepDecay(
    learning_rate: float,
    milestones: Sequence[int],
    gamma: float = 0.1,
    **_,
) -> Schedule:
    """Piecewise-constant decay at milestone steps."""
    def schedule(step):
        return learning_rate * gamma ** sum(step >= m for m in milestones)

    return schedule


def CosineDecay(
    learning_rate: float,
    decay_steps: int,
    alpha: float = 0.0,
    **_,
) -> Schedule:
    """Plain cosine decay to ``alpha * learning_rate`` over decay_steps."""
    def schedule(step):
        frac = _clip01(float(step) / decay_steps)
        coeff = 0.5 * (1.0 + math.cos(math.pi * frac))
        return learning_rate * ((1 - alpha) * coeff + alpha)

    return schedule


_SCHEDULES = {
    "CosineAnnealingWithWarmupDecay": CosineAnnealingWithWarmupDecay,
    "LinearDecayWithWarmup": LinearDecayWithWarmup,
    "ViTLRScheduler": ViTLRScheduler,
    "MultiStepDecay": MultiStepDecay,
    "CosineDecay": CosineDecay,
}


def build_lr_scheduler(lr_cfg) -> Schedule:
    """Build from config; a bare float is a constant schedule."""
    if isinstance(lr_cfg, (int, float)):
        value = float(lr_cfg)
        return lambda step: value
    cfg = dict(lr_cfg)
    name = cfg.pop("name", "CosineAnnealingWithWarmupDecay")
    if name not in _SCHEDULES:
        raise ValueError(f"unknown lr scheduler {name!r}; have "
                         f"{sorted(_SCHEDULES)}")
    return _SCHEDULES[name](**cfg)
