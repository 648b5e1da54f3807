"""Trainer: the training loop of the port.

Port of the pieces of the JAX package's ``Trainer`` (core/engine.py) that
single-card pretraining runs: construction (device, optimizer, schedule),
the train step — micro-batch gradient accumulation (``make_grad_fn``,
:77-117), the global-norm clip and the AdamW update (:507-546) — ``fit``
with its ``loss``/``lr``/``ips``/``mfu`` log line (:778-929), and
``evaluate`` every ``Engine.eval_freq`` steps over ``Engine.eval_iters``
batches (:920-959). PyTorch runs eagerly, so there is no compiled step:
the step is the loop body. Dropout seeds come from one ``torch.Generator`` seeded
with ``Global.seed``. Checkpoints, the step sentry, preemption, elastic
resume, the profiler and observability are not ported.

Over several ranks (``Distributed.dp_degree`` × ``cp_degree`` ×
``mp_degree``, the current mesh of ``parallel/mesh.py``) every rank starts
from the same weights (under mp, its shards of them) and seeds; after the
backward the gradients are summed over the data group (dp × cp: the ranks
that hold different tokens) in flat buckets, before the global-norm
clip, whose norm is the whole model's (the shards' squares summed over
the mp group), so every rank of a replica takes the same update and the
replicated parameters stay equal on every rank. The logged loss and
``evaluate``'s mean are summed over the data group too (each rank's loss
is its share of the global mean), and only rank 0 logs.

MFU is the model-FLOPs count of ``bench.py`` (6 per parameter per token
plus the causal attention products; the whole model's parameters under
mp) over the step time and the bf16 dense peak of every card the ranks
run on.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from fleetx_tpu_torch.models.module import BasicModule
from fleetx_tpu_torch.optims.lr_scheduler import build_lr_scheduler
from fleetx_tpu_torch.optims.optimizer import (
    build_grad_clip,
    build_optimizer,
    global_norm,
)
from fleetx_tpu_torch.parallel.env import ranks_per_card
from fleetx_tpu_torch.parallel.mesh import mesh_from_config
from fleetx_tpu_torch.parallel.tensor_parallel import mp_split_axes
from fleetx_tpu_torch.utils.device import resolve_device
from fleetx_tpu_torch.utils.log import logger

__all__ = ["Trainer", "model_flops_per_token", "peak_flops",
           "all_reduce_sum"]

# bf16 dense tensor-core peak by exact device name (NVIDIA data sheet; the
# PCIe and NVL H100 parts have other peaks and are not listed)
_PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989e12}


def model_flops_per_token(n_params: int, num_layers: int, seq: int,
                          hidden: int) -> float:
    """Model FLOPs per trained token (copy of ``bench.py``): 6 per
    parameter (forward 2, backward 4; the tied LM head included through
    the shared weight) plus the causal attention score and value products
    (forward 4·s·h per layer per token, halved for causality, ×3 for
    forward and backward)."""
    return 6.0 * n_params + num_layers * 6.0 * seq * hidden


def peak_flops(device: torch.device) -> Optional[float]:
    """The card's bf16 dense peak FLOP/s, or None off a known card."""
    if device.type != "cuda":
        return None
    return _PEAK_BF16.get(torch.cuda.get_device_name(device))


BUCKET_BYTES = 256 << 20  # gradient all-reduce bucket


def all_reduce_sum(tensors: List[torch.Tensor], group=None,
                   bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum ``tensors`` (of one dtype and device) over ``group`` (the world
    when None), in place, packed into flat buckets of at most
    ``bucket_bytes`` (a tensor larger than that goes alone), one
    all-reduce per bucket."""
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        if not bucket:
            return
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        bucket.clear()

    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and size + nbytes > bucket_bytes:
            flush()
            size = 0
        bucket.append(t)
        size += nbytes
    flush()


class Trainer:
    """Trains ``module.nets`` on ``device`` (CUDA unless the caller names
    another; raises without it)."""

    def __init__(self, cfg, module: BasicModule,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.module = module
        self.device = resolve_device(device)
        eng = cfg.Engine
        self.max_steps = eng.max_steps
        self.num_train_epochs = eng.num_train_epochs
        self.accumulate_steps = eng.accumulate_steps or 1
        self.logging_freq = eng.logging_freq
        self.eval_freq = eng.eval_freq
        self.eval_iters = eng.eval_iters
        self.seed = int(cfg.Global.seed)
        opt_cfg = cfg.Optimizer or {}
        self.lr_schedule = build_lr_scheduler(opt_cfg.get("lr", 1e-4))
        self.clip = build_grad_clip(opt_cfg.get("grad_clip"))
        self.generator = torch.Generator().manual_seed(self.seed)
        self.mesh = mesh_from_config(cfg)
        self.primary = self.mesh.rank == 0  # the rank that logs
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0
        self.n_params = 0
        self.mp_split: Dict[str, int] = {}  # parameters split over mp
        self.history: List[Dict[str, float]] = []  # one entry per step

    # ----------------------------------------------------------------- init
    def init_state(self, params: Optional[Dict[str, torch.Tensor]] = None):
        """Load ``params`` (a state dict; fresh weights from
        ``Global.seed`` when None) onto the device and build the
        optimizer."""
        if params is None:
            params = self.module.init_params(self.seed, self.device)
        params = {k: v.to(self.device, torch.float32)
                  for k, v in params.items()}
        nets = self.module.nets
        nets.load_state_dict(params, assign=True)
        self.mp_split = mp_split_axes(nets)
        # the whole model's count: a shard split over mp counts mp times
        self.n_params = sum(
            p.numel() * (self.mesh.mp if n in self.mp_split else 1)
            for n, p in nets.named_parameters())
        self.optimizer = build_optimizer(self.cfg.Optimizer or {},
                                         nets.named_parameters())
        if self.primary:
            logger.info("initialized model: %.1fM params on %s (%s)",
                        self.n_params / 1e6, self.device, self.mesh)

    # ----------------------------------------------------------------- step
    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        """The host batch on the device. On CUDA it is copied from pinned
        memory: a copy from pageable memory waits for the stream to drain,
        which would stop the host from queueing a step ahead."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, object]:
        """One optimizer step on a device batch: the mean loss and mean
        gradients over ``accumulate_steps`` micro-batches (summed over the
        data group's ranks, each holding its share of the global mean), the
        clip, then AdamW at ``lr(step)``. Returns ``{"loss", "grad_norm",
        "lr"}`` (loss and grad_norm as device scalars, the same on every
        rank)."""
        nets = self.module.nets
        accum = self.accumulate_steps
        rows = next(iter(batch.values())).shape[0]
        if rows % accum:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{accum} micro-batches")
        micro = rows // accum
        loss_sum = torch.zeros((), device=self.device)
        for i in range(accum):
            part = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
            loss = self.module.loss_fn(part, self.generator, train=True)
            (loss / accum).backward()
            loss_sum += loss.detach()
        named = [(n, p) for n, p in nets.named_parameters()
                 if p.grad is not None]
        grads = [p.grad for _, p in named]
        mesh = self.mesh
        if mesh.data_world > 1:
            all_reduce_sum(grads + [loss_sum.view(1)],
                           group=mesh.data_group)
        # under mp the whole model's norm, the same on every rank
        norm = global_norm(grads, [n in self.mp_split for n, _ in named],
                           mesh.mp_group)
        grad_norm = norm if self.clip is None else self.clip(grads, norm)
        lr = float(self.lr_schedule(self.step))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return {"loss": loss_sum / accum, "grad_norm": grad_norm, "lr": lr}

    # ------------------------------------------------------------------ fit
    def _log_train(self, log: Dict) -> None:
        if self.primary:
            self.module.training_step_end(log)

    def _flops_per_token(self, seq: int) -> Optional[float]:
        gcfg = getattr(self.module, "gpt_config", None)
        if gcfg is None:
            return None
        return model_flops_per_token(self.n_params, gcfg.num_layers, seq,
                                     gcfg.hidden_size)

    def fit(self, train_data: Iterable,
            valid_data: Optional[Iterable] = None):
        """Train until ``Engine.max_steps`` or the end of
        ``Engine.num_train_epochs`` epochs, logging every
        ``Engine.logging_freq`` steps and, given ``valid_data``,
        evaluating every ``Engine.eval_freq`` steps."""
        if self.optimizer is None:
            self.init_state()
        peak = peak_flops(self.device)
        if peak is not None:  # every card the ranks run on
            peak *= max(self.mesh.world // ranks_per_card(), 1)
        tokens_per_batch = flops = None
        for epoch in range(self.num_train_epochs):
            sampler = getattr(train_data, "batch_sampler", None)
            if sampler is not None and hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
            t_last = time.time()
            window = []
            for batch in train_data:
                if self.step >= self.max_steps:
                    break
                if tokens_per_batch is None:  # the global batch's
                    tokens_per_batch = self.mesh.dp * int(
                        np.prod(np.shape(batch["tokens"])))
                    flops = self._flops_per_token(np.shape(batch["tokens"])[1])
                out = self.train_step(self._to_device(batch))
                window.append(out["loss"])
                self.history.append(out)
                if self.step % self.logging_freq == 0:
                    loss = float(torch.stack(window).mean())
                    window = []
                    dt = (time.time() - t_last) / self.logging_freq
                    t_last = time.time()
                    ips = tokens_per_batch / dt
                    mfu = (None if peak is None or flops is None
                           else ips * flops / peak)
                    self._log_train({
                        "epoch": epoch, "batch": self.step, "loss": loss,
                        "batch_cost": dt, "ips_total": ips, "ips": ips,
                        "lr": float(self.lr_schedule(self.step)), "mfu": mfu,
                    })
                if (self.eval_freq and valid_data is not None
                        and self.step % self.eval_freq == 0):
                    self.evaluate(valid_data, epoch=epoch)
            if self.step >= self.max_steps:
                break
        return self

    # ----------------------------------------------------------------- eval
    def evaluate(self, valid_data: Iterable, epoch: int = 0
                 ) -> Optional[float]:
        """The mean loss over the first ``Engine.eval_iters`` batches of
        ``valid_data`` (forward only, no dropout, no gradients), logged
        through ``validation_step_end``; None when there is no batch."""
        if self.optimizer is None:
            self.init_state()
        losses = []
        t0 = time.time()
        with torch.no_grad():
            for i, batch in enumerate(valid_data):
                if self.eval_iters is not None and i >= self.eval_iters:
                    break
                losses.append(self.module.loss_fn(self._to_device(batch),
                                                  None, train=False))
        if not losses:
            return None
        if self.mesh.data_world > 1:  # each rank's is its share of the mean
            losses = torch.stack(losses)
            dist.all_reduce(losses, group=self.mesh.data_group)
        mean = float(np.mean([float(x) for x in losses]))
        if self.primary:
            self.module.validation_step_end({
                "epoch": epoch, "batch": self.step, "loss": mean,
                "batch_cost": (time.time() - t0) / len(losses)})
        return mean
