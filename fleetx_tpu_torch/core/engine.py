"""Trainer: the training loop of the port.

Port of the JAX package's ``Trainer`` (core/engine.py) for GPT
pretraining: construction (device, optimizer, schedule), the train step —
micro-batch gradient accumulation (``make_grad_fn``, :77-117), the
global-norm clip and the AdamW update (:507-546) — ``fit`` with its
``loss``/``lr``/``ips``/``mfu`` log line (:778-929), ``evaluate`` every
``Engine.eval_freq`` steps over ``Engine.eval_iters`` batches
(:920-959), and the resilience of the run:

- checkpoints (``save``, ``load``, :1010-1435): every
  ``Engine.save_load.save_steps`` steps into
  ``<output_dir>/checkpoints/<step>/`` (``core/checkpoint.py``; under
  ``FLEETX_CKPT_ASYNC_SNAPSHOT=1`` a single process copies the state to
  the host in the step path and one uploader thread writes it); a load
  walks back from the newest step and quarantines a step that fails
  verified restore; ``init_state`` resumes a run whose ``output_dir``
  holds a step;
- the step sentry (:252-260, :547-562, :846-880): a step whose loss or
  gradient norm is not finite (or over ``FLEETX_SENTRY_LOSS_MAX`` /
  ``FLEETX_SENTRY_GNORM_MAX``) is skipped — no parameter, AdamW state,
  step count, learning rate or dropout draw moves, but its batch counts as
  consumed — and ``FLEETX_SENTRY_MAX_SKIPS`` skips in a row save and raise
  :class:`SentryAbort`;
- preemption (:1437-1470): SIGTERM during ``fit`` checkpoints and returns;
- the training fault hooks of ``resilience/faults.py``.

Observability (JAX :264-324, :846-907): the Trainer registers JAX's
families on the process registry (``obs/``; ``FLEETX_OBS_PORT`` starts
the exposition server) — steps, sentry skips, save failures and
quarantines; loss, learning rate, step seconds, tokens/s and MFU at each
logging step; ``fleetx_train_step_hbm_bytes``, which here is
``torch.cuda.max_memory_allocated`` of the trainer's card (the peak
bytes allocated, not JAX's cost-analysis estimate of bytes accessed);
optimizer-state bytes; checkpoint seconds by phase and bytes — and emits
the ``sentry_skip``, ``sentry_abort``, ``save_failure``,
``checkpoint_saved`` and ``checkpoint_quarantine`` events. The attributes
``sentry_skips``, ``save_failures`` and ``last_save`` read the same
counts for this trainer. ``train.data``, ``train.step`` and
``train.callback`` spans mark the fit loop's phases.

The profiler (JAX :1476-1525): with ``Profiler.enable``, a
``torch.profiler`` window (CPU and CUDA activities) opens after step
``scheduler[0]`` and closes after step ``scheduler[1]``; each rank writes
its Chrome trace under ``Profiler.profiler_log``
(``utils/profiler_summary.trace_path``) and rank 0 prints the summary
views, parsed from its trace file. The preemption, data-failure and
sentry-abort paths close the trace without the summary.

PyTorch runs eagerly, so there is no compiled step: the step is the loop
body. Dropout seeds come from one ``torch.Generator`` seeded with
``Global.seed``; it is part of a checkpoint, and a skipped step puts it
back where it was. The elastic supervisor that shrinks the mesh after a
host loss is ``resilience/elastic.run_elastic``.

Over several ranks (``Distributed.pp_degree`` × ``dp_degree`` ×
``sharding.sharding_degree`` × ``cp_degree`` × ``mp_degree``, the current
mesh of ``parallel/mesh.py``) every rank starts from the same weights
(under mp and pp, its stage's part and its shards of them) and seeds.
After the backward the gradients are summed over the data group (dp ×
fsdp × cp of one stage: the ranks that hold different tokens), before
the global-norm clip, whose norm is the whole model's (the shards'
squares summed over the mp group, the stages' over the pp group). Two
layouts of that sum (JAX :204-214):

- the ZeRO weight-update shard (``parallel/sharding.py``), on whenever dp
  × fsdp > 1 unless ``FLEETX_ZERO_UPDATE=0``: the gradients are
  reduce-scattered over the zero group (dp × fsdp) and, under cp, the
  slices summed over the cp group; the norm is taken from the slices, the
  clip, the sentry and AdamW run on them, the AdamW state lives on them
  between steps, and the updated slices are all-gathered into the whole
  parameters;
- otherwise an all-reduce over the data group in flat buckets, and AdamW
  on the whole parameters, as before the shard was ported.

Either way every rank of a replica takes the same update and the
replicated parameters stay equal on every rank. The logged loss and
``evaluate``'s mean are summed over the data group too (each rank's loss
is its share of the global mean), and only rank 0 logs. The sentry's
verdict is therefore the same on every rank; a SIGTERM that reaches one
rank reaches the others through a one-element MAX all-reduce over the
world after each fetch, so all ranks stop after the same step. A
checkpoint holds one state file per mp rank (per stage and mp rank under
pp) with whole tensors, written by the ranks of dp, fsdp and cp rank 0
(the replicas hold the same parameters; the AdamW slices are gathered to
the writer first); a load reads the file of its own stage and mp rank
and takes its own slices, so dp and fsdp may change between save and
load (reshard-on-load), and mp, pp or cp may not
(``resilience/elastic.py``).

Under Megatron sequence parallelism (``Model.sequence_parallel`` at mp >
1) the parameters that mp replicates see only their rank's part of the
sequence: their gradients are summed over the mp group after the
backward (:meth:`Trainer._sum_sequence_parallel_grads`), before
anything else reads them.

Under expert parallelism (an MoE model at dp > 1, ``parallel/moe.py``)
each data rank holds its block of every stacked expert leaf, and the
exchange's backward has already brought every rank's contributions to
its own experts: the expert gradients stay out of the data group's sum,
and the global norm (the clip's, the sentry's) sums their squares over
the data group beside the dense gradients counted once; a per-block clip
counts an expert leaf whole. The weight-update shard is off (the dense
rest is all-reduced, AdamW runs on whole tensors). A checkpoint holds
every expert leaf and its AdamW moments whole, in JAX's ``[E, ...]``
layout (gathered over the data group to the writer), and a load takes
its rank's block, so an MoE run saved at one dp loads at another. The
step also returns the module's ``metrics`` (an MoE module's ``lm_loss``
and ``balance_loss``), summed over the data group like the loss.

Under pipeline parallelism (``pp_degree > 1``) there is no accumulation
outside the pipeline (JAX :186-190): ``train_step`` runs the module's
schedule (``GPTModule.pipeline_loss``) over ``Engine.accumulate_steps``
microbatches. The tied word embedding has a copy on the first and on the
last stage: their gradients are summed over the mesh's embedding group
before the clip (the reference's SharedLayerDesc all-reduce), the global
norm counts it once, and the copies stay equal bit for bit. The last
stage's loss is broadcast over the pp group, so every rank logs and
judges the same loss.

The throughput gauge counts the elements of the batch's ``tokens``, else
its ``input_ids``, else its first array (JAX :832-840): an image batch
counts pixels, and the vision module logs images/s. MFU is the
model-FLOPs count over the step time and the bf16 dense peak of every
card the ranks run on: for GPT ``bench.py``'s (6 per parameter per token
plus the causal attention products; the whole model's parameters under
mp; an MoE model's expert leaves at the rows their GEMMs run, every
expert's capacity, ``moe_flops_per_token``), for a module that supplies
its own FLOPs a sample (``model_flops_per_sample``: the encoders) that
count spread over the sample's counted elements.
"""

from __future__ import annotations

import atexit
import hashlib
import os
import re
import shutil
import signal
import threading
import time
import weakref
from typing import Dict, Iterable, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from fleetx_tpu_torch.core.checkpoint import CheckpointStore
from fleetx_tpu_torch.models.module import BasicModule
from fleetx_tpu_torch.obs import emit as obs_emit
from fleetx_tpu_torch.obs import get_registry, span
from fleetx_tpu_torch.obs import http as obs_http
from fleetx_tpu_torch.optims.lr_scheduler import build_lr_scheduler
from fleetx_tpu_torch.optims.optimizer import (
    Blocks,
    build_grad_clip,
    build_optimizer,
    global_norm,
    moment_keys,
)
from fleetx_tpu_torch.parallel.env import ranks_per_card
from fleetx_tpu_torch.parallel.mesh import get_data_world, mesh_from_config
from fleetx_tpu_torch.parallel.moe import (
    expert_block,
    is_expert_param,
    moe_capacity,
)
from fleetx_tpu_torch.parallel.sharding import (
    BUCKET_BYTES,
    ZeroShards,
    all_reduce_sum,
)
from fleetx_tpu_torch.parallel.tensor_parallel import mp_split_axes
from fleetx_tpu_torch.resilience.elastic import (
    ElasticMeshMismatch,
    validate_restore_mesh,
)
from fleetx_tpu_torch.resilience.faults import faults
from fleetx_tpu_torch.utils.device import resolve_device
from fleetx_tpu_torch.utils.log import logger

__all__ = ["BUCKET_BYTES", "CheckpointUnrestorable", "SentryAbort",
           "Trainer", "model_flops_per_token", "moe_flops_per_token",
           "peak_flops", "all_reduce_sum"]


class CheckpointUnrestorable(RuntimeError):
    """Checkpoints existed but every candidate failed verified restore
    (all quarantined). Distinct from the no-checkpoint-yet case, which
    ``load()`` reports as ``False`` so that a first launch starts fresh:
    resuming a real run from scratch must fail loudly."""


class SentryAbort(RuntimeError):
    """``FLEETX_SENTRY_MAX_SKIPS`` consecutive train steps were skipped by
    the step sentry. The parameters and optimizer state are still the
    last healthy step's (a skipped step never touches them) and a
    checkpoint is written before this is raised."""

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


def moe_flops_per_token(dense_params: int, expert_params: int, cfg,
                        tokens: int, seq: int) -> float:
    """Model FLOPs per trained token of an MoE GPT whose global
    micro-batch routes ``tokens`` tokens: 6 per dense parameter (the
    gate included), each layer's expert leaves (``expert_params`` over
    all layers and experts) at the rows their GEMMs run, the E·C rows of
    every expert's capacity C (as XLA's cost analysis counts JAX's
    batched einsums), and the causal attention products as
    :func:`model_flops_per_token`."""
    _, capacity = moe_capacity(cfg, tokens)
    per_row = expert_params / cfg.num_experts  # one expert, all layers
    rows = cfg.num_experts * capacity
    return (6.0 * dense_params + 6.0 * per_row * rows / tokens
            + cfg.num_layers * 6.0 * seq * cfg.hidden_size)


def peak_flops(device: torch.device) -> Optional[float]:
    """The card's bf16 dense peak FLOP/s, or None off a known card."""
    if device.type != "cuda":
        return None
    return _PEAK_BF16.get(torch.cuda.get_device_name(device))


_LAYER = re.compile(r"^gpt\.layers\.\d+\.")  # a decoder layer's prefix


def _counted(batch):
    """The array of a batch whose elements the throughput gauge counts:
    ``tokens``, else ``input_ids``, else the first (JAX :832-840)."""
    for key in ("tokens", "input_ids"):
        if batch.get(key) is not None:
            return batch[key]
    return next(iter(batch.values()))


def _is_moment(v, like: torch.Tensor) -> bool:
    """Whether optimizer state ``v`` is a per-element moment of a
    parameter shaped like ``like`` (AdamW's ``exp_avg``/``exp_avg_sq``,
    Momentum's ``momentum_buffer``; not AdamW's 0-d ``step``)."""
    return torch.is_tensor(v) and v.dim() > 0 and v.shape == like.shape


def _state_digest(state: torch.Tensor) -> float:
    """A 48-bit digest of a generator state, exact in a float64."""
    return float(int(hashlib.sha256(state.numpy().tobytes()).hexdigest()[:12],
                     16))


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
        save_load = eng.save_load or {}
        self.save_steps = save_load.get("save_steps", 1000)
        self.output_dir = save_load.get("output_dir", "./output")
        self.seed = int(cfg.Global.seed)
        opt_cfg = cfg.Optimizer or {}
        self.lr_schedule = build_lr_scheduler(opt_cfg.get("lr", 1e-4))
        self.clip = build_grad_clip(opt_cfg.get("grad_clip"))
        self._grad_clip = self.clip  # kept when a caller wraps self.clip
        self.generator = torch.Generator().manual_seed(self.seed)
        self.mesh = mesh_from_config(cfg)
        # the data ranks an MoE model's experts split over (1: whole)
        self.ep_world = getattr(module, "ep_world", 1)
        # the ZeRO weight-update shard (JAX :204-214): on whenever there is
        # a data-parallel axis, unless FLEETX_ZERO_UPDATE=0 or the experts
        # are split over it
        self._zero_update = (
            os.environ.get("FLEETX_ZERO_UPDATE", "1") == "1"
            and self.mesh.zero_world > 1 and self.ep_world == 1)
        self.zero: Optional[ZeroShards] = None  # made by init_state
        if self.mesh.pp > 1:
            # the pipeline streams the microbatches itself (JAX :186-190)
            self.accumulate_steps = 1
        self.primary = self.mesh.rank == 0  # the rank that logs
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0
        self.n_params = 0
        self.mp_split: Dict[str, int] = {}  # parameters split over mp
        self.experts: set = set()  # parameters split over the data ranks
        self.history: List[Dict[str, float]] = []  # one entry per step
        self.eval_metrics: Dict[str, float] = {}  # the last evaluate's
        self.start_epoch = 0
        self._cur_epoch = 0  # the epoch the fit loop is inside
        self.consumed_samples = 0
        self._restored_step = None
        self._preempted = False
        self._prev_sigterm = None
        self._store: Optional[CheckpointStore] = None
        # step-shadow snapshot (FLEETX_CKPT_ASYNC_SNAPSHOT): save() copies
        # the state to the host in the step path and hands it to one
        # uploader thread; a single process only, since a multi-rank save
        # meets at barriers that a per-rank thread would skew
        self._ckpt_async = (
            os.environ.get("FLEETX_CKPT_ASYNC_SNAPSHOT", "0") == "1"
            and self.mesh.world == 1)
        self._upload_thread: Optional[threading.Thread] = None
        if self._ckpt_async:
            # an upload in flight must finish before the interpreter ends,
            # or its step stays a <step>.tmp; weakly, so that the hook
            # does not keep the trainer (and its device state) alive
            ref = weakref.ref(self)
            atexit.register(lambda: ref() and ref().wait_for_checkpoints())
        # the step sentry's knobs, read once (JAX :252-260)
        self._sentry_enabled = os.environ.get("FLEETX_SENTRY", "1") == "1"
        self._sentry_loss_max = float(
            os.environ.get("FLEETX_SENTRY_LOSS_MAX", 0) or 0)
        self._sentry_gnorm_max = float(
            os.environ.get("FLEETX_SENTRY_GNORM_MAX", 0) or 0)
        self._sentry_max_skips = int(
            os.environ.get("FLEETX_SENTRY_MAX_SKIPS", 25) or 25)
        self.sentry_skips = 0  # total skipped steps this run
        self._sentry_consecutive = 0
        self.save_failures = 0  # periodic saves that failed (run survived)
        self._last_saved_meta = None  # (step, epoch, consumed_samples)
        # the last save's step, bytes (this rank's file; the snapshot's
        # tensors while its upload runs), seconds in the step path
        # (blocking), writing this rank's file (write) and in all (total;
        # write and total are None while its upload runs)
        self.last_save: Optional[Dict[str, float]] = None
        self._init_obs()
        self._prof = None  # the open torch.profiler window, if any
        self._prof_enabled = False

    def _init_obs(self) -> None:
        """JAX's training families on the process registry (JAX
        :264-324), every one exposed at zero at once; gauges are process
        wide (last writer wins), counters accumulate across trainers."""
        obs_http.maybe_start_from_env()
        reg = get_registry()
        self._obs_steps = reg.counter(
            "fleetx_train_steps_total", "Optimizer steps applied")
        self._obs_sentry_skips = reg.counter(
            "fleetx_train_sentry_skips_total",
            "Train steps skipped by the anomaly sentry")
        self._obs_save_failures = reg.counter(
            "fleetx_train_save_failures_total",
            "Checkpoint saves that failed (run survived)")
        self._obs_quarantines = reg.counter(
            "fleetx_train_checkpoint_quarantines_total",
            "Corrupt checkpoint steps quarantined during restore")
        self._obs_loss = reg.gauge(
            "fleetx_train_loss", "Loss averaged over the last logging window")
        self._obs_lr = reg.gauge(
            "fleetx_train_learning_rate", "Current learning rate")
        self._obs_step_time = reg.histogram(
            "fleetx_train_step_seconds",
            "Per-step wall clock (logging-window mean samples)")
        self._obs_tokens_per_s = reg.gauge(
            "fleetx_train_tokens_per_second",
            "Training throughput over the last logging window")
        self._obs_mfu = reg.gauge(
            "fleetx_train_mfu",
            "Model-FLOPs utilization: model flops per step / step time / "
            "peak card FLOPs")
        self._obs_hbm_bytes = reg.gauge(
            "fleetx_train_step_hbm_bytes",
            "Peak device memory allocated on this rank's card "
            "(torch.cuda.max_memory_allocated)")
        self._obs_opt_bytes = reg.gauge(
            "fleetx_train_opt_state_bytes",
            "Optimizer-state bytes resident per device (ZeRO update "
            "sharding shrinks this by the dp*fsdp factor)")
        self._obs_ckpt_seconds = reg.histogram(
            "fleetx_ckpt_save_seconds",
            "Checkpoint save duration; phase=blocking is the step-path "
            "stall (D2H snapshot under FLEETX_CKPT_ASYNC_SNAPSHOT, the "
            "whole write otherwise), phase=total includes the async upload",
            labelnames=("phase",))
        self._obs_ckpt_bytes = reg.gauge(
            "fleetx_ckpt_bytes",
            "Bytes of train state in the last checkpoint snapshot")
        for fam in (self._obs_steps, self._obs_sentry_skips,
                    self._obs_save_failures, self._obs_quarantines,
                    self._obs_loss, self._obs_lr, self._obs_step_time,
                    self._obs_tokens_per_s, self._obs_mfu,
                    self._obs_hbm_bytes, self._obs_opt_bytes,
                    self._obs_ckpt_bytes):
            fam.labels()
        for phase in ("blocking", "total"):
            self._obs_ckpt_seconds.labels(phase=phase)

    # ----------------------------------------------------------------- init
    def init_state(self, params: Optional[Dict[str, torch.Tensor]] = None):
        """Load ``params`` (a state dict; fresh weights from
        ``Global.seed`` when None) onto the device and build the
        optimizer. When ``<output_dir>/checkpoints`` holds a step, the run
        resumes from it instead (JAX :363-377): ``load()`` restores the
        newest one that passes verified restore, and raises
        :class:`CheckpointUnrestorable` when none does."""
        if params is None:
            params = self.module.init_params(self.seed, self.device)
        params = {k: v.to(self.device, torch.float32).contiguous()
                  for k, v in params.items()}
        nets = self.module.nets
        nets.load_state_dict(params, assign=True)
        self.mp_split = mp_split_axes(nets)
        self.experts = ({n for n, _ in nets.named_parameters()
                         if is_expert_param(n)} if self.ep_world > 1
                        else set())
        # the whole model's count: a shard split over mp counts mp times,
        # an expert block ep_world times, the stages are summed and the
        # tied copy counts once
        n_params = sum(p.numel() * (self.mesh.mp if n in self.mp_split
                                    else self.ep_world if n in self.experts
                                    else 1)
                       for n, p in nets.named_parameters()
                       if n not in self._tie_copies())
        if self.mesh.pp > 1:
            n_params = self._sum_over([float(n_params)],
                                      self.mesh.pp_group)[0]
        self.n_params = int(n_params)
        named = list(nets.named_parameters())
        if self._zero_update:
            self.zero = ZeroShards(named, self.mp_split, self.mesh)
            named = list(zip(self.zero.names, self.zero.shards))
        self._opt_names = {id(t): n for n, t in named}
        self.optimizer = build_optimizer(self.cfg.Optimizer or {}, named)
        self.step = 0
        self._restored_step = None
        self._obs_opt_bytes.set(float(self.opt_state_device_bytes()))
        if self.primary:
            logger.info("initialized model: %.1fM params on %s (%s)",
                        self.n_params / 1e6, self.device, self.mesh)
        if self._ckpt_store().all_steps():
            self.load()

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

    def _sentry_ok(self, loss: torch.Tensor, norm: torch.Tensor) -> bool:
        """The sentry's verdict on a step (JAX :547-562): loss and
        gradient norm finite and under their thresholds. The one host
        read of the step."""
        ok = torch.isfinite(loss) & torch.isfinite(norm)
        if self._sentry_loss_max > 0:
            ok &= loss <= self._sentry_loss_max
        if self._sentry_gnorm_max > 0:
            ok &= norm <= self._sentry_gnorm_max
        return bool(ok)

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, object]:
        """One optimizer step on a device batch: the mean loss and mean
        gradients over ``accumulate_steps`` micro-batches (summed over the
        data group's ranks, each holding its share of the global mean;
        expert blocks not), the clip, then AdamW at ``lr(step)``. With the
        sentry on, a step it refuses is skipped: the gradients are dropped
        and the dropout generator is put back, so nothing moves. Returns
        ``{"loss", "grad_norm", "lr", "skipped"}`` (loss and grad_norm as
        device scalars, the same on every rank) and the mean of the
        module's ``metrics`` over the micro-batches (an MoE module's
        ``lm_loss`` and ``balance_loss``), summed over the data group."""
        nets = self.module.nets
        accum = self.accumulate_steps
        rows = next(iter(batch.values())).shape[0]
        if rows % accum:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{accum} micro-batches")
        micro = rows // accum
        drawn_from = (self.generator.get_state() if self._sentry_enabled
                      else None)
        mesh = self.mesh
        metrics: Dict[str, torch.Tensor] = {}
        if mesh.pp > 1:  # the schedule runs the backwards too
            loss_sum = self.module.pipeline_loss(batch, self.generator,
                                                 train=True)
        else:
            loss_sum = torch.zeros((), device=self.device)
            for i in range(accum):
                part = {k: v[i * micro:(i + 1) * micro]
                        for k, v in batch.items()}
                loss = self.module.loss_fn(part, self.generator, train=True)
                (loss / accum).backward()
                loss_sum += loss.detach()
                for k, v in (getattr(self.module, "metrics", None)
                             or {}).items():
                    metrics[k] = metrics.get(k, 0.0) + v / accum
        self._sum_sequence_parallel_grads()
        zero = self.zero
        if zero is None:
            named = [(n, p) for n, p in nets.named_parameters()
                     if p.grad is not None]
            names, grads = [n for n, _ in named], [p.grad for _, p in named]
            if mesh.data_world > 1:
                # an expert block's gradient is whole on its rank already
                summed = [p.grad for n, p in named if n not in self.experts]
                extra = [loss_sum.view(1)] + [v.view(1)
                                              for v in metrics.values()]
                all_reduce_sum(summed + extra, group=mesh.data_group)
        else:
            # this rank's slices of the sums (a parameter the step did not
            # reach has a zero gradient); the whole gradients go
            params = list(nets.parameters())
            names = zero.names
            grads = zero.reduce_scatter([
                p.grad if p.grad is not None else torch.zeros_like(p)
                for p in params])
            for p in params:
                p.grad = None
            if mesh.data_world > 1:
                sums = torch.stack([loss_sum, *metrics.values()])
                dist.all_reduce(sums, group=mesh.data_group)
                loss_sum = sums[0]
                metrics = dict(zip(metrics, sums[1:]))
        if mesh.pp > 1:
            self._sum_tied_grads(names, grads)
            self._from_last_stage(loss_sum)
        # under mp, pp and the update shard the whole model's norm, the
        # same on every rank
        copies = self._tie_copies()
        counted = [i for i, n in enumerate(names) if n not in copies]
        norm = global_norm(
            [grads[i] for i in counted],
            [names[i] in self.mp_split for i in counted], mesh.mp_group,
            stage_group=mesh.pp_group,
            zero_parts=(None if zero is None
                        else [zero.plans[i].parts for i in counted]),
            zero_group=None if zero is None else mesh.zero_group,
            ep=[names[i] in self.experts for i in counted],
            ep_group=mesh.data_group if self.experts else None)
        if self._grad_clip is not None and self._grad_clip.per_block:
            self._grad_clip.blocks = self._blocks(names, grads)
        grad_norm = norm if self.clip is None else self.clip(grads, norm)
        lr = float(self.lr_schedule(self.step))
        loss = loss_sum / accum
        if self._sentry_enabled and not self._sentry_ok(loss, grad_norm):
            self.optimizer.zero_grad(set_to_none=True)
            self.generator.set_state(drawn_from)
            return {"loss": loss, "grad_norm": grad_norm, "lr": lr,
                    "skipped": True, **metrics}
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        if zero is not None:
            for shard, g in zip(zero.shards, grads):
                shard.grad = g
            zero.refresh_staged()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if zero is not None:
            zero.all_gather()
        self.step += 1
        return {"loss": loss, "grad_norm": grad_norm, "lr": lr,
                "skipped": False, **metrics}

    def _blocks(self, names: List[str], grads: List[torch.Tensor]
                ) -> Blocks:
        """Which whole JAX leaf each of this step's gradients (this rank's
        shards or update slices of the parameters ``names``) belongs to,
        for a per-block clip. A slice's squares are summed over the zero
        group (a slice that k ranks hold weighs k / world, as in
        ``global_norm``), an mp shard's over the mp group, an expert
        block's over the data group; then the
        decoder layers' copies of one parameter are summed, since the JAX
        model stacks them into one leaf (``nn.scan``, or the pipeline's
        stages, summed over the pp group) unless it unrolls them
        (``scan_layers: False`` or ``no_recompute_layers``)."""
        mesh, zero = self.mesh, self.zero
        model_cfg = self.cfg.get("Model") or {}
        stacked = mesh.pp > 1 or (model_cfg.get("scan_layers", True)
                                  and not model_cfg.get(
                                      "no_recompute_layers"))
        keys = [_LAYER.sub("gpt.layers.*.", n) if stacked else n
                for n in names]
        uniq = sorted(set(keys))
        layer_keys = [i for i, k in enumerate(uniq)
                      if k.startswith("gpt.layers.*.")]
        index = torch.tensor([uniq.index(k) for k in keys],
                             device=self.device)
        split = torch.tensor([n in self.mp_split for n in names],
                             device=self.device)
        ep = torch.tensor([n in self.experts for n in names],
                          device=self.device)
        parts = ([1] * len(names) if zero is None
                 else [plan.parts for plan in zero.plans])
        world = mesh.zero_world
        weight = torch.tensor([0.0 if k == 1 else k / world for k in parts],
                              device=self.device)
        sizes = [0.0] * len(uniq)
        for i, (n, g, k) in enumerate(zip(names, grads, parts)):
            sizes[uniq.index(keys[i])] += g.numel() * k * (
                mesh.mp if n in self.mp_split
                else self.ep_world if n in self.experts else 1)
        pp_sum = mesh.pp > 1 and stacked and bool(layer_keys)
        lo, hi = (layer_keys[0], layer_keys[-1] + 1) if layer_keys else (0, 0)
        if pp_sum:  # every stage holds some of each layer parameter
            sizes[lo:hi] = self._sum_over(sizes[lo:hi], mesh.pp_group)

        def sq_sum(sq: torch.Tensor) -> torch.Tensor:
            if zero is not None:
                sliced = sq * weight
                dist.all_reduce(sliced, group=mesh.zero_group)
                sq = torch.where(weight > 0, sliced, sq)
            if mesh.mp > 1:
                shards = sq * split
                dist.all_reduce(shards, group=mesh.mp_group)
                sq = torch.where(split, shards, sq)
            if self.experts:
                blocks = sq * ep
                dist.all_reduce(blocks, group=mesh.data_group)
                sq = torch.where(ep, blocks, sq)
            by_key = torch.zeros(len(uniq), device=sq.device).index_add_(
                0, index, sq)
            if pp_sum:
                layers = by_key[lo:hi].contiguous()
                dist.all_reduce(layers, group=mesh.pp_group)
                by_key[lo:hi] = layers
            return by_key[index]

        return Blocks(sq_sum, [int(sizes[uniq.index(k)]) for k in keys])

    def _sum_sequence_parallel_grads(self) -> None:
        """Under sequence parallelism, sum over the mp group the gradients
        of every parameter that mp does not split (the rule: absent from
        ``mp_split``; the LayerNorms, the row-parallel biases, the
        position table): each rank's saw only its part of the sequence.
        GSPMD makes this sum in JAX. Without sequence parallelism they
        are whole, and equal, on every mp rank already."""
        gcfg = getattr(self.module, "gpt_config", None)
        if gcfg is None or not gcfg.sp:
            return
        grads = [p.grad for n, p in self.module.nets.named_parameters()
                 if n not in self.mp_split and p.grad is not None]
        if grads:
            all_reduce_sum(grads, group=self.mesh.mp_group)

    def _tie_copies(self) -> List[str]:
        """The parameters that are a copy of another stage's (the last
        stage's tied word embedding under pp): counted once, on the first
        stage."""
        if self.mesh.pp == 1 or not self.mesh.is_last_stage:
            return []
        return list(getattr(self.module, "tied_parameters", ()))

    def _sum_tied_grads(self, names: List[str],
                        grads: List[torch.Tensor]) -> None:
        """Sum the tied parameters' gradients (or their slices: both copies
        have one plan) over the embedding group (the first and the last
        stage), so both copies take one update."""
        group = self.mesh.embed_group
        tied = set(getattr(self.module, "tied_parameters", ()))
        mine = [g for n, g in zip(names, grads) if n in tied]
        if group is not None and mine:
            all_reduce_sum(mine, group=group)

    def _from_last_stage(self, t: torch.Tensor) -> None:
        """Overwrite ``t`` with the last stage's (broadcast over the pp
        group)."""
        dist.broadcast(t, src=self.mesh.pp_ranks[-1],
                       group=self.mesh.pp_group)

    def _sum_over(self, values: List[float], group) -> List[float]:
        """The sum of ``values`` over ``group`` (on the host over gloo)."""
        on = "cpu" if dist.get_backend(group) == "gloo" else self.device
        t = torch.tensor(values, dtype=torch.float64, device=on)
        dist.all_reduce(t, group=group)
        return t.tolist()

    # ------------------------------------------------------------------ fit
    def _log_train(self, log: Dict) -> None:
        if self.primary:
            self.module.training_step_end(log)

    def _flops_per_token(self, seq: int, tokens: Optional[int] = None
                         ) -> Optional[float]:
        """The model FLOPs per token of a step whose global batch holds
        ``tokens`` tokens (the config's global batch when None) of length
        ``seq``."""
        gcfg = getattr(self.module, "gpt_config", None)
        if gcfg is None:
            return None
        if gcfg.expert_mode:
            if tokens is None:
                tokens = int(self.cfg.Global.global_batch_size) * seq
            experts = sum(p.numel() * self.ep_world for n, p in
                          self.module.nets.named_parameters()
                          if is_expert_param(n))
            # each micro-batch routes its own global tokens
            return moe_flops_per_token(self.n_params - experts, experts,
                                       gcfg, tokens // self.accumulate_steps,
                                       seq)
        return model_flops_per_token(self.n_params, gcfg.num_layers, seq,
                                     gcfg.hidden_size)

    def _flops_per_element(self, shape, tokens: int) -> Optional[float]:
        """The model FLOPs per counted element of a step whose global batch
        counts ``tokens`` elements, its counted array of local ``shape``:
        the module's FLOPs a sample over the elements of one sample, or
        the GPT count per token."""
        per_sample = self.module.model_flops_per_sample(self.n_params)
        if per_sample is not None:
            return per_sample / float(np.prod(shape[1:]))
        return self._flops_per_token(shape[1], tokens)

    def fit(self, train_data: Iterable,
            valid_data: Optional[Iterable] = None):
        """Train until ``Engine.max_steps`` or the end of
        ``Engine.num_train_epochs`` epochs (from the restored epoch),
        logging every ``Engine.logging_freq`` steps, saving every
        ``Engine.save_load.save_steps`` and, given ``valid_data``,
        evaluating every ``Engine.eval_freq`` steps. SIGTERM (on the main
        thread) checkpoints and returns; a data stream that raises banks
        a checkpoint and re-raises."""
        if self.optimizer is None:
            self.init_state()
        self._preempted = False  # a fresh fit() trains, not insta-saves
        self._install_preemption_handler()
        self._profiler_maybe_start()
        try:
            self._fit_epochs(train_data, valid_data)
        finally:
            self._restore_preemption_handler()
        return self

    def _fit_epochs(self, train_data, valid_data) -> None:
        peak = peak_flops(self.device)
        if peak is not None:  # every card the ranks run on
            peak *= max(self.mesh.world // ranks_per_card(), 1)
        global_batch = self.cfg.Global.global_batch_size
        tokens_per_batch = flops = None
        for epoch in range(self.start_epoch, self.num_train_epochs):
            self._cur_epoch = epoch
            sampler = getattr(train_data, "batch_sampler", None)
            if sampler is not None and hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
            dataset = getattr(train_data, "dataset", None)
            if dataset is not None and hasattr(dataset, "set_epoch"):
                dataset.set_epoch(epoch)  # per-epoch re-masking (ERNIE)
            t_last = time.time()
            window = []
            batches = iter(faults.wrap_train_data(train_data))
            while True:
                try:
                    with span("train.data", step=self.step):
                        batch = next(batches)
                except StopIteration:
                    break
                except Exception:
                    # bank the healthy progress before surfacing the
                    # failure, so a restart resumes here
                    logger.exception(
                        "train data stream raised at step %d; writing an "
                        "emergency checkpoint before re-raising", self.step)
                    self._profiler_maybe_stop(summary=False)
                    self._guarded_save(epoch)
                    self.wait_for_checkpoints()
                    raise
                if self.step >= self.max_steps:
                    break
                if self._preemption_agreed():
                    logger.warning("preemption signal received: "
                                   "checkpointing at step %d and exiting "
                                   "fit()", self.step)
                    # the trace closes first; its summary would spend the
                    # grace window
                    self._profiler_maybe_stop(summary=False)
                    self.save(epoch=epoch)
                    self.wait_for_checkpoints()
                    return
                # a host loss raises here, before the step: its batch was
                # fetched but not applied
                faults.on_train_step(self.step)
                if tokens_per_batch is None:  # the global batch's
                    shape = np.shape(_counted(batch))
                    tokens_per_batch = get_data_world(self.mesh) * int(
                        np.prod(shape))
                    flops = self._flops_per_element(shape, tokens_per_batch)
                    self._tokens_per_batch = tokens_per_batch
                    self._flops_per_tok = flops
                with span("train.step", step=self.step):
                    out = self.train_step(self._to_device(batch))
                # a skipped batch is consumed too: a resume does not
                # re-feed it
                self.consumed_samples += global_batch
                if out["skipped"]:
                    self._sentry_skip(out, epoch)
                    continue
                self._sentry_consecutive = 0
                self._obs_steps.inc()
                # before the logging, eval and save hooks, so that the
                # profiled window times the train steps
                self._profiler_step(self.step)
                window.append(out["loss"])
                self.history.append(out)
                with span("train.callback", step=self.step):
                    if self.step % self.logging_freq == 0:
                        loss = float(torch.stack(window).mean())
                        window = []
                        dt = (time.time() - t_last) / self.logging_freq
                        t_last = time.time()
                        ips = tokens_per_batch / dt
                        mfu = (None if peak is None or flops is None
                               else ips * flops / peak)
                        lr = float(self.lr_schedule(self.step))
                        self._obs_loss.set(loss)
                        self._obs_lr.set(lr)
                        self._obs_step_time.observe(dt)
                        self._obs_tokens_per_s.set(ips)
                        if mfu is not None:
                            self._obs_mfu.set(mfu)
                        if self.device.type == "cuda":
                            self._obs_hbm_bytes.set(float(
                                torch.cuda.max_memory_allocated(
                                    self.device)))
                        self._log_train({
                            "epoch": epoch, "batch": self.step,
                            "loss": loss, "batch_cost": dt,
                            "ips_total": ips, "ips": ips, "lr": lr,
                            "mfu": mfu,
                        })
                    if (self.eval_freq and valid_data is not None
                            and self.step % self.eval_freq == 0):
                        self.evaluate(valid_data, epoch=epoch)
                    if self.save_steps and self.step % self.save_steps == 0:
                        self._guarded_save(epoch)
            if self.step >= self.max_steps:
                break
        self._profiler_maybe_stop()
        self.wait_for_checkpoints()

    def _sentry_skip(self, out: Dict, epoch: int) -> None:
        """Count a skipped step (JAX :846-880); after
        ``FLEETX_SENTRY_MAX_SKIPS`` in a row, save and raise
        :class:`SentryAbort`."""
        self.sentry_skips += 1
        self._sentry_consecutive += 1
        self._obs_sentry_skips.inc()
        obs_emit("sentry_skip", step=self.step, loss=float(out["loss"]),
                 grad_norm=float(out["grad_norm"]),
                 consecutive=self._sentry_consecutive)
        if self.primary:
            logger.warning(
                "sentry: skipped anomalous step %d (loss=%s grad_norm=%s; "
                "%d skipped total, %d consecutive)", self.step,
                float(out["loss"]), float(out["grad_norm"]),
                self.sentry_skips, self._sentry_consecutive)
        if self._sentry_consecutive >= self._sentry_max_skips:
            self._profiler_maybe_stop(summary=False)
            self._guarded_save(epoch)
            self.wait_for_checkpoints()
            obs_emit("sentry_abort", step=self.step,
                     consecutive=self._sentry_consecutive)
            raise SentryAbort(
                f"{self._sentry_consecutive} consecutive train steps "
                f"skipped by the sentry at step {self.step} "
                "(FLEETX_SENTRY_MAX_SKIPS); last healthy state checkpointed")

    # ----------------------------------------------------------------- eval
    def evaluate(self, valid_data: Iterable, epoch: int = 0
                 ) -> Optional[float]:
        """The mean loss over the first ``Engine.eval_iters`` batches of
        ``valid_data`` (forward only, no dropout, no gradients; under pp
        the pipeline's forwards), logged through ``validation_step_end``
        with the mean of the module's ``metrics`` (a vision module's
        ``acc``), which :attr:`eval_metrics` keeps; None when there is no
        batch."""
        if self.optimizer is None:
            self.init_state()
        losses, metrics = [], {}
        t0 = time.time()
        loss_fn = (self.module.pipeline_loss if self.mesh.pp > 1
                   else self.module.loss_fn)
        with torch.no_grad():
            for i, batch in enumerate(valid_data):
                if self.eval_iters is not None and i >= self.eval_iters:
                    break
                losses.append(loss_fn(self._to_device(batch), None,
                                      train=False))
                for k, v in (getattr(self.module, "metrics", None)
                             or {}).items():
                    metrics.setdefault(k, []).append(v)
        if not losses:
            return None
        n = len(losses)
        if self.mesh.data_world > 1 or self.mesh.pp > 1:
            losses = torch.stack(losses)
        if self.mesh.data_world > 1:  # each rank's is its share of the mean
            dist.all_reduce(losses, group=self.mesh.data_group)
            for k, v in metrics.items():
                metrics[k] = torch.stack(v)
                dist.all_reduce(metrics[k], group=self.mesh.data_group)
        if self.mesh.pp > 1:
            self._from_last_stage(losses)
        mean = float(np.mean([float(x) for x in losses]))
        self.eval_metrics = {k: float(np.mean([float(x) for x in v]))
                             for k, v in metrics.items()}
        if self.primary:
            self.module.validation_step_end({
                "epoch": epoch, "batch": self.step, "loss": mean,
                "batch_cost": (time.time() - t0) / n,
                **self.eval_metrics})
        return mean

    # ------------------------------------------------------ across the ranks
    def _world_max(self, values: List[float]) -> List[float]:
        """The elementwise max of ``values`` over every rank (``values``
        itself on a single rank). Over gloo the reduction runs on the host,
        over NCCL on the card."""
        if self.mesh.world == 1:
            return list(values)
        on = "cpu" if dist.get_backend() == "gloo" else self.device
        t = torch.tensor(values, dtype=torch.float64, device=on)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t.tolist()

    def _all_ok(self, ok: bool) -> bool:
        """Whether ``ok`` holds on every rank."""
        return self._world_max([0.0 if ok else 1.0])[0] == 0.0

    def _barrier(self) -> None:
        self._world_max([0.0])

    # ------------------------------------------------------------ checkpoint
    def _ckpt_store(self) -> CheckpointStore:
        if self._store is None:
            self._store = CheckpointStore(
                os.path.join(self.output_dir, "checkpoints"), max_to_keep=3)
        return self._store

    def wait_for_checkpoints(self) -> None:
        """Block until the in-flight snapshot upload (if any) finishes."""
        t = self._upload_thread
        if t is not None:
            t.join()
            self._upload_thread = None

    def _record_save_failure(self, step: int) -> None:
        """Count one failed checkpoint save (the run survives)."""
        self.save_failures += 1
        self._obs_save_failures.inc()
        obs_emit("save_failure", step=step, failures=self.save_failures)

    def _guarded_save(self, epoch: int = 0) -> None:
        """A periodic or emergency save that survives a failed write: the
        failure is logged and counted, and the next cadence retries."""
        try:
            self.save(epoch=epoch)
        except Exception:
            self._record_save_failure(self.step)
            logger.exception(
                "checkpoint save failed at step %d (%d failures so far); "
                "training continues, next save in %s steps", self.step,
                self.save_failures, self.save_steps)

    def _dropout_impl(self) -> dict:
        """The switches that define the dropout noise stream (JAX
        :1269-1277). The port has no hardware-PRNG flash path."""
        model_cfg = self.cfg.get("Model") or {}
        return {"flash_hw_rng": False,
                "fast_dropout": bool(model_cfg.get("fast_dropout", True))}

    def _save_meta(self, epoch: int) -> dict:
        """The JSON side of a checkpoint (JAX :1066-1081): epoch, consumed
        samples, the dropout implementation and the mesh it was written
        under."""
        mesh = self.mesh
        return {"epoch": epoch, "consumed_samples": self.consumed_samples,
                "dropout_impl": self._dropout_impl(),
                "mesh": {"dp": mesh.dp, "fsdp": mesh.fsdp, "mp": mesh.mp,
                         "pp": mesh.pp, "cp": mesh.cp}}

    def _is_writer(self) -> bool:
        """Whether this rank writes its (stage and) mp rank's state file:
        the ranks of dp, fsdp and cp rank 0."""
        mesh = self.mesh
        return mesh.dp_rank == 0 and mesh.fsdp_rank == 0 and mesh.cp_rank == 0

    def _pp_rank(self) -> Optional[int]:
        """This rank's stage in its state file's name (None at pp 1, whose
        files keep their name)."""
        return self.mesh.pp_rank if self.mesh.pp > 1 else None

    def _virtual_pp(self) -> int:
        gcfg = getattr(self.module, "gpt_config", None)
        return getattr(gcfg, "virtual_pp", 1)

    def _param_names(self) -> List[str]:
        """The optimizer's parameters' names, in its index order."""
        return [self._opt_names[id(p)] for group in self.optimizer.param_groups
                for p in group["params"]]

    def opt_state_device_bytes(self) -> int:
        """The AdamW state's bytes resident on this rank (JAX :677-691):
        every state tensor at its own size, so the update shard shrinks
        the moments by the number of slices."""
        return sum(v.numel() * v.element_size()
                   for s in self.optimizer.state.values()
                   for v in s.values() if isinstance(v, torch.Tensor))

    def optimizer_state(self, device: Optional[torch.device] = None,
                        keep: bool = True) -> Dict[str, Dict]:
        """The AdamW state by parameter name with whole moments (on
        ``device``; theirs when None): under the update shard the slices
        are gathered over the zero group, a collective that every rank of
        the group enters (with ``keep`` False this rank keeps nothing and
        gets an empty dict)."""
        names = self._param_names()
        opt_params = [p for g in self.optimizer.param_groups
                      for p in g["params"]]
        state = {n: dict(self.optimizer.state.get(p, {}))
                 for n, p in zip(names, opt_params)}
        zero = self.zero
        if zero is None or not any(state.values()):
            return state if keep else {}
        for k in moment_keys(self.optimizer):
            whole = zero.whole([state[n][k] for n in zero.names], device,
                               keep=keep)
            for n, t in zip(zero.names, whole):
                state[n][k] = t
        return state if keep else {}

    def _state(self) -> dict:
        """This rank's checkpoint: step, parameters, the optimizer's state
        (whole moments) and parameter groups keyed by parameter name, the
        generator; under pp also the virtual degree, which places the
        layers. Under the update shard the moments are gathered to the
        writer (on the host) first: the ranks of cp rank 0 of each zero
        group take part."""
        names = self._param_names()
        opt = self.optimizer.state_dict()
        by_name = {names[i]: s for i, s in opt["state"].items()}
        if self.zero is not None and self.mesh.cp_rank == 0:
            writer = self._is_writer()
            whole = self.optimizer_state(torch.device("cpu"), keep=writer)
            if writer:
                by_name = {n: s for n, s in whole.items() if s}
        layout = ({"virtual_pp": self._virtual_pp()} if self.mesh.pp > 1
                  else {})
        params = {n: p.detach() for n, p in
                  self.module.nets.named_parameters()}
        if self.experts:  # every rank enters the gathers
            experts = sorted(self.experts)
            params.update(zip(experts, self._whole_experts(
                [params[n] for n in experts])))
            for k in moment_keys(self.optimizer):
                held = [n for n in experts if k in by_name.get(n, {})]
                for n, t in zip(held, self._whole_experts(
                        [by_name[n][k] for n in held])):
                    by_name[n] = {**by_name[n], k: t}
        return {**layout,
            "step": self.step,
            "params": params,
            "optimizer": {
                "state": by_name,
                "param_groups": [{**g, "params": [names[i] for i in
                                                  g["params"]]}
                                 for g in opt["param_groups"]]},
            "generator": self.generator.get_state(),
        }

    def _whole_experts(self, blocks: List[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Every data rank's blocks of the expert tensors ``blocks``
        joined along the expert axis (JAX's whole ``[E, ...]`` leaves); a
        collective over the data group (on the host over gloo)."""
        group = self.mesh.data_group
        host = dist.get_backend(group) == "gloo"
        out = []
        for t in blocks:
            src = t.detach().to("cpu" if host else t.device).contiguous()
            parts = [torch.empty_like(src) for _ in range(self.ep_world)]
            dist.all_gather(parts, src, group=group)
            out.append(torch.cat(parts).to(t.device))
        return out

    def _my_experts(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of a checkpoint's whole tensor ``whole`` of
        parameter ``name`` (``whole`` itself unless it is an expert
        leaf split over the data ranks)."""
        if name not in self.experts:
            return whole
        e = whole.shape[0]
        return whole[expert_block(e, self.ep_world, self.mesh.data_rank)]

    def _check_generator_agrees(self) -> None:
        """Every rank draws the same dropout seeds; a checkpoint keeps one
        generator state per mp rank, so a rank that drifted would resume
        another stream. Raise unless all ranks' states are equal."""
        if self.mesh.world == 1:
            return
        d = _state_digest(self.generator.get_state())
        hi, neg_lo = self._world_max([d, -d])
        if hi != -neg_lo:
            raise RuntimeError("the dropout generator's state differs "
                               "between ranks; refusing to checkpoint")

    def save(self, epoch: int = 0) -> None:
        """Save step, parameters, AdamW state, generator and meta (JAX
        :1083-1173). Every rank calls it. A step already saved with the
        same meta is skipped; a step saved with older meta (sentry skips
        advance ``consumed_samples`` with the step frozen) is rewritten:
        the old copy is detached first and reattached if the rewrite
        fails. Under ``FLEETX_CKPT_ASYNC_SNAPSHOT`` (a single process) the
        state is copied to the host here and written by an uploader
        thread; a rewrite stays synchronous."""
        self.wait_for_checkpoints()  # one upload at a time
        store = self._ckpt_store()
        step = self.step
        meta_sig = (step, epoch, self.consumed_samples)
        t0 = time.perf_counter()
        backup = None
        if step in store.all_steps():
            if meta_sig == self._last_saved_meta:
                logger.info("checkpoint for step %d already exists; "
                            "skipping duplicate save", step)
                return
            logger.info("checkpoint for step %d exists but meta advanced "
                        "(consumed_samples %s); rewriting", step,
                        self.consumed_samples)
            backup = self._detach_step(step)
        try:
            faults.on_checkpoint_save(step)
            meta = self._save_meta(epoch)
            self._check_generator_agrees()
            state = self._state()
            if self._ckpt_async and backup is None:
                host = _to_host(state)
                nbytes = _nbytes(host)
                blocking = time.perf_counter() - t0
                self.last_save = {"step": step, "bytes": nbytes,
                                  "blocking_s": blocking, "write_s": None,
                                  "total_s": None}
                self._obs_ckpt_bytes.set(float(nbytes))
                self._obs_ckpt_seconds.labels(phase="blocking").observe(
                    blocking)
                self._upload_thread = threading.Thread(
                    target=self._upload_snapshot,
                    args=(store, step, host, meta, meta_sig, t0),
                    name="fleetx-ckpt-upload", daemon=True)
                self._upload_thread.start()
                logger.info("snapshot of step %d handed to the uploader "
                            "(blocked %.3f s, %.1f MB)", step, blocking,
                            nbytes / 1e6)
                return
            nbytes, write_s = self._write(store, step, state, meta)
        except BaseException:
            if backup is not None:
                self._reattach_step(backup, step)
            raise
        if backup is not None and self.primary:
            shutil.rmtree(backup, ignore_errors=True)
        dt = time.perf_counter() - t0
        self.last_save = {"step": step, "bytes": nbytes, "blocking_s": dt,
                          "write_s": write_s, "total_s": dt}
        self._last_saved_meta = meta_sig
        self._obs_ckpt_bytes.set(float(nbytes))
        self._obs_ckpt_seconds.labels(phase="blocking").observe(dt)
        self._obs_ckpt_seconds.labels(phase="total").observe(dt)
        obs_emit("checkpoint_saved", step=step, mode="sync", seconds=dt)
        if self.primary:
            logger.info("saved checkpoint at step %d -> %s (%.3f s, %.1f MB "
                        "per file)", step, store.step_dir(step), dt,
                        nbytes / 1e6)

    def _write(self, store: CheckpointStore, step: int, state: dict,
               meta: dict) -> tuple:
        """The synchronous, collective write of one step: rank 0 opens
        ``<step>.tmp``; the ranks of dp and cp rank 0 each write and fsync
        their (stage and) mp rank's file; rank 0 commits once every rank's write
        returned. A failure on any rank drops the partial step and raises
        on every rank. This rank's file's bytes (0 when it writes none) and
        seconds writing it."""
        mesh = self.mesh
        writer = self._is_writer()
        nbytes, write_s, failure = 0, 0.0, None
        for phase in ("begin", "write", "commit"):
            try:
                if phase == "begin" and self.primary:
                    store.begin(step)
                elif phase == "write" and writer:
                    t0 = time.perf_counter()
                    nbytes = store.write_state(step, mesh.mp_rank, state,
                                               self._pp_rank())
                    write_s = time.perf_counter() - t0
                elif phase == "commit" and self.primary:
                    store.commit(step, meta)
            except Exception as e:  # reported to every rank below
                failure = e
            if not self._all_ok(failure is None):
                if self.primary:
                    store.abort(step)
                raise failure or RuntimeError(
                    f"checkpoint step {step}: the {phase} failed on "
                    "another rank")
        return nbytes, write_s

    def _upload_snapshot(self, store, step, host, meta, meta_sig,
                         t0) -> None:
        """Uploader-thread body: write a host snapshot (a single process).
        ``_last_saved_meta`` moves only once the step is committed; a
        failure is counted as a synchronous one is."""
        try:
            store.begin(step)
            t_write = time.perf_counter()
            nbytes = store.write_state(step, 0, host)
            write_s = time.perf_counter() - t_write
            store.commit(step, meta)
            self._last_saved_meta = meta_sig
            total = time.perf_counter() - t0
            self.last_save = {**self.last_save, "bytes": nbytes,
                              "write_s": write_s, "total_s": total}
            self._obs_ckpt_seconds.labels(phase="total").observe(total)
            obs_emit("checkpoint_saved", step=step, mode="async_snapshot",
                     seconds=total)
            logger.info("saved checkpoint at step %d -> %s (async snapshot: "
                        "%.3f s blocking / %.3f s total)", step,
                        store.step_dir(step), self.last_save["blocking_s"],
                        total)
        except Exception:
            store.abort(step)
            self._record_save_failure(step)
            logger.exception("async snapshot upload failed at step %d (%d "
                             "failures so far); training continues, next "
                             "save retries", step, self.save_failures)

    def _detach_step(self, step: int) -> Optional[str]:
        """Move an existing step aside (to ``<output_dir>/rewrite/<step>``)
        before a meta-advanced rewrite (JAX :1209); the backup's path."""
        store = self._ckpt_store()
        exists = os.path.isdir(store.step_dir(step))
        self._barrier()  # every rank has looked before rank 0 moves it
        hold = os.path.join(self.output_dir, "rewrite")
        if self.primary and exists:
            store.detach(step, hold)
        self._barrier()
        return os.path.join(hold, str(step)) if exists else None

    def _reattach_step(self, backup: str, step: int) -> None:
        """Put a detached step back after a failed rewrite (JAX :1232)."""
        if self.primary:
            self._ckpt_store().reattach(backup, step)
            logger.warning("rewrite of checkpoint step %d failed; original "
                           "copy restored", step)
        self._barrier()

    def _quarantine_step(self, step: int) -> None:
        """Move a step that failed verified restore out of the checkpoint
        root, to ``<output_dir>/quarantine/<step>`` (JAX :1408), so that it
        is never offered again."""
        if self.primary:
            dst = self._ckpt_store().quarantine(
                step, os.path.join(self.output_dir, "quarantine"))
            if dst is not None:
                logger.warning("quarantined corrupt checkpoint step %d -> "
                               "%s", step, dst)
                self._obs_quarantines.inc()
                obs_emit("checkpoint_quarantine", step=step, moved_to=dst)
        self._barrier()

    def load(self, step: Optional[int] = None) -> bool:
        """Restore a checkpoint: parameters (in place, so the optimizer
        keeps stepping them), AdamW state, step, epoch, consumed samples
        and the dropout generator (JAX :1279-1341). Without ``step`` it
        walks back from the newest step; one that fails verified restore
        on any rank (unreadable, another step counter, a key or shape
        that differs from the model's) is quarantined and the next older
        one tried. An explicit ``step`` raises instead. False when there
        is no checkpoint; :class:`CheckpointUnrestorable` when every
        candidate is bad; a step written under another mp/pp/cp raises
        :class:`~fleetx_tpu_torch.resilience.elastic.ElasticMeshMismatch`
        and is not quarantined."""
        self.wait_for_checkpoints()  # a pending upload is a candidate too
        store = self._ckpt_store()
        candidates = ([step] if step is not None
                      else sorted(store.all_steps(), reverse=True))
        if not candidates:
            logger.warning("no checkpoint found under %s", store.root)
            return False
        newest = candidates[0]
        for cand in candidates:
            if cand == self._restored_step and self.step == cand:
                return True  # init_state already restored it
            if self.optimizer is None:
                raise RuntimeError("call init_state (or fit) before load")
            t0 = time.perf_counter()
            restored = failure = None
            try:
                restored = self._restore_step(cand)
            except ElasticMeshMismatch:
                raise  # a configuration error, not corruption
            except Exception as e:  # reported to every rank below
                failure = e
            if not self._all_ok(failure is None):
                if step is not None:
                    raise failure or RuntimeError(
                        f"checkpoint step {cand} failed verified restore "
                        "on another rank")
                logger.error("checkpoint step %d failed verified restore "
                             "(%s); quarantining it and falling back to the "
                             "next-older step", cand,
                             failure if failure is not None
                             else "on another rank")
                self._quarantine_step(cand)
                continue
            self._apply_restored(cand, *restored)
            self._obs_opt_bytes.set(float(self.opt_state_device_bytes()))
            if self.primary:
                logger.info("restored checkpoint step %d (epoch %d) in "
                            "%.3f s", cand, self.start_epoch,
                            time.perf_counter() - t0)
            if cand != newest:
                logger.warning("restored FALLBACK checkpoint step %d; newer "
                               "step(s) %s were quarantined", cand,
                               [s for s in candidates if s > cand])
            return True
        raise CheckpointUnrestorable(
            f"no restorable checkpoint under {store.root}: every candidate "
            f"step {candidates} failed verified restore and was "
            "quarantined")

    def _restore_step(self, step: int):
        """Read and verify this rank's state of ``step`` (raises on any
        mismatch). The meta is read first and its mesh checked against
        this trainer's (JAX :1343-1378)."""
        store = self._ckpt_store()
        meta = store.read_meta(step)
        validate_restore_mesh(meta.get("mesh") or {}, self.mesh, step=step)
        state = store.read_state(step, self.mesh.mp_rank, self._pp_rank())
        if state.get("virtual_pp", 1) != self._virtual_pp():
            raise ElasticMeshMismatch(
                f"checkpoint step {step} was written at virtual_pp "
                f"{state.get('virtual_pp', 1)}, this run places its layers "
                f"at {self._virtual_pp()}")
        if state.get("step") != step:
            raise ValueError(f"checkpoint dir {step} holds step counter "
                             f"{state.get('step')}")
        params = state["params"]
        # the shapes a checkpoint holds: an expert leaf whole
        want = {n: torch.empty((p.shape[0] * self.ep_world,)
                               + tuple(p.shape[1:]), dtype=p.dtype,
                               device="meta")
                if n in self.experts else p
                for n, p in self.module.nets.named_parameters()}
        if params.keys() != want.keys():
            raise ValueError(f"checkpoint step {step}: parameters "
                             f"{sorted(params.keys() ^ want.keys())} differ "
                             "from the model's")
        for n, p in want.items():
            if params[n].shape != p.shape or params[n].dtype != p.dtype:
                raise ValueError(f"checkpoint step {step}: {n} is "
                                 f"{tuple(params[n].shape)} {params[n].dtype}"
                                 f", the model's {tuple(p.shape)} {p.dtype}")
        opt = state["optimizer"]
        groups = [g["params"] for g in opt["param_groups"]]
        names = self._param_names()
        if [n for g in groups for n in g] != names:
            raise ValueError(f"checkpoint step {step}: the optimizer's "
                             "parameter groups differ from the model's")
        for n, s in opt["state"].items():
            for k, v in s.items():
                if (torch.is_tensor(v) and v.dim()
                        and v.shape != want[n].shape):
                    raise ValueError(f"checkpoint step {step}: {k} of {n} "
                                     f"is {tuple(v.shape)}")
        if not (isinstance(state.get("generator"), torch.Tensor)
                and state["generator"].dtype == torch.uint8):
            raise ValueError(f"checkpoint step {step}: no generator state")
        return state, meta

    def _apply_restored(self, step: int, state: dict, meta: dict) -> None:
        """Install a verified restore: the parameters copied into the
        existing ones (the optimizer holds those objects), the AdamW state
        re-keyed from names to the optimizer's indices, the generator, the
        step and the resume meta (JAX :1380-1406)."""
        with torch.no_grad():
            for n, p in self.module.nets.named_parameters():
                p.copy_(self._my_experts(n, state["params"][n]))
        index = {n: i for i, n in enumerate(self._param_names())}
        opt = state["optimizer"]
        by_name = {n: {k: (self._my_experts(n, v) if torch.is_tensor(v)
                           and v.dim() else v) for k, v in s.items()}
                   for n, s in opt["state"].items()}
        if self.zero is not None:  # reshard-on-load: this rank's slices
            self.zero.refresh_staged()
            pos = {n: i for i, n in enumerate(self.zero.names)}
            whole = dict(self.module.nets.named_parameters())
            by_name = {n: {k: (self.zero.shard_of(pos[n], v)
                               if _is_moment(v, whole[n]) else v)
                           for k, v in s.items()}
                       for n, s in by_name.items()}
        self.optimizer.load_state_dict({
            "state": {index[n]: s for n, s in by_name.items()},
            "param_groups": [{**g, "params": [index[n] for n in g["params"]]}
                             for g in opt["param_groups"]]})
        self.generator.set_state(state["generator"])
        self.step = step
        self.start_epoch = meta.get("epoch", 0)
        self.consumed_samples = meta.get("consumed_samples", 0)
        # a save at this step with unchanged meta must skip, not rewrite
        self._last_saved_meta = (step, self.start_epoch,
                                 self.consumed_samples)
        saved_impl = meta.get("dropout_impl")
        if saved_impl is not None and saved_impl != self._dropout_impl():
            logger.warning(
                "checkpoint was trained with dropout_impl=%s but this run "
                "uses %s — the dropout noise stream will differ from an "
                "uninterrupted run", saved_impl, self._dropout_impl())
        self._restored_step = step

    # -------------------------------------------------------------- profiler
    def flops_per_step(self) -> Optional[float]:
        """The model FLOPs of one step over the global batch (the MFU
        formula, ``model_flops_per_token``), None before the first batch
        or without a GPT config."""
        tokens = getattr(self, "_tokens_per_batch", None)
        flops = getattr(self, "_flops_per_tok", None)
        return None if tokens is None or flops is None else tokens * flops

    def _profiler_maybe_start(self) -> None:
        """Read the ``Profiler`` section (JAX :1476-1484): the window
        ``scheduler`` [lo, hi] (default [1, 5]) and ``profiler_log``."""
        prof = self.cfg.get("Profiler") or {}
        self._prof_enabled = bool(prof.get("enable"))
        if not self._prof_enabled:
            return
        self._prof_window = tuple(prof.get("scheduler") or [1, 5])
        self._prof_dir = prof.get("profiler_log", "profiler_log")
        self._prof_run = time.strftime("%Y_%m_%d_%H_%M_%S")

    def _profiler_step(self, step: int) -> None:
        """After applied step ``step``: open the window at ``lo``, tick,
        and close it at ``hi`` (JAX :1486-1503)."""
        if not self._prof_enabled:
            return
        lo, hi = self._prof_window
        if self._prof is None and step >= lo:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize(self.device)
            self._prof = profile(activities=acts)
            self._prof.start()
            self._prof_ticks = [time.perf_counter()]
        elif self._prof is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._prof_ticks.append(time.perf_counter())
        if self._prof is not None and step >= hi:
            self._prof_enabled = False
            self._profiler_maybe_stop()

    def _profiler_maybe_stop(self, summary: bool = True) -> None:
        """Close an open window: write this rank's trace and, on rank 0
        and unless ``summary`` is False (the preemption path), print the
        summary views from it (JAX :1505-1525)."""
        if self._prof is None:
            return
        from fleetx_tpu_torch.utils.profiler_summary import (
            print_summary,
            trace_path,
        )

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        path = trace_path(self._prof_dir, self._prof_run, self.mesh.rank)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._prof.export_chrome_trace(path)
        self._prof = None
        self.profiler_trace = path
        logger.info("profiler trace written to %s", path)
        if summary and self.primary:
            ticks = self._prof_ticks
            print_summary(self, dict(self.cfg.get("Profiler") or {}),
                          self._prof_dir,
                          [b - a for a, b in zip(ticks, ticks[1:])],
                          trace_file=path)

    # ------------------------------------------------------------ preemption
    def _install_preemption_handler(self) -> None:
        """SIGTERM -> finish the in-flight step, checkpoint, return from
        ``fit`` (JAX :1437-1458). Only the main thread may set a signal
        handler; elsewhere this does nothing."""
        if threading.current_thread() is not threading.main_thread():
            return

        def on_sigterm(signum, frame):
            self._preempted = True  # the fit loop checkpoints and returns

        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, on_sigterm)
        except (ValueError, OSError):
            self._prev_sigterm = None

    def _restore_preemption_handler(self) -> None:
        """Put back whatever SIGTERM handler ``fit`` displaced."""
        if (self._prev_sigterm is None
                or threading.current_thread() is not threading.main_thread()):
            return
        try:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
        except (ValueError, OSError):
            pass
        self._prev_sigterm = None

    def _preemption_agreed(self) -> bool:
        """Whether any rank was sent SIGTERM: ranks must stop after the
        same step, or one would wait in a collective the others never
        join."""
        return self._world_max([float(self._preempted)])[0] > 0


def _to_host(tree):
    """A copy of ``tree``'s tensors on the host (the snapshot's D2H)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _nbytes(tree) -> int:
    """The bytes of ``tree``'s tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return 0
