"""Deterministic fault injection for the training path.

Port of the training side of the JAX package's ``resilience/faults.py``:
one process-global :class:`FaultInjector` (``faults``) owns a
:class:`FaultPlan` parsed from ``FLEETX_FAULT_*`` environment variables
(read once, when this module is imported) or installed with
:meth:`FaultInjector.configure`. The ``Trainer`` wraps its train data in
:meth:`~FaultInjector.wrap_train_data`, calls
:meth:`~FaultInjector.on_train_step` before each step and
:meth:`~FaultInjector.on_checkpoint_save` before each checkpoint write;
with no plan active every hook is one ``is None`` check.

Injection points (batch indices count *fetched* train batches across the
whole run, whether or not the sentry later skips the step, so the
injection stays deterministic under skip and resume):

- ``FLEETX_FAULT_NAN_BATCH``: every floating-point leaf of the matching
  batches (for GPT, ``loss_mask``) becomes NaN;
- ``FLEETX_FAULT_DATA_RAISE_BATCH``: the data stream raises
  :class:`DataFault` instead of yielding the matching batch;
- ``FLEETX_FAULT_DATA_SLOW_BATCH`` / ``FLEETX_FAULT_DATA_SLOW_S``: sleep
  before yielding the matching batch;
- ``FLEETX_FAULT_CKPT_SAVE_STEP``: ``Trainer.save`` raises
  :class:`CkptFault` at the matching step numbers;
- ``FLEETX_FAULT_HOST_LOSS_STEP``: the step path raises
  :class:`HostLossFault` before the matching applied step runs (each
  step index at most once per configure).

Selectors share one grammar: a comma-separated list of entries, each an
int (``"3"``) or ``"N+"`` for every index >= N (``"0+"`` = always).

The serving injection points (ticks, prefill, poison requests, replicas,
KV shipping, RPC) wait for the serving features and the fleet layer
(ROADMAP Queue A, "Serving features still missing" and "Fleet layer");
the JAX package's structured events wait for the obs module ("Remaining
GPT and Trainer switches"): an injection here is logged instead.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable, Optional

import numpy as np

from fleetx_tpu_torch.utils.log import logger

__all__ = ["CkptFault", "DataFault", "FaultInjector", "FaultPlan",
           "HostLossFault", "faults"]


class DataFault(RuntimeError):
    """Injected data-iterator failure (FLEETX_FAULT_DATA_RAISE_BATCH)."""


class CkptFault(IOError):
    """Injected checkpoint-write failure (FLEETX_FAULT_CKPT_SAVE_STEP)."""


class HostLossFault(RuntimeError):
    """Injected training host loss (FLEETX_FAULT_HOST_LOSS_STEP): a host
    dropped out of the job before the matching step ran."""


class _Selector:
    """Index selector: ``"3"``, ``"1,4"``, ``"2+"`` (every index >= 2)."""

    def __init__(self, spec: str):
        self.exact = set()
        self.from_ = None  # smallest N of any "N+" entry
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            if part.endswith("+"):
                n = int(part[:-1])
                self.from_ = n if self.from_ is None else min(self.from_, n)
            else:
                self.exact.add(int(part))

    def __contains__(self, i: int) -> bool:
        return i in self.exact or (self.from_ is not None and i >= self.from_)

    def __bool__(self) -> bool:
        return bool(self.exact) or self.from_ is not None


@dataclasses.dataclass
class FaultPlan:
    """Parsed training fault schedule (module docstring has the grammar)."""

    nan_batch: Optional[str] = None
    data_raise_batch: Optional[str] = None
    data_slow_batch: Optional[str] = None
    data_slow_s: float = 0.05
    ckpt_save_step: Optional[str] = None
    host_loss_step: Optional[str] = None

    @classmethod
    def from_env(cls, env=os.environ) -> Optional["FaultPlan"]:
        """A plan from ``FLEETX_FAULT_*`` (None when none is set). A
        malformed value raises a ValueError naming the variable."""
        raw = env.get("FLEETX_FAULT_DATA_SLOW_S")
        try:
            slow_s = float(raw) if raw else 0.05
        except ValueError:
            raise ValueError(f"FLEETX_FAULT_DATA_SLOW_S={raw!r} is not a "
                             "float")
        plan = cls(
            nan_batch=env.get("FLEETX_FAULT_NAN_BATCH") or None,
            data_raise_batch=env.get("FLEETX_FAULT_DATA_RAISE_BATCH") or None,
            data_slow_batch=env.get("FLEETX_FAULT_DATA_SLOW_BATCH") or None,
            data_slow_s=slow_s,
            ckpt_save_step=env.get("FLEETX_FAULT_CKPT_SAVE_STEP") or None,
            host_loss_step=env.get("FLEETX_FAULT_HOST_LOSS_STEP") or None,
        )
        if not (plan.nan_batch or plan.data_raise_batch
                or plan.data_slow_batch or plan.ckpt_save_step
                or plan.host_loss_step):
            return None
        return plan


class FaultInjector:
    """Process-global injector: the active plan and the fetch counter."""

    _ZERO = {"nan": 0, "data_raise": 0, "data_slow": 0, "ckpt": 0,
             "host_loss": 0}

    def __init__(self):
        self._plan: Optional[FaultPlan] = None
        self._nan_sel = self._raise_sel = self._slow_sel = None
        self._ckpt_sel = self._host_loss_sel = None
        self._host_loss_fired = set()  # step indices already killed once
        self._batch_counter = 0
        self.injected = dict(self._ZERO)

    def configure(self, plan: Optional[FaultPlan] = None, **kw) -> None:
        """Install ``plan`` (or build one from keyword fields); resets the
        counters."""
        if plan is None and kw:
            plan = FaultPlan(**{k: str(v) if v is not None
                                and k.endswith(("batch", "step")) else v
                                for k, v in kw.items()})

        def sel(field):
            spec = getattr(plan, field, None) if plan else None
            if not spec:
                return None
            try:
                return _Selector(spec)
            except ValueError:
                raise ValueError(
                    f"FLEETX_FAULT_{field.upper()}={spec!r}: selector "
                    "entries must be ints like '3', '1,4', or '2+'")

        self._plan = plan
        self._nan_sel = sel("nan_batch")
        self._raise_sel = sel("data_raise_batch")
        self._slow_sel = sel("data_slow_batch")
        self._ckpt_sel = sel("ckpt_save_step")
        self._host_loss_sel = sel("host_loss_step")
        self._host_loss_fired = set()
        self._batch_counter = 0
        self.injected = dict(self._ZERO)

    def configure_from_env(self, env=os.environ) -> None:
        """Re-read ``FLEETX_FAULT_*`` into the active plan."""
        self.configure(FaultPlan.from_env(env))

    def reset(self) -> None:
        """Deactivate all faults and zero the counters."""
        self.configure(None)

    @property
    def active(self) -> bool:
        """True when any fault is scheduled."""
        return self._plan is not None

    # ------------------------------------------------------ injection points
    def wrap_train_data(self, data: Iterable) -> Iterable:
        """Route a train-data iterable through the data faults; ``data``
        itself when inert. The fetch counter runs across epochs (each wrap
        continues where the previous left off)."""
        if self._plan is None:
            return data

        def gen():
            for batch in data:
                i = self._batch_counter
                self._batch_counter += 1
                if self._raise_sel and i in self._raise_sel:
                    self.injected["data_raise"] += 1
                    raise DataFault(f"injected data failure at batch {i} "
                                    "(FLEETX_FAULT_DATA_RAISE_BATCH)")
                if self._slow_sel and i in self._slow_sel:
                    self.injected["data_slow"] += 1
                    logger.warning("fault: data stream stalls %.3f s at "
                                   "batch %d", self._plan.data_slow_s, i)
                    time.sleep(self._plan.data_slow_s)
                if self._nan_sel and i in self._nan_sel:
                    batch = self._poison(batch, i)
                yield batch

        return gen()

    def _poison(self, batch, i: int):
        """A copy of a dict batch with every floating-point leaf NaN."""
        out, hit = {}, False
        for k, v in batch.items():
            arr = np.asarray(v)
            if np.issubdtype(arr.dtype, np.floating):
                arr = np.full_like(arr, np.nan)
                hit = True
            out[k] = arr
        if not hit:
            raise ValueError(
                f"FLEETX_FAULT_NAN_BATCH: batch {i} has no floating-point "
                "leaf to poison (keys: " + ", ".join(batch) + ")")
        self.injected["nan"] += 1
        logger.warning("fault: batch %d poisoned with NaN", i)
        return out

    def on_checkpoint_save(self, step: int) -> None:
        """Raise :class:`CkptFault` when ``step`` matches the plan."""
        if self._ckpt_sel and step in self._ckpt_sel:
            self.injected["ckpt"] += 1
            raise CkptFault(f"injected checkpoint-write failure at step "
                            f"{step} (FLEETX_FAULT_CKPT_SAVE_STEP)")

    def on_train_step(self, step: int) -> None:
        """Raise :class:`HostLossFault` before applied step ``step`` runs
        when it matches the plan, at most once per step index per
        :meth:`configure`."""
        if (self._host_loss_sel and step in self._host_loss_sel
                and step not in self._host_loss_fired):
            self._host_loss_fired.add(step)
            self.injected["host_loss"] += 1
            raise HostLossFault(
                f"injected host loss before step {step} "
                "(FLEETX_FAULT_HOST_LOSS_STEP)")


faults = FaultInjector()
faults.configure_from_env()
