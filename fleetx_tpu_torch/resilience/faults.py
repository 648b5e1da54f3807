"""Deterministic fault injection for the training path and the serving
engine.

Port of the training and engine-side serving parts of the JAX package's
``resilience/faults.py``:
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

Serving injection points (the engine's crash safety; indices count
*attempted* device calls, so a tick retried after a recovery takes a fresh
index and a one-shot selector faults exactly once):

- ``FLEETX_FAULT_TICK_RAISE``: the matching decode ticks raise
  :class:`TickFault` before their forward;
- ``FLEETX_FAULT_PREFILL_RAISE``: the matching prefill attempts raise
  :class:`PrefillFault`;
- ``FLEETX_FAULT_TICK_HANG`` / ``FLEETX_FAULT_TICK_HANG_S``: the matching
  decode ticks sleep that long inside the watched call (what
  ``FLEETX_SERVING_TICK_TIMEOUT_S`` catches);
- ``FLEETX_FAULT_POISON_REQUEST``: a selector over request ids: any decode
  tick (or bisection probe) whose batch holds one raises
  :class:`PoisonFault`;
- ``FLEETX_FAULT_KV_SHIP_RAISE``: the matching ``export_kv`` attempts raise
  :class:`KVShipFault` before a page is read;
- ``FLEETX_FAULT_KV_SHIP_CORRUPT``: the matching exports flip one byte of a
  serialized page, which the receiver's crc32 check refuses.

Replica-level injection points (the router calls both hooks):

- ``FLEETX_FAULT_REPLICA_KILL``: ``"replica:tick"`` entries (comma
  separated): the router's attempt to tick the matching replica at the
  matching ROUTER tick raises :class:`ReplicaKilled` (each entry fires
  once); the router marks the replica dead and migrates its requests;
- ``FLEETX_FAULT_PROBE_FLAP``: ``"replica:times"`` entries: the matching
  replica's next ``times`` health probes lie (``state: "dead"``) before
  telling the truth again.

Cross-process RPC injection points (the replica client; indices count
*attempted* RPC calls process-wide in the calling process):

- ``FLEETX_FAULT_RPC_DROP``: the matching RPC attempts raise
  :class:`RPCFault` (a ``ConnectionError``) instead of touching the
  network;
- ``FLEETX_FAULT_RPC_DELAY`` / ``FLEETX_FAULT_RPC_DELAY_S``: sleep that
  long before the matching RPC attempts.

Selectors share one grammar: a comma-separated list of entries, each an
int (``"3"``) or ``"N+"`` for every index >= N (``"0+"`` = always).
Each injection is logged and emitted as a ``fault_injected`` event.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable, Optional

import numpy as np

from fleetx_tpu_torch.obs.events import emit as obs_emit
from fleetx_tpu_torch.utils.log import logger

__all__ = ["CkptFault", "DataFault", "FaultInjector", "FaultPlan",
           "HostLossFault", "KVShipFault", "PoisonFault", "PrefillFault",
           "RPCFault", "ReplicaKilled", "TickFault", "faults"]


class DataFault(RuntimeError):
    """Injected data-iterator failure (FLEETX_FAULT_DATA_RAISE_BATCH)."""


class CkptFault(IOError):
    """Injected checkpoint-write failure (FLEETX_FAULT_CKPT_SAVE_STEP)."""


class HostLossFault(RuntimeError):
    """Injected training host loss (FLEETX_FAULT_HOST_LOSS_STEP): a host
    dropped out of the job before the matching step ran."""


class TickFault(RuntimeError):
    """Injected serving decode-tick failure (FLEETX_FAULT_TICK_RAISE)."""


class PrefillFault(RuntimeError):
    """Injected serving prefill failure (FLEETX_FAULT_PREFILL_RAISE)."""


class PoisonFault(RuntimeError):
    """Injected poison-request failure (FLEETX_FAULT_POISON_REQUEST): the
    decode batch held a request whose presence kills the step."""


class KVShipFault(RuntimeError):
    """Injected KV-export failure (FLEETX_FAULT_KV_SHIP_RAISE): the
    prefill-role replica died mid-handoff; the caller falls back to
    replaying the request elsewhere."""


class ReplicaKilled(RuntimeError):
    """Injected replica death (FLEETX_FAULT_REPLICA_KILL), and what the
    replica client raises when a replica process stops answering: the
    router rotates the replica out and migrates its in-flight requests."""


class RPCFault(ConnectionError):
    """Injected RPC transport failure (FLEETX_FAULT_RPC_DROP): the call
    never reached the replica process. A ``ConnectionError``, so the
    replica client maps injected and real drops through one path."""


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


def _parse_pairs(spec: str, what: str):
    """``"a:b"`` entries (comma separated ``replica:value`` int pairs) as
    an ordered ``[(a, b), ...]``; a malformed entry raises, naming the
    variable."""
    out = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        try:
            a, b = part.split(":")
            out.append((int(a), int(b)))
        except ValueError:
            raise ValueError(
                f"{what}={spec!r}: entries must be 'replica:N' int pairs "
                "like '1:3' or '0:2,1:3'")
    return out


# the plan's selector fields: a plan with none of them set is no plan
_SELECTORS = ("nan_batch", "data_raise_batch", "data_slow_batch",
              "ckpt_save_step", "host_loss_step", "tick_raise",
              "prefill_raise", "tick_hang", "poison_request", "kv_ship_raise",
              "kv_ship_corrupt", "rpc_drop", "rpc_delay")
# the "replica:N" pair fields, which count as set the same way
_PAIRS = ("replica_kill", "probe_flap")


@dataclasses.dataclass
class FaultPlan:
    """Parsed fault schedule (module docstring has the grammar)."""

    nan_batch: Optional[str] = None
    data_raise_batch: Optional[str] = None
    data_slow_batch: Optional[str] = None
    data_slow_s: float = 0.05
    ckpt_save_step: Optional[str] = None
    host_loss_step: Optional[str] = None
    tick_raise: Optional[str] = None
    prefill_raise: Optional[str] = None
    tick_hang: Optional[str] = None
    tick_hang_s: float = 30.0
    poison_request: Optional[str] = None
    kv_ship_raise: Optional[str] = None
    kv_ship_corrupt: Optional[str] = None
    replica_kill: Optional[str] = None
    probe_flap: Optional[str] = None
    rpc_drop: Optional[str] = None
    rpc_delay: Optional[str] = None
    rpc_delay_s: float = 0.05

    @classmethod
    def from_env(cls, env=os.environ) -> Optional["FaultPlan"]:
        """A plan from ``FLEETX_FAULT_*`` (None when none is set). A
        malformed value raises a ValueError naming the variable."""
        def _float(name, default):
            raw = env.get(name)
            if not raw:
                return default
            try:
                return float(raw)
            except ValueError:
                raise ValueError(f"{name}={raw!r} is not a float")

        plan = cls(
            nan_batch=env.get("FLEETX_FAULT_NAN_BATCH") or None,
            data_raise_batch=env.get("FLEETX_FAULT_DATA_RAISE_BATCH") or None,
            data_slow_batch=env.get("FLEETX_FAULT_DATA_SLOW_BATCH") or None,
            data_slow_s=_float("FLEETX_FAULT_DATA_SLOW_S", 0.05),
            ckpt_save_step=env.get("FLEETX_FAULT_CKPT_SAVE_STEP") or None,
            host_loss_step=env.get("FLEETX_FAULT_HOST_LOSS_STEP") or None,
            tick_raise=env.get("FLEETX_FAULT_TICK_RAISE") or None,
            prefill_raise=env.get("FLEETX_FAULT_PREFILL_RAISE") or None,
            tick_hang=env.get("FLEETX_FAULT_TICK_HANG") or None,
            tick_hang_s=_float("FLEETX_FAULT_TICK_HANG_S", 30.0),
            poison_request=env.get("FLEETX_FAULT_POISON_REQUEST") or None,
            kv_ship_raise=env.get("FLEETX_FAULT_KV_SHIP_RAISE") or None,
            kv_ship_corrupt=env.get("FLEETX_FAULT_KV_SHIP_CORRUPT") or None,
            replica_kill=env.get("FLEETX_FAULT_REPLICA_KILL") or None,
            probe_flap=env.get("FLEETX_FAULT_PROBE_FLAP") or None,
            rpc_drop=env.get("FLEETX_FAULT_RPC_DROP") or None,
            rpc_delay=env.get("FLEETX_FAULT_RPC_DELAY") or None,
            rpc_delay_s=_float("FLEETX_FAULT_RPC_DELAY_S", 0.05),
        )
        if not any(getattr(plan, f) for f in _SELECTORS + _PAIRS):
            return None
        return plan


class FaultInjector:
    """Process-global injector: the active plan and the fetch counter."""

    _ZERO = {"nan": 0, "data_raise": 0, "data_slow": 0, "ckpt": 0,
             "host_loss": 0, "tick_raise": 0, "prefill_raise": 0,
             "tick_hang": 0, "poison": 0, "kv_ship_raise": 0,
             "kv_ship_corrupt": 0, "replica_kill": 0, "probe_flap": 0,
             "rpc_drop": 0, "rpc_delay": 0}

    def __init__(self):
        self._plan: Optional[FaultPlan] = None
        self._nan_sel = self._raise_sel = self._slow_sel = None
        self._ckpt_sel = self._host_loss_sel = None
        self._tick_sel = self._prefill_sel = self._hang_sel = None
        self._poison_sel = self._ship_raise_sel = self._ship_corrupt_sel = None
        self._rpc_drop_sel = self._rpc_delay_sel = None
        self._kill_pending = set()   # {(replica, router tick)} unfired
        self._flap_remaining = {}    # replica -> lying probes left
        self._host_loss_fired = set()  # step indices already killed once
        self._batch_counter = 0
        self._rpc_counter = 0
        self.injected = dict(self._ZERO)

    def configure(self, plan: Optional[FaultPlan] = None, **kw) -> None:
        """Install ``plan`` (or build one from keyword fields); resets the
        counters."""
        if plan is None and kw:
            plan = FaultPlan(**{k: str(v) if v is not None
                                and k in _SELECTORS + _PAIRS else v
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
        self._tick_sel = sel("tick_raise")
        self._prefill_sel = sel("prefill_raise")
        self._hang_sel = sel("tick_hang")
        self._poison_sel = sel("poison_request")
        self._ship_raise_sel = sel("kv_ship_raise")
        self._ship_corrupt_sel = sel("kv_ship_corrupt")
        self._rpc_drop_sel = sel("rpc_drop")
        self._rpc_delay_sel = sel("rpc_delay")
        kill = plan.replica_kill if plan else None
        flap = plan.probe_flap if plan else None
        self._kill_pending = set(
            _parse_pairs(kill, "FLEETX_FAULT_REPLICA_KILL") if kill else ())
        self._flap_remaining = dict(
            _parse_pairs(flap, "FLEETX_FAULT_PROBE_FLAP") if flap else ())
        self._host_loss_fired = set()
        self._batch_counter = 0
        self._rpc_counter = 0
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


    def _injected(self, fault: str, **where) -> None:
        self.injected[fault] += 1
        logger.warning("fault: %s injected (%s)", fault, ", ".join(
            f"{k}={v}" for k, v in where.items()))
        obs_emit("fault_injected", fault=fault, **where)

    def on_serving_tick(self, tick: int) -> None:
        """Decode-tick attempt ``tick``: sleep ``tick_hang_s`` and/or raise
        :class:`TickFault` when it matches. The engine calls this inside
        the watched device call, so an injected hang is what its watchdog
        sees."""
        if self._plan is None:
            return
        if self._hang_sel and tick in self._hang_sel:
            self._injected("tick_hang", tick=tick)
            time.sleep(self._plan.tick_hang_s)
        if self._tick_sel and tick in self._tick_sel:
            self._injected("tick_raise", tick=tick)
            raise TickFault(f"injected decode-tick failure at tick {tick} "
                            "(FLEETX_FAULT_TICK_RAISE)")

    def on_serving_prefill(self, attempt: int, request_id: int) -> None:
        """Raise :class:`PrefillFault` when prefill attempt ``attempt``
        matches (every prefill the engine makes counts, replays too)."""
        if self._prefill_sel and attempt in self._prefill_sel:
            self._injected("prefill_raise", attempt=attempt,
                           request=request_id)
            raise PrefillFault(
                f"injected prefill failure at attempt {attempt} (request "
                f"{request_id}, FLEETX_FAULT_PREFILL_RAISE)")

    def on_serving_batch(self, request_ids) -> None:
        """Raise :class:`PoisonFault` when a configured poison request is
        in ``request_ids`` (a decode tick's batch or a probe's subset)."""
        if self._poison_sel is None:
            return
        hits = [int(r) for r in request_ids if int(r) in self._poison_sel]
        if hits:
            self._injected("poison", requests=str(hits))
            raise PoisonFault(
                f"injected poison-request failure (requests {hits} in the "
                "decode batch, FLEETX_FAULT_POISON_REQUEST)")

    def on_kv_ship(self, attempt: int, request_id: int) -> None:
        """Raise :class:`KVShipFault` when export attempt ``attempt``
        matches."""
        if self._ship_raise_sel and attempt in self._ship_raise_sel:
            self._injected("kv_ship_raise", attempt=attempt,
                           request=request_id)
            raise KVShipFault(
                f"injected KV-export failure at ship attempt {attempt} "
                f"(request {request_id}, FLEETX_FAULT_KV_SHIP_RAISE)")

    def on_kv_ship_corrupt(self, attempt: int) -> bool:
        """True when export attempt ``attempt`` should corrupt one of its
        serialized pages."""
        if self._ship_corrupt_sel and attempt in self._ship_corrupt_sel:
            self._injected("kv_ship_corrupt", attempt=attempt)
            return True
        return False


    def on_rpc(self, method: str) -> None:
        """The replica client's seam, before every HTTP call it makes:
        sleep ``rpc_delay_s`` when the delay selector matches, then raise
        :class:`RPCFault` when the drop selector matches (a connection
        that stalls before dying). ``method`` only labels the event."""
        if self._rpc_drop_sel is None and self._rpc_delay_sel is None:
            return
        i = self._rpc_counter
        self._rpc_counter += 1
        if self._rpc_delay_sel and i in self._rpc_delay_sel:
            self._injected("rpc_delay", attempt=i, method=method)
            time.sleep(self._plan.rpc_delay_s)
        if self._rpc_drop_sel and i in self._rpc_drop_sel:
            self._injected("rpc_drop", attempt=i, method=method)
            raise RPCFault(f"injected RPC drop at attempt {i} (method "
                           f"{method!r}, FLEETX_FAULT_RPC_DROP)")

    def on_router_tick(self, replica: int, tick: int) -> None:
        """Raise :class:`ReplicaKilled` when the router is about to tick
        ``replica`` at router tick ``tick`` and an unfired
        ``FLEETX_FAULT_REPLICA_KILL`` entry matches (each fires once)."""
        if not self._kill_pending:
            return
        key = (int(replica), int(tick))
        if key in self._kill_pending:
            self._kill_pending.discard(key)
            self._injected("replica_kill", replica=key[0], tick=key[1])
            raise ReplicaKilled(
                f"injected replica death: replica {key[0]} at router tick "
                f"{key[1]} (FLEETX_FAULT_REPLICA_KILL)")

    def on_router_probe(self, replica: int) -> Optional[dict]:
        """A lying ``state: "dead"`` health report for ``replica`` while
        its ``FLEETX_FAULT_PROBE_FLAP`` budget lasts (None: probe
        honestly)."""
        remaining = self._flap_remaining.get(int(replica), 0)
        if remaining <= 0:
            return None
        self._flap_remaining[int(replica)] = remaining - 1
        self._injected("probe_flap", replica=int(replica),
                       remaining=remaining - 1)
        return {"state": "dead", "queue_depth": 0, "active": 0,
                "injected": True}


faults = FaultInjector()
faults.configure_from_env()
