"""Structured event log: bounded deque of typed operational events.

Where metrics answer "how much/how fast", events answer "what happened":
a sentry skipped step 14, checkpoint step 300 was quarantined, the
serving engine recovered, request 7 was retired as poison. Producers
call :func:`emit` at the site; consumers query the log in snapshots
(``GET /snapshot``), assert on it in chaos tests
(``tools/chaos_check.py`` verifies every injected fault banked its
expected event), and watch per-kind counts through the
``fleetx_events_total{kind=...}`` registry counter.

Known kinds (docs/OBSERVABILITY.md has the full table + attrs):

- training: ``sentry_skip``, ``sentry_abort``, ``save_failure``,
  ``checkpoint_quarantine``
- serving: ``engine_recovery``, ``poison_retired``, ``cache_full``,
  ``tick_fault``, ``tick_timeout``, ``queue_reject``, ``drain_reject``,
  ``request_timeout``, ``request_cancelled``, ``callback_error``,
  ``shutdown``
- router: ``replica_out``, ``replica_back``, ``replica_dead``,
  ``request_migrated``, ``router_stranded``
- chaos: ``fault_injected``

The set is open — any snake_case kind is accepted — but new kinds
belong in the doc table. The log is bounded (``FLEETX_OBS_EVENTS``
events, oldest dropped) so a replica can emit forever; per-kind counts
stay exact in the registry counter even after eviction.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import threading
import time
from typing import Dict, List, Optional

from fleetx_tpu_torch.obs._util import env_int, json_safe as _json_safe
from fleetx_tpu_torch.obs.registry import get_registry

__all__ = ["Event", "EventLog", "emit", "get_event_log"]

_KIND_RE = re.compile(r"^[a-z][a-z0-9_]*$")


@dataclasses.dataclass
class Event:
    """One structured event: kind + unix time + free-form attrs."""

    kind: str
    time_s: float
    attrs: Dict

    def as_dict(self) -> Dict:
        """JSON-safe view (snapshot/exposition shape)."""
        return {"kind": self.kind, "time_s": self.time_s,
                "attrs": {k: _json_safe(v) for k, v in self.attrs.items()}}


def _env_cap() -> int:
    return env_int("FLEETX_OBS_EVENTS", 1024, minimum=1)


class EventLog:
    """Bounded, thread-safe event log + the per-kind registry counter."""

    def __init__(self, capacity: Optional[int] = None, registry=None):
        self._events: collections.deque = collections.deque(
            maxlen=capacity or _env_cap())
        self._lock = threading.Lock()
        self._counter = (registry or get_registry()).counter(
            "fleetx_events_total",
            "Structured events emitted, by kind (fleetx_tpu/obs/events.py)",
            labelnames=("kind",),
        )

    def emit(self, kind: str, **attrs) -> Event:
        """Record one event; returns it. ``kind`` must be snake_case."""
        if not _KIND_RE.match(kind):
            raise ValueError(f"event kind {kind!r} must be snake_case")
        ev = Event(kind=kind, time_s=time.time(), attrs=attrs)
        with self._lock:
            self._events.append(ev)
        self._counter.labels(kind=kind).inc()
        return ev

    def find(self, kind: Optional[str] = None, **attrs) -> List[Event]:
        """Events matching ``kind`` (None = all) whose attrs contain
        every given key/value, oldest first."""
        with self._lock:
            events = list(self._events)
        out = []
        for ev in events:
            if kind is not None and ev.kind != kind:
                continue
            if any(ev.attrs.get(k) != v for k, v in attrs.items()):
                continue
            out.append(ev)
        return out

    def last(self, kind: Optional[str] = None, **attrs) -> Optional[Event]:
        """Most recent matching event (None when none match)."""
        hits = self.find(kind, **attrs)
        return hits[-1] if hits else None

    def counts(self) -> Dict[str, int]:
        """Per-kind counts over the CURRENT window (the registry's
        ``fleetx_events_total`` keeps lifetime counts past eviction)."""
        out: Dict[str, int] = {}
        with self._lock:
            for ev in self._events:
                out[ev.kind] = out.get(ev.kind, 0) + 1
        return out

    def snapshot(self) -> List[Dict]:
        """JSON-safe list of the current window, oldest first."""
        with self._lock:
            return [ev.as_dict() for ev in self._events]

    def clear(self) -> None:
        """Empty the window (tests / chaos scenario isolation); the
        lifetime registry counter is left untouched."""
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


_EVENTS = EventLog()


def get_event_log() -> EventLog:
    """The process-global event log."""
    return _EVENTS


def emit(kind: str, **attrs) -> Event:
    """Emit onto the process-global log (see :class:`EventLog.emit`)."""
    return _EVENTS.emit(kind, **attrs)
