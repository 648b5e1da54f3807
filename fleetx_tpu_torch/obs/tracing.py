"""Host-side span tracing with a profiler bridge.

``with span("train.step"):`` records one nested host span into a
bounded ring buffer (``FLEETX_OBS_SPANS`` spans, oldest dropped) AND —
the bridge — enters a ``torch.profiler.record_function`` of the same
name, so when a profiling window is open (``Profiler.enable`` in the
Trainer) the host phases show up in the Chrome trace over the kernels
they launched: the train data/step/callback phases over the step's
kernels. Outside a profiling window ``record_function`` costs a few
microseconds, so spans stay on permanently.

The ring buffer is exported as Chrome-trace JSON
(:meth:`SpanRecorder.chrome_trace`, ``chrome://tracing`` / Perfetto
loadable) by ``tools/obs_dump.py`` or ``GET /trace`` on the exposition
server — the always-on, no-profiler view of where host time went.

Span taxonomy (docs/OBSERVABILITY.md): dotted snake_case names,
``<subsystem>.<phase>`` — ``serving.tick``, ``serving.admit``,
``serving.prefill``, ``serving.decode``, ``serving.rollback``,
``serving.recover``, ``train.data``, ``train.step``, ``train.callback``.
Nesting is tracked per thread; attrs ride into the Chrome trace as
``args``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional

from fleetx_tpu_torch.obs._util import env_int, json_safe as _json_safe

__all__ = ["Span", "SpanRecorder", "get_recorder", "span"]


@dataclasses.dataclass
class Span:
    """One completed host span (times from ``time.perf_counter``)."""

    name: str
    start_s: float
    end_s: float
    thread_id: int
    depth: int
    attrs: Dict

    @property
    def duration_s(self) -> float:
        """Wall-clock length of the span."""
        return self.end_s - self.start_s


class SpanRecorder:
    """Bounded ring buffer of completed spans + Chrome-trace export.

    Capacity 0 disables recording entirely (the TraceAnnotation bridge
    in :func:`span` still runs — profiler alignment costs nothing)."""

    def __init__(self, capacity: Optional[int] = None):
        cap = (env_int("FLEETX_OBS_SPANS", 4096, minimum=0)
               if capacity is None else capacity)
        self.capacity = max(cap, 0)
        self._lock = threading.Lock()
        self._spans: collections.deque = collections.deque(
            maxlen=self.capacity or 1)
        self._local = threading.local()
        self.dropped = 0  # spans pushed out of the ring (or cap-0 culled)

    def record(self, s: Span) -> None:
        """Append one completed span (oldest evicted at capacity)."""
        if self.capacity == 0:
            self.dropped += 1
            return
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(s)

    def spans(self) -> List[Span]:
        """Current ring contents, oldest first."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        """Empty the ring (tests / between benchmark passes)."""
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    # ---------------------------------------------------- nesting helpers
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    # -------------------------------------------------------------- export
    def chrome_trace(self) -> Dict:
        """Chrome-trace JSON dict (``traceEvents`` of complete ``X``
        events, microsecond timestamps) — load in chrome://tracing or
        Perfetto; ``tools/obs_dump.py`` writes it to disk."""
        pid = os.getpid()
        events = [{
            "ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": "fleetx_obs host spans"},
        }]
        for s in self.spans():
            events.append({
                "ph": "X",
                "pid": pid,
                "tid": s.thread_id,
                "name": s.name,
                "ts": s.start_s * 1e6,
                "dur": max(s.duration_s, 0.0) * 1e6,
                "args": {k: _json_safe(v) for k, v in s.attrs.items()},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


_RECORDER = SpanRecorder()
_XPROF = os.environ.get("FLEETX_OBS_XPROF", "1") == "1"


def get_recorder() -> SpanRecorder:
    """The process-global span recorder."""
    return _RECORDER


def _trace_annotation(name: str):
    """The profiler bridge: a ``torch.profiler.record_function`` context
    (None when torch is unavailable or ``FLEETX_OBS_XPROF=0``)."""
    if not _XPROF:
        return None
    try:
        import torch

        return torch.profiler.record_function(name)
    except Exception:  # noqa: BLE001 — tracing must never break the host
        return None


@contextlib.contextmanager
def span(name: str, recorder: Optional[SpanRecorder] = None, **attrs):
    """Record one nested host span named ``name`` (module docstring);
    ``attrs`` become Chrome-trace args. Re-entrant and thread-safe;
    exceptions propagate (the span still closes and records)."""
    rec = recorder or _RECORDER
    stack = rec._stack()
    ann = _trace_annotation(name)
    if ann is not None:
        ann.__enter__()
    start = time.perf_counter()
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()
        end = time.perf_counter()
        if ann is not None:
            ann.__exit__(None, None, None)
        rec.record(Span(
            name=name, start_s=start, end_s=end,
            thread_id=threading.get_ident(), depth=len(stack), attrs=attrs,
        ))
