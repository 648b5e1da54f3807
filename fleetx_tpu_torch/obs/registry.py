"""Process-wide metrics registry: Counter / Gauge / Histogram families.

The one place every subsystem publishes numbers through (docs/
OBSERVABILITY.md): ``ServingMetrics`` rides it for queue/TTFT/tick
stats, the Trainer for step-time/tokens-per-s/MFU, the event log for
per-kind event counts. Design constraints, in order:

- **read-only on the data path**: instruments are plain host-side
  counters guarded by one registry lock — no device work, no torch import,
  nothing an instrumented tick could perturb (the serving byte-parity
  suites run with instrumentation on).
- **bounded memory forever**: histograms keep ``count/sum/min/max``
  exactly and a ``deque(maxlen=FLEETX_OBS_RESERVOIR)`` reservoir for
  percentiles, so a replica that retires ten million requests holds the
  same few KiB a fresh one does.
- **two read surfaces**: :meth:`MetricsRegistry.prometheus_text` (the
  ``GET /metrics`` wire format — histograms expose as summaries with
  reservoir quantiles) and :meth:`MetricsRegistry.snapshot` (JSON-safe
  dict, embedded in bench records and ``GET /snapshot``).

Metric names must be snake_case; the port registers the JAX package's
names (``fleetx_`` prefix, a row in the docs/OBSERVABILITY.md metric
table). One process-global default registry (:func:`get_registry`)
serves the common case; tests build private ones.
"""

from __future__ import annotations

import collections
import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Tuple

from fleetx_tpu_torch.obs._util import env_int

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
]

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")


def _reservoir_cap() -> int:
    """Default histogram reservoir size (``FLEETX_OBS_RESERVOIR``)."""
    return env_int("FLEETX_OBS_RESERVOIR", 4096, minimum=1)


class Counter:
    """Monotonic counter child (one label combination of a family)."""

    kind = "counter"

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (must be >= 0) to the counter."""
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        """Current count."""
        return self._value


class Gauge:
    """Set-to-current-value gauge child."""

    kind = "gauge"

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        """Set the gauge to ``v``."""
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (may be negative) to the gauge."""
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        """Current value."""
        return self._value


class Histogram:
    """Distribution child: exact count/sum/min/max + bounded reservoir.

    ``count``/``sum`` (and hence ``mean``) are exact over every
    observation ever made; percentiles come from the newest
    ``reservoir_cap`` samples — the recent-behavior window percentiles
    are meant to describe on a long-lived replica."""

    kind = "histogram"

    def __init__(self, lock: threading.RLock, reservoir_cap: int):
        self._lock = lock
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.reservoir: collections.deque = collections.deque(
            maxlen=reservoir_cap)

    def observe(self, v: float) -> None:
        """Record one sample."""
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self.reservoir.append(v)

    @property
    def mean(self) -> Optional[float]:
        """Exact mean over all observations (None when empty)."""
        return self.sum / self.count if self.count else None

    def quantiles(self, qs) -> List[Optional[float]]:
        """Reservoir percentiles for every ``q`` in [0, 100] of ``qs``
        from ONE snapshot + sort (the lock is held only for the O(n)
        copy — a scrape computing p50/p95/p99 never blocks the data
        path's ``observe()`` calls behind a sort). Linear interpolation
        between closest ranks, matching ``numpy.percentile``'s
        default; all-None when empty."""
        with self._lock:
            data = list(self.reservoir)
        if not data:
            return [None] * len(qs)
        data.sort()
        out = []
        for q in qs:
            if len(data) == 1:
                out.append(data[0])
                continue
            rank = (len(data) - 1) * (q / 100.0)
            lo = int(math.floor(rank))
            hi = min(lo + 1, len(data) - 1)
            frac = rank - lo
            out.append(data[lo] * (1.0 - frac) + data[hi] * frac)
        return out

    def percentile(self, q: float) -> Optional[float]:
        """Single reservoir percentile (see :meth:`quantiles`)."""
        return self.quantiles((q,))[0]


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One named metric + its per-label-combination children.

    With no labelnames the family has exactly one anonymous child and
    the instrument methods (``inc``/``set``/``observe``...) delegate to
    it, so unlabeled metrics read like plain instruments."""

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 kind: str, labelnames: Tuple[str, ...],
                 reservoir_cap: Optional[int]):
        self._registry = registry
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = labelnames
        self._reservoir_cap = reservoir_cap
        self._children: Dict[Tuple[str, ...], object] = {}

    def _make_child(self):
        if self.kind == "histogram":
            cap = self._reservoir_cap or _reservoir_cap()
            return Histogram(self._registry._lock, cap)
        return _KINDS[self.kind](self._registry._lock)

    def labels(self, **labelvalues: str):
        """Child for one label combination (created on first use)."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._registry._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def remove(self, **labelvalues: str) -> None:
        """Drop one label combination's child (no-op when absent) —
        owners of per-instance series (e.g. ``ServingMetrics``'
        ``engine="<n>"`` children) remove them at teardown so a process
        that cycles engines doesn't accumulate dead series forever."""
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._registry._lock:
            self._children.pop(key, None)

    def _solo(self):
        if self.labelnames:
            raise ValueError(
                f"metric {self.name!r} is labeled {self.labelnames}; "
                "call .labels(...) first")
        return self.labels()

    # unlabeled-family conveniences — each validates the family is
    # actually unlabeled and the kind supports the verb
    def inc(self, n: float = 1.0) -> None:
        """Unlabeled counter/gauge increment."""
        self._solo().inc(n)

    def set(self, v: float) -> None:
        """Unlabeled gauge set."""
        self._solo().set(v)

    def observe(self, v: float) -> None:
        """Unlabeled histogram observation."""
        self._solo().observe(v)

    @property
    def value(self) -> float:
        """Unlabeled counter/gauge value."""
        return self._solo().value

    def series(self) -> List[Tuple[Dict[str, str], object]]:
        """(labels dict, child) pairs, stable insertion order."""
        with self._registry._lock:
            items = list(self._children.items())
        return [(dict(zip(self.labelnames, key)), child)
                for key, child in items]


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: Dict[str, str], extra: Iterable[Tuple[str, str]] = ()
                ) -> str:
    pairs = [f'{k}="{_escape_label(str(v))}"' for k, v in labels.items()]
    pairs += [f'{k}="{_escape_label(str(v))}"' for k, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_value(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if not math.isfinite(v):  # int(inf) raises; Prometheus spells it +Inf
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    """Named metric families + the two exposition surfaces."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}

    def _register(self, name: str, help: str, kind: str,
                  labelnames: Tuple[str, ...],
                  reservoir_cap: Optional[int] = None) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} must be snake_case "
                "([a-z][a-z0-9_]*)")
        for ln in labelnames:
            if not _NAME_RE.match(ln):
                raise ValueError(f"label name {ln!r} must be snake_case")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind} "
                        f"with labels {fam.labelnames}; cannot re-register "
                        f"as {kind} with labels {tuple(labelnames)}")
                return fam
            fam = _Family(self, name, help, kind, tuple(labelnames),
                          reservoir_cap)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Tuple[str, ...] = ()) -> _Family:
        """Register (or fetch) a counter family."""
        return self._register(name, help, "counter", tuple(labelnames))

    def gauge(self, name: str, help: str = "",
              labelnames: Tuple[str, ...] = ()) -> _Family:
        """Register (or fetch) a gauge family."""
        return self._register(name, help, "gauge", tuple(labelnames))

    def histogram(self, name: str, help: str = "",
                  labelnames: Tuple[str, ...] = (),
                  reservoir_cap: Optional[int] = None) -> _Family:
        """Register (or fetch) a histogram family (bounded reservoir;
        cap defaults to ``FLEETX_OBS_RESERVOIR``)."""
        return self._register(name, help, "histogram", tuple(labelnames),
                              reservoir_cap)

    def families(self) -> List[_Family]:
        """All registered families, registration order."""
        with self._lock:
            return list(self._families.values())

    def clear(self) -> None:
        """Drop every family (tests only — live instruments held by
        producers keep working but stop being exposed)."""
        with self._lock:
            self._families.clear()

    # -------------------------------------------------------- expositions
    def prometheus_text(self) -> str:
        """Prometheus text exposition (format 0.0.4). Histograms expose
        as summaries: reservoir quantiles + exact ``_sum``/``_count``."""
        out = []
        for fam in self.families():
            series = fam.series()
            if not series:
                continue
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            ptype = "summary" if fam.kind == "histogram" else fam.kind
            out.append(f"# TYPE {fam.name} {ptype}")
            for labels, child in series:
                if fam.kind == "histogram":
                    vals = child.quantiles((50, 95, 99))  # one sort
                    for q, v in zip((0.5, 0.95, 0.99), vals):
                        if v is None:
                            continue
                        out.append(
                            f"{fam.name}"
                            f"{_fmt_labels(labels, [('quantile', q)])} "
                            f"{_fmt_value(v)}")
                    out.append(f"{fam.name}_sum{_fmt_labels(labels)} "
                               f"{_fmt_value(child.sum)}")
                    out.append(f"{fam.name}_count{_fmt_labels(labels)} "
                               f"{_fmt_value(child.count)}")
                else:
                    out.append(f"{fam.name}{_fmt_labels(labels)} "
                               f"{_fmt_value(child.value)}")
        return "\n".join(out) + "\n" if out else ""

    def snapshot(self) -> Dict:
        """JSON-safe dict view: ``{name: {type, help, series: [...]}}``.
        Histogram series carry exact count/sum/mean/min/max plus
        reservoir p50/p95/p99."""
        out = {}
        for fam in self.families():
            series = []
            for labels, child in fam.series():
                entry: Dict = {"labels": labels}
                if fam.kind == "histogram":
                    p50, p95, p99 = child.quantiles((50, 95, 99))
                    entry.update(
                        count=child.count, sum=child.sum, mean=child.mean,
                        min=child.min, max=child.max,
                        p50=p50, p95=p95, p99=p99,
                    )
                else:
                    entry["value"] = child.value
                series.append(entry)
            if series:
                out[fam.name] = {"type": fam.kind, "help": fam.help,
                                 "series": series}
        return out


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global default registry."""
    return _REGISTRY
