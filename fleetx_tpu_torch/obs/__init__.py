"""Unified observability layer: metrics registry, span tracing,
structured events, HTTP exposition.

Copy of the JAX package's ``obs/`` (stdlib only; that package's
``__init__`` imports jax, so the port cannot import it). The metric
names, labels, the Prometheus text format and the endpoint contract are
the same; the span bridge enters ``torch.profiler.record_function``.

The substrate every subsystem reports through (docs/OBSERVABILITY.md):

- :mod:`fleetx_tpu_torch.obs.registry` — process-wide Counter/Gauge/Histogram
  families with labels and bounded percentile reservoirs; Prometheus
  text + JSON snapshot expositions.
- :mod:`fleetx_tpu_torch.obs.tracing` — nested host spans in a ring buffer,
  Chrome-trace export, and a ``torch.profiler.record_function`` bridge
  so host phases line up with the kernels inside profiler traces.
- :mod:`fleetx_tpu_torch.obs.events` — bounded log of typed operational
  events (sentry skips, quarantines, recoveries, shutdowns), asserted
  on by the chaos suite.
- :mod:`fleetx_tpu_torch.obs.http` — stdlib daemon-thread server: ``GET
  /metrics`` ``/snapshot`` ``/trace`` ``/healthz`` (drain-aware),
  enabled by ``FLEETX_OBS_PORT``.

Everything here is host-side and read-only with respect to the data
path: the serving byte-parity suites run with instrumentation enabled.

    from fleetx_tpu_torch.obs import emit, get_registry, span

    ticks = get_registry().counter(TICKS_METRIC)  # a "fleetx_*" literal —
    with span("serving.tick"):                    # snake_case, fleetx_
        ticks.inc()                               # prefix, and a row in
    emit("engine_recovery", number=1)             # docs/OBSERVABILITY.md
                                                  # (lint-enforced)
"""

from fleetx_tpu_torch.obs.events import Event, EventLog, emit, get_event_log
from fleetx_tpu_torch.obs.http import (
    ObsServer,
    get_server,
    health_report,
    health_status,
    healthz_payload,
    maybe_start_from_env,
    register_health,
    unregister_health,
)
from fleetx_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from fleetx_tpu_torch.obs.tracing import Span, SpanRecorder, get_recorder, span

__all__ = [
    "Counter",
    "Event",
    "EventLog",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ObsServer",
    "Span",
    "SpanRecorder",
    "emit",
    "get_event_log",
    "get_recorder",
    "get_registry",
    "get_server",
    "health_report",
    "health_status",
    "healthz_payload",
    "maybe_start_from_env",
    "register_health",
    "span",
    "unregister_health",
]
