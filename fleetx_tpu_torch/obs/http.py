"""Stdlib-only HTTP exposition server for the observability layer.

A daemon-thread ``ThreadingHTTPServer`` (no third-party deps) serving
the endpoint contract docs/OBSERVABILITY.md pins down:

- ``GET /metrics``  — Prometheus text exposition of the registry.
- ``GET /snapshot`` — JSON: registry snapshot + event log window +
  health status + span-ring stats (full spans via ``/trace``).
- ``GET /trace``    — Chrome-trace JSON of the host span ring buffer
  (load in chrome://tracing / Perfetto).
- ``GET /healthz``  — 200 while every registered health probe passes,
  503 otherwise, with a small JSON body carrying the rotate-out REASON,
  not just the code: ``state`` (``ok`` / ``draining`` / ``dead``, the
  worst across probes), ``role`` (the serving phase a disaggregated
  router keys placement on), ``queue_depth``, ``queue_tokens`` and
  ``active`` (summed over
  probes that report them), plus per-probe booleans, the failing names,
  and each probe's full report under ``detail``. Probes may return a
  plain bool (healthy yes/no) or a dict with a ``state`` key — the
  serving engine returns its drain-aware ``ServingEngine.health()``
  dict, so ``request_shutdown()`` (SIGTERM) flips a replica to 503
  ``state: "draining"`` *while it drains* and ``RecoveryExhausted`` to
  ``state: "dead"`` — exactly the rotate-me-out signal the
  multi-replica serving router load-balances on (docs/SERVING.md
  "Multi-replica router").

Enable by setting ``FLEETX_OBS_PORT`` (``maybe_start_from_env`` is
called by the Trainer and ServingEngine constructors, so any training
or serving process becomes scrapeable with one env var; port 0 binds an
ephemeral port — useful in tests). Binds ``FLEETX_OBS_HOST`` (default
127.0.0.1: metrics can leak prompts/config — exposing beyond localhost
is an explicit operator choice). All handlers are read-only: nothing an
external scraper does can perturb the data path.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, Optional, Tuple

from fleetx_tpu_torch.obs.events import get_event_log
from fleetx_tpu_torch.obs.httpd import HttpDaemon, JsonHandler
from fleetx_tpu_torch.obs.registry import get_registry
from fleetx_tpu_torch.obs.tracing import get_recorder

__all__ = [
    "ObsServer",
    "get_server",
    "health_report",
    "health_status",
    "healthz_payload",
    "maybe_start_from_env",
    "register_health",
    "snapshot_payload",
    "unregister_health",
]

_health_lock = threading.Lock()
_health_probes: Dict[str, Callable[[], bool]] = {}


def register_health(name: str, probe: Callable[[], object]) -> None:
    """Register a named liveness probe for ``/healthz``. ``probe()``
    returns either a bool (True = healthy) or a report dict with a
    ``state`` key (``"ok"`` = healthy; ``"draining"``/``"dead"`` are the
    standard unhealthy states, extra keys like ``queue_depth``/``active``
    ride into the healthz body); a raising probe counts as failing. Re-
    registering a name replaces it (callers pair with
    ``weakref.finalize`` to unregister at owner teardown)."""
    with _health_lock:
        _health_probes[name] = probe


def unregister_health(name: str) -> None:
    """Remove a probe (no-op when absent)."""
    with _health_lock:
        _health_probes.pop(name, None)


def health_report() -> Tuple[bool, Dict[str, bool], Dict[str, Dict]]:
    """(all healthy, {probe: healthy}, {probe: report dict}) over the
    registered probes. Bool-returning probes get a synthesized report
    (``state`` ``"ok"``/``"dead"`` — a bare bool carries no drain
    nuance); dict-returning probes are healthy iff ``state == "ok"`` and
    their report passes through verbatim. A raising probe is unhealthy
    with the error in its report. No probes registered = healthy (a bare
    process serves 200)."""
    with _health_lock:
        probes = dict(_health_probes)
    results, details = {}, {}
    for name, probe in probes.items():
        try:
            out = probe()
        except Exception as e:  # noqa: BLE001 — a broken probe is unhealthy
            results[name] = False
            details[name] = {"state": "dead",
                             "error": f"{type(e).__name__}: {e}"}
            continue
        if isinstance(out, dict):
            healthy = out.get("state") == "ok"
            results[name] = healthy
            if out.get("state") not in ("ok", "draining", "dead"):
                # normalize reports without a recognized state so the
                # body's aggregate can never contradict the status code
                # (an unhealthy stateless report must aggregate as dead,
                # not default to ok)
                out = {**out, "state": "ok" if healthy else "dead"}
            details[name] = out
        else:
            results[name] = bool(out)
            details[name] = {"state": "ok" if out else "dead"}
    return all(results.values()), results, details


def health_status() -> Tuple[bool, Dict[str, bool]]:
    """(all healthy, {probe name: healthy}) — the boolean view of
    :func:`health_report` (kept for callers that only gate on 200/503)."""
    ok, results, _ = health_report()
    return ok, results


def healthz_payload() -> Tuple[bool, Dict]:
    """(healthy, the ``/healthz`` JSON body). The body leads with the
    aggregate rotate-out reason — ``state`` is the WORST across probes
    (``dead`` > ``draining`` > ``ok``) — and sums ``queue_depth``/
    ``active`` over the probes that report them, so a single-engine
    replica's body reads directly as that engine's health dict."""
    ok, results, details = health_report()
    states = [d.get("state", "ok") for d in details.values()]
    state = ("dead" if "dead" in states
             else "draining" if "draining" in states else "ok")
    # phase role (docs/SERVING.md "Disaggregated prefill/decode"): a
    # single-engine replica's probe carries it; a phase-aware router
    # scraping this body keys prefill placement on it + queue_tokens
    roles = {d["role"] for d in details.values() if "role" in d}
    role = roles.pop() if len(roles) == 1 else "both"

    def total(key):
        # probe reports are caller-supplied: a malformed load field must
        # degrade to 0, never crash the handler (the contract is that a
        # broken probe reads as unhealthy, not as a dead endpoint)
        n = 0
        for d in details.values():
            try:
                n += int(d.get(key, 0))
            except (TypeError, ValueError):
                pass
        return n

    body = {
        "status": "ok" if ok else "unhealthy",
        "state": state,
        "role": role,
        "queue_depth": total("queue_depth"),
        "queue_tokens": total("queue_tokens"),
        "active": total("active"),
        "probes": results,
        "failing": sorted(n for n, v in results.items() if not v),
        "detail": details,
    }
    return ok, body


def snapshot_payload() -> Dict:
    """THE ``/snapshot`` payload (one definition — the HTTP handler and
    ``tools/obs_dump.py``'s in-process dump both serve exactly this, so
    the two surfaces cannot drift)."""
    ok, body = healthz_payload()
    rec = get_recorder()
    return {
        "metrics": get_registry().snapshot(),
        "events": get_event_log().snapshot(),
        "health": {"ok": ok, "state": body["state"],
                   "probes": body["probes"], "detail": body["detail"]},
        "spans": {"recorded": len(rec.spans()),
                  "dropped": rec.dropped,
                  "capacity": rec.capacity},
    }


class _Handler(JsonHandler):
    """Request handler over the module-global registry/events/spans
    (``_send``/``_send_json``/silent logging come from the shared
    :class:`~fleetx_tpu_torch.obs.httpd.JsonHandler` base)."""

    server_version = "fleetx-obs/1"

    def do_GET(self) -> None:  # noqa: N802 — http.server contract
        """Route the four read-only endpoints (404 otherwise)."""
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/metrics":
            self._send(200, get_registry().prometheus_text().encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            ok, body = healthz_payload()
            self._send_json(200 if ok else 503, body)
        elif path == "/snapshot":
            self._send_json(200, snapshot_payload())
        elif path == "/trace":
            self._send_json(200, get_recorder().chrome_trace())
        else:
            self._send_json(404, {"error": f"unknown path {self.path!r}",
                                  "endpoints": ["/metrics", "/snapshot",
                                                "/trace", "/healthz"]})


class ObsServer(HttpDaemon):
    """The exposition server: daemon thread, started once, stoppable
    (the shared :class:`~fleetx_tpu_torch.obs.httpd.HttpDaemon` plumbing under
    the obs routes)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        super().__init__(_Handler, port=port, host=host,
                         thread_name="fleetx-obs-http")


_server_lock = threading.Lock()
_server: Optional[ObsServer] = None
_server_failed = False


def get_server() -> Optional[ObsServer]:
    """The running env-gated server, if any."""
    return _server


def maybe_start_from_env() -> Optional[ObsServer]:
    """Start the process-global server when ``FLEETX_OBS_PORT`` is set
    (unset/empty = off; ``0`` = ephemeral port). Idempotent and cheap —
    the Trainer and ServingEngine constructors call it — and a bind
    failure (port taken by a sibling replica) logs and disables rather
    than killing the workload."""
    global _server, _server_failed
    raw = os.environ.get("FLEETX_OBS_PORT", "")
    if raw == "":
        return None
    with _server_lock:
        if _server is not None:
            return _server
        if _server_failed:
            return None  # already failed + logged once; don't retry/re-log
        try:
            port = int(raw)
            _server = ObsServer(
                port=port, host=os.environ.get("FLEETX_OBS_HOST",
                                               "127.0.0.1")).start()
        except Exception as e:  # noqa: BLE001 — obs must never kill the job
            from fleetx_tpu_torch.utils.log import logger

            _server_failed = True
            logger.error("obs: FLEETX_OBS_PORT=%s server failed to start "
                         "(%s: %s); exposition disabled for this process",
                         raw, type(e).__name__, e)
            return None
        from fleetx_tpu_torch.utils.log import logger

        logger.info("obs: exposition server listening on %s "
                    "(/metrics /snapshot /trace /healthz)", _server.url)
        return _server
