"""Shared cases of the port's router parity files.

Each scenario runs twice: the port's router over port engines, and the JAX
package's router over JAX engines, on the same bridged weights
(``torch_serving_cases.weights``: the tiny GPT at fp32, seed 6) with the
same engine switches. :class:`Pkg` gathers one package's names so a
scenario is written once; ``outcome`` reduces a run to what must be equal
across the packages: token lists, finish reasons, callback streams,
replica states, the router's counters, its event counts and the whole
event log, engines' events included (``event_log``).
"""

import contextlib
import importlib
from types import SimpleNamespace

import numpy as np

import fleetx_tpu.serving as jax_serving
import fleetx_tpu_torch.serving as port_serving
from fleetx_tpu.obs import get_event_log as jax_events
from fleetx_tpu_torch.obs import get_event_log as port_events
from fleetx_tpu_torch.resilience.faults import faults as port_faults
from torch_serving_cases import jax_engine, port_engine, weights

# the JAX package's injector: its faults module (the package __init__
# re-exports a name that shadows it)
jax_faults = importlib.import_module("fleetx_tpu.resilience.faults").faults

PROMPTS = [np.asarray([1, 2, 3], np.int32),
           np.asarray([4, 5, 6, 7, 8], np.int32),
           np.asarray([9, 10], np.int32),
           np.asarray([11, 12, 13], np.int32)]
ROUTER_ENGINE = dict(slots=2, cache_len=32)
COUNTERS = ("dispatched", "affinity_hits", "migrated", "replica_deaths",
            "probe_failures", "rejected", "shed", "preempted", "finished",
            "finish_reasons", "per_tenant")
EVENTS = ("replica_out", "replica_back", "replica_dead", "request_migrated",
          "router_stranded", "queue_reject", "request_timeout",
          "request_preempted", "request_handoff", "kv_ship_failed",
          "autoscale_up", "autoscale_down", "replica_added",
          "replica_removed")

_W = {}


def w():
    if "w" not in _W:
        _W["w"] = weights()
    return _W["w"]


class Pkg(SimpleNamespace):
    """One package's router, engines, injector and event log."""

    def engine(self, **kw):
        return self.make(w(), **dict(ROUTER_ENGINE, **kw))

    @contextlib.contextmanager
    def faulted(self, **plan):
        self.faults.configure(**plan)
        try:
            yield
        finally:
            self.faults.reset()


PORT = Pkg(name="port", s=port_serving, make=port_engine, faults=port_faults,
           events=port_events)
JAX = Pkg(name="jax", s=jax_serving, make=jax_engine, faults=jax_faults,
          events=jax_events)
BOTH = [PORT, JAX]


def clean(pkg):
    for p in BOTH:
        p.faults.reset()
        p.events().clear()


def recorder():
    """``(streams, cb)``: the callback transcript per request id."""
    streams = {}

    def cb(rid, tok, fin):
        streams.setdefault(rid, []).append(int(tok))

    return streams, cb


def outcome(pkg, router, res, rids, streams=None):
    """What must be equal across the packages."""
    snap = router.metrics.snapshot()
    ev = pkg.events()
    return {
        "tokens": [None if r not in res else [int(t) for t in res[r].tokens]
                   for r in rids],
        "reasons": [None if r not in res else res[r].finish_reason
                    for r in rids],
        "streams": (None if streams is None
                    else [streams.get(r, []) for r in rids]),
        "states": list(router.replica_states),
        "counters": {k: snap[k] for k in COUNTERS},
        "events": {k: len(ev.find(k)) for k in EVENTS},
        "log": event_log(pkg),
    }


def event_log(pkg):
    """The whole event log, oldest first, as ``(kind, attrs)`` pairs that
    compare across the packages: each engine or router label is replaced
    by its order of first appearance (the labels count engines and routers
    process-wide), and an ``error`` attribute keeps only the exception's
    type name."""
    labels = {"engine": {}, "router": {}}
    out = []
    for e in pkg.events().find():
        attrs = dict(e.attrs)
        for key, seen in labels.items():
            if key in attrs:
                attrs[key] = seen.setdefault(attrs[key], len(seen))
        if isinstance(attrs.get("error"), str):
            attrs["error"] = attrs["error"].split(":")[0]
        out.append((e.kind, attrs))
    return out


def both(scenario):
    """``scenario(pkg)`` for each package (faults and events cleared
    around each run): ``{"port": ..., "jax": ...}``."""
    out = {}
    for pkg in BOTH:
        clean(pkg)
        try:
            out[pkg.name] = scenario(pkg)
        finally:
            clean(pkg)
    return out


def assert_same(out):
    """The port's outcome equals JAX's, key by key (for a readable
    failure)."""
    port, jax = out["port"], out["jax"]
    assert port.keys() == jax.keys()
    for key in port:
        assert port[key] == jax[key], (key, port[key], jax[key])
