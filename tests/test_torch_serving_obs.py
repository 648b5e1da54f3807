"""The port's serving exposition against the JAX package's.

One traffic run goes through both packages' engines on the same weights;
the Prometheus text each package's ``/metrics`` serves must hold the same
``fleetx_serving_*`` families for the engine, with the same types and
label keys, equal counters and equal histogram counts (times are not
compared). ``/healthz`` flips to 503 with the same JSON keys after
``request_shutdown`` (``tests/test_obs.py``
``test_live_engine_exposes_prometheus_and_flips_healthz``), a
``ServingMetrics`` that dies drops its series, and ``log_every`` writes the
snapshot line every that many ticks.
"""

import gc
import json
import urllib.error
import urllib.request

import pytest

from fleetx_tpu.obs.http import ObsServer as JaxObsServer
from fleetx_tpu_torch.obs.http import ObsServer
from fleetx_tpu_torch.obs.registry import MetricsRegistry
from fleetx_tpu_torch.serving.metrics import ServingMetrics
from torch_serving_cases import (
    jax_engine,
    port_engine,
    prompts,
    serve,
    tokens,
    weights,
)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def _labels(text: str) -> dict:
    if not text:
        return {}
    out = {}
    for pair in text.split(","):
        k, v = pair.split("=", 1)
        out[k] = v.strip('"')
    return out


def serving_series(text: str, engine: str):
    """``({family: type}, {(name, labels without engine): value})`` of the
    ``fleetx_serving_*`` series of ``engine`` in a Prometheus text."""
    types, values = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE fleetx_serving_"):
            _, _, name, kind = line.split()
            types[name] = kind
        elif line.startswith("fleetx_serving_"):
            head, value = line.rsplit(" ", 1)
            name, _, rest = head.partition("{")
            labels = _labels(rest.rstrip("}"))
            if labels.pop("engine", None) != engine:
                continue
            values[(name, tuple(sorted(labels.items())))] = float(value)
    families = {n for n, _ in values}
    types = {n: k for n, k in types.items()
             if n in families or f"{n}_count" in families}
    return types, values


@pytest.fixture(scope="module")
def runs():
    """The same requests through JAX's engine and the port's, each
    scraped over its package's ``/metrics``."""
    w = weights()
    jax_eng, port_eng = jax_engine(w), port_engine(w)
    want = serve(jax_eng, prompts())
    got = serve(port_eng, prompts())
    out = {}
    for key, eng, server in (("jax", jax_eng, JaxObsServer),
                             ("port", port_eng, ObsServer)):
        srv = server(port=0).start()
        try:
            _, body = _get(srv.url + "/metrics")
        finally:
            srv.stop()
        out[key] = serving_series(body.decode(), eng.metrics.engine_label)
    return tokens(want), tokens(got), out, port_eng


def test_metrics_families_types_and_counters_match_jax(runs):
    want, got, out, _ = runs
    assert got == want
    (jt, jv), (pt, pv) = out["jax"], out["port"]
    assert pt == jt  # every family, with its Prometheus type
    assert ({(n, tuple(k for k, _ in lab)) for n, lab in pv}
            == {(n, tuple(k for k, _ in lab)) for n, lab in jv})
    compared = 0
    for key, value in jv.items():
        name = key[0]
        if jt.get(name) == "counter" or (
                name.endswith("_count") and jt.get(name[:-6]) == "summary"):
            assert pv[key] == value, key
            compared += 1
    assert compared > 20
    assert pv[("fleetx_serving_tokens_total", ())] == sum(map(len, got))


def test_metrics_counters_equal_the_snapshot(runs):
    _, _, out, eng = runs
    snap = eng.metrics.snapshot()
    values = out["port"][1]
    for key, name in (("submitted", "fleetx_serving_submitted_total"),
                      ("admitted", "fleetx_serving_admitted_total"),
                      ("tokens_generated", "fleetx_serving_tokens_total"),
                      ("ticks", "fleetx_serving_ticks_total"),
                      ("prefix_queries",
                       "fleetx_serving_prefix_queries_total")):
        assert values[(name, ())] == snap[key], key
    reasons = {dict(lab)["reason"]: v for (n, lab), v in values.items()
               if n == "fleetx_serving_retired_total"}
    assert reasons == snap["finish_reasons"]


def test_healthz_flips_to_503_with_jax_keys_after_shutdown():
    """Both packages' ``/healthz`` read 200, then 503 with ``state``
    ``"draining"`` after ``request_shutdown``, with the same JSON keys
    (top level and the engine's probe report)."""
    gc.collect()  # a shut-down engine of an earlier test leaves its probe
    w = weights()
    bodies = {}
    for key, eng, server in (("jax", jax_engine(w), JaxObsServer),
                             ("port", port_engine(w), ObsServer)):
        serve(eng, prompts()[:1], max_length=3)
        srv = server(port=0).start()
        try:
            status, _ = _get(srv.url + "/healthz")
            assert status == 200, key
            eng.request_shutdown(grace_s=0.0)
            with pytest.raises(urllib.error.HTTPError) as exc:
                _get(srv.url + "/healthz")
            assert exc.value.code == 503, key
            body = json.loads(exc.value.read())
            eng.shutdown(grace_s=0.0)
        finally:
            srv.stop()
        probe = f"serving_engine_{eng.metrics.engine_label}"
        bodies[key] = (set(body), set(body["detail"][probe]),
                       body["state"])
        del eng
        gc.collect()
    assert bodies["port"] == bodies["jax"]
    assert bodies["port"][2] == "draining"


def test_series_dropped_on_garbage_collection():
    """JAX ``test_serving_metrics_series_removed_on_gc``: a dead instance
    leaves no series in its registry."""
    reg = MetricsRegistry()
    m = ServingMetrics(slots=2, registry=reg)
    m.record_submit()
    m.record_retire(0.01, "eos")
    m.observe_tick(1, 1, 0.001)
    m.set_quant_config("bf16", "int8", 10, 20, 30)
    assert any(fam.series() for fam in reg.families())
    del m
    gc.collect()
    assert not [(fam.name, labels) for fam in reg.families()
                for labels, _ in fam.series()]


@pytest.mark.parametrize("how", ["keyword", "env"])
def test_log_every_writes_the_snapshot_line(how, monkeypatch):
    """``log_every=N`` (or ``FLEETX_SERVING_LOG_EVERY``) writes
    ``metrics.log_snapshot()`` on every N-th tick, as JAX's ``step`` does."""
    kw = {}
    if how == "env":
        monkeypatch.setenv("FLEETX_SERVING_LOG_EVERY", "3")
    else:
        kw["log_every"] = 3
    eng = port_engine(weights(), **kw)
    lines = []
    log = eng.metrics.log_snapshot
    eng.metrics.log_snapshot = lambda: (lines.append(eng._ticks), log())
    serve(eng, prompts())
    ticks = eng.metrics.snapshot()["ticks"]
    assert ticks >= 6 and lines == list(range(3, ticks + 1, 3))
    assert eng.log_every == 3
