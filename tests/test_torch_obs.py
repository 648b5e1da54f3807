"""The port's observability (``fleetx_tpu_torch/obs/``), the Trainer's
training families and events, and the profiler with its summary views
(``utils/profiler_summary.py``), against the JAX package's.

- The registry: the same operations on the port's and on JAX's
  ``MetricsRegistry`` give equal ``prometheus_text()`` and
  ``snapshot()``.
- The kernel view: on the synthetic traces of ``test_profiler_summary.py``
  the port's view logs JAX's lines (the same ranking, self times, calls
  and shares).
- A tiny CPU ``Trainer`` over 5 batches with the third poisoned (one
  sentry skip) and ``FLEETX_OBS_PORT=0``: the registry's counters moved by
  the attributes' counts, the events were emitted, ``/metrics`` served
  them; with ``Profiler.enable`` and ``scheduler: [1, 3]`` the trace file
  exists and the summary views were logged from it.
"""

import gzip
import json
import logging
import os
import urllib.request

import pytest

from fleetx_tpu.obs.registry import MetricsRegistry as JaxRegistry
from fleetx_tpu.utils import profiler_summary as jax_summary
from fleetx_tpu.utils.log import logger as jax_logger
from fleetx_tpu_torch.obs import get_event_log, get_registry
from fleetx_tpu_torch.obs import http as obs_http
from fleetx_tpu_torch.obs.registry import MetricsRegistry
from fleetx_tpu_torch.resilience.faults import faults
from fleetx_tpu_torch.utils import profiler_summary
from fleetx_tpu_torch.utils.log import logger
from test_profiler_summary import _meta, _write_trace
from test_torch_checkpoint import clean_process_state  # noqa: F401
from test_torch_checkpoint import fit, tiny_cfg


def _drive(reg):
    c = reg.counter("fleetx_demo_total", "A counter", labelnames=("kind",))
    c.labels(kind="a").inc()
    c.labels(kind="b").inc(2.5)
    g = reg.gauge("fleetx_demo_gauge", "A gauge")
    g.set(3.25)
    g.inc(-1)
    h = reg.histogram("fleetx_demo_seconds", "A histogram",
                      labelnames=("phase",))
    for i, v in enumerate((0.5, 0.125, 2.0, 1e-3, 7.0)):
        h.labels(phase="x" if i % 2 else "y").observe(v)
    reg.counter("fleetx_demo_plain_total", "Plain").inc()
    return reg


def test_registry_expositions_equal_jax():
    port, jax_reg = _drive(MetricsRegistry()), _drive(JaxRegistry())
    assert port.prometheus_text() == jax_reg.prometheus_text()
    assert port.snapshot() == jax_reg.snapshot()


TRACES = {
    "wrapper-and-host": [
        _meta(3, pname="/device:TPU:0"), _meta(701, pname="/host:CPU"),
        _meta(3, tid=1, tname="XLA Modules"), _meta(3, tid=2, tname="XLA Ops"),
        _meta(701, tid=9, tname="python"),
        {"ph": "X", "pid": 3, "tid": 1, "name": "jit_step", "ts": 0,
         "dur": 1000},
        {"ph": "X", "pid": 3, "tid": 2, "name": "matmul", "ts": 0, "dur": 150},
        {"ph": "X", "pid": 3, "tid": 2, "name": "attn", "ts": 150, "dur": 500},
        {"ph": "X", "pid": 3, "tid": 2, "name": "matmul", "ts": 650,
         "dur": 150},
        {"ph": "X", "pid": 701, "tid": 9, "name": "host_stuff", "ts": 0,
         "dur": 10**6}],
    "nested": [
        _meta(3, pname="/device:TPU:0"), _meta(3, tid=2, tname="XLA Ops"),
        {"ph": "X", "pid": 3, "tid": 2, "name": "outer", "ts": 0, "dur": 100},
        {"ph": "X", "pid": 3, "tid": 2, "name": "inner", "ts": 10,
         "dur": 80}],
    "ranked": [
        _meta(3, pname="/device:TPU:0"), _meta(3, tid=2, tname="XLA Ops")] + [
        {"ph": "X", "pid": 3, "tid": 2, "name": n, "ts": t, "dur": d}
        for n, t, d in (("big", 0, 600), ("mid", 600, 100), ("mid", 700, 100),
                        ("small", 800, 50), ("mid", 850, 100),
                        ("small", 950, 50))],
    "no-op-line": [
        _meta(5, pname="/device:GPU:0"), _meta(5, tid=1, tname="Steps"),
        _meta(5, tid=4, tname="stream 7"),
        {"ph": "X", "pid": 5, "tid": 1, "name": "step", "ts": 0, "dur": 900},
        {"ph": "X", "pid": 5, "tid": 4, "name": "gemm", "ts": 0, "dur": 300},
        {"ph": "X", "pid": 5, "tid": 4, "name": "flash", "ts": 300,
         "dur": 400}],
}


@pytest.fixture
def propagate():
    logger.propagate = jax_logger.propagate = True
    yield
    logger.propagate = jax_logger.propagate = False


@pytest.mark.parametrize("name", sorted(TRACES))
def test_kernel_view_ranks_the_ops_jax_ranks(tmp_path, caplog, propagate,
                                             name):
    log_dir = _write_trace(tmp_path, TRACES[name])
    with caplog.at_level(logging.INFO, logger="fleetx_tpu"):
        jax_summary._kernel(log_dir, top_k=3)
    want = [r.getMessage() for r in caplog.records]
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="fleetx_tpu_torch"):
        profiler_summary._kernel(log_dir, top_k=3)
    got = [r.getMessage() for r in caplog.records]
    assert got == want and len(want) > 2


def _value(text, name, default=None):
    for line in text.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{"):
            return float(line.rsplit(" ", 1)[1])
    if default is None:
        raise KeyError(name)
    return default


def test_trainer_families_events_profiler_and_exposition(
        tmp_path, monkeypatch, caplog, propagate):
    monkeypatch.setenv("FLEETX_OBS_PORT", "0")
    reg = get_registry()

    def counters():
        text = reg.prometheus_text()
        # 0 before the first trainer of the process registers them
        return {n: _value(text, n, 0.0) for n in (
            "fleetx_train_steps_total", "fleetx_train_sentry_skips_total",
            "fleetx_train_save_failures_total")}

    before = counters()
    skips = len(get_event_log().find("sentry_skip"))
    prof_dir = tmp_path / "prof"
    cfg = tiny_cfg(tmp_path, "out", "Engine.max_steps=4",
                   "Engine.save_load.save_steps=0", "Profiler.enable=True",
                   "Profiler.scheduler=[1,3]",
                   f"Profiler.profiler_log={prof_dir}")
    faults.configure(nan_batch="2")
    with caplog.at_level(logging.INFO, logger="fleetx_tpu_torch"):
        trainer = fit(cfg)
    after = counters()
    assert trainer.step == 4 and trainer.sentry_skips == 1
    assert after["fleetx_train_steps_total"] - \
        before["fleetx_train_steps_total"] == trainer.step
    assert after["fleetx_train_sentry_skips_total"] - \
        before["fleetx_train_sentry_skips_total"] == trainer.sentry_skips
    assert after["fleetx_train_save_failures_total"] == \
        before["fleetx_train_save_failures_total"] + trainer.save_failures
    assert len(get_event_log().find("sentry_skip")) == skips + 1
    # the window: opened after step 1, closed after step 3
    path = trainer.profiler_trace
    assert os.path.isfile(path) and path.startswith(str(prof_dir))
    with gzip.open(path, "rt") as f:
        assert json.load(f)["traceEvents"]
    text = caplog.text
    for view in ("profiler overview", "model view", "kernel view",
                 "memory view"):
        assert view in text, view
    assert "steps profiled: 2" in text
    assert profiler_summary.kernel_table(path)
    # the exposition server started with the trainer serves the families
    server = obs_http.get_server()
    assert server is not None
    body = urllib.request.urlopen(server.url + "/metrics",
                                  timeout=10).read().decode()
    assert _value(body, "fleetx_train_steps_total") == \
        after["fleetx_train_steps_total"]
    assert _value(body, "fleetx_train_tokens_per_second") > 0
    assert "fleetx_train_opt_state_bytes" in body
