"""The port's serving engine under hung ticks, shutdown and faults in its
other paths, against the JAX package: the tick watchdog, graceful
shutdown (``shutdown``, SIGTERM), replay with a shared prefix, a fault
mid chunked prefill, a fault in a speculative or an int8 tick, and the
per-tick wall clock.

Greedy streams and partial tokens under the same plan equal JAX's engine's
where JAX's tests compare them; the paths JAX's tests hold only against
their own fault-free run are held against the port's.
"""

import importlib
import os
import signal

import numpy as np
import pytest

from fleetx_tpu_torch.resilience.faults import faults
from fleetx_tpu_torch.serving import ShuttingDown
from torch_serving_cases import jax_engine, port_engine, serve, tokens, weights

jax_faults = importlib.import_module("fleetx_tpu.resilience.faults").faults

PROMPTS = [np.asarray([1, 2, 3], np.int32),
           np.asarray([4, 5, 6, 7, 8], np.int32),
           np.asarray([9, 10], np.int32),
           np.asarray([11, 12, 13], np.int32)]
PAGED = pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])


@pytest.fixture(scope="module")
def w():
    return weights()


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


@pytest.fixture(scope="module")
def clean(w):
    """The port's fault-free greedy streams per layout, checked once
    against JAX's."""
    out = {paged: tokens(serve(port_engine(w, paged=paged), PROMPTS))
           for paged in (False, True)}
    assert out[True] == out[False] == tokens(serve(jax_engine(w), PROMPTS))
    return out


@PAGED
def test_hung_tick_watchdog_recovers(w, clean, paged):
    """A decode forward stuck past ``tick_timeout_s`` is abandoned (its
    worker thread finishes it on the old storage), diagnostics banked, and
    recovery resumes byte-identically."""
    eng = port_engine(w, paged=paged)
    serve(eng, [np.asarray([50, 51], np.int32)], max_length=3)  # warm
    old = eng.cache_manager.cache["key"]
    faults.configure(tick_hang=str(eng._fault_ticks + 1), tick_hang_s=1.0)
    eng.tick_timeout_s = 0.3
    got = tokens(serve(eng, PROMPTS))
    faults.reset()
    assert eng.hang_diagnostics["timeout_s"] == 0.3
    assert eng.metrics.engine_recoveries >= 1
    assert len(eng.abandoned) == 1
    eng.abandoned[0].join(timeout=10)
    assert not eng.abandoned[0].is_alive()
    assert eng.cache_manager.cache["key"] is not old
    assert got == clean[paged]
    if paged:
        eng.cache_manager.pool.check_invariants()


@PAGED
def test_shutdown_returns_partials_for_everything(w, paged):
    """Under load with no grace: every request returns ``shutdown`` with
    JAX's partial tokens, new submits are refused, nothing is held."""
    out = {}
    for make in (port_engine, jax_engine):
        eng = make(w, paged=paged)
        rids = [eng.submit(p, max_length=50) for p in PROMPTS]
        rids.append(eng.submit(np.asarray([20, 21], np.int32),
                               max_length=50))
        eng.step()
        eng.step()
        res = eng.shutdown(grace_s=0.0)
        assert set(res) == set(rids)
        assert {res[r].finish_reason for r in rids} == {"shutdown"}
        with pytest.raises(Exception, match="draining"):
            eng.submit(PROMPTS[0])
        assert eng.metrics.drain_rejects == 1
        assert eng.cache_manager.active_count == 0
        out[make] = [res[r].tokens.tolist() for r in rids]
    assert out[port_engine] == out[jax_engine]
    assert sum(1 for t in out[port_engine] if t) >= 3


def test_shutdown_with_grace_finishes_and_health_moves(w, clean):
    eng = port_engine(w)
    rids = [eng.submit(p, max_length=8) for p in PROMPTS]
    eng.step()
    assert eng.health()["state"] == "ok"
    eng.request_shutdown(grace_s=60.0)
    assert eng.health()["state"] == "draining"
    res = eng.shutdown()
    assert [res[r].tokens.tolist() for r in rids] == clean[True]
    assert {res[r].finish_reason for r in rids} == {"max_length"}
    with pytest.raises(ShuttingDown):
        eng.submit(PROMPTS[0])


def test_sigterm_requests_drain(w):
    eng = port_engine(w)
    prev = signal.getsignal(signal.SIGTERM)
    eng.install_sigterm_handler(grace_s=0.0)
    try:
        rids = [eng.submit(p, max_length=50) for p in PROMPTS[:3]]
        eng.step()
        os.kill(os.getpid(), signal.SIGTERM)  # delivered synchronously
        assert eng.health()["state"] == "draining"
        with pytest.raises(ShuttingDown):
            eng.submit(PROMPTS[0])
        res = eng.drain()
        assert {res[r].finish_reason for r in rids} == {"shutdown"}
        assert any(len(res[r].tokens) for r in rids)
    finally:
        eng.uninstall_sigterm_handler()
    assert signal.getsignal(signal.SIGTERM) is prev


def test_shared_prefix_replay_keeps_trie_sharing(w):
    """Requests over one system prompt stay byte-equal to JAX's through a
    mid-flight fault; the rebuilt trie shares the prefix again."""
    prefix = np.arange(16, dtype=np.int32) + 20
    prompts = [np.concatenate([prefix, np.asarray([i + 1], np.int32)])
               for i in range(3)]
    want = tokens(serve(jax_engine(w), prompts, max_length=6))
    faults.configure(tick_raise="2")
    eng = port_engine(w)
    got = tokens(serve(eng, prompts, max_length=6))
    assert got == want
    assert eng.metrics.engine_recoveries == 1
    assert eng.metrics.snapshot()["prefix_hits"] >= 2
    eng.cache_manager.pool.check_invariants()


@PAGED
def test_fault_mid_chunked_prefill_requeues_and_matches(w, paged):
    """A prefill fault in a middle chunk rolls the request back to the
    queue head and it restarts; streams equal the fault-free chunked
    engine's and JAX's."""
    long = np.arange(3, 33, dtype=np.int32)
    ps = [PROMPTS[0], long, PROMPTS[1]]
    want = tokens(serve(port_engine(w, paged=paged, prefill_chunk=8), ps))
    assert want == tokens(serve(jax_engine(w, paged=paged), ps))
    faults.configure(prefill_raise="2")
    eng = port_engine(w, paged=paged, prefill_chunk=8)
    assert tokens(serve(eng, ps)) == want
    assert eng.metrics.engine_recoveries == 1
    assert eng.metrics.poison_retired == 0


def test_speculative_tick_fault_recovers(w):
    """A fault in the verify forward rolls back like a plain tick; the
    streams equal the fault-free speculative (and plain) engine's."""
    ps = [np.asarray([5, 6, 7, 5, 6, 7, 5, 6], np.int32), PROMPTS[1]]
    want = tokens(serve(port_engine(w), ps, max_length=10))
    faults.configure(tick_raise="2")
    eng = port_engine(w, spec=True, spec_k=3)
    assert tokens(serve(eng, ps, max_length=10)) == want
    assert eng.metrics.engine_recoveries == 1
    assert eng.metrics.spec_proposed_tokens > 0


@PAGED
def test_int8_tick_fault_recovers(w, paged):
    """At int8 KV the replay rebuilds values and scales: streams equal the
    fault-free int8 run's."""
    want = tokens(serve(port_engine(w, paged=paged, kv_dtype="int8"),
                        PROMPTS))
    faults.configure(tick_raise="3")
    eng = port_engine(w, paged=paged, kv_dtype="int8")
    assert tokens(serve(eng, PROMPTS)) == want
    assert eng.metrics.engine_recoveries == 1


def test_tick_wallclock_metrics_present(w):
    faults.configure(tick_raise="1")
    eng = port_engine(w)
    serve(eng, PROMPTS)
    snap = eng.metrics.snapshot()
    assert snap["tick_ms_p50"] is not None
    assert snap["tick_ms_p99"] >= snap["tick_ms_p50"]
    assert len(eng.metrics.tick_s) == snap["ticks"]
    assert snap["engine_recoveries"] == 1
