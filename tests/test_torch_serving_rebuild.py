"""How the port's serving engine rebuilds its storage in a recovery: the
old storage is released before the new one is allocated (a recovery
needs one pool's memory), a call the watchdog abandoned keeps the old
tensors until it ends, a rebuild that fails leaves the engine dead, and a
request whose own catch-up fails is quarantined alone.

Streams are held against JAX's engine's fault-free greedy streams on the
same weights (byte-equal)."""

import importlib
import weakref

import numpy as np
import pytest

from fleetx_tpu_torch.resilience.faults import faults
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
    """JAX's fault-free greedy streams."""
    return tokens(serve(jax_engine(w), PROMPTS))


def _watch_rebuild(eng):
    """Record, at each rebuild, whether the storage before it was already
    released (``True``) or still alive."""
    seen = []
    ref = weakref.ref(eng.cache_manager.cache["key"])
    build = eng._new_cache_manager

    def rebuild():
        nonlocal ref
        seen.append(ref() is None)
        out = build()
        ref = weakref.ref(out.cache["key"])
        return out

    eng._new_cache_manager = rebuild
    return seen


@PAGED
@pytest.mark.parametrize("watchdog", [False, True], ids=["direct", "watched"])
def test_recovery_releases_the_old_storage_before_allocating(w, clean, paged,
                                                             watchdog):
    """A faulted tick's frames (and the watchdog worker's) let go of the
    old pool before recovery allocates the new one; the streams equal
    JAX's fault-free ones."""
    eng = port_engine(w, paged=paged)
    if watchdog:
        eng.tick_timeout_s = 30.0
    seen = _watch_rebuild(eng)
    faults.configure(tick_raise="1,3")
    got = tokens(serve(eng, PROMPTS))
    assert seen == [True, True]
    assert eng.metrics.engine_recoveries == 2
    assert got == clean


@PAGED
def test_abandoned_call_keeps_the_old_storage_until_it_ends(w, clean, paged):
    """A hung call the watchdog abandoned still holds the pool it was
    bound to, so the rebuild finds it alive; once the call ends, nothing
    holds it."""
    eng = port_engine(w, paged=paged)
    serve(eng, [np.asarray([50, 51], np.int32)], max_length=3)  # warm
    seen = _watch_rebuild(eng)
    old = weakref.ref(eng.cache_manager.cache["key"])
    faults.configure(tick_hang=str(eng._fault_ticks + 1), tick_hang_s=1.0)
    eng.tick_timeout_s = 0.3
    got = tokens(serve(eng, PROMPTS))
    faults.reset()
    assert seen[0] is False and len(eng.abandoned) == 1
    eng.abandoned[0].join(timeout=10)
    assert not eng.abandoned[0].is_alive()
    assert old() is None
    assert got == clean


@PAGED
def test_failed_rebuild_reads_dead(w, paged):
    """A recovery whose new storage cannot be allocated raises out of
    ``step`` with ``health()`` reading dead; nothing is left half active."""
    eng = port_engine(w, paged=paged)
    for p in PROMPTS:
        eng.submit(p, max_length=8)
    eng.step()

    def no_memory():
        raise RuntimeError("not enough memory for the new pool")

    eng._new_cache_manager = no_memory
    faults.configure(tick_raise=str(eng._fault_ticks))
    with pytest.raises(RuntimeError, match="not enough memory"):
        eng.step()
    health = eng.health()
    assert health["state"] == "dead"
    assert not eng._active and not eng._prefilled


@PAGED
@pytest.mark.parametrize("lanes", [1, 3])
def test_a_failed_catch_up_quarantines_its_request_alone(w, clean, paged,
                                                         lanes):
    """A request whose own catch-up fails retires ``error`` with its
    partial tokens, whether it was the only lane to catch up or one of
    several; the others stream as without the fault, and the engine stays
    up."""
    eng = port_engine(w, paged=paged)
    rids = [eng.submit(p, max_length=8) for p in PROMPTS[:lanes]]
    for _ in range(3):
        eng.step()
    victim = rids[-1]
    catch_up = eng._catch_up_forwards

    def failing(todo):
        if any(req.id == victim for req, _ in todo):
            raise RuntimeError("catch-up of the victim failed")
        return catch_up(todo)

    eng._catch_up_forwards = failing
    assert eng.recover() == [victim]
    eng._catch_up_forwards = catch_up
    res = eng.drain()
    assert eng.health()["state"] == "ok"
    assert res[victim].finish_reason == "error"
    part = res[victim].tokens.tolist()
    assert 1 < len(part) < 8 and part == clean[lanes - 1][:len(part)]
    for i, rid in enumerate(rids[:-1]):
        assert res[rid].tokens.tolist() == clean[i]
