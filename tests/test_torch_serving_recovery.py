"""Crash recovery of the port's serving engine against the JAX package:
transactional ticks, replay recovery, poison bisection and quarantine,
the recovery budget, admit-with-history.

Both packages' engines serve the same prompts on the same weights under
the same fault plan (each package's own ``faults`` injector configured
alike); greedy streams, finish reasons and partial tokens must be
byte-equal to JAX's engine's, on the slot and the paged cache where JAX
parametrizes them, with the pool's invariants intact. Sampled streams
after a recovery are held port to port (JAX's ``jax.random`` bits cannot
be matched): byte-equal to the same seeds' fault-free run.
"""

import importlib

import numpy as np
import pytest
import torch

from fleetx_tpu_torch.resilience.faults import faults
from fleetx_tpu_torch.serving import RecoveryExhausted
from torch_serving_cases import jax_engine, port_engine, weights

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


def run(make, w, paged, plan=None, seeds=None, max_length=8, **kw):
    """Submit PROMPTS to a fresh engine under ``plan``, drain; returns
    ``(results in order, engine)``."""
    injector = faults if make is port_engine else jax_faults
    if plan:
        injector.configure(**plan)
    try:
        eng = make(w, paged=paged, **kw)
        rids = [eng.submit(p, max_length=max_length,
                           seed=None if seeds is None else seeds[i])
                for i, p in enumerate(PROMPTS)]
        res = eng.drain()
    finally:
        injector.reset()
    if paged:
        eng.cache_manager.pool.check_invariants()
    return [res[r] for r in rids], eng


def streams(results):
    return [r.tokens.tolist() for r in results]


_CLEAN = {}


def clean(w, paged):
    """JAX's fault-free greedy streams, once per cache layout."""
    if paged not in _CLEAN:
        _CLEAN[paged] = streams(run(jax_engine, w, paged)[0])
    return _CLEAN[paged]


@PAGED
def test_tick_raise_rollback_and_replay_parity(w, paged):
    """Tolerance: greedy tokens byte-equal to JAX's engine under the same
    plan (and to the fault-free run)."""
    plan = dict(tick_raise="1")
    ours, eng = run(port_engine, w, paged, plan)
    theirs, jeng = run(jax_engine, w, paged, plan)
    assert streams(ours) == streams(theirs) == clean(w, paged)
    assert (eng.metrics.engine_recoveries
            == jeng.metrics.engine_recoveries == 1)
    assert eng.metrics.snapshot()["engine_recoveries"] == 1


@PAGED
def test_manual_recover_is_byte_identical_and_fresh(w, paged):
    """``recover()`` mid-flight builds fresh storage (new tensors, the old
    ones untouched) and the streams equal the fault-free run's."""
    eng = port_engine(w, paged=paged)
    rids = [eng.submit(p, max_length=8) for p in PROMPTS]
    eng.step()
    eng.step()
    old = {k: v for k, v in eng.cache_manager.cache.items()
           if torch.is_tensor(v)}
    snapshot = {k: v.clone() for k, v in old.items()}
    eng.recover()
    for k, v in eng.cache_manager.cache.items():
        if torch.is_tensor(v):
            assert v.data_ptr() != old[k].data_ptr()
            assert torch.equal(old[k], snapshot[k])
    if paged:
        eng.cache_manager.pool.check_invariants()
    res = eng.drain()
    assert [res[r].tokens.tolist() for r in rids] == clean(w, paged)


@PAGED
def test_sampling_replay_reconstructs_the_stream(w, paged):
    """Sampled streams after a recovery equal the same seeds' fault-free
    port run (the tick rolled back restores each generator's state)."""
    from fleetx_tpu_torch.models.gpt.generation import GenerationConfig

    gen = GenerationConfig(decode_strategy="sampling", temperature=0.9,
                           top_k=8, top_p=0.9, eos_token_id=10**6,
                           max_length=8)
    seeds = [100, 101, 102, 103]
    want, _ = run(port_engine, w, paged, seeds=seeds, gen_cfg=gen)
    for plan in (dict(tick_raise="2"), dict(tick_raise="1,3")):
        got, eng = run(port_engine, w, paged, plan, seeds=seeds,
                       gen_cfg=gen)
        assert (eng.metrics.engine_recoveries
                == plan["tick_raise"].count(",") + 1)
        assert streams(got) == streams(want)


def test_failed_tick_leaves_pre_tick_state(w):
    faults.configure(tick_raise="1")
    eng = port_engine(w)
    rids = [eng.submit(p, max_length=8) for p in PROMPTS]
    eng.step()
    before = {r.id: list(r.tokens) for r in eng._active.values()}
    results, depth = set(eng._results), eng.scheduler.queue_depth
    summary = eng.step()
    assert summary["recovered"] and not summary["decoded"]
    assert eng.scheduler.queue_depth == depth
    assert set(eng._results) == results
    assert {r.id: list(r.tokens) for r in eng._active.values()} == before
    eng.cache_manager.pool.check_invariants()
    faults.reset()
    res = eng.drain()
    assert [res[r].tokens.tolist() for r in rids] == clean(w, True)


@PAGED
def test_poison_request_bisection_neighbor_parity(w, paged):
    """The poison request retires ``error`` with JAX's partial tokens; its
    neighbours are byte-equal to JAX's and to the run without it."""
    plan = dict(poison_request="1")
    ours, eng = run(port_engine, w, paged, plan)
    theirs, jeng = run(jax_engine, w, paged, plan)
    assert [r.finish_reason for r in ours] == [
        r.finish_reason for r in theirs] == ["max_length", "error",
                                            "max_length", "max_length"]
    assert streams(ours) == streams(theirs)
    assert len(ours[1].tokens) >= 1
    for i in (0, 2, 3):
        assert ours[i].tokens.tolist() == clean(w, paged)[i]
    assert eng.metrics.poison_retired == jeng.metrics.poison_retired == 1
    assert eng.probes >= 3


@PAGED
def test_probe_writes_land_only_where_the_next_tick_writes(w, paged):
    """A bisection probe moves no host state, and of the storage it
    writes only each probed lane's next position (which the next committed
    tick overwrites first), the trash page and pinned positions past
    every live window; the ticks after it equal those of an engine that
    never probed."""
    a, b = port_engine(w, paged=paged), port_engine(w, paged=paged)
    for eng in (a, b):
        for p in PROMPTS:
            eng.submit(p, max_length=8)
        eng.step()
        eng.step()
    before = {k: v.clone() for k, v in a.cache_manager.cache.items()
              if torch.is_tensor(v)}
    lengths = a.cache_manager.lengths.copy()
    tokens = {r.id: list(r.tokens) for r in a._active.values()}
    probed = sorted(a._active)[:2]
    assert not a._probe_fails(probed)
    assert (a.cache_manager.lengths == lengths).all()
    assert {r.id: list(r.tokens) for r in a._active.values()} == tokens
    ps = a.page_size
    for name, old in before.items():
        new = a.cache_manager.cache[name]
        moved = (new != old).reshape(old.shape[0], old.shape[1],
                                     old.shape[2], -1).any(-1).any(0)
        for i, j in zip(*torch.nonzero(moved, as_tuple=True)):
            i, j = int(i), int(j)
            if paged:
                owners = [(lane, li) for lane in range(a.slots)
                          for li in range(int(a.cache_manager.pool
                                              .alloc_counts[lane]))
                          if a.cache_manager.tables[lane, li] == i]
                assert i == 0 or owners and all(
                    lane in probed and li * ps + j == lengths[lane]
                    or li * ps + j >= lengths[lane] for lane, li in owners)
            else:
                assert i in probed and j == lengths[i] or j == a.cache_len - 1
    ra, rb = a.drain(), b.drain()
    assert ({k: v.tokens.tolist() for k, v in ra.items()}
            == {k: v.tokens.tolist() for k, v in rb.items()})


def test_poison_prefill_quarantined_without_bisection(w):
    faults.configure(prefill_raise="0+")
    eng = port_engine(w)
    rid = eng.submit(PROMPTS[0], max_length=8)
    res = eng.drain(max_ticks=10)
    faults.reset()
    jax_faults.configure(prefill_raise="0+")
    jeng = jax_engine(w)
    jrid = jeng.submit(PROMPTS[0], max_length=8)
    jres = jeng.drain(max_ticks=10)
    assert res[rid].finish_reason == jres[jrid].finish_reason == "error"
    assert len(res[rid].tokens) == 0
    assert eng.metrics.poison_retired == jeng.metrics.poison_retired == 1
    eng.cache_manager.pool.check_invariants()
    rid = eng.submit(PROMPTS[0], max_length=8)
    assert eng.drain()[rid].tokens.tolist() == clean(w, True)[0]


def test_recovery_exhausted_flips_health_to_dead(w):
    faults.configure(tick_raise="0+")
    eng = port_engine(w, max_recoveries=3)
    eng.submit(PROMPTS[0], max_length=8)
    assert eng.health()["state"] == "ok"
    with pytest.raises(RecoveryExhausted):
        eng.drain(max_ticks=20)
    assert eng.health()["state"] == "dead"
    assert eng.metrics.engine_recoveries == 4


def test_real_cuda_error_is_not_replayed(w, monkeypatch):
    """A real CUDA error poisons the context: the tick re-raises it and the
    engine reads dead, no recovery attempted."""
    eng = port_engine(w)
    eng.submit(PROMPTS[0], max_length=8)
    eng.step()

    def broken(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(eng.executor, "forward", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.step()
    assert eng.metrics.engine_recoveries == 0
    assert eng.health()["state"] == "dead"


@PAGED
def test_admit_with_history_matches_jax(w, paged):
    """``submit(history=)``: a request another replica started admits by
    replay and finishes with JAX's tokens; the history rides the result,
    callbacks fire only for new tokens; a terminal history is refused."""
    want = clean(w, paged)
    seen = []
    eng = port_engine(w, paged=paged)
    rids = [eng.submit(p, max_length=8, history=want[i][:3],
                       on_token=lambda rid, t, done: seen.append(rid))
            for i, p in enumerate(PROMPTS)]
    res = eng.drain()
    jeng = jax_engine(w, paged=paged)
    jrids = [jeng.submit(p, max_length=8, history=want[i][:3])
             for i, p in enumerate(PROMPTS)]
    jres = jeng.drain()
    assert ([res[r].tokens.tolist() for r in rids]
            == [jres[r].tokens.tolist() for r in jrids] == want)
    assert len(seen) == 4 * 5
    with pytest.raises(ValueError, match="terminal"):
        eng.submit(PROMPTS[0], max_length=3, history=want[0][:3])
    with pytest.raises(ValueError, match="EOS"):
        eng.submit(PROMPTS[0], max_length=8, eos_token_id=want[0][2],
                   history=want[0][:3])
