"""The port's ``ServingRouter`` against the JAX package's router: failover.

Each scenario of ``tests/test_router.py``'s failure half runs through the
port's router over port engines and through JAX's router over JAX
engines, on the same weights: token lists, finish reasons, callback
streams, replica states, the router's counters (dispatched, migrated,
deaths, probe failures, rejected, shed, ...) and its event counts are
equal, and every normally finished stream equals a clean single engine's.
Sampled streams are the port's own (JAX draws from ``jax.random`` keys):
a sampled request migrated off a killed replica equals one port engine
given the same seed. The dispatch half, the suspect-only queue and
stranding are ``test_torch_router_dispatch``.
"""

import numpy as np
import pytest

from torch_router_cases import (
    PORT,
    PROMPTS,
    assert_same,
    both,
    clean,
    outcome,
    recorder,
)


@pytest.fixture(autouse=True)
def _clean():
    clean(None)
    yield
    clean(None)


def reference(pkg, prompts, max_length=8, **kw):
    """Greedy tokens of one never-faulted engine (batch composition never
    changes greedy tokens)."""
    eng = pkg.engine(slots=1, **kw)
    rids = [eng.submit(p, max_length=max_length) for p in prompts]
    res = eng.drain()
    return [[int(t) for t in res[r].tokens] for r in rids]


@pytest.fixture(scope="module")
def clean_streams():
    """The port's clean greedy streams (each scenario's equality with
    JAX's router holds them against JAX's tokens too)."""
    return reference(PORT, PROMPTS)


def test_replica_kill_failover_byte_parity(clean_streams):
    """A replica killed at router tick 3 of a 3-replica fleet: exactly one
    result each, migrated streams byte-equal to a clean engine, the
    callback transcript equal to the result, JAX's counters."""
    def run(pkg):
        streams, cb = recorder()
        with pkg.faulted(replica_kill="1:3"):
            router = pkg.s.ServingRouter([pkg.engine() for _ in range(3)],
                                         probe_every=1)
            rids = [router.submit(p, max_length=8, on_token=cb)
                    for p in PROMPTS]
            res = router.drain(max_ticks=400)
        return outcome(pkg, router, res, rids, streams)

    out = both(run)
    assert_same(out)
    got = out["port"]
    assert got["tokens"] == clean_streams == got["streams"]
    assert got["states"][1] == "dead"
    assert got["counters"]["replica_deaths"] == 1
    assert got["counters"]["migrated"] >= 1


def test_probe_flap_rotates_out_and_back_never_dead(clean_streams):
    def run(pkg):
        with pkg.faulted(probe_flap="1:2"):
            router = pkg.s.ServingRouter(
                [pkg.engine(), pkg.engine()], probe_every=1,
                probe_max_failures=4, probe_backoff_ticks=1)
            rids = [router.submit(p, max_length=8) for p in PROMPTS]
            res = router.drain(max_ticks=400)
        return outcome(pkg, router, res, rids)

    out = both(run)
    assert_same(out)
    got = out["port"]
    assert got["tokens"] == clean_streams
    assert got["events"]["replica_out"] and got["events"]["replica_back"]
    assert not got["events"]["replica_dead"]
    assert got["states"] == ["ok", "ok"]


def test_probe_escalation_marks_dead_and_migrates(clean_streams):
    def run(pkg):
        with pkg.faulted(probe_flap="0:50"):
            router = pkg.s.ServingRouter(
                [pkg.engine(), pkg.engine()], probe_every=1,
                probe_max_failures=3, probe_backoff_ticks=1)
            rids = [router.submit(p, max_length=8) for p in PROMPTS]
            res = router.drain(max_ticks=400)
        return outcome(pkg, router, res, rids)

    out = both(run)
    assert_same(out)
    got = out["port"]
    assert got["tokens"] == clean_streams
    assert got["events"]["replica_dead"] == 1
    assert got["states"][0] == "dead"
    assert got["counters"]["probe_failures"] >= 3


def test_conservation_under_kill_flap_and_saturation_churn():
    """Random bursts over a bounded queue while two replicas are killed
    and a probe flaps: exactly one result per accepted request, the
    transcript equal to the result, normal finishes equal to a clean
    engine, and the same rejects, sheds and migrations as JAX."""
    def run(pkg):
        rng = np.random.RandomState(3)
        streams, cb = recorder()
        accepted, rejected, prompts = [], 0, {}
        with pkg.faulted(replica_kill="0:6,2:11", probe_flap="1:2"):
            router = pkg.s.ServingRouter(
                [pkg.engine() for _ in range(3)], probe_every=1,
                probe_max_failures=3, probe_backoff_ticks=1, max_queue=6)
            for _ in range(4):
                for _ in range(5):
                    p = rng.randint(1, 61, rng.randint(2, 7)).astype(
                        np.int32)
                    kw = {"deadline_s": 1e-6} if rng.rand() < 0.15 else {}
                    try:
                        rid = router.submit(p, max_length=8, on_token=cb,
                                            **kw)
                    except pkg.s.QueueFull:
                        rejected += 1
                        continue
                    accepted.append(rid)
                    prompts[rid] = p
                for _ in range(3):
                    router.step()
            res = router.drain(max_ticks=600)
        out = outcome(pkg, router, res, accepted, streams)
        out["rejected"] = rejected
        out["complete"] = sorted(res) == sorted(accepted)
        out["prompts"] = [prompts[r].tolist() for r in accepted]
        return out

    out = both(run)
    assert_same(out)
    got = out["port"]
    assert got["complete"] and got["rejected"] > 0
    assert set(got["reasons"]) <= {"max_length", "timeout"}
    assert got["tokens"] == got["streams"]
    finished = [(p, t) for p, t, r in zip(got["prompts"], got["tokens"],
                                          got["reasons"])
                if r == "max_length"]
    want = reference(PORT, [np.asarray(p, np.int32) for p, _ in finished])
    assert [t for _, t in finished] == want
    assert got["counters"]["replica_deaths"] == 2
    assert got["states"].count("dead") == 2


def test_suspect_turning_draining_cancels_hedged_copies(clean_streams):
    """A suspect whose next probe says draining is ticked again: its
    hedged-away copies are cancelled first, so nothing double-delivers."""
    def run(pkg):
        e0, e1 = pkg.engine(), pkg.engine()
        router = pkg.s.ServingRouter([e0, e1], probe_every=1,
                                     probe_max_failures=4,
                                     probe_backoff_ticks=1, hedge=True)
        streams, cb = recorder()
        rids = [router.submit(p, max_length=8, on_token=cb)
                for p in PROMPTS]
        router.step()
        lies = {"n": 1}
        honest = e0.health

        def flaky():
            if lies["n"]:
                lies["n"] -= 1
                return {"state": "dead", "queue_depth": 0, "active": 0}
            return honest()

        e0.health = flaky
        router.step()
        states = [list(router.replica_states)]
        e0.request_shutdown(grace_s=30.0)
        router.step()
        states.append(list(router.replica_states))
        res = router.drain(max_ticks=400)
        out = outcome(pkg, router, res, rids, streams)
        out["mid_states"] = states
        out["zombies"] = len(e0._active) + len(e0.scheduler)
        return out

    out = both(run)
    assert_same(out)
    got = out["port"]
    assert got["mid_states"] == [["suspect", "ok"], ["draining", "ok"]]
    assert got["tokens"] == got["streams"] == clean_streams
    assert got["zombies"] == 0 and not got["events"]["replica_dead"]


def test_raising_health_between_probes_does_not_crash_step(clean_streams):
    def run(pkg):
        e0, e1 = pkg.engine(), pkg.engine()
        router = pkg.s.ServingRouter([e0, e1], probe_every=5,
                                     probe_max_failures=2,
                                     probe_backoff_ticks=1)
        router.step()

        def raising():
            raise RuntimeError("tunnel wedged")

        e0.health = raising
        rids = [router.submit(p, max_length=8) for p in PROMPTS]
        res = router.drain(max_ticks=400)
        return outcome(pkg, router, res, rids)

    out = both(run)
    assert_same(out)
    assert out["port"]["tokens"] == clean_streams
    assert out["port"]["states"][0] == "dead"


SAMPLING = dict(decode_strategy="sampling", temperature=0.9, top_k=8,
                top_p=0.9)


def test_sampled_failover_equals_one_engine_with_the_same_seed():
    """Seeded sampling across a kill: a request's stream after migration
    equals one port engine's given the router's seed for it (explicit,
    or derived from ``base_seed`` and the router's request id)."""
    seeds = [123, None, 7, None]
    streams, cb = recorder()
    with PORT.faulted(replica_kill="1:3"):
        router = PORT.s.ServingRouter([PORT.engine() for _ in range(3)],
                                      probe_every=1, base_seed=11)
        rids = [router.submit(p, max_length=8, seed=s, on_token=cb,
                              **SAMPLING)
                for p, s in zip(PROMPTS, seeds)]
        res = router.drain(max_ticks=400)
    assert router.metrics.snapshot()["migrated"] >= 1
    for rid, p, s in zip(rids, PROMPTS, seeds):
        if s is None:
            s = int(np.random.SeedSequence([11, rid]).generate_state(1)[0])
        eng = PORT.engine(slots=1)
        one = eng.submit(p, max_length=8, seed=s, **SAMPLING)
        want = eng.drain()[one].tokens.tolist()
        assert res[rid].tokens.tolist() == want == streams[rid], rid
