"""The port's ``ServingRouter`` against the JAX package's router: dispatch,
admission and degradation.

The dispatch half of ``tests/test_router.py``, each scenario through the
port's router over port engines and JAX's router over JAX engines on the
same weights, with equal tokens, finish reasons, states, counters and
event counts: the admit-with-history seam, least-loaded placement and
prefix affinity, the bounded queue and deadline shed, shutdown, the queue
TTL, a heterogeneous fleet's refusal ladder, the suspect-only queue and
stranding. (The failover half is ``test_torch_router``.)
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
)


@pytest.fixture(autouse=True)
def _clean():
    clean(None)
    yield
    clean(None)


@pytest.fixture(scope="module")
def clean_streams():
    eng = PORT.engine(slots=1)
    rids = [eng.submit(p, max_length=8) for p in PROMPTS]
    res = eng.drain()
    return [[int(t) for t in res[r].tokens] for r in rids]


def test_submit_with_history_continues_byte_identically(clean_streams):
    """The engine's admit-with-history seam in both packages: the first k
    tokens as history give the full stream, and ``on_token`` fires only
    for the new tokens; a terminal history raises."""
    want = clean_streams[1]

    def run(pkg):
        eng = pkg.engine()
        got = []
        rid = eng.submit(PROMPTS[1], max_length=8, history=want[:3],
                         on_token=lambda r, t, f: got.append(int(t)))
        res = eng.drain()[rid]
        with pytest.raises(ValueError, match="terminal"):
            eng.submit(PROMPTS[0], max_length=4, history=[5, 6, 7, 8])
        with pytest.raises(ValueError, match="EOS"):
            eng.submit(PROMPTS[0], max_length=8, eos_token_id=7,
                       history=[5, 7])
        return {"tokens": res.tokens.tolist(), "new": got,
                "reason": res.finish_reason}

    out = both(run)
    assert_same(out)
    assert out["port"] == {"tokens": want, "new": want[3:],
                           "reason": "max_length"}


def test_sampling_history_resumes_the_stream():
    """The same seed and k history tokens resume a sampled stream at its
    exact position (one skipped draw per history token)."""
    kw = dict(decode_strategy="sampling", temperature=0.9, top_k=8,
              top_p=0.9, seed=123)
    eng = PORT.engine()
    rid = eng.submit(PROMPTS[0], max_length=8, **kw)
    want = eng.drain()[rid].tokens.tolist()
    for k in (1, 4, 7):
        eng = PORT.engine()
        rid = eng.submit(PROMPTS[0], max_length=8, history=want[:k], **kw)
        assert eng.drain()[rid].tokens.tolist() == want, k


def test_least_loaded_dispatch_and_prefix_affinity():
    """Placement: least-loaded first (ties by index), a prompt sharing a
    routed full-page prefix pins back to its replica, and the pin drops
    when that replica dies."""
    prefix = np.arange(1, 9, dtype=np.int32)
    pa = np.concatenate([prefix, np.asarray([20, 21], np.int32)])
    pc = np.concatenate([prefix, np.asarray([30, 31, 32], np.int32)])

    def run(pkg):
        router = pkg.s.ServingRouter([pkg.engine(), pkg.engine()],
                                     probe_every=1)
        placed, rids, res = [], [], {}
        for p in (pa, PROMPTS[0]):
            rids.append(router.submit(p, max_length=8))
            router.step()
            placed.append(router._requests[rids[-1]].replica)
        res.update(router.drain(max_ticks=300))
        rids.append(router.submit(pc, max_length=8))
        router.step()
        placed.append(router._requests[rids[-1]].replica)
        res.update(router.drain(max_ticks=300))
        with pkg.faulted(replica_kill="0:%d" % (router._ticks + 1)):
            rids.append(router.submit(pc, max_length=8))
            router.step()
        res.update(router.drain(max_ticks=300))
        out = outcome(pkg, router, res, rids)
        out["placed"] = placed
        out["pins"] = sorted(router._affinity_map.values())
        return out

    out = both(run)
    assert_same(out)
    got = out["port"]
    assert got["placed"] == [0, 1, 0]
    assert got["counters"]["affinity_hits"] >= 1
    assert got["tokens"][2] == got["tokens"][3]
    assert got["reasons"][3] == "max_length" and 0 not in got["pins"]
    assert got["states"][0] == "dead"


def test_router_bounded_queue_and_deadline_shed(clean_streams):
    def run(pkg):
        router = pkg.s.ServingRouter([pkg.engine()], max_queue=4)
        accepted, rejected = [], 0
        for i in range(10):
            kw = {"deadline_s": 1e-6} if i == 3 else {}
            try:
                accepted.append(
                    router.submit(PROMPTS[i % 4], max_length=8, **kw))
            except pkg.s.QueueFull:
                rejected += 1
        res = router.drain(max_ticks=300)
        after = router.submit(PROMPTS[0], max_length=8)
        res.update(router.drain(max_ticks=200))
        out = outcome(pkg, router, res, accepted + [after])
        out["rejected"] = rejected
        return out

    out = both(run)
    assert_same(out)
    got = out["port"]
    assert got["rejected"] > 0 and "timeout" in got["reasons"]
    assert set(got["reasons"]) <= {"max_length", "timeout"}
    assert got["tokens"][-1] == clean_streams[0]


def test_router_shutdown_returns_every_request():
    def run(pkg):
        router = pkg.s.ServingRouter([pkg.engine()], max_queue=0)
        rids = [router.submit(p, max_length=8) for p in PROMPTS * 2]
        router.step()
        res = router.shutdown(grace_s=30.0)
        with pytest.raises(pkg.s.ShuttingDown):
            router.submit(PROMPTS[0])
        return outcome(pkg, router, res, rids)

    out = both(run)
    assert_same(out)
    assert None not in out["port"]["reasons"]
    assert set(out["port"]["reasons"]) <= {"max_length", "eos", "shutdown"}


def test_queue_ttl_measures_waiting_not_lifetime():
    """The queue TTL is this queue residency; the deadline is the whole
    lifetime (JAX's margins)."""
    def run(pkg):
        router = pkg.s.ServingRouter([pkg.engine()], queue_ttl_s=5.0)
        rid = router.submit(PROMPTS[0], max_length=8)
        req = router._requests[rid]
        now = router._now()
        req.submit_time = now - 20.0
        req.queued_since = now
        sheds = [router._shed_expired(now + 0.1), req.state]
        req.queued_since = now - 6.0
        sheds += [router._shed_expired(now),
                  router.result(rid).finish_reason]
        rid2 = router.submit(PROMPTS[0], max_length=8, deadline_s=10.0)
        req2 = router._requests[rid2]
        req2.submit_time = router._now() - 11.0
        req2.queued_since = router._now()
        sheds += [router._shed_expired(router._now()),
                  router.result(rid2).finish_reason]
        return sheds

    out = both(run)
    assert out["port"] == out["jax"] == [0, "queued", 1, "timeout", 1,
                                         "timeout"]


def test_heterogeneous_fleet_refusal_tries_next_replica():
    """A replica refusing a migrated history (its smaller budget) is
    excluded and the roomier one admits it; a request every replica
    refuses errors exactly once."""
    def run(pkg):
        router = pkg.s.ServingRouter([pkg.engine(cache_len=16),
                                      pkg.engine()])
        rid = router.submit(PROMPTS[0], max_length=28)
        req = router._requests[rid]
        req.tokens = [int(t) % 61 for t in range(14)]
        router.step()
        placed = (req.state, req.replica)
        res = router.drain(max_ticks=300)
        router2 = pkg.s.ServingRouter([pkg.engine(cache_len=16)])
        rid2 = router2.submit(PROMPTS[0], max_length=14)
        router2._requests[rid2].tokens = [5] * 14
        router2.step()
        return {"placed": placed, "tokens": res[rid].tokens.tolist(),
                "reason": res[rid].finish_reason,
                "refused": router2.result(rid2).finish_reason}

    out = both(run)
    assert_same(out)
    assert out["port"]["placed"] == ("dispatched", 1)
    assert out["port"]["refused"] == "error"
def test_queue_waits_while_only_replica_is_suspect(clean_streams):
    def run(pkg):
        with pkg.faulted(probe_flap="0:2"):
            router = pkg.s.ServingRouter([pkg.engine()], probe_every=1,
                                         probe_max_failures=4,
                                         probe_backoff_ticks=1)
            rid = router.submit(PROMPTS[0], max_length=8)
            for _ in range(3):
                router.step()
            res = router.drain(max_ticks=300)
        return outcome(pkg, router, res, [rid])

    out = both(run)
    assert_same(out)
    assert out["port"]["tokens"] == clean_streams[:1]
    assert not out["port"]["events"]["replica_dead"]


def test_all_replicas_dead_strands_loudly():
    def run(pkg):
        with pkg.faulted(replica_kill="0:2"):
            router = pkg.s.ServingRouter([pkg.engine()], probe_every=1)
            rids = [router.submit(p, max_length=8) for p in PROMPTS]
            res = router.drain(max_ticks=100)
        return outcome(pkg, router, res, rids)

    out = both(run)
    assert_same(out)
    assert set(out["port"]["reasons"]) == {"error"}
    assert out["port"]["events"]["router_stranded"]
