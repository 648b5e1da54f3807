"""The port's per-tenant QoS dispatch and ``FleetAutoscaler`` against the
JAX package's.

``tests/test_router_qos.py``'s scenarios through both packages' routers
over their own engines on the same weights: lane-scoped admission, rate
and token budgets on a settable clock, DRR equal to FIFO on one lane,
weighted shares under a flood, zero-loss preemption and its churn with a
kill and a flap, and the autoscaler's scale-up and drain-down; tokens,
finish reasons, counters and event counts equal. The port's own: a seeded
sampled stream preempted and re-admitted equals one engine's, and a
scaled-up replica sharing the fleet's disk tier prewarms the router's hot
prefix.
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


def policy(pkg, **kw):
    return pkg.s.TenantPolicy(**kw)


def test_lane_scoped_queue_full_isolates_flooder():
    def run(pkg):
        router = pkg.s.ServingRouter(
            [pkg.engine(slots=1, max_queue=1)],
            tenants={"flood": policy(pkg, max_queue=2)})
        rids = [router.submit(PROMPTS[0], max_length=8, tenant="flood")
                for _ in range(2)]
        with pytest.raises(pkg.s.QueueFull, match="flood"):
            router.submit(PROMPTS[0], max_length=8, tenant="flood")
        rids.append(router.submit(PROMPTS[1], max_length=8))
        res = router.drain(max_ticks=300)
        return outcome(pkg, router, res, rids)

    out = both(run)
    assert_same(out)
    per = out["port"]["counters"]["per_tenant"]
    assert per["flood"]["shed"] == 1
    assert per.get("default", {}).get("shed", 0) == 0


def test_tenant_rate_and_token_budget():
    """rate_rps bounds admits a second, token_budget cost tokens a second,
    both refilled on the router clock (a settable one here)."""
    def run(pkg):
        router = pkg.s.ServingRouter(
            [pkg.engine()],
            tenants={"metered": policy(pkg, rate_rps=2.0),
                     "budgeted": policy(pkg, token_budget=16.0)})
        t = [100.0]
        router._now = lambda: t[0]
        rids, refused = [], []

        def submit(p, tenant):
            try:
                rids.append(router.submit(p, max_length=8, tenant=tenant))
            except pkg.s.QueueFull as e:
                refused.append(tenant in str(e))

        for tenant in ("metered", "metered", "metered", "budgeted",
                       "budgeted"):
            submit(PROMPTS[0], tenant)
        t[0] += 1.0
        submit(PROMPTS[1], "metered")
        submit(PROMPTS[1], "budgeted")
        res = router.drain(max_ticks=300)
        out = outcome(pkg, router, res, rids)
        out["refused"] = refused
        return out

    out = both(run)
    assert_same(out)
    assert out["port"]["refused"] == [True, True]
    assert out["port"]["reasons"] == ["max_length"] * 5


def test_drr_single_lane_matches_fifo():
    def run(pkg):
        out = {}
        for mode in ("fifo", "drr"):
            router = pkg.s.ServingRouter([pkg.engine()], dispatch=mode)
            rids = [router.submit(p, max_length=8) for p in PROMPTS]
            res = router.drain(max_ticks=300)
            out[mode] = outcome(pkg, router, res, rids)
        return out

    out = both(run)
    assert_same(out)
    port = out["port"]
    assert port["drr"]["tokens"] == port["fifo"]["tokens"]


def test_drr_weighted_share_and_flood_isolation():
    def run(pkg):
        router = pkg.s.ServingRouter(
            [pkg.engine(max_queue=2)],
            tenants={"heavy": policy(pkg, weight=4.0),
                     "light": policy(pkg, weight=1.0)},
            drr_quantum=16)
        rids = [router.submit(PROMPTS[i % 4], max_length=8, tenant=t)
                for t in ("heavy", "light") for i in range(6)]
        router.step()
        first = {t: s["dispatched"] for t, s in
                 router.metrics.snapshot()["per_tenant"].items()}
        res = router.drain(max_ticks=600)
        out = outcome(pkg, router, res, rids)
        out["first_wave"] = first
        return out

    out = both(run)
    assert_same(out)
    first = out["port"]["first_wave"]
    assert first["heavy"] >= first.get("light", 0)
    assert out["port"]["reasons"] == ["max_length"] * 12


def test_priority_preemption_zero_loss():
    """A deadline-at-risk paid request evicts a best-effort one from the
    only slot; the victim re-queues with its history and finishes with
    the uncontended stream, no token lost or repeated."""
    def run(pkg):
        streams, cb = recorder()
        router = pkg.s.ServingRouter(
            [pkg.engine(slots=1, max_queue=1)],
            tenants={"paid": policy(pkg, priority=1)},
            deadline_s=60.0, preempt_risk_frac=0.0)
        rids = [router.submit(PROMPTS[0], max_length=8, on_token=cb)]
        router.step()
        rids.append(router.submit(PROMPTS[1], max_length=8, on_token=cb))
        router.step()
        rids.append(router.submit(PROMPTS[2], max_length=8, on_token=cb,
                                  tenant="paid"))
        router.step()
        ev = pkg.events().find("request_preempted", by_tenant="paid")
        victim = rids.index(ev[0].attrs["request"]) if ev else None
        res = router.drain(max_ticks=400)
        out = outcome(pkg, router, res, rids, streams)
        out["victim"] = victim
        return out

    out = both(run)
    assert_same(out)
    got = out["port"]
    assert got["victim"] in (0, 1) and got["counters"]["preempted"] == 1
    eng = PORT.engine(slots=1)
    one = [eng.submit(p, max_length=8) for p in PROMPTS[:3]]
    res = eng.drain()
    want = [res[r].tokens.tolist() for r in one]
    assert got["tokens"] == got["streams"] == want


def test_preempted_sampled_stream_resumes_bit_for_bit():
    """A seeded sampling victim, preempted mid-stream and re-admitted with
    its history and seed, equals one engine's stream of that seed."""
    kw = dict(decode_strategy="sampling", temperature=0.9, top_k=8,
              top_p=0.9)
    streams, cb = recorder()
    router = PORT.s.ServingRouter(
        [PORT.engine(slots=1, max_queue=1)],
        tenants={"paid": policy(PORT, priority=1)},
        deadline_s=60.0, preempt_risk_frac=0.0)
    victim = router.submit(PROMPTS[1], max_length=8, seed=5, on_token=cb,
                           **kw)
    for _ in range(3):
        router.step()
    router.submit(PROMPTS[3], max_length=8, tenant="paid")
    paid = router.submit(PROMPTS[2], max_length=8, tenant="paid")
    res = router.drain(max_ticks=400)
    assert router.metrics.snapshot()["preempted"] >= 1
    assert res[paid].finish_reason == "max_length"
    eng = PORT.engine(slots=1)
    rid = eng.submit(PROMPTS[1], max_length=8, seed=5, **kw)
    want = eng.drain()[rid].tokens.tolist()
    assert res[victim].tokens.tolist() == want == streams[victim]


@pytest.mark.parametrize("seed", [0, 1])
def test_preemption_churn_conservation(seed):
    """Random submits and cancels under preemption pressure with a replica
    killed mid-churn (and, for seed 1, a probe flapping): one result each,
    the same results, counters and events as JAX."""
    def run(pkg):
        rng = np.random.default_rng(seed)
        flap = {"probe_flap": "0:2"} if seed else {}
        streams, cb = recorder()
        submitted, prompts = [], {}
        with pkg.faulted(replica_kill=f"1:{6 + seed}", **flap):
            router = pkg.s.ServingRouter(
                [pkg.engine(slots=1, max_queue=1) for _ in range(2)],
                tenants={"paid": policy(pkg, priority=1)},
                probe_every=1, probe_max_failures=4,
                probe_backoff_ticks=1, deadline_s=120.0,
                preempt_risk_frac=0.0)
            for _ in range(40):
                op = int(rng.integers(0, 4))
                if op <= 1 and len(submitted) < 10:
                    p = np.asarray(
                        rng.integers(1, 60, int(rng.integers(2, 6))),
                        np.int32)
                    tn = "paid" if int(rng.integers(0, 2)) else "default"
                    try:
                        rid = router.submit(p, max_length=8, on_token=cb,
                                            tenant=tn)
                    except pkg.s.QueueFull:
                        continue
                    submitted.append(rid)
                    prompts[rid] = p
                elif op == 2 and submitted and int(rng.integers(0, 5)) == 0:
                    router.cancel(int(rng.choice(submitted)))
                router.step()
            res = router.drain(max_ticks=600)
        out = outcome(pkg, router, res, submitted, streams)
        out["complete"] = set(res) == set(submitted)
        out["prompts"] = [prompts[r].tolist() for r in submitted]
        return out

    out = both(run)
    assert_same(out)
    got = out["port"]
    assert got["complete"] and got["events"]["replica_dead"]
    eng = PORT.engine(slots=1)
    one = [eng.submit(np.asarray(p, np.int32), max_length=8)
           for p in got["prompts"]]
    ref = eng.drain()
    for toks, stream, reason, r in zip(got["tokens"], got["streams"],
                                       got["reasons"], one):
        want = ref[r].tokens.tolist()
        if reason == "max_length":
            assert toks == stream == want
        else:
            assert toks == want[:len(toks)]
    if seed:
        assert got["events"]["replica_back"]


def test_autoscaler_scale_up_and_scale_down_by_drain():
    """Sustained backlog spawns a replica through spawn_fn, the fleet
    finishes everything once, and a lull drains one replica back out,
    never below min_replicas; the same decisions as JAX's autoscaler."""
    def run(pkg):
        router = pkg.s.ServingRouter([pkg.engine(slots=1, max_queue=1)],
                                     probe_every=1)
        spawned = []

        def spawn():
            spawned.append(pkg.engine())
            return spawned[-1]

        scaler = pkg.s.FleetAutoscaler(
            router, spawn, min_replicas=1, max_replicas=2,
            high_queue_tokens=2.0, low_queue_tokens=1.0, eval_every=1,
            up_after=2, down_after=3, grace_s=5.0)
        rids = [router.submit(p, max_length=8) for p in PROMPTS * 2]
        actions = []
        done = {}
        for _ in range(600):
            router.step()
            act = scaler.step()
            if act:
                actions.append((router._ticks, act))
            for rid in rids:
                if rid not in done:
                    r = router.take_result(rid)
                    if r is not None:
                        done[rid] = r
            if scaler.scale_downs and not scaler._draining:
                break
        out = outcome(pkg, router, done, rids)
        out["actions"] = actions
        out["snapshot"] = scaler.snapshot()
        return out

    out = both(run)
    assert_same(out)
    got = out["port"]
    assert [a for _, a in got["actions"]] == ["up", "down"]
    assert got["reasons"] == ["max_length"] * 8
    assert sorted(got["states"]) == ["dead", "ok"]
    assert got["events"]["autoscale_up"] == 1


def test_autoscaler_prewarms_a_scaled_up_replica(tmp_path):
    """A replica the autoscaler spawns onto the fleet's shared disk tier
    prewarms the router's hot prefix before it joins: its first request
    with that prefix hits the trie, and its stream is the uncontended
    one."""
    shared = np.arange(1, 25, dtype=np.int32)  # three full pages
    disk = dict(disk_cache_dir=str(tmp_path), disk_cache_bytes=1 << 20,
                num_pages=8)
    first = PORT.engine(**disk)
    router = PORT.s.ServingRouter([first], probe_every=1)
    router.drain()
    rid = router.submit(shared, max_length=4)
    router.drain(max_ticks=200)
    for lo in (30, 36):  # pool pressure spills the warm prefix to disk
        router.submit(np.arange(lo, lo + 24, dtype=np.int32), max_length=4)
    router.drain(max_ticks=200)
    spawned = []
    scaler = PORT.s.FleetAutoscaler(
        router, lambda: spawned.append(PORT.engine(**disk)) or spawned[-1],
        min_replicas=1, max_replicas=2, eval_every=1, up_after=1)
    warmed = []
    prewarm = PORT.s.ServingEngine.prewarm

    def counted(engine, prompt):
        warmed.append(prewarm(engine, prompt))
        return warmed[-1]

    PORT.s.ServingEngine.prewarm = counted
    try:
        assert scaler._scale_up(backlog=1e9) == "up"
    finally:
        PORT.s.ServingEngine.prewarm = prewarm
    assert warmed and warmed[0] >= 16, warmed
    eng = spawned[0]
    rid = eng.submit(shared, max_length=4)
    res = eng.drain()[rid]
    assert eng.metrics.prefix_hits > 0
    ref = PORT.engine(slots=1)
    one = ref.submit(shared, max_length=4)
    assert res.tokens.tolist() == ref.drain()[one].tokens.tolist()
    assert rid is not None and router.replica_states == ["ok", "ok"]
