"""The port's router over prefill- and decode-role engines against the JAX
package's: ``tests/test_serving_disagg.py``'s router half.

Fresh prompts land on the prefill replica, finished prefills hand their
pages to the decode replica, and the streams equal a colocated fleet's;
every rung of the fallback ladder (an export fault, a corrupt ship caught
by the crc at the decode replica's submit, the prefill replica killed)
replays to the same bytes; a fleet without roles makes no handoff. Each
through both packages' routers over their own engines (chunked prefill of
4, pages of 8) on the same weights, with equal tokens, counters and
router events.
"""

import numpy as np
import pytest

from torch_router_cases import assert_same, both, clean, outcome

PROMPTS = [np.asarray([1, 2, 3], np.int32),
           np.asarray([4, 5, 6, 7, 8], np.int32),
           np.asarray([9, 10], np.int32),
           np.asarray([11, 12, 13, 14, 15, 16, 17, 18, 19], np.int32)]
DISAGG = dict(slots=3, prefill_chunk=4)


@pytest.fixture(autouse=True)
def _clean():
    clean(None)
    yield
    clean(None)


def run_router(pkg, router):
    rids = [router.submit(p, max_length=8) for p in PROMPTS]
    res = router.drain(max_ticks=500)
    return outcome(pkg, router, res, rids)


def disagg(pkg, **kw):
    return pkg.s.ServingRouter(
        [pkg.engine(role="prefill", **DISAGG),
         pkg.engine(role="decode", **DISAGG)], base_seed=3, **kw)


@pytest.fixture(scope="module")
def colocated():
    out = both(lambda pkg: run_router(pkg, pkg.s.ServingRouter(
        [pkg.engine(**DISAGG), pkg.engine(**DISAGG)], base_seed=3)))
    assert_same(out)
    return out["port"]["tokens"]


def test_router_disagg_parity_roles_and_health(colocated):
    def run(pkg):
        router = disagg(pkg)
        pre, dec = (r.engine for r in router._replicas)
        out = run_router(pkg, router)
        out["roles"] = [r.role for r in router._replicas]
        out["shipped"] = (pre.metrics.kv_pages_shipped,
                          dec.metrics.kv_pages_revived_remote)
        h = pre.health()
        out["health"] = (h["role"], "queue_tokens" in h,
                         dec.health()["role"])
        return out

    out = both(run)
    assert_same(out)
    got = out["port"]
    assert got["tokens"] == colocated
    assert got["roles"] == ["prefill", "decode"]
    assert got["shipped"][0] > 0 and got["shipped"][0] == got["shipped"][1]
    assert got["health"] == ("prefill", True, "decode")
    assert got["events"]["request_handoff"] == len(PROMPTS)


@pytest.mark.parametrize("plan,where", [
    (dict(kv_ship_raise="1"), "export"),
    (dict(kv_ship_corrupt="0"), "admit"),
    (dict(replica_kill="0:3"), None)],
    ids=["export-fault", "corrupt-ship", "prefill-killed"])
def test_router_fallback_ladder(colocated, plan, where):
    """Each rung degrades to replay, never to other bytes."""
    def run(pkg):
        kw = {"probe_max_failures": 1} if "replica_kill" in plan else {}
        with pkg.faulted(**plan):
            out = run_router(pkg, disagg(pkg, **kw))
        out["where"] = sorted({e.attrs.get("where") for e in
                               pkg.events().find("kv_ship_failed")})
        return out

    out = both(run)
    assert_same(out)
    got = out["port"]
    assert got["tokens"] == colocated
    if where is None:
        assert got["states"][0] == "dead" and got["events"]["replica_dead"]
    else:
        assert where in got["where"]


def test_router_all_roles_colocated_unchanged(colocated):
    def run(pkg):
        engines = [pkg.engine(**DISAGG), pkg.engine(**DISAGG)]
        router = pkg.s.ServingRouter(engines, base_seed=5)
        rids = [router.submit(p, max_length=8) for p in PROMPTS]
        handoffs = 0
        while any(router.result(r) is None for r in rids):
            handoffs += router.step().get("handoff", 0)
        res = {r: router.result(r) for r in rids}
        out = outcome(pkg, router, res, rids)
        out["handoffs"] = handoffs
        out["shipped"] = [e.metrics.kv_pages_shipped for e in engines]
        return out

    out = both(run)
    assert_same(out)
    assert out["port"]["handoffs"] == 0
    assert out["port"]["shipped"] == [0, 0]
    assert out["port"]["tokens"] == colocated
