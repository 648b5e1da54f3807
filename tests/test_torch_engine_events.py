"""The serving engine's whole event log against JAX's.

Each scenario runs once through a port engine and once through a JAX engine
on the same bridged weights (``torch_serving_cases.weights``) with the same
switches, and the two event logs must be equal event for event, attributes
included (``torch_router_cases.event_log``: engine labels by order of first
appearance). The scenarios reach every event the engine emits outside the
fleet and recovery paths: a rejected submit, a drain, cancels, queue and
active timeouts, speculative decoding, a dry page pool and a raising
callback.
"""

import numpy as np
import pytest

from torch_router_cases import both, event_log, w
from torch_serving_cases import prompts, serve


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _reasons(res, rids):
    return [(res[r].finish_reason, [int(t) for t in res[r].tokens])
            for r in rids]


def rejected_submit(pkg):
    eng = pkg.engine(max_queue=1)
    p = prompts()
    rid = eng.submit(p[0], max_length=3)
    with pytest.raises(pkg.s.QueueFull):
        eng.submit(p[1], max_length=3)
    return _reasons(eng.drain(), [rid])


def drain(pkg):
    eng = pkg.engine()
    p = prompts()
    rids = [eng.submit(q, max_length=6) for q in p[:2]]
    eng.step()
    eng.request_shutdown(grace_s=30.0)
    with pytest.raises(pkg.s.ShuttingDown):
        eng.submit(p[2], max_length=3)
    return _reasons(eng.shutdown(), rids)


def cancel(pkg):
    eng = pkg.engine(slots=1)
    p = prompts()
    a = eng.submit(p[0], max_length=10)
    b = eng.submit(p[1], max_length=10)
    eng.step()  # a holds the only lane, b waits
    assert eng.cancel(b) and eng.cancel(a) and not eng.cancel(a)
    return _reasons(eng.drain(), [a, b])


def timeouts(pkg):
    eng = pkg.engine(slots=1)
    clock = eng._now = Clock()
    p = prompts()
    a = eng.submit(p[0], max_length=20, deadline_s=5.0)
    b = eng.submit(p[1], max_length=3, queue_ttl_s=1.0)
    eng.step()
    clock.t = 2.0  # b's queue TTL passed
    eng.step()
    clock.t = 6.0  # a's deadline passed mid-decode
    eng.step()
    return _reasons(eng.drain(), [a, b])


def spec(pkg):
    eng = pkg.engine(spec=True, spec_k=3)
    p = [np.tile(np.asarray([3, 5, 7], np.int32), 4), prompts()[1]]
    return [(r.finish_reason, r.tokens.tolist())
            for r in serve(eng, p, max_length=10)]


def cache_full(pkg):
    eng = pkg.engine(slots=2, cache_len=32, num_pages=7, prefix_cache=False)
    p = [np.arange(1, 8, dtype=np.int32), np.arange(10, 17, dtype=np.int32)]
    out = [(r.finish_reason, r.tokens.tolist())
           for r in serve(eng, p, max_length=20)]
    assert "cache_full" in {reason for reason, _ in out}
    return out


def callback_error(pkg):
    eng = pkg.engine()
    p = prompts()

    def raising(rid, tok, fin):
        raise RuntimeError("callback bug")

    a = eng.submit(p[0], max_length=6, on_token=raising)
    b = eng.submit(p[1], max_length=6)
    return _reasons(eng.drain(), [a, b])


SCENARIOS = [rejected_submit, drain, cancel, timeouts, spec, cache_full,
             callback_error]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_engine_event_log_equals_jax(scenario):
    def run(pkg):
        return {"results": scenario(pkg), "log": event_log(pkg)}

    out = both(run)
    port, jax = out["port"], out["jax"]
    assert port["results"] == jax["results"]
    assert port["log"] == jax["log"], (port["log"], jax["log"])
    assert port["log"], "the scenario emitted no event"


def test_recovery_counts_only_decoding_lanes_as_replayed():
    """``engine_recovery``'s ``replayed`` is the decode lanes in use after
    the rebuild, as JAX counts it: a parked request of a prefill-role
    engine replays but is not counted."""
    def run(pkg):
        eng = pkg.engine(role="prefill")
        p = prompts()
        rids = [eng.submit(q, max_length=6) for q in p[:2]]
        eng.step()
        eng.step()
        eng.recover()
        ev = pkg.events().last("engine_recovery")
        return [len(eng.prefilled_ready()), ev.attrs["replayed"], len(rids)]

    out = both(run)
    assert out["port"] == out["jax"]
    assert out["port"][0] > 0 and out["port"][1] == 0
