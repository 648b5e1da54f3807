"""The engine-protocol battery of ``tests/test_protocol.py`` over the port's
three engine kinds: ``ServingEngine`` (GPT), ``ErnieScoringEngine`` and
``EmbeddingEngine`` (ViT, embedding mode), all on the CPU.

Every behaviour the router and the front door rely on holds for each kind:
the surface, the health report with the model family and capabilities,
``submit_limit``, the bounded queue, queue-TTL and deadline shedding,
cancel, drain and the metrics snapshot. The results are held against the
JAX engines on the same weights: ERNIE ids equal, ViT vectors within 2e-5
(``torch_encoder_cases.TOL``: the port's attention is the flash forward's
plain version, JAX's its dense path). The same request twice gives equal
tokens within one batch; across batch makeup (a lone request against two
in one bucket) ERNIE ids are equal and ViT vectors agree within
``BATCH_MAKEUP_TOL`` (the GEMMs of two row counts may round apart).
"""

import numpy as np
import pytest

import fleetx_tpu.serving as jax_serving
from fleetx_tpu_torch.serving import (
    ENGINE_SURFACE,
    EmbeddingEngine,
    ErnieScoringEngine,
    QueueFull,
    ShuttingDown,
    decode_floats,
    encode_floats,
    engine_conforms,
)
from torch_encoder_cases import IMAGE, TOL, ernie_pair, vit_pair
from torch_router_cases import w
from torch_serving_cases import port_engine

KINDS = ("gpt", "ernie", "vit")
# ViT vectors of one image in buckets of 1 and 2 rows, fp32 on the CPU
BATCH_MAKEUP_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def zoo():
    return {"ernie": ernie_pair(seed=0), "vit": vit_pair(seed=1)}


def _make(zoo, kind, **kw):
    """A fresh port engine of ``kind`` (2 slots unless given)."""
    kw.setdefault("slots", 2)
    if kind == "gpt":
        return port_engine(w(), cache_len=32, **kw)
    _, _, port = zoo[kind]
    cls = ErnieScoringEngine if kind == "ernie" else EmbeddingEngine
    # each engine loads its own copy of the weights onto the device
    model = type(port)(port.cfg, device="meta")
    return cls(model, port.state_dict(), device="cpu", **kw)


def _jax(zoo, kind, **kw):
    model, tree, _ = zoo[kind]
    cls = (jax_serving.ErnieScoringEngine if kind == "ernie"
           else jax_serving.EmbeddingEngine)
    return cls(model, tree, slots=kw.pop("slots", 2), **kw)


def _prompt(kind, salt=0):
    if kind == "gpt":
        return np.asarray([1 + salt, 2, 3], np.int32)
    if kind == "ernie":
        return np.asarray([5 + salt, 3, 9, 11], np.int32)  # mask id 3
    rng = np.random.RandomState(7 + salt)
    return encode_floats(rng.rand(*IMAGE).astype(np.float32))


@pytest.fixture(params=KINDS)
def kind(request):
    return request.param


def test_surface_conforms(zoo, kind):
    eng = _make(zoo, kind)
    assert engine_conforms(eng, require_attrs=True) is None
    for name in ENGINE_SURFACE:
        assert callable(getattr(eng, name)), name


def test_health_report_shape(zoo, kind):
    eng = _make(zoo, kind)
    h = eng.health()
    for key in ("state", "role", "model", "capabilities", "queue_depth",
                "queue_tokens", "active", "slots"):
        assert key in h, (kind, key)
    assert h["state"] == "ok" and h["model"] == kind
    caps = h["capabilities"]
    assert caps["family"] == kind
    assert caps["emits"] == ("floats" if kind == "vit" else "tokens")
    assert caps["has_kv_cache"] is (kind == "gpt")
    if kind != "gpt":
        assert caps["cache_layout"] == "none" and not caps["supports_spec"]
        assert caps == _jax(zoo, kind).capabilities.as_dict()
    eng.request_shutdown()
    assert eng.health()["state"] == "draining"
    eng.drain()
    eng2 = _make(zoo, kind)
    eng2.declare_dead()
    assert eng2.health()["state"] == "dead"


def test_submit_limit_is_the_rejection_bound(zoo, kind):
    eng = _make(zoo, kind)
    lim = eng.submit_limit
    assert isinstance(lim, int) and lim > 1
    with pytest.raises(ValueError):
        eng.submit(np.ones(lim, np.int32))
    if kind != "gpt":
        assert lim == _jax(zoo, kind).submit_limit
        with pytest.raises(ValueError, match="no KV cache"):
            eng.submit(_prompt(kind), kv_payloads=[b""])


def test_bounded_queue_rejects(zoo, kind):
    eng = _make(zoo, kind, max_queue=1)
    eng.submit(_prompt(kind))
    with pytest.raises(QueueFull):
        eng.submit(_prompt(kind, salt=1))
    assert eng.metrics.snapshot()["rejected"] >= 1
    eng.drain()


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_queue_ttl_sheds_to_timeout(zoo, kind):
    eng = _make(zoo, kind, slots=1)
    clock = eng._now = Clock()
    ra = eng.submit(_prompt(kind))
    eng.step()
    rb = eng.submit(_prompt(kind, salt=1), queue_ttl_s=1.0)
    clock.t += 5.0
    eng.step()
    res = eng.drain()
    assert res[rb].finish_reason == "timeout" and not len(res[rb].tokens)
    assert res[ra].finish_reason in ("max_length", "complete")
    assert len(res[ra].tokens) > 0


def test_deadline_sheds_to_timeout(zoo, kind):
    eng = _make(zoo, kind)
    clock = eng._now = Clock()
    rid = eng.submit(_prompt(kind), deadline_s=1.0)
    clock.t += 5.0
    eng.step()
    assert eng.drain()[rid].finish_reason == "timeout"


def test_cancel_is_terminal_and_idempotent(zoo, kind):
    eng = _make(zoo, kind)
    ra = eng.submit(_prompt(kind))
    rb = eng.submit(_prompt(kind, salt=1))
    assert eng.cancel(rb) is True
    assert eng.cancel(rb) is False
    res = eng.drain()
    assert res[rb].finish_reason == "cancelled" and not len(res[rb].tokens)
    assert res[ra].finish_reason in ("max_length", "complete")
    assert eng.cancel(ra) is False


def test_drain_rejects_new_and_terminates_inflight(zoo, kind):
    eng = _make(zoo, kind)
    rids = [eng.submit(_prompt(kind, salt=i)) for i in range(3)]
    eng.request_shutdown()
    with pytest.raises(ShuttingDown):
        eng.submit(_prompt(kind, salt=9))
    res = eng.drain()
    for rid in rids:
        assert res[rid].finish_reason in ("max_length", "complete",
                                          "shutdown", "timeout")


def test_metrics_snapshot_shape(zoo, kind):
    eng = _make(zoo, kind)
    rids = [eng.submit(_prompt(kind, salt=i)) for i in range(2)]
    res = eng.drain()
    assert all(len(res[r].tokens) > 0 for r in rids)
    m = eng.metrics.snapshot()
    for key in ("submitted", "admitted", "retired", "rejected", "timeouts",
                "cancels", "tokens_generated", "ticks", "queue_depth",
                "slots", "ttft_ms_p50"):
        assert key in m, (kind, key)
    assert m["submitted"] == m["admitted"] == m["retired"] == 2
    assert m["tokens_generated"] > 0 and m["queue_depth"] == 0


def _serve(eng, prompts):
    rids = [eng.submit(p) for p in prompts]
    res = eng.drain()
    assert all(res[r].finish_reason == "complete" for r in rids)
    return [np.asarray(res[r].tokens) for r in rids]


@pytest.mark.parametrize("family", ["ernie", "vit"])
def test_results_equal_jax_engines(zoo, family):
    """Fill-in-blank, scoring and embedding answers against the JAX
    engines on the same weights and requests (five requests over two
    ticks of a 4-slot engine, so the buckets hold 4 and 1 rows)."""
    if family == "ernie":
        rng = np.random.RandomState(11)
        prompts = []
        for n, masks in ((4, 1), (9, 2), (17, 0), (30, 3), (2, 0)):
            p = rng.randint(4, 97, n).astype(np.int32)
            p[rng.choice(n, masks, replace=False)] = 3
            prompts.append(p)
    else:
        prompts = [_prompt("vit", salt=i) for i in range(5)]
    got = _serve(_make(zoo, family, slots=4), prompts)
    want = _serve(_jax(zoo, family, slots=4), prompts)
    if family == "ernie":
        assert [g.tolist() for g in got] == [x.tolist() for x in want]
        assert [len(g) for g in got] == [1, 2, 1, 3, 1]
    else:
        for g, x in zip(got, want):
            assert g.size == 32
            np.testing.assert_allclose(decode_floats(g), decode_floats(x),
                                       **TOL)


def test_results_are_exact_and_deterministic(zoo, kind):
    """The same request twice in one batch gives equal tokens; against a
    lone request (another bucket) ERNIE and GPT tokens are equal and ViT
    vectors agree within BATCH_MAKEUP_TOL."""
    eng = _make(zoo, kind)
    r1 = eng.submit(_prompt(kind))
    r2 = eng.submit(_prompt(kind))
    res = eng.drain()
    assert np.array_equal(res[r1].tokens, res[r2].tokens)
    eng2 = _make(zoo, kind)
    r3 = eng2.submit(_prompt(kind))
    lone = eng2.drain()[r3].tokens
    if kind == "vit":
        np.testing.assert_allclose(decode_floats(lone),
                                   decode_floats(res[r1].tokens),
                                   **BATCH_MAKEUP_TOL)
    else:
        assert np.array_equal(lone, res[r1].tokens)
