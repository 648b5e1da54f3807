"""The port's slot-cache serving engine and its admission limits, against
the JAX package.

The slot cache gives each lane one contiguous row (``paged=False`` /
``FLEETX_SERVING_PAGED=0``). Greedy streams of the port's slot engine must
be byte-identical to its paged engine and to the JAX slot engine on the
same weights, at fp32 and at int8 KV. The admission limits — the bounded
queue, the queue TTL, the deadline and ``cancel`` — retire requests as the
JAX engine does, and leave the lanes and pages consistent
(``check_invariants``) after each. The switches once left out (int8
weights, the obs exposition's ``log_every``, a mesh) work beside the
ported ones; what a mesh still refuses names its ROADMAP item.
"""

import numpy as np
import pytest
import torch

from fleetx_tpu_torch.models.gpt.model import GPTForPretraining
from fleetx_tpu_torch.parallel.mesh import Mesh
from fleetx_tpu_torch.serving import (
    QueueFull,
    ServingEngine,
    SlotKVCacheManager,
)
from fleetx_tpu_torch.serving.cache_manager import scatter_slot
from torch_serving_cases import (
    jax_engine,
    port_engine,
    prompts,
    serve,
    tokens,
    weights,
)

MESH_TIERS = "Page tiers and roles under a mesh"
ZERO3 = "ZeRO stage 3 \\(parameter sharding\\)"


@pytest.fixture(scope="module")
def w():
    return weights()


@pytest.fixture(scope="module")
def jax_slot_streams(w):
    """The JAX slot engine's greedy streams and finish reasons, once per
    KV precision."""
    out = {}
    for kv in (None, "int8"):
        res = serve(jax_engine(w, paged=False, kv_dtype=kv), prompts())
        out[kv] = (tokens(res), [r.finish_reason for r in res])
    return out


@pytest.mark.parametrize("kv", [None, "int8"], ids=["fp32", "int8"])
def test_slot_streams_match_paged_and_jax_slot_engine(w, jax_slot_streams,
                                                      kv):
    want, reasons = jax_slot_streams[kv]
    slot = port_engine(w, paged=False, kv_dtype=kv)
    got = serve(slot, prompts())
    assert tokens(got) == want
    assert [r.finish_reason for r in got] == reasons
    assert tokens(serve(port_engine(w, kv_dtype=kv), prompts())) == want
    assert len({t for s in want for t in s}) > 4  # not a degenerate stream
    assert slot.cache_manager.free_count == slot.slots
    slot.cache_manager.check_invariants()
    snap = slot.metrics.snapshot()
    assert snap["prefix_queries"] == 0 and snap["pages_total"] == 0


def test_slot_cache_layout_and_env_switch(w, monkeypatch):
    monkeypatch.setenv("FLEETX_SERVING_PAGED", "0")
    engine = port_engine(w, kv_dtype="int8")
    assert not engine.paged and engine.num_pages == 0
    manager = engine.cache_manager
    assert isinstance(manager, SlotKVCacheManager)
    cfg = engine.model.cfg
    want = (cfg.num_layers, 3, 48, cfg.num_attention_heads, cfg.head_dim)
    assert manager.cache["key"].shape == want
    assert manager.cache["key"].dtype == torch.int8
    assert manager.cache["value_scale"].shape == want[:-1] + (1,)
    nbytes = sum(t.numel() * t.element_size()
                 for t in manager.cache.values() if torch.is_tensor(t))
    assert engine.metrics.snapshot()["kv_cache_bytes"] == nbytes
    # the cache length rounds to the decode kernel's 8-row tile under
    # flash (the port's default), as the JAX engine rounds it
    assert port_engine(w, paged=False, cache_len=45).cache_len == 48


def test_scatter_slot_copies_one_row():
    cache = {"key": torch.zeros(2, 3, 4, 1, 2), "index": 0}
    small = {"key": torch.ones(2, 1, 4, 1, 2), "index": 4}
    scatter_slot(cache, small, 1)
    assert cache["key"][:, 1].eq(1).all()
    assert cache["key"][:, [0, 2]].eq(0).all() and cache["index"] == 0


def test_slot_top_k_1_sampling_equals_greedy(w):
    """A ``top_k=1`` sampling request on the slot path emits the greedy
    stream, through the sampler; seeded sampling repeats."""
    greedy = tokens(serve(port_engine(w, paged=False), prompts()[:2]))
    assert tokens(serve(port_engine(w, paged=False), prompts()[:2],
                        decode_strategy="sampling", top_k=1)) == greedy
    runs = [tokens(serve(port_engine(w, paged=False), prompts()[:2],
                         decode_strategy="sampling", temperature=1.5,
                         seed=s)) for s in (3, 3, 4)]
    assert runs[0] == runs[1] != runs[2]


def test_prefix_cache_switch(w, monkeypatch):
    """``FLEETX_SERVING_PREFIX_CACHE=0``: no prompt page is shared, the
    streams are unchanged."""
    shared = np.concatenate([prompts()[0], [1, 2, 3]]).astype(np.int32)
    ps = [shared, shared]
    on = port_engine(w)
    want = tokens(serve(on, ps))
    assert on.metrics.snapshot()["prefix_hits"] == 1
    monkeypatch.setenv("FLEETX_SERVING_PREFIX_CACHE", "0")
    off = port_engine(w)
    assert not off.prefix_cache and not off.cache_manager.pool.prefix_cache
    assert tokens(serve(off, ps)) == want
    assert off.metrics.snapshot()["prefix_hits"] == 0
    off.cache_manager.check_invariants()


# ------------------------------------------------------- admission limits


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_queue_full_rejects_and_expired_entries_make_room(w, paged):
    engine = port_engine(w, paged=paged, max_queue=2)
    clock = engine._now = Clock()
    p = prompts()
    engine.submit(p[0], max_length=3, queue_ttl_s=1.0)
    engine.submit(p[1], max_length=3)
    with pytest.raises(QueueFull, match="FLEETX_SERVING_MAX_QUEUE"):
        engine.submit(p[2], max_length=3)
    assert engine.metrics.snapshot()["rejected"] == 1
    clock.t = 2.0  # request 0 waited past its TTL: the sweep frees a place
    rid = engine.submit(p[2], max_length=3)
    res = engine.drain()
    assert res[0].finish_reason == "timeout" and not len(res[0].tokens)
    assert res[1].finish_reason == res[rid].finish_reason == "max_length"
    snap = engine.metrics.snapshot()
    assert snap["timeouts"] == 1 and snap["submitted"] == 3
    engine.cache_manager.check_invariants()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_queue_ttl_and_deadline_retire_with_timeout(w, paged, monkeypatch):
    monkeypatch.setenv("FLEETX_SERVING_DEADLINE_S", "5")
    engine = port_engine(w, paged=paged, slots=1)
    assert engine.deadline_s == 5.0
    clock = engine._now = Clock()
    p = prompts()
    a = engine.submit(p[0], max_length=20)
    b = engine.submit(p[1], max_length=3, queue_ttl_s=1.0, deadline_s=0)
    engine.step()  # a admitted and decoding; b waits for the only lane
    clock.t = 2.0
    summary = engine.step()  # b's queue TTL passed
    assert summary["timed_out"] == [b]
    clock.t = 6.0
    summary = engine.step()  # a's deadline passed mid-decode
    assert a in summary["timed_out"] and a in summary["retired"]
    res = engine.drain()
    assert res[a].finish_reason == "timeout" and 3 <= len(res[a].tokens) < 20
    assert res[b].finish_reason == "timeout" and not len(res[b].tokens)
    assert engine.cache_manager.free_count == 1
    engine.cache_manager.check_invariants()
    assert engine.metrics.snapshot()["timeouts"] == 2


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_cancel_queued_and_active(w, paged):
    engine = port_engine(w, paged=paged, slots=1)
    p = prompts()
    a = engine.submit(p[0], max_length=20)
    b = engine.submit(p[1], max_length=3)
    engine.step()
    assert engine.cancel(b)  # still queued
    engine.cache_manager.check_invariants()
    engine.step()
    assert engine.cancel(a)  # decoding: its lane frees at once
    assert engine.cache_manager.free_count == 1
    engine.cache_manager.check_invariants()
    if paged:
        assert engine.cache_manager.pages_in_use == 0
    assert not engine.cancel(a) and not engine.cancel(99)
    c = engine.submit(p[2], max_length=3)
    res = engine.drain()
    assert res[a].finish_reason == res[b].finish_reason == "cancelled"
    assert len(res[a].tokens) == 3 and not len(res[b].tokens)
    assert res[c].finish_reason == "max_length"
    assert engine.metrics.snapshot()["cancels"] == 2
    engine.cache_manager.check_invariants()


def test_limits_off_are_inert(w):
    """No limit set: the same streams as an engine given huge limits."""
    want = tokens(serve(port_engine(w), prompts()))
    assert tokens(serve(port_engine(w, max_queue=100, queue_ttl_s=1e9,
                                    deadline_s=1e9), prompts())) == want


@pytest.mark.parametrize("switch,refused", [
    (dict(host_cache_bytes=1 << 20, weight_dtype="int8"), None),
    (dict(disk_cache_dir="x", log_every=10), None),
    (dict(role="prefill", mesh=Mesh(mp=2)), MESH_TIERS),
    (dict(weight_dtype="int8"), None),
    (dict(mesh=Mesh(fsdp=2, mp=2)), ZERO3),
    (dict(tick_timeout_s=1.0, log_every=5), None),
    (dict(max_recoveries=2, weight_dtype="int8"), None),
    (dict(grace_s=5.0, mesh=Mesh()), None),
    (dict(log_every=10), None)])
def test_left_out_switches_name_their_roadmap_item(w, switch, refused):
    """The switches once left out (int8 weights, ``log_every``, a mesh)
    work, alone or beside a ported one, and the engine serves; what a mesh
    still refuses (a role or the page tiers at mp > 1, an fsdp extent)
    raises naming its ROADMAP item."""
    if refused:
        with pytest.raises(NotImplementedError, match=refused):
            port_engine(w, **switch)
        return
    engine = port_engine(w, **switch)
    assert engine.weight_dtype == switch.get("weight_dtype", "bf16")
    assert engine.log_every == switch.get("log_every", 0)
    assert engine.mesh is switch.get("mesh")
    res = serve(engine, prompts()[:2], max_length=3)
    assert [len(r.tokens) for r in res] == [3, 3]
    snap = engine.metrics.snapshot()
    assert snap["weight_dtype"] == engine.weight_dtype
    assert (snap["mesh_devices"], snap["mesh"]) == (
        (1, "1") if "mesh" in switch else (1, "-"))


# a variable once left out, set beside (or as) the variable of the id
_LEFT_OUT_ENV = {
    "FLEETX_SERVING_HOST_CACHE_BYTES": ("FLEETX_SERVING_LOG_EVERY", "10"),
    "FLEETX_SERVING_ROLE": ("FLEETX_SERVING_WEIGHT_DTYPE", "int8"),
    "FLEETX_SERVING_WEIGHT_DTYPE": ("FLEETX_SERVING_WEIGHT_DTYPE", "int8"),
}


@pytest.mark.parametrize("env", ["FLEETX_SERVING_HOST_CACHE_BYTES",
                                 "FLEETX_SERVING_ROLE",
                                 "FLEETX_SERVING_WEIGHT_DTYPE"])
def test_left_out_variables_name_their_roadmap_item(w, env, monkeypatch):
    """The variables once left out (``FLEETX_SERVING_LOG_EVERY``,
    ``FLEETX_SERVING_WEIGHT_DTYPE``) are read, beside a ported one."""
    monkeypatch.setenv(env, "int8" if "DTYPE" in env else "prefill"
                       if "ROLE" in env else "4096")
    monkeypatch.setenv(*_LEFT_OUT_ENV[env])
    engine = port_engine(w)
    assert engine.log_every == (10 if "HOST" in env else 0)
    assert engine.weight_dtype == ("bf16" if "HOST" in env else "int8")
    assert engine.role == ("prefill" if "ROLE" in env else "both")
    assert engine.metrics.snapshot()["weight_dtype"] == engine.weight_dtype


def test_left_out_methods_name_their_roadmap_item(w):
    """Every method once left out is ported, the periodic log line
    included (``metrics.log_snapshot``, written every ``log_every``
    ticks); an unknown keyword is a TypeError."""
    engine = port_engine(w)
    for name in ("recover", "shutdown", "prefilled_ready", "export_kv",
                 "prewarm", "health", "declare_dead", "generate_batch"):
        assert callable(getattr(engine, name))
    assert engine.prefilled_ready() == [] and engine.recover() == []
    assert callable(engine.metrics.log_snapshot)
    engine.metrics.log_snapshot()
    assert port_engine(w, log_every=10).log_every == 10
    with pytest.raises(TypeError, match="unexpected keyword"):
        port_engine(w, bogus=1)


def test_slot_engine_without_device_needs_cuda(w, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg, params = w
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(GPTForPretraining(cfg, device="meta"), params,
                      paged=False)
