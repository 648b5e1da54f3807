"""Chunked prefill in the port's serving engine, against the JAX package.

With ``prefill_chunk`` set, a prompt whose non-shared suffix exceeds the
chunk is written one chunk per tick, interleaved with the batched decode.
Chunking only moves WHEN prompt tokens are written, never what anything
computes: greedy streams must equal the unchunked engine's byte for byte
(paged and slot, fp32 and int8 KV) and the JAX chunked engine's. Then the
scheduling contract: at most one prefill-shaped call per tick, one token per
active stream on every tick while a prompt is prefilling, deadlines checked
between chunks, and FIFO order behind a prefilling head.
"""

import numpy as np
import pytest

from torch_serving_cases import (
    jax_engine,
    port_engine,
    prompts,
    serve,
    tokens,
)
from torch_serving_cases import weights as make_weights

CHUNK = 6


@pytest.fixture(scope="module")
def w():
    return make_weights()


@pytest.fixture(scope="module")
def jax_chunked(w):
    """The JAX engine's chunked greedy streams, paged and slot."""
    out = {}
    for paged in (True, False):
        eng = jax_engine(w, paged=paged, prefill_chunk=CHUNK)
        out[paged] = tokens(serve(eng, prompts()))
        assert eng.metrics.prefill_chunks >= 2 * (19 // CHUNK)
    return out


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
@pytest.mark.parametrize("kv", [None, "int8"], ids=["fp32", "int8"])
def test_chunked_equals_unchunked_and_jax_chunked(w, jax_chunked, paged, kv):
    want = tokens(serve(port_engine(w, paged=paged, kv_dtype=kv), prompts()))
    eng = port_engine(w, paged=paged, kv_dtype=kv, prefill_chunk=CHUNK)
    assert tokens(serve(eng, prompts())) == want
    if kv is None:
        assert want == jax_chunked[paged]
    # the 19-, 23- and 9-token prompts ran in chunks (4, 4 and 2 calls)
    assert eng.metrics.prefill_chunks == 10
    assert not eng._prefilling
    assert eng.cache_manager.free_count == eng.slots
    eng.cache_manager.check_invariants()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_chunk_at_the_cache_capacity_edge(w, paged):
    """A prompt of cache_len - 1 tokens: the last chunk's padded bucket
    must stop at the cache's end (an overhanging write would clamp back
    over live prompt K/V and change the sampled token)."""
    prompt = np.random.RandomState(13).randint(0, 61, 47).astype(np.int32)
    kw = dict(paged=paged, slots=1)
    want = tokens(serve(port_engine(w, **kw), [prompt], max_length=1))
    got = tokens(serve(port_engine(w, prefill_chunk=CHUNK, **kw), [prompt],
                       max_length=1))
    assert got == want


def test_chunk_at_or_above_the_prompt_is_one_call(w):
    eng = port_engine(w, prefill_chunk=32)
    rid = eng.submit(np.arange(1, 9, dtype=np.int32), max_length=3)
    summary = eng.step()
    assert summary["admitted"] == 1 and summary["chunked"] == 0
    assert not eng._prefilling
    assert eng.drain()[rid].finish_reason == "max_length"
    assert eng.metrics.prefill_chunks == 0


def _count_prefill_calls(eng):
    """Wrap the executor: the number of prefill-shaped (s > 1) forwards
    since the last read."""
    calls = []
    forward = eng.executor.forward

    def counted(cache, ids, *args, **kw):
        calls.append(ids.shape[1])
        return forward(cache, ids, *args, **kw)

    eng.executor.forward = counted

    def read():
        n = sum(s > 1 for s in calls)
        calls.clear()
        return n

    return read


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_one_prefill_call_and_one_token_per_tick(w, paged):
    """While a long prompt is written chunk by chunk, the active stream
    gains exactly one token every tick, and no tick makes more than one
    prefill-shaped call; the unchunked engine makes three in one tick."""
    eng = port_engine(w, paged=paged, prefill_chunk=CHUNK)
    read = _count_prefill_calls(eng)
    short = eng.submit(np.asarray([1, 2, 3], np.int32), max_length=16)
    eng.step()
    assert read() == 1
    long_rid = eng.submit(np.arange(1, 31, dtype=np.int32), max_length=3)
    eng.submit(np.arange(5, 20, dtype=np.int32), max_length=3)
    req = eng._active[0]
    assert req.id == short
    ticks = 0
    while eng._prefilling or len(eng.scheduler):
        before = len(req.tokens)
        summary = eng.step()
        ticks += 1
        assert len(req.tokens) == before + 1, "a stream stalled"
        assert read() <= 1
        assert summary["chunked"] + summary["admitted"] <= 1
    assert ticks >= 30 // CHUNK + 15 // CHUNK
    res = eng.drain()
    want = tokens(serve(port_engine(w, paged=paged), [
        np.asarray([1, 2, 3], np.int32)], max_length=16))
    assert res[short].tokens.tolist() == want[0]
    assert len(res[long_rid].tokens) == 3
    snap = eng.metrics.snapshot()
    assert snap["prefill_stall_ms_max"] is not None
    unchunked = port_engine(w, paged=paged)
    read = _count_prefill_calls(unchunked)
    for n in (3, 30, 15):
        unchunked.submit(np.arange(1, n + 1, dtype=np.int32), max_length=3)
    unchunked.step()
    assert read() == 3


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_expired_request_stops_burning_chunks(w, paged):
    eng = port_engine(w, paged=paged, prefill_chunk=CHUNK)
    clock = {"t": 0.0}
    eng._now = lambda: clock["t"]
    rid = eng.submit(np.arange(1, 20, dtype=np.int32), max_length=4,
                     deadline_s=5.0)
    eng.step()  # admission and the first chunk
    assert eng._prefilling and not eng._active
    assert eng.metrics.snapshot()["prefill_queue_tokens"] == 19 - CHUNK
    clock["t"] = 10.0
    summary = eng.step()
    assert summary["chunked"] == 0 and summary["timed_out"] == [rid]
    res = eng.drain()
    assert res[rid].finish_reason == "timeout" and not len(res[rid].tokens)
    assert eng.metrics.prefill_chunks == 1
    assert eng.cache_manager.free_count == eng.slots
    eng.cache_manager.check_invariants()
    if paged:
        assert eng.cache_manager.pages_in_use == 0
    rid2 = eng.submit(np.asarray([5, 6, 7], np.int32), max_length=3)
    assert eng.drain()[rid2].finish_reason == "max_length"


def test_cancel_a_prefilling_request(w):
    eng = port_engine(w, paged=False, prefill_chunk=CHUNK)
    rid = eng.submit(np.arange(1, 20, dtype=np.int32), max_length=4)
    eng.step()
    req = eng._prefilling[0]
    assert req.phase == "prefilling" and req.chunk_cache is not None
    assert eng.cancel(rid)
    assert req.chunk_cache is None and req.phase == "finished"
    assert eng.drain()[rid].finish_reason == "cancelled"
    eng.cache_manager.check_invariants()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_fifo_holds_behind_a_chunked_head(w, paged):
    eng = port_engine(w, paged=paged, prefill_chunk=CHUNK, slots=2)
    order = []

    def on_token(rid, tok, finished):
        if rid not in order:
            order.append(rid)

    long_rid = eng.submit(np.arange(1, 20, dtype=np.int32), max_length=3,
                          on_token=on_token)
    short_rid = eng.submit(np.asarray([1, 2], np.int32), max_length=3,
                           on_token=on_token)
    eng.drain()
    assert order == [long_rid, short_rid]
