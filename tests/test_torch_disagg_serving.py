"""Prefill/decode roles of the port's engine, with KV shipped as bytes,
against the JAX package.

A prefill-role engine parks each request after its first token;
``export_kv`` ships the pages covering the prompt as wire-format blobs and
a decode-role engine admits them with ``submit(kv_payloads=, history=[t0])``
(no prefill). Greedy streams, at fp32 and int8 KV, equal JAX's colocated
engine's — when the port's prefill role ships to its decode role, and when
JAX's prefill role ships to the port's decode role (K/V computed by the
other package: rounding-different, the same tokens). Sampled streams after
shipping equal the port's colocated run's. Bad roles, bad payloads and a
corrupt ship are refused; an export fault leaves the request parked; a
decode replica recovers its shipped admissions by replay.
"""

import numpy as np
import pytest

from fleetx_tpu_torch.resilience.faults import KVShipFault, faults
from fleetx_tpu_torch.serving import ServingEngine
from fleetx_tpu_torch.serving.cache_manager import HostPageStore
from torch_serving_cases import (
    forced_flash,
    jax_engine,
    port_engine,
    prompts,
    serve,
    tokens,
    weights,
)

KVS = [None, "int8"]


@pytest.fixture(scope="module")
def w():
    return weights()


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def jax_colocated(w):
    """JAX's colocated greedy streams, per KV precision."""
    return {kv: tokens(serve(jax_engine(w, kv_dtype=kv), prompts()))
            for kv in KVS}


def disaggregate(pre, dec, ps, max_length=8, **submit):
    """Serve ``ps`` through a prefill-role engine ``pre`` that ships every
    parked request to the decode-role port engine ``dec``; returns the
    results in prompt order and the blobs shipped per request."""
    int8_jax = (pre.kv_dtype == "int8"
                and not isinstance(pre, ServingEngine))
    rids = [pre.submit(p, max_length=max_length, **submit) for p in ps]
    handed, shipped, results = {}, {}, {}
    while len(results) < len(ps):
        with forced_flash(int8_jax):
            pre.step()
        for erid in pre.prefilled_ready():
            blobs = pre.export_kv(erid)
            stub = pre.take_result(erid)
            assert stub.finish_reason == "prefilled"
            i = rids.index(erid)
            shipped[i] = blobs
            handed[i] = dec.submit(ps[i], max_length=max_length,
                                   history=list(stub.tokens),
                                   kv_payloads=blobs, **submit)
        dec.step()
        for i, drid in list(handed.items()):
            res = dec.take_result(drid)
            if res is not None:
                results[i] = res
                del handed[i]
    return [results[i] for i in range(len(ps))], shipped


@pytest.mark.parametrize("kv", KVS, ids=["fp32", "int8"])
@pytest.mark.parametrize("prefill", ["port", "jax"])
def test_shipped_streams_match_jax_colocated(w, jax_colocated, kv, prefill):
    """Tolerance: greedy tokens byte-equal."""
    make = port_engine if prefill == "port" else jax_engine
    pre = make(w, role="prefill", kv_dtype=kv)
    dec = port_engine(w, role="decode", kv_dtype=kv)
    got, shipped = disaggregate(pre, dec, prompts())
    assert tokens(got) == jax_colocated[kv]
    page = len(HostPageStore.payload_to_bytes(
        dec.cache_manager.read_pages([1])[0]))
    for i, p in enumerate(prompts()):
        assert [len(b) for b in shipped[i]] == [page] * -(-len(p) // 8)
    assert pre.metrics.kv_pages_shipped == dec.metrics.kv_pages_revived_remote
    assert dec.metrics.snapshot()["role"] == "decode"
    dec.cache_manager.check_invariants()
    pre.cache_manager.pool.check_invariants()


def test_shipped_sampling_continues_the_stream(w):
    """Sampled streams after shipping equal the port's colocated run of the
    same seeds: the decode replica moves each stream past t0's draw."""
    kw = dict(decode_strategy="sampling", temperature=0.9, top_k=8,
              top_p=0.9)
    colocated = port_engine(w)
    rids = [colocated.submit(p, max_length=8, seed=100 + i, **kw)
            for i, p in enumerate(prompts())]
    res = colocated.drain()
    want = [res[r].tokens.tolist() for r in rids]
    pre = port_engine(w, role="prefill")
    dec = port_engine(w, role="decode")
    got = []
    for i, p in enumerate(prompts()):
        got += tokens(disaggregate(pre, dec, [p], seed=100 + i, **kw)[0])
    assert got == want


def test_role_and_payload_validation(w):
    with pytest.raises(ValueError, match="role"):
        port_engine(w, role="decoder")
    with pytest.raises(ValueError, match="paged"):
        port_engine(w, role="prefill", paged=False)
    eng = port_engine(w)
    blob = HostPageStore.payload_to_bytes(
        [None, np.zeros((2, 8, 2, 16), np.float32),
         np.zeros((2, 8, 2, 16), np.float32)])
    p = prompts()[1]  # 4 tokens: one page
    with pytest.raises(ValueError, match="history"):
        eng.submit(p, max_length=8, kv_payloads=[blob])
    with pytest.raises(ValueError, match="page"):
        eng.submit(p, max_length=8, history=[1], kv_payloads=[blob, blob])
    with pytest.raises(ValueError, match="history=\\[t0\\]"):
        eng.submit(p, max_length=8, history=[1, 2], kv_payloads=[blob])
    with pytest.raises(ValueError, match="paged"):
        port_engine(w, paged=False).submit(p, max_length=8, history=[1],
                                           kv_payloads=[blob])
    with pytest.raises(KeyError, match="not parked"):
        eng.export_kv(12345)
    # payloads that do not fit the pool are refused, never scattered
    unrolled = HostPageStore.payload_to_bytes(
        [None, np.zeros((8, 2, 16), np.float32),
         np.zeros((8, 2, 16), np.float32)] * 2)
    wide = HostPageStore.payload_to_bytes(
        [None, np.zeros((2, 8, 4, 16), np.float32),
         np.zeros((2, 8, 4, 16), np.float32)])
    int8 = HostPageStore.payload_to_bytes(
        [None, np.zeros((2, 8, 2, 16), np.int8),
         np.zeros((2, 8, 2, 1), np.float32),
         np.zeros((2, 8, 2, 16), np.int8),
         np.zeros((2, 8, 2, 1), np.float32)])
    for bad in (unrolled, wide, int8):
        with pytest.raises(ValueError, match="leaves|pool"):
            eng.submit(p, max_length=8, history=[1], kv_payloads=[bad])
    assert eng.scheduler.queue_depth == 0


def test_corrupt_ship_refused_and_export_fault_keeps_parked(w):
    pre = port_engine(w, role="prefill")
    dec = port_engine(w, role="decode")
    p = prompts()[0]
    rid = pre.submit(p, max_length=8)
    pre.step()
    assert pre.prefilled_ready() == [rid]
    faults.configure(kv_ship_raise="0", kv_ship_corrupt="1")
    with pytest.raises(KVShipFault):
        pre.export_kv(rid)
    assert pre.prefilled_ready() == [rid]  # still parked
    blobs = pre.export_kv(rid)  # attempt 1: one byte flipped
    stub = pre.take_result(rid)
    with pytest.raises(ValueError, match="crc32"):
        dec.submit(p, max_length=8, history=list(stub.tokens),
                   kv_payloads=blobs)
    assert dec.scheduler.queue_depth == 0
    # the fallback: replay on the decode replica from the history alone
    drid = dec.submit(p, max_length=8, history=list(stub.tokens))
    got = dec.drain()[drid].tokens.tolist()
    assert got == tokens(serve(port_engine(w), [p]))[0]


def test_decode_replica_recovers_shipped_admissions(w, jax_colocated):
    faults.configure(tick_raise="2")
    got, _ = disaggregate(port_engine(w, role="prefill"),
                          dec := port_engine(w, role="decode"), prompts())
    assert dec.metrics.engine_recoveries == 1
    assert tokens(got) == jax_colocated[None]
    dec.cache_manager.pool.check_invariants()


def test_prefill_replica_recovers_parked_requests(w, jax_colocated):
    """A recovery on the prefill role replays its parked requests, which
    stay parked and export the same pages."""
    pre = port_engine(w, role="prefill")
    rids = [pre.submit(p, max_length=8) for p in prompts()[:3]]
    pre.step()
    assert pre.prefilled_ready() == rids
    before = {r: pre.export_kv(r) for r in rids[:1]}
    pre.recover()
    assert pre.prefilled_ready() == rids[1:]
    dec = port_engine(w, role="decode")
    shipped = {rids[0]: before[rids[0]]}
    shipped.update({r: pre.export_kv(r) for r in rids[1:]})
    for i, r in enumerate(rids):
        pre.take_result(r)
        drid = dec.submit(prompts()[i], max_length=8,
                          history=[jax_colocated[None][i][0]],
                          kv_payloads=shipped[r])
        assert dec.drain()[drid].tokens.tolist() == jax_colocated[None][i]
