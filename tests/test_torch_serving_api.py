"""The port's front door and replica RPC against the JAX package's
``serving/api``.

- The wire: KV blobs and results round-trip, and a result dict written by
  JAX's ``result_to_wire`` decodes in the port to the same fields; the
  error kinds cross as themselves.
- ``ApiServer``: SSE and JSON bodies equal JAX's server's over JAX's engine
  on the same weights (ids and timestamps normalised); a seeded sampled
  SSE stream equals the port engine's; the 4xx table, ``/v1/models`` and
  the ``/v1/embeddings`` refusals equal JAX's; ``/healthz`` for an engine
  and a router target; the ``fleetx_api_*`` families equal JAX's.
- The replica RPC: a router over ``ReplicaClient``s decodes the engine's
  streams and migrates off a stopped replica server with no token lost,
  as JAX's does; the KV handoff over HTTP; the unreachable mapping; typed
  errors; the ``rpc_drop``/``rpc_delay`` injectors.
"""

import gc
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from fleetx_tpu.obs import get_registry as jax_registry
from fleetx_tpu.serving.api import wire as jax_wire
from fleetx_tpu.serving.api.replica_client import (
    ReplicaClient as JaxReplicaClient,
)
from fleetx_tpu.serving.api.replica_server import (
    ReplicaServer as JaxReplicaServer,
)
from fleetx_tpu.serving.api.server import ApiServer as JaxApiServer
from fleetx_tpu_torch.obs import get_registry
from fleetx_tpu_torch.resilience.faults import (
    FaultPlan,
    ReplicaKilled,
    RPCFault,
)
from fleetx_tpu_torch.serving import QueueFull, ServingResult, ShuttingDown
from fleetx_tpu_torch.serving.api import wire
from fleetx_tpu_torch.serving.api.replica_client import ReplicaClient
from fleetx_tpu_torch.serving.api.replica_server import ReplicaServer
from fleetx_tpu_torch.serving.api.server import ApiServer
from torch_router_cases import PORT, assert_same, both, clean, outcome

PROMPTS = [np.asarray([1, 2, 3], np.int32),
           np.asarray([4, 5, 6, 7, 8], np.int32),
           np.asarray([9, 10], np.int32)]
API_ENGINE = dict(slots=3)
SAMPLED = dict(decode_strategy="sampling", temperature=0.7, top_p=0.9,
               seed=123)
SERVERS = {"port": (ApiServer, ReplicaServer, ReplicaClient),
           "jax": (JaxApiServer, JaxReplicaServer, JaxReplicaClient)}


@pytest.fixture(autouse=True)
def _clean():
    clean(None)
    yield
    clean(None)
    gc.collect()  # engines parked draining drop their health probes


@pytest.fixture(scope="module")
def ref_tokens():
    """The port engine's greedy tokens for PROMPTS and its seeded sampled
    stream for PROMPTS[1]."""
    eng = PORT.engine(**API_ENGINE)
    rids = [eng.submit(p) for p in PROMPTS]
    srid = eng.submit(PROMPTS[1], **SAMPLED)
    res = eng.drain()
    return ([res[r].tokens.tolist() for r in rids],
            res[srid].tokens.tolist())


def _post(url, body):
    req = urllib.request.Request(url, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=60)


def _sse_chunks(resp):
    out = []
    for line in resp:
        line = line.decode().strip()
        if line.startswith("data: "):
            out.append(line[6:] if line[6:] == "[DONE]"
                       else json.loads(line[6:]))
    return out


def _normal(body):
    """Drop what may differ between two servers: timestamps and ids."""
    if isinstance(body, dict):
        return {k: _normal(v) for k, v in body.items()
                if k not in ("created", "id")}
    if isinstance(body, list):
        return [_normal(v) for v in body]
    return body


# ---------------------------------------------------------------- wire


def test_wire_blobs_and_results_round_trip():
    blobs = [b"\x00\xffpage0", b"page1\x01"]
    assert wire.b64_blobs_decode(wire.b64_blobs_encode(blobs)) == blobs
    assert wire.b64_blobs_encode(blobs) == jax_wire.b64_blobs_encode(blobs)
    assert wire.b64_blobs_encode(None) is None
    res = ServingResult(id=3, prompt=np.asarray([1, 2], np.int32),
                        tokens=np.asarray([4, 5, 6], np.int32),
                        finish_reason="eos", ttft_s=0.5, latency_s=1.5)
    d = json.loads(json.dumps(wire.result_to_wire(res)))
    back = wire.result_from_wire(d)
    assert (back.id, back.finish_reason, back.ttft_s, back.latency_s) == (
        3, "eos", 0.5, 1.5)
    assert back.tokens.tolist() == [4, 5, 6] and back.prompt.dtype == np.int32
    assert wire.result_to_wire(None) is None


def test_jax_written_result_decodes_in_the_port():
    """The result dict is the wire contract: JAX's ``result_to_wire``
    output, through JSON, decodes to the same fields in the port, and the
    port writes JAX's dict."""
    from fleetx_tpu.serving import ServingResult as JaxResult

    jres = JaxResult(id=7, prompt=np.asarray([9, 8, 7], np.int32),
                     tokens=np.asarray([1, 2], np.int32),
                     finish_reason="max_length", ttft_s=0.25,
                     latency_s=0.75)
    d = json.loads(json.dumps(jax_wire.result_to_wire(jres)))
    got = wire.result_from_wire(d)
    for field in ("id", "finish_reason", "ttft_s", "latency_s"):
        assert getattr(got, field) == getattr(jres, field), field
    np.testing.assert_array_equal(got.tokens, jres.tokens)
    np.testing.assert_array_equal(got.prompt, jres.prompt)
    assert wire.result_to_wire(got) == d


def test_wire_error_kinds_round_trip():
    assert wire.kind_for_exception(QueueFull("x")) == "queue_full"
    assert wire.kind_for_exception(ShuttingDown("x")) == "shutting_down"
    assert wire.kind_for_exception(ValueError("x")) == "value_error"
    assert wire.kind_for_exception(KeyError("x")) == "key_error"
    assert wire.kind_for_exception(RuntimeError("x")) == "internal"
    for kind, exc in (("queue_full", QueueFull),
                      ("shutting_down", ShuttingDown),
                      ("value_error", ValueError),
                      ("no_such_kind", RuntimeError)):
        with pytest.raises(exc):
            wire.raise_for_kind(kind, "m")
    # the same kind strings as JAX's table
    assert set(wire._kinds()) == set(jax_wire._kinds())


# ------------------------------------------------------------ API layer


def _completions(api_url):
    """Every body of the parity traffic, in order."""
    bodies = []
    chat = {"messages": [{"role": "user", "content": "1 2 3"}]}
    with _post(api_url + "/v1/chat/completions",
               dict(chat, stream=True)) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        bodies.append(_sse_chunks(r))
    with _post(api_url + "/v1/chat/completions", chat) as r:
        bodies.append(json.loads(r.read()))
    with _post(api_url + "/v1/completions",
               {"prompt": "4 5 6 7 8", "stream": True,
                "max_tokens": 6}) as r:
        bodies.append(_sse_chunks(r))
    with _post(api_url + "/v1/completions",
               {"prompt": [9, 10], "max_tokens": 5,
                "temperature": 0}) as r:
        bodies.append(json.loads(r.read()))
    return bodies


def test_sse_and_json_bodies_equal_jax(ref_tokens):
    """The same requests through both packages' ``ApiServer`` over their
    own engine: SSE chunks and JSON bodies equal but for ids and
    timestamps, and the streamed tokens are the engine's."""
    def run(pkg):
        api = SERVERS[pkg.name][0](pkg.engine(**API_ENGINE),
                                   model_id="m").start()
        try:
            return _normal(_completions(api.url))
        finally:
            api.stop()

    out = both(run)
    assert out["port"] == out["jax"]
    sse = out["port"][0]
    assert sse[-1] == "[DONE]"
    assert [c["token"] for c in sse if "token" in c] == ref_tokens[0][0]
    assert out["port"][1]["tokens"] == ref_tokens[0][0]
    assert out["port"][1]["choices"][0]["finish_reason"] == "length"


def test_seeded_sampled_sse_equals_the_engine(ref_tokens):
    api = ApiServer(PORT.engine(**API_ENGINE), model_id="m").start()
    try:
        with _post(api.url + "/v1/completions",
                   {"prompt": "4 5 6 7 8", "stream": True,
                    "temperature": 0.7, "top_p": 0.9, "seed": 123}) as r:
            chunks = _sse_chunks(r)
    finally:
        api.stop()
    assert [c["token"] for c in chunks if "token" in c] == ref_tokens[1]


CASES_4XX = [
    ("/v1/chat/completions", {}),
    ("/v1/chat/completions", {"messages": []}),
    ("/v1/chat/completions", {"messages": ["hi"]}),
    ("/v1/chat/completions",
     {"messages": [{"role": "user", "content": "not ids"}]}),
    ("/v1/completions", {}),
    ("/v1/completions", {"prompt": ""}),
    ("/v1/completions", {"prompt": "1 2", "temperature": -1}),
    ("/v1/completions", {"prompt": "1 2", "top_p": 0}),
    ("/v1/completions", {"prompt": "1 2", "top_p": 1.5}),
    ("/v1/completions", {"prompt": "1 2", "top_k": 0}),
    ("/v1/completions", {"prompt": "1 2", "max_tokens": 0}),
    ("/v1/completions", {"prompt": "1 2", "max_tokens": "8"}),
    ("/v1/completions", {"prompt": "1 2", "n": 2}),
    ("/v1/completions", {"prompt": "1 2", "seed": "abc"}),
    ("/v1/completions", {"prompt": "1 2", "stream": "yes"}),
    ("/v1/completions", {"prompt": " ".join(["1"] * 99)}),
    ("/v1/chat/completions",
     {"model": "gpt-4", "messages": [{"role": "user", "content": "1"}]}),
    ("/v1/embeddings", {"input": "1"}),
    ("/v1/embeddings", {"input": [0.5, 1.5], "model": "vit"}),
    ("/v1/nowhere", {}),
]


def _refusals(api_url):
    out = []
    for path, body in CASES_4XX:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(api_url + path, body)
        err = json.loads(ei.value.read())["error"]
        out.append((ei.value.code, err["type"], err["code"],
                    err["message"]))
    req = urllib.request.Request(api_url + "/v1/completions", b"{not json",
                                 {"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    out.append((ei.value.code,))
    with urllib.request.urlopen(api_url + "/v1/models", timeout=30) as r:
        out.append(_undated(json.loads(r.read())))
    return out


def _undated(models):
    """A ``/v1/models`` body without its timestamps."""
    return dict(models, data=[{k: v for k, v in m.items() if k != "created"}
                              for m in models["data"]])


def test_4xx_table_models_and_embeddings_equal_jax():
    """Every malformed request gets JAX's status and error type; the
    embeddings refusals of a fleet without a float-out family are JAX's
    messages; ``/v1/models`` lists the same."""
    def run(pkg):
        api = SERVERS[pkg.name][0](pkg.engine(**API_ENGINE),
                                   model_id="fleetx-test").start()
        try:
            return _refusals(api.url)
        finally:
            api.stop()

    out = both(run)
    port, jax = out["port"], out["jax"]
    assert len(port) == len(jax)
    for (path, _), a, b in zip(CASES_4XX, port, jax):
        assert a[:3] == b[:3], (path, a, b)
        if "/v1/nowhere" not in path and "99" not in str(a[3]):
            assert a[3] == b[3], (path, a, b)
    assert port[-2:] == jax[-2:]
    assert [m["id"] for m in port[-1]["data"]] == ["fleetx-test"]


def test_models_and_healthz_over_a_router():
    """A router target: ``/v1/models`` derives one entry per model group,
    ``/healthz`` aggregates the replica states, as JAX's server does; an
    engine target turns 503 draining on ``request_shutdown``."""
    def run(pkg):
        eng = pkg.engine(**API_ENGINE)
        router = pkg.s.ServingRouter([pkg.engine(**API_ENGINE),
                                      pkg.engine(**API_ENGINE)])
        got = []
        for target in (router, eng):
            api = SERVERS[pkg.name][0](target, model_id="m").start()
            try:
                with urllib.request.urlopen(api.url + "/v1/models",
                                            timeout=30) as r:
                    got.append(_undated(json.loads(r.read())))
                with urllib.request.urlopen(api.url + "/healthz",
                                            timeout=30) as r:
                    body = json.loads(r.read())
                got.append({k: body[k] for k in ("state", "replicas")
                            if k in body})
                if target is eng:
                    eng.request_shutdown(0.0)
                    with pytest.raises(urllib.error.HTTPError) as ei:
                        urllib.request.urlopen(api.url + "/healthz",
                                               timeout=30)
                    got.append((ei.value.code,
                                json.loads(ei.value.read())["state"]))
            finally:
                api.stop()
        return got

    out = both(run)
    port, jax = out["port"], out["jax"]
    # capability flags are each package's engine's own (the JAX model
    # carries more); the listing's shape and replica groups are equal
    for body in (port[0], jax[0]):
        for m in body["data"]:
            m.pop("capabilities", None)
    assert port == jax
    assert port[1] == {"state": "ok", "replicas": ["ok", "ok"]}
    assert port[-1] == (503, "draining")


def test_api_metric_families_equal_jax():
    """After traffic through each server, the ``fleetx_api_*`` families
    have JAX's names, kinds and label names."""
    def run(pkg):
        api = SERVERS[pkg.name][0](pkg.engine(**API_ENGINE)).start()
        try:
            with _post(api.url + "/v1/completions",
                       {"prompt": "1 2 3", "max_tokens": 3}) as r:
                r.read()
            with pytest.raises(urllib.error.HTTPError):
                _post(api.url + "/v1/completions", {})
        finally:
            api.stop()
        reg = get_registry() if pkg is PORT else jax_registry()
        return sorted((f.name, f.kind, tuple(f.labelnames))
                      for f in reg.families()
                      if f.name.startswith("fleetx_api_"))

    out = both(run)
    assert out["port"] == out["jax"]
    assert {n for n, _, _ in out["port"]} == {
        "fleetx_api_requests_total", "fleetx_api_errors_total",
        "fleetx_api_tokens_total", "fleetx_api_active_requests",
        "fleetx_api_ttft_seconds"}


# ------------------------------------------------------- replica RPC


def test_rpc_router_byte_parity_and_migration(ref_tokens):
    """A router over two replica servers decodes the engine's streams; a
    server stopped after three ticks has its requests migrated with no
    token lost, and the router escalates it to dead, as JAX's does."""
    def run(pkg):
        _, Server, Client = SERVERS[pkg.name]
        servers = [Server(pkg.engine(**API_ENGINE)).start()
                   for _ in range(2)]
        try:
            clients = [Client(s.url, connect_wait_s=5) for s in servers]
            spec = (clients[0].paged, clients[0].page_size,
                    clients[0].cache_len,
                    clients[0].model.cfg.max_position_embeddings)
            router = pkg.s.ServingRouter(clients, probe_every=1)
            streams = {}
            rids = [router.submit(p, max_length=8,
                                  on_token=lambda r, t, f:
                                  streams.setdefault(r, []).append(int(t)))
                    for p in PROMPTS]
            for _ in range(3):
                router.step()
            servers[0].stop()
            res = router.drain(max_ticks=500)
            for _ in range(64):
                if pkg.events().find("replica_dead"):
                    break
                router.step()
            out = outcome(pkg, router, res, rids, streams)
            out["spec"] = spec
            return out
        finally:
            for s in servers[1:]:
                s.stop()

    out = both(run)
    assert_same(out)
    got = out["port"]
    assert got["spec"] == (True, 8, 32, 64)
    assert got["tokens"] == got["streams"] == [t[:8] for t in ref_tokens[0]]
    assert got["events"]["request_migrated"] and got["events"]["replica_dead"]


def test_rpc_disagg_kv_handoff(ref_tokens):
    servers = [ReplicaServer(PORT.engine(role="prefill", **API_ENGINE)),
               ReplicaServer(PORT.engine(role="decode", **API_ENGINE))]
    for s in servers:
        s.start()
    try:
        clients = [ReplicaClient(s.url, connect_wait_s=5) for s in servers]
        assert [c.role for c in clients] == ["prefill", "decode"]
        router = PORT.s.ServingRouter(clients, probe_every=1)
        rids = [router.submit(p, max_length=8) for p in PROMPTS]
        res = router.drain(max_ticks=500)
        assert [res[r].tokens.tolist() for r in rids] == [
            t[:8] for t in ref_tokens[0]]
        assert PORT.events().find("kv_shipped")
        assert servers[1].engine.metrics.kv_pages_revived_remote > 0
    finally:
        for s in servers:
            s.stop()


def test_rpc_failure_mapping_unreachable():
    server = ReplicaServer(PORT.engine(**API_ENGINE)).start()
    client = ReplicaClient(server.url, connect_wait_s=5)
    server.stop()
    with pytest.raises(QueueFull):
        client.submit([1, 2])
    with pytest.raises(ReplicaKilled):
        client.step()
    with pytest.raises(ConnectionError):
        client.health()
    with pytest.raises(ConnectionError):
        client.export_kv(0)
    assert client.take_result(0) is None
    assert client.emitted_tokens(0) is None
    assert client.prefilled_ready() == []
    assert client.cancel(0) is False
    client.request_shutdown()
    client.declare_dead()


def test_rpc_typed_errors_cross_the_wire():
    server = ReplicaServer(PORT.engine(**API_ENGINE)).start()
    try:
        client = ReplicaClient(server.url, connect_wait_s=5)
        assert client.submit_limit == 32 and client.slots == 3
        with pytest.raises(ValueError, match="empty"):
            client.submit([])
        with pytest.raises(ValueError):
            client.submit(list(range(40)))
        with pytest.raises(KeyError):
            client.export_kv(12345)
        client.request_shutdown(0.0)
        with pytest.raises(ShuttingDown):
            client.submit([1, 2, 3])
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(server.url + "/healthz", timeout=30)
        assert ei.value.code == 503
    finally:
        server.stop()


def test_rpc_fault_injectors(monkeypatch):
    """rpc_drop raises a ConnectionError subclass before the network (the
    client's sentinel mapping applies), rpc_delay sleeps, each once per
    matching attempt; both parse from the environment."""
    server = ReplicaServer(PORT.engine(**API_ENGINE)).start()
    try:
        client = ReplicaClient(server.url, connect_wait_s=5)
        PORT.faults.configure(rpc_drop="0")
        with pytest.raises(RPCFault):
            client.health()
        PORT.faults.configure(rpc_drop="0")
        assert client.take_result(0) is None
        assert PORT.faults.injected["rpc_drop"] == 1
        PORT.faults.configure(rpc_delay="0", rpc_delay_s=0.2)
        t0 = time.monotonic()
        client.health()
        assert time.monotonic() - t0 >= 0.2
        client.health()
        assert PORT.faults.injected["rpc_delay"] == 1
        PORT.faults.reset()
        monkeypatch.setenv("FLEETX_FAULT_RPC_DROP", "2+")
        monkeypatch.setenv("FLEETX_FAULT_RPC_DELAY", "0")
        monkeypatch.setenv("FLEETX_FAULT_RPC_DELAY_S", "0.01")
        monkeypatch.setenv("FLEETX_FAULT_REPLICA_KILL", "1:3")
        monkeypatch.setenv("FLEETX_FAULT_PROBE_FLAP", "0:2")
        plan = FaultPlan.from_env()
        assert (plan.rpc_drop, plan.rpc_delay, plan.rpc_delay_s) == (
            "2+", "0", 0.01)
        assert (plan.replica_kill, plan.probe_flap) == ("1:3", "0:2")
        with pytest.raises(ValueError, match="REPLICA_KILL"):
            PORT.faults.configure(replica_kill="1-3")
    finally:
        PORT.faults.reset()
        server.stop()
