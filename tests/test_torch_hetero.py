"""The heterogeneous fleet of ``tests/test_hetero.py`` over port engines,
against the JAX package's answers on the same weights.

One ``ServingRouter`` over GPT ``ServingEngine``s, an ``ErnieScoringEngine``
and ``EmbeddingEngine``s (ViT, embedding mode), built alike in both
packages (``torch_router_cases``: the GPT engines on the bridged tiny
weights; ``torch_encoder_cases``: the encoders'). Routing units: the
``models()`` group view and its per-group limits, the clean refusal of an
unserved family, dispatch that never crosses families, failover inside a
group and stranding of one group only, each equal to JAX's (GPT tokens and
ERNIE ids exact, ViT vectors within ``TOL``, the whole event log). The API
half: ``/v1/models`` derives from the groups and ``/v1/embeddings`` serves
the float-out family end to end, vectors equal to the engine's wire tokens
for a lone request and within ``BATCH_MAKEUP_TOL`` for a row batched with
another; its 404 and 400 answers are JAX's.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from fleetx_tpu.serving.api.server import ApiServer as JaxApiServer
from fleetx_tpu_torch.serving.api.server import ApiServer
from test_torch_protocol import BATCH_MAKEUP_TOL
from torch_encoder_cases import TOL, ernie_pair, images, vit_pair
from torch_router_cases import JAX, PORT, both, event_log

GPT_PROMPTS = [np.asarray([1, 2, 3], np.int32),
               np.asarray([4, 5, 6, 7, 8], np.int32)]
BLANK = np.asarray([5, 3, 9, 11], np.int32)  # mask id 3 at position 1

_ZOO = {}


def zoo():
    if not _ZOO:
        _ZOO.update(ernie=ernie_pair(seed=0), vit=vit_pair(seed=1))
    return _ZOO


def make(pkg, kind, **kw):
    """A ``kind`` engine of ``pkg`` (2 slots)."""
    if kind == "gpt":
        return pkg.engine(**kw)
    model, tree, port = zoo()[kind]
    cls = (pkg.s.ErnieScoringEngine if kind == "ernie"
           else pkg.s.EmbeddingEngine)
    if pkg is JAX:
        return cls(model, tree, slots=2, **kw)
    return cls(type(port)(port.cfg, device="meta"), port.state_dict(),
               device="cpu", slots=2, **kw)


def wire(pkg, img):
    return pkg.s.encode_floats(img)


def _vectors_close(got, want, tol=TOL):
    g = JAX.s.decode_floats(np.asarray(got))
    x = JAX.s.decode_floats(np.asarray(want))
    assert g.shape == x.shape
    np.testing.assert_allclose(g, x, **tol)


def _split(kinds, res, rids):
    """Results by family: exact token lists for gpt and ernie, the ViT
    vectors apart (compared within a tolerance)."""
    exact, vecs = [], []
    for kind, rid in zip(kinds, rids):
        r = res[rid]
        if kind == "vit":
            vecs.append(np.asarray(r.tokens))
            exact.append((kind, r.finish_reason))
        else:
            exact.append((kind, r.finish_reason, r.tokens.tolist()))
    return exact, vecs


def _same(out):
    port, jax = out["port"], out["jax"]
    for key in port:
        if key == "vectors":
            assert len(port[key]) == len(jax[key])
            for g, x in zip(port[key], jax[key]):
                _vectors_close(g, x)
        else:
            assert port[key] == jax[key], (key, port[key], jax[key])


def test_models_view_and_per_group_limits():
    def run(pkg):
        router = pkg.s.ServingRouter([make(pkg, "gpt"), make(pkg, "gpt"),
                                      make(pkg, "ernie"), make(pkg, "vit")])
        return {"models": router.models()}

    out = both(run)
    groups = out["port"]["models"]
    assert groups == out["jax"]["models"]
    assert sorted(groups) == ["ernie", "gpt", "vit"]
    assert groups["gpt"]["replicas"] == [0, 1] and groups["gpt"]["live"] == 2
    assert groups["vit"]["limit"] == 8 * 8 * 3 + 1
    assert groups["vit"]["capabilities"]["emits"] == "floats"
    assert groups["ernie"]["capabilities"]["has_kv_cache"] is False


def test_unknown_model_is_a_clean_submit_reject():
    def run(pkg):
        router = pkg.s.ServingRouter([make(pkg, "gpt"), make(pkg, "vit")])
        msgs = []
        for prompt, model in ((GPT_PROMPTS[0], "bert"),
                              (np.ones(100, np.int32), "gpt")):
            with pytest.raises(ValueError) as e:
                router.submit(prompt, max_length=4, model=model)
            msgs.append(str(e.value))
        return {"messages": msgs, "drained": router.drain()}

    out = both(run)
    assert out["port"] == out["jax"]
    assert "bert" in out["port"]["messages"][0]
    assert "not servable by any" in out["port"]["messages"][1]


def test_dispatch_never_crosses_families():
    """Three-family traffic through one router: each request lands on its
    family's replica (every prompt each engine saw), and the answers are
    a lone engine's of that family and JAX's."""
    kinds = ["gpt", "gpt", "ernie", "vit"]

    def run(pkg):
        img = images(1)[0]
        lone = make(pkg, "vit")
        lr = lone.submit(wire(pkg, img))
        lone_bits = np.asarray(lone.drain()[lr].tokens)
        engines = [make(pkg, "gpt"), make(pkg, "ernie"), make(pkg, "vit")]
        seen = {i: [] for i in range(3)}
        for i, eng in enumerate(engines):
            orig = eng.submit

            def tap(prompt, _orig=orig, _i=i, **kw):
                seen[_i].append(int(np.asarray(prompt).size))
                return _orig(prompt, **kw)

            eng.submit = tap
        router = pkg.s.ServingRouter(engines)
        rids = [router.submit(GPT_PROMPTS[0], max_length=8),
                router.submit(GPT_PROMPTS[1], max_length=8, model="gpt"),
                router.submit(BLANK, model="ernie"),
                router.submit(wire(pkg, img), model="vit")]
        res = router.drain()
        assert np.array_equal(res[rids[3]].tokens, lone_bits)
        exact, vecs = _split(kinds, res, rids)
        return {"exact": exact, "vectors": vecs, "seen": seen,
                "log": event_log(pkg)}

    out = both(run)
    _same(out)
    seen = out["port"]["seen"]
    assert seen[0] and all(n < 16 for n in seen[0])
    assert seen[1] == [BLANK.size] and seen[2] == [8 * 8 * 3]


def test_failover_stays_inside_the_model_group():
    """A GPT replica killed mid-stream on a 2-GPT + 1-ViT fleet: the
    stream migrates to the other GPT replica, the ViT request completes,
    as in JAX's router."""
    kinds = ["gpt", "gpt", "vit"]

    def run(pkg):
        with pkg.faulted(replica_kill="0:3"):
            router = pkg.s.ServingRouter(
                [make(pkg, "gpt"), make(pkg, "gpt"), make(pkg, "vit")],
                probe_every=1)
            rids = [router.submit(p, max_length=8, model="gpt")
                    for p in GPT_PROMPTS]
            rids.append(router.submit(wire(pkg, images(1)[0]),
                                      model="vit"))
            res = router.drain(max_ticks=400)
        exact, vecs = _split(kinds, res, rids)
        groups = router.models()
        return {"exact": exact, "vectors": vecs,
                "live": {k: v["live"] for k, v in groups.items()},
                "deaths": router.metrics.snapshot()["replica_deaths"],
                "log": event_log(pkg)}

    out = both(run)
    _same(out)
    assert out["port"]["live"] == {"gpt": 1, "vit": 1}
    assert out["port"]["deaths"] == 1
    assert any(kind == "replica_dead" for kind, _ in out["port"]["log"])


def test_group_stranding_is_per_model():
    def run(pkg):
        gpt = make(pkg, "gpt")
        router = pkg.s.ServingRouter([gpt, make(pkg, "vit")], probe_every=1)
        g = router.submit(GPT_PROMPTS[0], max_length=8, model="gpt")
        v = router.submit(wire(pkg, images(1)[0]), model="vit")
        gpt.declare_dead()
        res = router.drain(max_ticks=400)
        stranded = pkg.events().find("router_stranded")
        return {"reasons": [res[g].finish_reason, res[v].finish_reason],
                "models": stranded[-1].attrs["models"],
                "log": event_log(pkg)}

    out = both(run)
    assert out["port"] == out["jax"]
    assert out["port"]["reasons"] == ["error", "complete"]
    assert "gpt" in out["port"]["models"]
    assert "vit" not in out["port"]["models"]


def test_probe_refreshes_capability_advertisement():
    router = PORT.s.ServingRouter([make(PORT, "gpt"), make(PORT, "vit")],
                                  probe_every=1)
    for _ in range(3):
        router.step()
    groups = router.models()
    assert groups["gpt"]["capabilities"]["family"] == "gpt"
    assert groups["vit"]["capabilities"]["emits"] == "floats"
    assert list(router.replica_states) == ["ok", "ok"]


def _post(url, body):
    req = urllib.request.Request(url, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=60)


def _refusal(url, body):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/v1/embeddings", body)
    err = json.loads(e.value.read())["error"]
    return e.value.code, err["type"], err["message"]


def test_api_models_and_embeddings_over_hetero_fleet():
    """``/v1/models`` lists the groups; ``/v1/embeddings`` on the only
    float-out family returns the engine's wire vector for a lone row,
    keeps row order in the batch form, and answers a missing, a token-out
    and an ambiguous family as JAX's server does."""
    img, img1 = images(2)
    flat = [float(v) for v in img.reshape(-1)]
    flat1 = [float(v) for v in img1.reshape(-1)]

    def run(pkg):
        ref = make(pkg, "vit")
        rr = ref.submit(wire(pkg, img))
        want = pkg.s.decode_floats(ref.drain()[rr].tokens)
        router = pkg.s.ServingRouter([make(pkg, "gpt"), make(pkg, "ernie"),
                                      make(pkg, "vit")])
        server = ApiServer if pkg is PORT else JaxApiServer
        api = server(router, model_id="fleet-hetero").start()
        try:
            with urllib.request.urlopen(api.url + "/v1/models",
                                        timeout=30) as r:
                listing = json.loads(r.read())
            for m in listing["data"]:
                m.pop("created")
            with _post(api.url + "/v1/embeddings", {"input": flat}) as r:
                single = json.loads(r.read())
            with _post(api.url + "/v1/embeddings",
                       {"model": "vit", "input": [flat, flat1]}) as r:
                batch = json.loads(r.read())
            with _post(api.url + "/v1/completions",
                       {"model": "gpt", "prompt": [1, 2, 3],
                        "max_tokens": 4}) as r:
                comp = json.loads(r.read())
            refusals = [_refusal(api.url, {"model": "resnet",
                                           "input": [1.0, 2.0]}),
                        _refusal(api.url, {"model": "gpt",
                                           "input": [1.0, 2.0]}),
                        _refusal(api.url, {"input": "1"})]
        finally:
            api.stop()
        # a second float-out family makes an unnamed request ambiguous
        two = pkg.s.ServingRouter([make(pkg, "vit"),
                                   make(pkg, "vit", family="vit2")])
        api = server(two).start()
        try:
            refusals.append(_refusal(api.url, {"input": flat}))
        finally:
            api.stop()
        return {"listing": listing, "want": want, "single": single,
                "batch": batch, "finish": comp["choices"][0][
                    "finish_reason"], "refusals": refusals}

    out = both(run)
    port, jax = out["port"], out["jax"]
    assert port["listing"] == jax["listing"]
    ids = [m["id"] for m in port["listing"]["data"]]
    assert ids[0] == "fleet-hetero" and sorted(ids[1:]) == ["ernie", "gpt",
                                                            "vit"]
    single = np.asarray(port["single"]["data"][0]["embedding"], np.float32)
    assert port["single"]["model"] == "vit"
    assert np.array_equal(single, port["want"]), "API vector != engine bits"
    np.testing.assert_allclose(single, jax["want"], **TOL)
    assert [d["index"] for d in port["batch"]["data"]] == [0, 1]
    np.testing.assert_allclose(
        np.asarray(port["batch"]["data"][0]["embedding"], np.float32),
        port["want"], **BATCH_MAKEUP_TOL)
    for p, j in zip(port["batch"]["data"], jax["batch"]["data"]):
        np.testing.assert_allclose(p["embedding"], j["embedding"], **TOL)
    assert port["batch"]["usage"] == jax["batch"]["usage"]
    assert port["finish"] == jax["finish"] == "length"
    assert port["refusals"] == jax["refusals"]
    assert [r[0] for r in port["refusals"]] == [404, 404, 400, 400]


def test_drr_prices_an_image_by_its_wire_length():
    """JAX's router prices a request by its prompt length: an image of
    H·W·C = 3072 wire ints at the default quantum (256 a tick) waits 12
    ticks to dispatch there, one tick at a quantum of its size. The
    port's prices a KV-free request by the rows its engine runs
    (``EmbeddingEngine.request_rows``: the ViT's 4 patches and its class
    token), so it dispatches in the first tick at either quantum (ROADMAP
    Queue C, gaps by design: "DRR prices an image by its wire length")."""
    model, tree, port = vit_pair(seed=1, image_size=32)
    img = images(1, shape=(32, 32, 3))[0]

    def ticks(pkg, **router_kw):
        if pkg is JAX:
            eng = pkg.s.EmbeddingEngine(model, tree, slots=2)
        else:
            eng = pkg.s.EmbeddingEngine(
                type(port)(port.cfg, device="meta"), port.state_dict(),
                device="cpu", slots=2)
        router = pkg.s.ServingRouter([eng], **router_kw)
        rid = router.submit(wire(pkg, img))
        n = 0
        while router.result(rid) is None:
            router.step()
            n += 1
        return n

    out = both(lambda pkg: [ticks(pkg), ticks(pkg, drr_quantum=32 * 32 * 3)])
    assert out["jax"] == [12, 1]
    assert out["port"] == [1, 1]
