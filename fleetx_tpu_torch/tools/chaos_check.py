"""Chaos smoke driver for the port's fleet layer: run the router, RPC and
front-door resilience scenarios end to end.

Port of the fleet scenarios of the JAX package's ``tools/chaos_check.py``;
one PASS/FAIL line per scenario, non-zero exit on any failure:

- ``router_kill``: a replica of a 3-replica ``ServingRouter`` is KILLED
  mid-burst (``FLEETX_FAULT_REPLICA_KILL``): every request still reaches
  exactly one terminal result, migrated requests resume on survivors
  byte-identical to a clean single replica, a seeded workload's goodput
  shows no lost request, and ``replica_dead`` + ``request_migrated``
  events are banked;
- ``router_saturation``: a router pushed past saturation (bounded queue +
  tight deadlines) rejects with ``QueueFull``, sheds expired queued
  requests as ``timeout``, gives every accepted request exactly one
  terminal result, and keeps serving afterwards;
- ``serving_disagg``: a 1 prefill + 1 decode fleet is byte-identical to
  colocated; a corrupted shipped page and a killed prefill replica both
  fall back to replay with the same bytes;
- ``serving_http``: a REAL replica subprocess (``tools/serve.py``'s
  worker) is SIGKILLed while an OpenAI-compatible SSE stream is in
  flight: the stream completes through the router's RPC migration,
  byte-identical to a clean in-process engine;
- ``serving_qos``: a flooding tenant saturates two replicas, a priority
  tenant preempts its way in and a replica is killed mid-churn: every
  stream byte-identical to an uncontended engine, shed confined to the
  flood lane;
- ``serving_hetero``: two GPT and two ViT embedding replicas in one
  router, a ViT replica killed with its batch dispatched and a GPT replica
  killed mid-stream: one terminal result per request, GPT streams
  byte-identical to a clean replica, embeddings within
  ``HETERO_EMB_TOL`` of a lone engine's, no dispatch across families.

Still to port (ROADMAP Queue A): ``sentry``, ``sentry_zero``, ``ckpt``,
the engine-level ``serving*`` scenarios and ``train_elastic``.

Usage::

    python -m fleetx_tpu_torch.tools.chaos_check [--only router_kill,...]
        [--device cpu]

The engines run on CUDA unless ``--device`` names another device.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _serving_fixture(device):
    """Tiny GPT engine factory (vocab 61, hidden 32, one layer, fp32; the
    serve demo's weights) and four short prompts."""
    import numpy as np

    from fleetx_tpu_torch.serving import ServingEngine
    from fleetx_tpu_torch.tools.serve import demo_model

    model, params, gen_cfg, dev = demo_model(device=device)
    prompts = [np.asarray([1, 2, 3], np.int32),
               np.asarray([4, 5, 6, 7, 8], np.int32),
               np.asarray([9, 10], np.int32),
               np.asarray([11, 12, 13], np.int32)]

    def make(paged, **kw):
        return ServingEngine(model, params, device=dev,
                             slots=3, cache_len=32, gen_cfg=gen_cfg,
                             prefill_bucket=4, paged=paged,
                             page_size=8 if paged else None, **kw)

    return make, prompts


def _run_workload(eng, prompts, max_length=8):
    import numpy as np

    rids = [eng.submit(p, max_length=max_length) for p in prompts]
    res = eng.drain()
    return [np.asarray(res[r].tokens) for r in rids], res, rids


def scenario_router_kill(tmp, device):
    """A replica killed mid-burst: zero-token-loss migration, exactly
    one terminal result per request, byte parity vs a clean single
    replica, goodput shows a blip but no lost requests."""
    import numpy as np

    from fleetx_tpu_torch.obs import get_event_log
    from fleetx_tpu_torch.resilience.faults import faults
    from fleetx_tpu_torch.serving import (
        ServingRouter,
        TenantSpec,
        WorkloadSpec,
        generate_trace,
        run_trace,
        score_goodput,
        trace_hash,
    )

    make, prompts = _serving_fixture(device)
    # clean single-replica reference streams (batch composition never
    # changes greedy tokens, so one engine is THE reference)
    clean, _, _ = _run_workload(make(True), prompts)
    streams = {}

    def cb(rid, tok, fin):
        streams.setdefault(rid, []).append(int(tok))

    faults.configure(replica_kill="1:3")
    try:
        router = ServingRouter([make(True) for _ in range(3)],
                               probe_every=1)
        rids = [router.submit(p, max_length=8, on_token=cb)
                for p in prompts]
        res = router.drain(max_ticks=500)
    finally:
        faults.reset()
    assert len(res) == len(prompts), (
        f"{len(prompts)} submitted, {len(res)} terminal results — "
        "requests were lost or duplicated")
    for i, rid in enumerate(rids):
        assert np.array_equal(np.asarray(res[rid].tokens), clean[i]), (
            f"request {rid} diverged from the clean single replica "
            "after the kill")
        assert streams[rid] == list(clean[i]), (
            f"request {rid} callback stream has lost/duplicated tokens")
    ev = get_event_log()
    dead = ev.find("replica_dead", replica=1)
    assert dead, "replica death left no replica_dead event"
    migrated = ev.find("request_migrated")
    assert migrated, "failover left no request_migrated event"
    assert ev.find("fault_injected", fault="replica_kill"), \
        "kill injection left no fault_injected event"
    m = router.metrics.snapshot()
    assert m["replica_deaths"] == 1 and m["migrated"] >= 1, m
    # the goodput view of the same story: a seeded trace over a freshly
    # killed router — the kill is a latency blip, never a lost request
    spec = WorkloadSpec(seed=11, n_requests=8, arrival_rate=200.0,
                        vocab=61,
                        tenants=(TenantSpec("burst", prompt_len=(3, 6),
                                            gen_len=(4, 8)),))
    trace = generate_trace(spec)
    faults.configure(replica_kill="0:4")
    try:
        router2 = ServingRouter([make(True) for _ in range(3)],
                                probe_every=1)
        score = score_goodput(run_trace(router2, trace))
    finally:
        faults.reset()
    assert score["completed_frac"] == 1.0, (
        f"kill lost requests under the seeded workload: {score}")
    return (f"kill at tick 3 migrated {m['migrated']} request(s) "
            f"byte-identically ({len(prompts)}/{len(prompts)} exactly-one-"
            f"result); workload {trace_hash(trace)} goodput "
            f"{score['goodput']} with ttft_p99 {score['ttft_ms_p99']:.0f}ms"
            " blip, zero lost")


def scenario_router_saturation(tmp, device):
    """Past-saturation load: bounded-queue rejects + deadline sheds,
    every accepted request exactly one terminal result, router alive."""
    from fleetx_tpu_torch.obs import get_event_log
    from fleetx_tpu_torch.serving import QueueFull, ServingRouter

    make, prompts = _serving_fixture(device)
    router = ServingRouter([make(True)], max_queue=6)
    accepted, rejected = [], 0
    # a burst far past one 3-slot replica: the bounded queue must reject
    # the overflow, and the tight-deadline stragglers must shed as
    # timeouts instead of waiting forever
    for i in range(12):
        kw = {"deadline_s": 1e-6} if i in (4, 5) else {}
        try:
            accepted.append(router.submit(prompts[i % len(prompts)],
                                          max_length=8, **kw))
        except QueueFull:
            rejected += 1
    res = router.drain(max_ticks=500)
    assert rejected > 0, "queue bound never rejected under a 12-burst"
    assert len(res) == len(accepted), (
        f"{len(accepted)} accepted, {len(res)} terminal results")
    reasons = {r: res[r].finish_reason for r in res}
    assert any(v == "timeout" for v in reasons.values()), (
        f"tight deadlines never shed: {reasons}")
    assert all(v in ("eos", "max_length", "timeout")
               for v in reasons.values()), reasons
    ev = get_event_log()
    assert ev.find("queue_reject"), "rejects left no queue_reject event"
    assert ev.find("request_timeout"), "sheds left no request_timeout event"
    # never collapses: the router serves normally after the storm
    rid = router.submit(prompts[0], max_length=8)
    after = router.drain(max_ticks=200)
    assert after[rid].finish_reason in ("eos", "max_length")
    m = router.metrics.snapshot()
    return (f"12-burst on a 3-slot replica: {rejected} rejected, "
            f"{sum(v == 'timeout' for v in reasons.values())} shed, "
            f"{sum(v != 'timeout' for v in reasons.values())} completed, "
            f"exactly-one-result held ({m['finished']} finished), router "
            "alive after the storm")


def scenario_serving_disagg(tmp, device):
    """Disaggregated prefill/decode under fire: a prefill replica
    killed mid-export AND a corrupted shipped page — both fall back to
    the replay ladder, byte parity vs a clean colocated run holds, and
    the ship/fallback events are banked."""
    import numpy as np

    from fleetx_tpu_torch.obs import get_event_log
    from fleetx_tpu_torch.resilience.faults import faults
    from fleetx_tpu_torch.serving import ServingRouter

    make, prompts = _serving_fixture(device)
    clean, _, _ = _run_workload(make(True), prompts)

    def run_router(router):
        rids = [router.submit(p, max_length=8) for p in prompts]
        res = router.drain(max_ticks=500)
        assert len(res) == len(prompts), (
            f"{len(prompts)} submitted, {len(res)} terminal results")
        return [np.asarray(res[r].tokens) for r in rids]

    # 1) clean disaggregated pass: 1 prefill + 1 decode == colocated
    router = ServingRouter([make(True, role="prefill"),
                            make(True, role="decode")], probe_every=1)
    got = run_router(router)
    assert all(np.array_equal(a, b) for a, b in zip(clean, got)), \
        "disaggregated tokens diverged from colocated"
    pre = router._replicas[0].engine
    dec = router._replicas[1].engine
    shipped = pre.metrics.kv_pages_shipped
    assert shipped > 0 and dec.metrics.kv_pages_revived_remote == shipped
    ev = get_event_log()
    assert ev.find("kv_shipped"), "handoffs left no kv_shipped event"
    assert ev.find("kv_revived_remote"), "no kv_revived_remote event"

    # 2) corrupt one shipped page: the decode replica's wire checksum
    #    rejects it at admit, the request replays — same bytes out
    faults.configure(kv_ship_corrupt="1")
    try:
        got = run_router(ServingRouter(
            [make(True, role="prefill"), make(True, role="decode")],
            probe_every=1))
    finally:
        faults.reset()
    assert all(np.array_equal(a, b) for a, b in zip(clean, got)), \
        "corrupted ship diverged after replay fallback"
    failed = ev.find("kv_ship_failed")
    assert any(e.attrs.get("where") == "admit" for e in failed), \
        "corrupt blob left no admit-side kv_ship_failed event"
    assert ev.find("fault_injected", fault="kv_ship_corrupt")

    # 3) kill the prefill replica mid-run: every parked/queued request
    #    migrates to the decode replica and replays — zero tokens lost
    faults.configure(replica_kill="0:3")
    try:
        got = run_router(ServingRouter(
            [make(True, role="prefill"), make(True, role="decode")],
            probe_every=1, probe_max_failures=1))
    finally:
        faults.reset()
    assert all(np.array_equal(a, b) for a, b in zip(clean, got)), \
        "prefill-replica kill diverged after migration replay"
    assert ev.find("replica_dead", replica=0), "no replica_dead event"
    n_fail = len(ev.find("kv_ship_failed"))
    return (f"disaggregated 1P+1D byte-identical to colocated "
            f"({shipped} pages shipped); corrupt ship + prefill kill "
            f"both replayed to parity ({n_fail} kv_ship_failed "
            "fallback(s) banked)")


def scenario_serving_http(tmp, device):
    """A replica PROCESS SIGKILLed mid-SSE-stream: the OpenAI front
    door's stream completes through router migration over the replica
    RPC — byte-identical to a clean in-process engine, zero tokens
    lost or duplicated."""
    import json
    import urllib.request

    from fleetx_tpu_torch.obs import get_event_log
    from fleetx_tpu_torch.serving import ServingRouter
    from fleetx_tpu_torch.serving.api.replica_client import ReplicaClient
    from fleetx_tpu_torch.serving.api.server import ApiServer
    from fleetx_tpu_torch.tools.serve import (
        _build_demo_engine,
        _spawn_replicas,
    )

    os.makedirs(tmp, exist_ok=True)
    gen_len = 20
    # clean reference: the same demo engine serve.py replicas build
    eng = _build_demo_engine(0, device=device)
    rid = eng.submit([1, 2, 3], max_length=gen_len)
    clean = [int(t) for t in eng.drain()[rid].tokens]
    assert len(clean) == gen_len

    procs, urls = _spawn_replicas(2, grace_s=5.0, tmpdir=tmp,
                                  device=device)
    api = None
    try:
        clients = [ReplicaClient(u, connect_wait_s=60) for u in urls]
        router = ServingRouter(clients, probe_every=1)
        api = ApiServer(router, model_id="fleetx-demo").start()
        req = urllib.request.Request(
            api.url + "/v1/chat/completions",
            json.dumps({"model": "fleetx-demo", "stream": True,
                        "max_tokens": gen_len,
                        "messages": [{"role": "user",
                                      "content": "1 2 3"}]}).encode(),
            {"Content-Type": "application/json"})
        toks, finish, killed = [], None, None
        with urllib.request.urlopen(req, timeout=120) as resp:
            for line in resp:
                line = line.decode().strip()
                if not line.startswith("data: ") or line[6:] == "[DONE]":
                    continue
                chunk = json.loads(line[6:])
                if "token" in chunk:
                    toks.append(chunk["token"])
                if chunk["choices"][0]["finish_reason"]:
                    finish = chunk["choices"][0]["finish_reason"]
                if len(toks) == 3 and killed is None:
                    # find the replica actually decoding this stream and
                    # SIGKILL its whole process mid-flight
                    for i, c in enumerate(clients):
                        if c.health().get("active", 0) > 0:
                            killed = i
                            procs[i].kill()
                            break
                    assert killed is not None, "no replica was active"
        assert killed is not None, "stream finished before the kill fired"
        assert toks == clean, (
            f"stream diverged after replica-process kill: {toks} != {clean}"
            " (token lost or duplicated)")
        assert finish == "length", finish
        ev = get_event_log()
        assert ev.find("replica_dead", replica=killed), \
            "process kill left no replica_dead event"
        assert ev.find("request_migrated"), "no request_migrated event"
    finally:
        if api is not None:
            api.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
    return (f"replica process {killed} SIGKILLed after 3 tokens; SSE "
            f"stream completed {len(toks)}/{gen_len} tokens byte-"
            "identical through RPC migration (zero loss/dup)")


def scenario_serving_qos(tmp, device):
    """Per-tenant QoS under fire: a flooding tenant saturates the fleet,
    a priority tenant preempts its way in, and a replica is SIGKILLed
    right in the middle of the preemption churn — the priority tenant's
    streams stay byte-identical to a clean uncontended engine, every
    preempted flood request still finishes byte-identically (zero-loss
    preemption across the kill), and all shed stays on the flood lane."""
    import numpy as np

    from fleetx_tpu_torch.obs import get_event_log
    from fleetx_tpu_torch.resilience.faults import faults
    from fleetx_tpu_torch.serving import QueueFull, ServingRouter, TenantPolicy

    make, prompts = _serving_fixture(device)
    flood_prompts = [np.asarray([20 + j, 25, 30 + j], np.int32)
                     for j in range(16)]
    # clean references from a lone uncontended engine: greedy decode is
    # batch-composition-invariant, so these are THE bytes every tenant
    # must reproduce through preemption, migration, and the kill
    clean_paid, _, _ = _run_workload(make(True), prompts)
    flood_ref = {}
    ref = make(True)
    for j, p in enumerate(flood_prompts):
        flood_ref[j] = ref.submit(p, max_length=16)
    ref_res = ref.drain()
    clean_flood = {j: np.asarray(ref_res[r].tokens)
                   for j, r in flood_ref.items()}

    faults.configure(replica_kill="1:6")
    try:
        router = ServingRouter(
            [make(True, max_queue=1) for _ in range(2)],
            tenants={"paid": TenantPolicy(weight=4.0, priority=1),
                     "flood": TenantPolicy(weight=1.0, max_queue=4)},
            probe_every=1, preempt_risk_frac=0.0)
        # flood in rounds so dispatch keeps both replicas' slots AND
        # engine queues pinned full while the lane holds a backlog —
        # long generations (16 tokens) keep them busy past the kill
        flood_rids, rejected = {}, 0
        fi = iter(range(len(flood_prompts)))
        for _ in range(4):
            for j in (next(fi), next(fi), next(fi), next(fi)):
                try:
                    flood_rids[j] = router.submit(
                        flood_prompts[j], max_length=16, tenant="flood")
                except QueueFull:
                    rejected += 1
            router.step()
        # the priority tenant arrives into a saturated fleet: a generous
        # total deadline arms preemption (risk_frac=0.0 -> any capacity
        # refusal preempts a lower-priority victim) without shed risk
        paid_rids = [router.submit(p, max_length=8, tenant="paid",
                                   deadline_s=120.0) for p in prompts]
        res = router.drain(max_ticks=500)
    finally:
        faults.reset()
    accepted = len(flood_rids) + len(paid_rids)
    assert len(res) == accepted, (
        f"{accepted} accepted, {len(res)} terminal results — requests "
        "were lost or duplicated")
    assert rejected > 0, "the flood never overflowed its bounded lane"
    for i, rid in enumerate(paid_rids):
        assert res[rid].finish_reason in ("eos", "max_length"), (
            f"priority request {rid} shed under flood: "
            f"{res[rid].finish_reason}")
        assert np.array_equal(np.asarray(res[rid].tokens), clean_paid[i]), (
            f"priority request {rid} diverged from the clean "
            "uncontended engine")
    for j, rid in flood_rids.items():
        assert np.array_equal(np.asarray(res[rid].tokens),
                              clean_flood[j]), (
            f"flood request {rid} diverged after preemption/kill — "
            "preemption lost or duplicated tokens")
    ev = get_event_log()
    preempted = ev.find("request_preempted")
    assert preempted, "saturated fleet + priority deadline never preempted"
    assert all(e.attrs["tenant"] == "flood" for e in preempted), (
        "a non-flood request was preempted: "
        f"{[e.attrs for e in preempted]}")
    assert ev.find("replica_dead", replica=1), "the kill never landed"
    assert ev.find("fault_injected", fault="replica_kill")
    assert ev.find("request_migrated"), "no request_migrated event"
    m = router.metrics.snapshot()
    assert m["preempted"] >= 1 and m["replica_deaths"] == 1, m
    return (f"flood saturated 2 replicas ({rejected} lane rejects); "
            f"{len(preempted)} preemption(s), replica 1 SIGKILLed at "
            f"tick 6 mid-churn; {len(paid_rids)}/{len(paid_rids)} "
            f"priority + {len(flood_rids)}/{len(flood_rids)} flood "
            "streams byte-identical, shed confined to the flood lane")


# embedding vectors of the hetero fleet against a lone engine: a request
# that migrates rides another batch, whose GEMMs may round it apart
# (ROADMAP Queue C, "ViT batch makeup"); fp32, relative and absolute
HETERO_EMB_TOL = 1e-5
# serving_hetero's kills: ViT replica 2 at router tick 1, its batch
# dispatched and not yet run, so the whole batch migrates; GPT replica 1 at
# tick 3, mid-stream with tokens already emitted
HETERO_KILL = "2:1,1:3"


def hetero_pass(router, requests, want, emb_gap, emb_tol, max_ticks=500):
    """Submit every family's requests to ``router``, interleaved
    (``requests``: family -> list of ``submit`` keyword dicts), and drain.
    Holds one terminal result per request, each ``gpt`` stream byte-equal
    to ``want["gpt"]``, each ``vit`` answer complete with
    ``emb_gap(vector, want["vit"][i]) <= emb_tol``, every other family's
    answer complete. Returns ``(rids, results, worst gap, bit-equal
    vectors)``, ``rids`` as ``(family, index, router id)``."""
    import numpy as np

    from fleetx_tpu_torch.serving import decode_floats

    rids = []
    for i in range(max(len(r) for r in requests.values())):
        for fam, reqs in requests.items():
            if i < len(reqs):
                rids.append((fam, i, router.submit(**reqs[i], model=fam)))
    res = router.drain(max_ticks=max_ticks)
    assert len(res) == len(rids) and all(r in res for _, _, r in rids), (
        f"{len(rids)} submitted, {len(res)} terminal results: requests "
        "were lost or duplicated")
    worst, bit_equal = 0.0, 0
    for fam, i, rid in rids:
        if fam == "gpt":
            assert np.array_equal(np.asarray(res[rid].tokens),
                                  want["gpt"][i]), (
                f"GPT request {rid} diverged from the clean single replica")
            continue
        assert res[rid].finish_reason == "complete", (fam, res[rid])
        if fam != "vit":
            continue
        vec = decode_floats(res[rid].tokens)
        assert vec.size == want["vit"][i].size, vec.size
        bit_equal += int(np.array_equal(vec, want["vit"][i]))
        gap = emb_gap(vec, want["vit"][i])
        worst = max(worst, gap)
        assert gap <= emb_tol, (
            f"embedding request {rid} is {gap} from the lone engine's "
            f"(limit {emb_tol})")
    return rids, res, worst, bit_equal


def hetero_fault_plan(fleet, requests, want, emb_gap, emb_tol,
                      max_ticks=500, **router_kw):
    """``serving_hetero`` over any engines: ``fleet`` is ``(family,
    engine)`` by replica index, 0-1 ``gpt`` and 2-3 ``vit`` (more may
    follow). Under HETERO_KILL a ``ServingRouter`` over them serves
    ``requests`` through hetero_pass; then every prompt an engine was
    given is one of its own family's, both kills left ``fault_injected``
    and ``replica_dead`` events, a request migrated, and one replica of
    each killed group lives on. Returns ``(router, rids, results, worst
    gap, bit-equal vectors, prompts given by family)``."""
    import numpy as np

    from fleetx_tpu_torch.obs import get_event_log
    from fleetx_tpu_torch.resilience.faults import faults
    from fleetx_tpu_torch.serving import ServingRouter

    assert [f for f, _ in fleet[:4]] == ["gpt", "gpt", "vit", "vit"], fleet

    def wire(prompt):
        return np.asarray(prompt, np.int32).reshape(-1).tobytes()

    own = {fam: {wire(r["prompt"]) for r in reqs}
           for fam, reqs in requests.items()}
    given = {fam: [] for fam in own}

    def tapped(eng, fam):
        submit = eng.submit

        def tap(prompt, **kw):
            given[fam].append(wire(prompt))
            return submit(prompt, **kw)

        return tap

    kept = [eng.__dict__.get("submit") for _, eng in fleet]
    for fam, eng in fleet:
        eng.submit = tapped(eng, fam)
    get_event_log().clear()
    faults.configure(replica_kill=HETERO_KILL)
    try:
        router = ServingRouter([e for _, e in fleet], probe_every=1,
                               **router_kw)
        rids, res, worst, bit_equal = hetero_pass(
            router, requests, want, emb_gap, emb_tol, max_ticks=max_ticks)
    finally:
        faults.reset()
        for (_, eng), submit in zip(fleet, kept):
            if submit is None:
                del eng.submit
            else:
                eng.submit = submit
    for fam, seen in given.items():
        assert seen and all(p in own[fam] for p in seen), (
            f"{fam} engines were given another family's prompt")
    ev = get_event_log()
    for replica in (1, 2):
        assert ev.find("fault_injected", fault="replica_kill",
                       replica=replica), \
            f"kill injection on replica {replica} left no event"
        assert ev.find("replica_dead", replica=replica), \
            f"replica {replica} death left no replica_dead event"
    assert ev.find("request_migrated"), "failover left no request_migrated"
    m = router.metrics.snapshot()
    assert m["replica_deaths"] == 2 and m["migrated"] >= 2, m
    groups = router.models()
    assert groups["gpt"]["live"] == 1 and groups["vit"]["live"] == 1, groups
    return router, rids, res, worst, bit_equal, {
        fam: len(seen) for fam, seen in given.items()}


def scenario_serving_hetero(tmp, device):
    """A heterogeneous fleet under fire: a GPT replica killed mid-stream
    AND an embedding (ViT) replica killed with its batch dispatched in the
    SAME router: every request of both families reaches exactly one
    terminal result, migrated GPT streams are byte-identical to a clean
    replica, the embeddings equal a lone engine's within HETERO_EMB_TOL,
    and no dispatch crosses families (hetero_fault_plan)."""
    import numpy as np
    import torch

    from fleetx_tpu_torch.models.vision.convert import init_params
    from fleetx_tpu_torch.models.vision.vit import ViT, ViTConfig
    from fleetx_tpu_torch.serving import (
        EmbeddingEngine,
        decode_floats,
        encode_floats,
    )
    from fleetx_tpu_torch.tools.serve import DEMO_STD

    make, prompts = _serving_fixture(device)
    clean, _, _ = _run_workload(make(True), prompts)

    vcfg = ViTConfig(image_size=8, patch_size=4, in_channels=3,
                     num_classes=0, hidden_size=32, num_layers=2,
                     num_attention_heads=2, dtype=torch.float32)
    vit_params = {k: (v if k.endswith((".scale", "bias")) or k == "cls_token"
                      else v * (DEMO_STD / 0.02))
                  for k, v in init_params(vcfg, seed=1, device="cpu").items()}
    rng = np.random.RandomState(7)
    images = [encode_floats(rng.rand(8, 8, 3).astype(np.float32))
              for _ in range(4)]

    def make_emb():
        return EmbeddingEngine(ViT(vcfg, device="meta"), vit_params,
                               device=make(True).device, slots=2)

    # the lone engine's vectors: the reference the fleet reproduces
    ref_emb = make_emb()
    ref_rids = [ref_emb.submit(img) for img in images]
    ref_res = ref_emb.drain()
    ref_vecs = [decode_floats(ref_res[r].tokens) for r in ref_rids]

    def gap(vec, ref):  # x the elementwise tolerance
        return float(np.max(np.abs(vec - ref) / (
            HETERO_EMB_TOL + HETERO_EMB_TOL * np.abs(ref))))

    fleet = [("gpt", make(True)), ("gpt", make(True)),
             ("vit", make_emb()), ("vit", make_emb())]
    router, rids, _, worst, bit_equal, given = hetero_fault_plan(
        fleet, {"gpt": [dict(prompt=p, max_length=8) for p in prompts],
                "vit": [dict(prompt=img) for img in images]},
        {"gpt": clean, "vit": ref_vecs}, gap, 1.0)
    m = router.metrics.snapshot()
    return (f"killed GPT replica 1 mid-stream + ViT replica 2 mid-batch; "
            f"{len(rids)}/{len(rids)} exactly-one-result, {m['migrated']} "
            f"migrated, GPT byte-identical, embeddings {bit_equal}/"
            f"{len(images)} bit-equal to a lone engine, worst "
            f"{worst:.3g} x tol {HETERO_EMB_TOL}; zero cross-model "
            f"dispatches ({given['gpt']} gpt / {given['vit']} vit "
            "submits)")


SCENARIOS = {
    "router_kill": scenario_router_kill,
    "router_saturation": scenario_router_saturation,
    "serving_disagg": scenario_serving_disagg,
    "serving_http": scenario_serving_http,
    "serving_qos": scenario_serving_qos,
    "serving_hetero": scenario_serving_hetero,
}


def main(argv=None) -> int:
    """Run the selected chaos scenarios; 0 iff all pass."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of " + ",".join(SCENARIOS))
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: a fresh tempdir)")
    ap.add_argument("--device", default=None,
                    help="the engines' device (default CUDA; 'cpu' runs "
                         "the plain PyTorch path)")
    args = ap.parse_args(argv)
    names = (args.only.split(",") if args.only else list(SCENARIOS))
    tmp = args.workdir or tempfile.mkdtemp(prefix="chaos_check_")
    failures = 0
    for name in names:
        fn = SCENARIOS.get(name.strip())
        if fn is None:
            print(f"FAIL {name}: unknown scenario")
            failures += 1
            continue
        try:
            # each scenario asserts on the structured event log: start it
            # empty so an earlier scenario's events cannot satisfy this one
            from fleetx_tpu_torch.obs import get_event_log

            get_event_log().clear()
            detail = fn(os.path.join(tmp, name.strip()), args.device)
            print(f"PASS {name}: {detail}")
        except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
            import traceback

            traceback.print_exc()
            print(f"FAIL {name}: {type(e).__name__}: {e}")
            failures += 1
    print(f"chaos_check: {len(names) - failures}/{len(names)} scenarios passed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
