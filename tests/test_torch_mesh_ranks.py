"""Rank programs of the port's mesh (mp) serving tests, and the tests that
need nothing but the port.

JAX-free on purpose: :func:`fleetx_tpu_torch.parallel.launch.spawn` runs
:func:`mesh_serving_program` in fresh processes (the ranks of one gloo
group on the CPU, or ranks that share the card), which import this module
and nothing of JAX. ``test_torch_mesh_serving.py`` and
``test_torch_mesh_matrix.py`` hold its streams against JAX's
single-device and mp 2 engines. The tests here hold the port against
itself: seeded sampling at mp 2 against the single-device engine, the
construction refusals, and the serving shard plan of an int8 state dict.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fleetx_tpu_torch.models.gpt.convert import init_params, shard_params
from fleetx_tpu_torch.models.gpt.generation import GenerationConfig
from fleetx_tpu_torch.models.gpt.model import GPTConfig, GPTForPretraining
from fleetx_tpu_torch.ops.quant import quantize_tree_int8
from fleetx_tpu_torch.parallel.mesh import Mesh, build_mesh
from fleetx_tpu_torch.serving import ServingEngine
from test_torch_cp_ranks import run_ranks

# tests/test_mesh_serving.py's CFG (vocab 96 divides over mp 2)
MESH_CFG = dict(vocab_size=96, hidden_size=48, num_layers=2,
                num_attention_heads=4, ffn_hidden_size=96,
                max_position_embeddings=64, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
ENGINE = dict(slots=3, cache_len=32, prefill_bucket=4)
NO_EOS = 10**6
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 20, 21, 22, 23], [9, 10]]
SAMPLING = dict(decode_strategy="sampling", temperature=1.3, top_k=8)


def mesh_cfg(**kw) -> GPTConfig:
    return GPTConfig(**{**MESH_CFG, **kw}, dtype=torch.float32,
                     use_flash_attention=False)


def serve_case(params, cfg, case, mesh=None):
    """One engine of ``case`` (``kw``: engine switches, ``gen``: the
    generation config's fields, ``prompts``, ``max_length``, ``seeds``,
    ``fault``: a tick fault plan) on the CPU over the whole state dict
    ``params``; returns its streams, per-rank cache bytes before and after
    the drain, recoveries and the metrics snapshot."""
    from fleetx_tpu_torch.resilience.faults import faults

    gen = GenerationConfig(**{"decode_strategy": "greedy",
                              "eos_token_id": NO_EOS, "pad_token_id": 95,
                              **case.get("gen", {})})
    eng = ServingEngine(GPTForPretraining(cfg, device="meta"), params,
                        device="cpu", gen_cfg=gen, mesh=mesh,
                        **{**ENGINE, **case.get("kw", {})})
    before = eng.cache_manager.cache_nbytes()
    if case.get("fault"):
        faults.configure(**case["fault"])
    try:
        seeds = case.get("seeds") or [None] * len(case["prompts"])
        rids = [eng.submit(np.asarray(p, np.int32),
                           max_length=case.get("max_length", 5), seed=s)
                for p, s in zip(case["prompts"], seeds)]
        res = eng.drain()
    finally:
        faults.reset()
    return {"tokens": [res[r].tokens.tolist() for r in rids],
            "cache_bytes": before,
            "cache_bytes_after": eng.cache_manager.cache_nbytes(),
            "recoveries": eng.metrics.engine_recoveries,
            "snapshot": eng.metrics.snapshot()}


def mesh_serving_program(params_np, cfg_kw, cases, mp=2):
    """This rank's results of every case of ``cases`` ({name: case}, as
    :func:`serve_case` takes it) served by an mp ``mp`` engine over the
    whole model's numpy state dict ``params_np``, in order."""
    torch.manual_seed(0)
    mesh = build_mesh(mp=mp)
    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    cfg = mesh_cfg(**cfg_kw)
    return {name: serve_case(params, cfg, case, mesh)
            for name, case in cases.items()}


def mesh_cuda_program(params_np, cfg_kw, prompts, max_length=12):
    """On the card: an mp 2 paged engine's streams, its first B8 output
    of layer 0 (this rank's heads) and its B8 launches per decode tick."""
    from fleetx_tpu_torch.ops import decode_attention as da

    mesh = build_mesh(mp=2)
    cfg = GPTConfig(**cfg_kw)
    params = {k: torch.from_numpy(v).cuda() for k, v in params_np.items()}
    out = serve_on_card(params, cfg, prompts, max_length, mesh)
    out["launches"] = da.launches["paged_decode"] - out.pop("before")
    return out


def serve_on_card(params, cfg, prompts, max_length, mesh=None):
    """A greedy paged engine on the card (under ``mesh``) over
    ``prompts``: its streams, the first B8 call's output and the decode
    ticks (with ``before``, B8's launch count before the traffic)."""
    from fleetx_tpu_torch.models.gpt import model as gpt_model
    from fleetx_tpu_torch.ops import decode_attention as da

    eng = ServingEngine(GPTForPretraining(cfg, device="meta"), params,
                        gen_cfg=GenerationConfig(decode_strategy="greedy",
                                                 eos_token_id=-1),
                        mesh=mesh, slots=2, cache_len=64, page_size=8)
    first = []
    kernel = gpt_model.paged_decode_attention

    def kept(*a, **kw):
        o = kernel(*a, **kw)
        if not first:
            first.append(o.detach().cpu().numpy())
        return o

    gpt_model.paged_decode_attention = kept
    before = da.launches["paged_decode"]
    try:
        for p in prompts:
            eng.submit(np.asarray(p, np.int32), max_length=max_length)
        ticks = 0
        while eng.scheduler.queue_depth or eng.cache_manager.active_count:
            ticks += eng.step()["decoded"] > 0
        res = eng.drain()
    finally:
        gpt_model.paged_decode_attention = kernel
    return {"tokens": [res[i].tokens.tolist() for i in sorted(res)],
            "first": first[0], "ticks": ticks, "before": before}


def run_mesh(params, cases, mp=2, **cfg_kw):
    """:func:`mesh_serving_program` on ``mp`` gloo ranks of the CPU; the
    ranks' results in rank order."""
    params_np = {k: v.detach().cpu().numpy() for k, v in params.items()}
    return run_ranks(mesh_serving_program, mp, params_np, cfg_kw, cases, mp)


# ------------------------------------------------------------------ tests

@pytest.fixture(scope="module")
def weights():
    cfg = mesh_cfg()
    return cfg, init_params(cfg, seed=3, device="cpu")


def test_seeded_sampling_on_mp2_equals_single_device(weights):
    """Seeded sampling requests draw the same streams on the mesh as on one
    device: every rank samples from the same gathered logits with the
    request's own generator (JAX ``test_mesh_mp2_fsdp2_and_sampling``)."""
    cfg, params = weights
    case = dict(gen=SAMPLING, prompts=PROMPTS, max_length=6,
                seeds=[11, 12, 13])
    want = serve_case(params, cfg, case)["tokens"]
    ranks = run_mesh(params, {"sampling": case})
    for rank in ranks:
        assert rank["sampling"]["tokens"] == want
    assert len({tuple(map(tuple, r["sampling"]["tokens"]))
                for r in ranks}) == 1


@pytest.mark.parametrize("mesh,error,match", [
    (Mesh(pp=2), ValueError, "pp/cp"),
    (Mesh(cp=2), ValueError, "pp/cp"),
    (Mesh(mp=8), ValueError, "heads"),
    (Mesh(fsdp=2, mp=2), NotImplementedError,
     "ZeRO stage 3 \\(parameter sharding\\)"),
], ids=["pp", "cp", "heads", "fsdp"])
def test_mesh_construction_refusals(weights, mesh, error, match):
    """JAX ``test_mesh_validation_and_spec_units``: pp/cp extents and heads
    mp does not divide raise ValueError; an fsdp extent (JAX shards the
    parameters over it) names the ROADMAP item that would port it."""
    cfg, params = weights
    with pytest.raises(error, match=match):
        ServingEngine(GPTForPretraining(cfg, device="meta"), params,
                      device="cpu", mesh=mesh, **ENGINE)


@pytest.mark.parametrize("switch", [
    dict(host_cache_bytes=1 << 20), dict(role="prefill", page_size=8),
    dict(tick_timeout_s=1.0)], ids=["tiers", "role", "watchdog"])
def test_mesh_refuses_tiers_roles_and_the_watchdog(weights, switch):
    """At mp > 1 the page tiers and the roles name the ROADMAP item that
    would port them (a rank holds a head slice, the wire format whole
    pages); the watchdog names its Queue C entry."""
    cfg, params = weights
    match = ("Gaps by design" if "tick_timeout_s" in switch
             else "Page tiers and roles under a mesh")
    with pytest.raises(NotImplementedError, match=match):
        ServingEngine(GPTForPretraining(cfg, device="meta"), params,
                      device="cpu", mesh=Mesh(mp=2), **ENGINE, **switch)


@pytest.mark.parametrize("vocab", [96, 97])
def test_int8_shard_plan(vocab):
    """The serving shard plan of a whole int8 state dict (JAX
    ``serving_param_shardings``): each ``_q8`` takes its weight's split,
    the fused qkv's ``_scale`` (3·hd channels shared by the heads) and
    every row-parallel or embedding scale are whole on each rank, the
    up projection's per-row scale splits with its rows, and a vocab that
    mp does not divide keeps the whole table."""
    cfg = mesh_cfg(vocab_size=vocab, decode_cache_len=32)
    hd = cfg.head_dim
    q = quantize_tree_int8(init_params(mesh_cfg(vocab_size=vocab), seed=1,
                                       device="cpu"), hd)
    shards = [shard_params(q, dataclasses.replace(cfg, mp_degree=2), r)
              for r in (0, 1)]
    pre = "gpt.layers.0."
    for name, axis in (("attn.qkv_proj.weight_q8", 0),
                       ("attn.out_proj.weight_q8", 1),
                       ("mlp.up_proj.weight_q8", 0),
                       ("mlp.down_proj.weight_q8", 1),
                       ("mlp.up_proj.weight_scale", 0)):
        whole = q[pre + name]
        assert torch.equal(torch.cat([s[pre + name] for s in shards], axis),
                           whole), name
        assert shards[0][pre + name].shape[axis] * 2 == whole.shape[axis]
    for name in ("attn.qkv_proj.weight_scale", "attn.out_proj.weight_scale",
                 "mlp.down_proj.weight_scale"):
        assert all(torch.equal(s[pre + name], q[pre + name])
                   for s in shards), name
    assert q[pre + "attn.qkv_proj.weight_scale"].shape == (3 * hd, 1)
    table = shards[0]["gpt.word_embeddings_q8"]
    assert table.shape[0] == (vocab // 2 if vocab % 2 == 0 else vocab)
    assert torch.equal(shards[1]["gpt.word_embeddings_scale"],
                       q["gpt.word_embeddings_scale"])
    # the engine's model takes the shard as it is
    model = GPTForPretraining(dataclasses.replace(cfg, mp_degree=2),
                              device="meta", int8=True)
    model.load_state_dict(shards[1], assign=True)
