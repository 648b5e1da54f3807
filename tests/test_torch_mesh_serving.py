"""The port's mesh (mp 2) serving engine against JAX's single-device and
mp 2 engines.

The port runs SPMD: two gloo ranks on the CPU, each an engine over the
whole state dict that keeps its heads, MLP and vocab shard
(``test_torch_mesh_ranks.mesh_serving_program``); JAX runs one engine over
a two-device mesh (``tests/test_mesh_serving.py``, on ``eight_devices``).
On the same weights (the mesh config, drawn at std 0.3 so that greedy
streams vary) every stream of both ranks must be byte-equal to JAX's
single-device and mp 2 engines', paged and slot and after a recovered tick
fault; each rank's cache holds half the single-device bytes, also after
the recovery's rebuild, and the gauges say so. The JAX engines and the
port's ranks run once per module (the ranks run every case in one spawn).
"""

import numpy as np
import pytest

from fleetx_tpu.models.gpt.generation import (
    GenerationConfig as JaxGenerationConfig,
)
from fleetx_tpu.parallel.mesh import MeshConfig, build_mesh
from fleetx_tpu.resilience.faults import faults as jax_faults
from fleetx_tpu.serving import ServingEngine as JaxServingEngine
from test_torch_mesh_ranks import (
    ENGINE,
    NO_EOS,
    PROMPTS,
    run_mesh,
    serve_case,
)
from torch_serving_cases import mesh_jax_model, mesh_weights

CASES = {
    "paged": dict(prompts=PROMPTS),
    "slot": dict(kw=dict(paged=False), prompts=PROMPTS),
    "recovered": dict(prompts=PROMPTS, fault=dict(tick_raise="1")),
}


def jax_streams(tree, case, mesh=None):
    """JAX's engine (on ``mesh`` when given) over ``case``'s requests, its
    fault plan on JAX's own injector."""
    gen = JaxGenerationConfig(decode_strategy="greedy", eos_token_id=NO_EOS,
                              pad_token_id=95)
    eng = JaxServingEngine(mesh_jax_model(), tree, gen_cfg=gen, mesh=mesh,
                           **{**ENGINE, **case.get("kw", {})})
    if case.get("fault"):
        jax_faults.configure(**case["fault"])
    try:
        rids = [eng.submit(np.asarray(p, np.int32),
                           max_length=case.get("max_length", 5))
                for p in case["prompts"]]
        res = eng.drain()
    finally:
        jax_faults.reset()
    return [np.asarray(res[r].tokens).tolist() for r in rids]


@pytest.fixture(scope="module")
def w():
    return mesh_weights()


@pytest.fixture(scope="module")
def jax_runs(w, eight_devices):
    """JAX's single-device and mp 2 streams of every case (the single run
    without its fault plan: the fault-free stream is the recovered one)."""
    mp2 = build_mesh(MeshConfig(mp=2), eight_devices[:2])
    tree = w[0]
    single = {name: jax_streams(tree, case) for name, case in CASES.items()
              if "fault" not in case}
    single["recovered"] = single["paged"]  # the same requests, no fault
    return {name: (single[name], jax_streams(tree, case, mp2))
            for name, case in CASES.items()}


@pytest.fixture(scope="module")
def port_runs(w):
    """Each rank's results of every case, and the single-device port
    engine's cache bytes per layout."""
    _, cfg, params = w
    single = {name: serve_case(params, cfg, case)
              for name, case in CASES.items() if "fault" not in case}
    single["recovered"] = single["paged"]
    return run_mesh(params, CASES), single


@pytest.mark.parametrize("name", list(CASES))
def test_mp2_streams_match_jax_single_and_mp2_engines(jax_runs, port_runs,
                                                      name):
    """JAX ``test_mesh_paged_parity_cache_bytes_and_gauge``,
    ``test_mesh_slot_path_parity`` and
    ``test_mesh_recover_rebuilds_sharded_state``: both ranks' greedy
    streams byte-equal to JAX's single-device and mp 2 engines'."""
    single, mp2 = jax_runs[name]
    assert mp2 == single  # the reference agrees with itself
    ranks, port_single = port_runs
    assert port_single[name]["tokens"] == single
    for rank in ranks:
        assert rank[name]["tokens"] == single, name


@pytest.mark.parametrize("name", list(CASES))
def test_mp2_cache_bytes_per_rank_and_gauges(port_runs, name):
    """Each rank's cache holds half the single-device engine's bytes (its
    heads), in [0.45, 0.55], also after the recovery's rebuild; the gauges
    read ``mesh_devices`` 2, ``mesh`` "mp2" and the per-rank bytes."""
    ranks, single = port_runs
    want = single[name]["cache_bytes"]
    for rank in ranks:
        got = rank[name]
        assert 0.45 <= got["cache_bytes"] / want <= 0.55
        assert 0.45 <= got["cache_bytes_after"] / want <= 0.55
        snap = got["snapshot"]
        assert snap["kv_cache_bytes"] == got["cache_bytes"]
        assert snap["mesh_devices"] == 2 and snap["mesh"] == "mp2"
        assert got["recoveries"] == (1 if name == "recovered" else 0)
    assert single[name]["snapshot"]["mesh_devices"] == 1
    assert single[name]["snapshot"]["mesh"] == "-"
