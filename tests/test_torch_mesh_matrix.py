"""The port's mesh (mp 2) serving engine at int8 KV and int8 weights,
against JAX's single-device and mp 2 engines.

The int8 half of JAX ``test_mesh_matrix_int8_spec_chunked``: int8 KV with
int8 weights (the whole model quantized before its shards are cut, the
scales' split JAX's), paged and slot; ``test_torch_mesh_spec_chunk.py``
holds the other half. Both ranks' greedy streams must be byte-equal to
JAX's single-device and mp 2 engines' on the same weights. The cases run
as ``test_torch_mesh_serving.py`` runs its own: the JAX engines once per
module, the port's ranks in one spawn.
"""

import pytest

from test_torch_mesh_ranks import PROMPTS, run_mesh
from test_torch_mesh_serving import jax_streams
from torch_serving_cases import mesh_weights

from fleetx_tpu.parallel.mesh import MeshConfig, build_mesh

CASES = {
    f"{name}-{layout}": dict(kw={**kw, "paged": layout == "paged"},
                             prompts=PROMPTS)
    for name, kw in (("int8", dict(kv_dtype="int8", weight_dtype="int8")),)
    for layout in ("paged", "slot")}


@pytest.fixture(scope="module")
def w():
    return mesh_weights()


@pytest.fixture(scope="module")
def runs(w, eight_devices):
    """JAX's single-device and mp 2 streams and the port's ranks' results
    of every case."""
    mp2 = build_mesh(MeshConfig(mp=2), eight_devices[:2])
    jax_out = {name: (jax_streams(w[0], case), jax_streams(w[0], case, mp2))
               for name, case in CASES.items()}
    return jax_out, run_mesh(w[2], CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_mp2_matrix_streams_match_jax(runs, name):
    check_matrix_case(runs, name)


def check_matrix_case(runs, name):
    """Both ranks' streams of case ``name`` against JAX's engines."""
    jax_out, ranks = runs
    single, mp2 = jax_out[name]
    assert mp2 == single  # the reference agrees with itself
    for rank in ranks:
        assert rank[name]["tokens"] == single, name
    if name.startswith("int8"):
        snap = ranks[0][name]["snapshot"]
        assert snap["weight_dtype"] == "int8" and snap["kv_dtype"] == "int8"
