"""The port's mesh (mp 2) serving engine with speculative decoding and
chunked prefill, against JAX's single-device and mp 2 engines.

The other half of JAX ``test_mesh_matrix_int8_spec_chunked``
(``test_torch_mesh_matrix.py`` holds int8): speculative decoding (n-gram
drafts, k 4, the verify under the mesh) and chunked prefill (chunk 3,
multi-call cache writes through the head slices), each paged and slot.
Both ranks' greedy streams must be byte-equal to JAX's single-device and
mp 2 engines' on the same weights.
"""

import pytest

from fleetx_tpu.parallel.mesh import MeshConfig, build_mesh
from test_torch_mesh_matrix import check_matrix_case
from test_torch_mesh_ranks import PROMPTS, run_mesh
from test_torch_mesh_serving import jax_streams
from torch_serving_cases import mesh_weights

CASES = {
    f"{name}-{layout}": dict(kw={**kw, "paged": layout == "paged"},
                             prompts=PROMPTS)
    for name, kw in (("spec", dict(spec=True, spec_k=4)),
                     ("chunk", dict(prefill_chunk=3)))
    for layout in ("paged", "slot")}


@pytest.fixture(scope="module")
def runs(eight_devices):
    """JAX's single-device and mp 2 streams and the port's ranks' results
    of every case."""
    tree, _, params = mesh_weights()
    mp2 = build_mesh(MeshConfig(mp=2), eight_devices[:2])
    jax_out = {name: (jax_streams(tree, case), jax_streams(tree, case, mp2))
               for name, case in CASES.items()}
    return jax_out, run_mesh(params, CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_mp2_spec_and_chunk_streams_match_jax(runs, name):
    check_matrix_case(runs, name)
