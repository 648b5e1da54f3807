"""The port's ZeRO weight-update shard under tensor and pipeline
parallelism, held against the port's replicated update.

JAX-free: the rank programs are ``test_torch_zero_ranks.py``'s. At
sharding 2 (stage 2) × mp 2 the update shard folds the fsdp axis onto a
dimension of each rank's mp shard (on top of the mp split, as JAX's
``zero_update_spec`` does); at pp 2 × sharding 2 it shards each stage's
parameters over that stage's zero group, and the tied embedding's two
copies sum their slices over the embedding group. On 4 gloo ranks, three
steps from the seeded init on the tiny config (4 layers under pp) in
fp32: the update shard on and off give the same parameters and whole
AdamW moments within ``test_zero_update.py``'s ``atol 2e-6``, and the
ranks of one (pp, mp) coordinate hold them bit for bit.
"""

import numpy as np
import pytest

from fleetx_tpu_torch.parallel.mesh import set_mesh
from test_torch_cp_ranks import run_ranks
from test_torch_mp_ranks import TINY, overrides
from test_torch_zero_ranks import (
    FSDP2,
    STEPS,
    assert_close,
    assert_replicas_equal,
    zero_fit_program,
)

LAYOUTS = {
    "fsdp2xmp2": ("Distributed.mp_degree=2", "Global.local_batch_size=2",
                  "Global.micro_batch_size=1"),
    "pp2xfsdp2": ("Distributed.pp_degree=2", "Model.num_layers=4",
                  "Global.local_batch_size=2",
                  "Global.micro_batch_size=1"),
}


@pytest.fixture(autouse=True)
def single_rank_mesh():
    """Each test starts, and leaves the process, on a single rank's mesh."""
    set_mesh(None)
    yield
    set_mesh(None)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_zero_on_equals_zero_off_with_mp_and_pp(tmp_path, layout):
    """Three steps on 4 ranks with the update shard on and off: the same
    losses (1e-6) and grad norms, parameters and whole moments within
    2e-6, the replicas bit-equal, the coordinates laid out (pp, dp, fsdp,
    cp, mp) with mp fastest."""
    over = overrides(tmp_path, "torch", *FSDP2, *LAYOUTS[layout])
    on = run_ranks(zero_fit_program, 4, TINY, over, STEPS, None, "1")
    off = run_ranks(zero_fit_program, 4, TINY, over, STEPS, None, "0")
    want = ([(0, 0, 0, 0, 0), (0, 0, 0, 0, 1), (0, 0, 1, 0, 0),
             (0, 0, 1, 0, 1)] if layout == "fsdp2xmp2" else
            [(0, 0, 0, 0, 0), (0, 0, 1, 0, 0), (1, 0, 0, 0, 0),
             (1, 0, 1, 0, 0)])
    assert [r["coords"] for r in on] == want
    assert all(r["zero"] for r in on) and not any(r["zero"] for r in off)
    for runs in (on, off):
        assert_replicas_equal(runs)
        assert all(r["losses"] == runs[0]["losses"] for r in runs)
    np.testing.assert_allclose(on[0]["losses"], off[0]["losses"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(on[0]["grad_norms"], off[0]["grad_norms"],
                               rtol=1e-6)
    for a, b in zip(on, off):
        assert_close(a, b)
        assert a["opt_bytes"] <= 0.55 * b["opt_bytes"]
    if layout == "pp2xfsdp2":  # the tied copies stay equal
        first, last = on[0], on[2]
        np.testing.assert_array_equal(first["params"]["gpt.word_embeddings"],
                                      last["params"]["gpt.word_embeddings"])
