"""The port's tensor-parallel ``Trainer`` against itself: mp 2 and dp 2 ×
mp 2 against one rank, with dropout.

JAX-free; the ranks are spawned gloo processes running
``test_torch_mp_ranks.mp_train_program`` on the tiny config in fp32. An
mp layout changes only the order of fp32 sums, so losses and grad norms
are held to one rank's within 1e-5.
"""

import numpy as np
import pytest

from fleetx_tpu_torch.parallel.mesh import set_mesh
from test_torch_cp_ranks import run_ranks
from test_torch_mp_ranks import (
    TINY,
    check_replicas,
    mp_train_program,
    overrides,
    single_rank_steps,
)


@pytest.fixture(autouse=True)
def single_rank_mesh():
    """Each test starts, and leaves the process, on a single rank's mesh."""
    set_mesh(None)
    yield
    set_mesh(None)


@pytest.mark.parametrize("fused", [False, True], ids=["logits", "fused_ce"])
def test_mp2_and_dp2_mp2_match_mp1_with_dropout(tmp_path, fused):
    """Two steps from the seeded init (each rank its shards of the mp 1
    draw) at hidden and attention dropout 0.1: mp 2 (2 ranks) and dp 2 x
    mp 2 (4 ranks) give mp 1's losses and grad norms within 1e-5 (the
    same masks: the hidden dropout acts on the replicated activation, the
    attention dropout keys on global heads); the mp ranks read the same
    rows and the dp ranks different ones. No gradient accumulation: the
    dropout hash keys on the row in the step's global batch."""
    base = overrides(tmp_path, "torch", "Model.hidden_dropout_prob=0.1",
                     "Model.attention_probs_dropout_prob=0.1",
                     f"Model.fused_ce={fused}")
    two = ["Global.local_batch_size=2", "Global.micro_batch_size=2"]
    want, norms = single_rank_steps(base + two, 2)
    mp2 = run_ranks(mp_train_program, 2, TINY,
                    base + two + ["Distributed.mp_degree=2"], 2, None)
    dpmp = run_ranks(mp_train_program, 4, TINY,
                     base + ["Global.local_batch_size=1",
                             "Global.micro_batch_size=1",
                             "Distributed.mp_degree=2",
                             "Distributed.dp_degree=2"], 2, None)
    for runs in (mp2, dpmp):
        np.testing.assert_allclose(runs[0]["losses"], want, rtol=1e-5)
        np.testing.assert_allclose(runs[0]["grad_norms"], norms, rtol=1e-5)
        check_replicas(runs, 2)
    tokens = [r["tokens"] for r in dpmp]
    assert [r["coords"] for r in dpmp] == [(0, 0, 0), (0, 0, 1), (1, 0, 0),
                                           (1, 0, 1)]
    assert np.array_equal(tokens[0], tokens[1])
    assert np.array_equal(tokens[2], tokens[3])
    assert not np.array_equal(tokens[0], tokens[2])
