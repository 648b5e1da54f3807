"""Tensor-parallel (mp) GPT training of the port with the vocab-parallel
fused cross-entropy B12 against the JAX package's mp 2 ``Trainer``.

The tiny config and the tolerances of ``test_torch_mp_training.py`` (1e-5
on losses, 1e-4 on every gathered gradient leaf), whose check this file
runs with ``Model.fused_ce=True``: the port's B12 (plain versions of B4-B6
on the CPU) against JAX ``fused_linear_ce`` under GSPMD on 2 virtual
devices.
"""

import pytest

from fleetx_tpu_torch.parallel.mesh import set_mesh
from test_torch_mp_training import check_steps_against_the_jax_trainer_at_mp2


@pytest.fixture(autouse=True)
def single_rank_mesh():
    """Each test starts, and leaves the process, on a single rank's mesh."""
    set_mesh(None)
    yield
    set_mesh(None)


def test_mp2_and_dp2_mp2_fused_ce_steps_match_the_jax_trainer(tmp_path,
                                                              monkeypatch):
    """B12 at mp 2 and dp 2 x mp 2 against JAX's mp 2 ``Trainer``."""
    check_steps_against_the_jax_trainer_at_mp2(tmp_path, monkeypatch, True)
