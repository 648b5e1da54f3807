"""Megatron sequence parallelism (``Model.sequence_parallel`` at mp 2) of
the port's ``Trainer`` against the JAX ``Trainer`` at mp 2 × SP.

The tiny config (vocab 128, hidden 64, 4 heads, ffn 128, 2 layers; flash
on, fp32, seq 64), 3 steps from the JAX init on 2 gloo ranks
(``test_torch_mp_ranks.mp_train_program``) against JAX on 2 virtual
devices, where GSPMD maps ``act_seq`` to ``mp``. The limits are those of
``test_torch_mp_training.py``: 1e-5 on the losses, 1e-4 relative (1e-6
absolute) on every gathered gradient leaf of the first step. The port
against itself without SP is ``test_torch_sp_ranks.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from fleetx_tpu.core.engine import Trainer as JaxTrainer
from fleetx_tpu.data import build_dataloader as jax_build_dataloader
from fleetx_tpu.models import build_module as jax_build_module
from fleetx_tpu.parallel.mesh import use_mesh
from fleetx_tpu.utils.config import get_config as jax_get_config
from fleetx_tpu_torch.models import build_module
from fleetx_tpu_torch.models.gpt.convert import params_from_jax
from fleetx_tpu_torch.parallel.mesh import set_mesh
from fleetx_tpu_torch.utils.config import get_config
from test_torch_cp_ranks import run_ranks
from test_torch_mp_ranks import (
    TINY,
    check_replicas,
    gathered_grads,
    mp_train_program,
    overrides,
)

STEPS = 3


@pytest.fixture(autouse=True)
def single_rank_mesh():
    set_mesh(None)
    yield
    set_mesh(None)


def test_mp2_sp_trainer_matches_the_jax_trainer(tmp_path, monkeypatch):
    """Three ``Trainer`` steps at mp 2 × SP: the first step's loss and
    every gathered gradient leaf as JAX's, the three losses as the JAX
    ``Trainer``'s; both ranks agree and the mp-replicated parameters
    (summed over the group under SP) are equal on both ranks."""
    monkeypatch.setenv("FLEETX_FORCE_FLASH", "1")
    extra = ("Distributed.mp_degree=2", "Model.sequence_parallel=True",
             "Global.local_batch_size=2", "Global.micro_batch_size=2",
             f"Engine.max_steps={STEPS}", "Engine.logging_freq=1")
    jcfg = jax_get_config(TINY, overrides=overrides(tmp_path, "jax", *extra),
                          nranks=2)
    jmod = jax_build_module(jcfg)
    assert jmod.gpt_config.sequence_parallel
    jlosses = []
    monkeypatch.setattr(jmod, "training_step_end",
                        lambda log: jlosses.append(log["loss"]))
    jloader = jax_build_dataloader(jcfg, "Train")
    batch = {k: jnp.asarray(v) for k, v in next(iter(jloader)).items()}
    jtrainer = JaxTrainer(jcfg, jmod)
    jtrainer.init_state(batch)
    params = jax.tree.map(np.asarray, nn.meta.unbox(jtrainer.state.params))
    with use_mesh(jtrainer.mesh):
        jl, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jmod.loss_fn(p, batch, None, train=False)[0]))(params)
    jtrainer.fit(jloader)
    assert len(jlosses) == STEPS
    over = overrides(tmp_path, "torch", *extra)
    gcfg = build_module(get_config(TINY, overrides=over,
                                   nranks=2)).gpt_config
    assert gcfg.sp
    whole = dataclasses.replace(gcfg, mp_degree=1)
    init = {n: t.numpy() for n, t in
            params_from_jax({"params": params}, whole).items()}
    want = params_from_jax({"params": jax.tree.map(np.asarray, jgrads)},
                           whole)
    runs = run_ranks(mp_train_program, 2, TINY, over, STEPS, init)
    np.testing.assert_allclose(runs[0]["losses"][0], float(jl), rtol=1e-5)
    np.testing.assert_allclose(runs[0]["losses"], jlosses, rtol=1e-5)
    got = gathered_grads(runs, gcfg)
    assert want.keys() == got.keys()
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    check_replicas(runs, 2)
