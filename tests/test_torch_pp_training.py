"""Pipeline-parallel (pp) GPT training of the port against the JAX package.

The tiny config (``configs/tiny/pretrain_gpt_tiny_cpu.yaml``) cut to 4
layers (as ``tests/test_pipeline.py`` cuts its pp model), flash attention
on, fp32, dropout 0, seq 64, a global batch of 4 rows in 2 microbatches
(``Engine.accumulate_steps`` 2, which JAX's pipeline streams). The JAX
``Trainer`` runs pp 2 as GSPMD on 2 virtual devices with
``FLEETX_FORCE_FLASH=1`` (its Pallas kernels in interpret mode); the
port's ranks are spawned gloo processes (``test_torch_pp_ranks.py``) that
take the JAX init, each cut to its stage. Tolerances are those
``test_torch_mp_training.py`` holds mp to: 1e-5 on losses and 1e-4 on
every gradient leaf (summation order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
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
from test_torch_mp_ranks import TINY, mp_train_program, overrides
from test_torch_pp_ranks import joined

EXTRA = ("Distributed.pp_degree=2", "Global.local_batch_size=4",
         "Global.micro_batch_size=2", "Model.num_layers=4",
         "Engine.max_steps=2", "Engine.logging_freq=1")


@pytest.fixture(autouse=True)
def single_rank_mesh():
    """Each test starts, and leaves the process, on a single rank's mesh."""
    set_mesh(None)
    yield
    set_mesh(None)


@pytest.fixture(scope="module")
def jax_pp2(tmp_path_factory):
    """JAX's pp 2 ``Trainer`` over two steps: the port's overrides, the
    whole model's init (numpy state dict), the first step's loss and
    gradients (the port's names) and both steps' logged losses."""
    tmp = tmp_path_factory.mktemp("pp")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLEETX_FORCE_FLASH", "1")
        jcfg = jax_get_config(TINY, overrides=overrides(tmp, "jax", *EXTRA),
                              nranks=2)
        jmod = jax_build_module(jcfg)
        assert (jmod.gpt_config.pp_degree,
                jmod.gpt_config.num_microbatches) == (2, 2)
        jlosses = []
        mp.setattr(jmod, "training_step_end",
                   lambda log: jlosses.append(log["loss"]))
        jloader = jax_build_dataloader(jcfg, "Train")
        batch = {k: jnp.asarray(v) for k, v in next(iter(jloader)).items()}
        jtrainer = JaxTrainer(jcfg, jmod)
        jtrainer.init_state(batch)
        params = jax.tree.map(np.asarray,
                              nn.meta.unbox(jtrainer.state.params))
        assert "pipe" in params["gpt"]["layers"]
        with use_mesh(jtrainer.mesh):
            jl, jgrads = jax.jit(jax.value_and_grad(
                lambda p: jmod.loss_fn(p, batch, None, train=False)[0]))(
                    params)
        jtrainer.fit(jloader)
    assert len(jlosses) == 2
    base = overrides(tmp, "torch", *EXTRA)
    whole = build_module(get_config(
        TINY, overrides=overrides(tmp, "torch", "Model.num_layers=4"),
        nranks=1)).gpt_config
    init = {n: t.numpy() for n, t in
            params_from_jax({"params": params}, whole).items()}
    want = {n: g.numpy() for n, g in params_from_jax(
        {"params": jax.tree.map(np.asarray, jgrads)}, whole).items()}
    return base, init, float(jl), want, jlosses


@pytest.mark.parametrize("extra,nprocs", [
    ((), 2),
    (("Model.virtual_pp_degree=2",), 2),
    (("Distributed.dp_degree=2", "Global.local_batch_size=2",
      "Global.micro_batch_size=1"), 4),
], ids=["pp2", "pp2xv2", "dp2xpp2"])
def test_pp_steps_match_the_jax_trainer_at_pp2(jax_pp2, extra, nprocs):
    """Two ``Trainer`` steps at pp 2, pp 2 × v 2 and dp 2 × pp 2 (the same
    global batch and microbatch rows) from JAX's init: the first step's
    loss and every gradient leaf (the stages joined) as JAX's pp 2 loss
    and gradients, both steps' losses as the JAX ``Trainer``'s; every rank
    logs the same losses and grad norms, and the two copies of the tied
    embedding have the same gradient."""
    base, init, jl, want, jlosses = jax_pp2
    runs = run_ranks(mp_train_program, nprocs, TINY, base + list(extra), 2,
                     init)
    np.testing.assert_allclose(runs[0]["losses"][0], jl, rtol=1e-5)
    np.testing.assert_allclose(runs[0]["losses"], jlosses, rtol=1e-5)
    assert runs[0]["losses"][1] != runs[0]["losses"][0]
    for r in runs:
        assert r["losses"] == runs[0]["losses"]
        assert r["grad_norms"] == runs[0]["grad_norms"]
        assert r["n_params"] == sum(g.size for g in want.values())
    replica = [r for r in runs if r["coords"][0] == 0]  # dp rank 0
    got = joined(replica)
    assert got.keys() == want.keys()
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    first, last = sorted(replica, key=lambda r: r["pp_rank"])
    np.testing.assert_array_equal(first["grads"]["gpt.word_embeddings"],
                                  last["grads"]["gpt.word_embeddings"])
