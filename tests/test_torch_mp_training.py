"""Tensor-parallel (mp) GPT training of the port against the JAX package and
against itself.

The tiny config (``configs/tiny/pretrain_gpt_tiny_cpu.yaml``: vocab 128,
hidden 64, 4 heads, ffn 128, 2 layers; flash attention on, fp32, seq 64).
The port's ranks are spawned gloo processes (``test_torch_mp_ranks.py``)
that build everything through the normal entry points; each shards the
whole model's weights for its mp rank. Tolerances: against JAX's mp 2
``Trainer`` (GSPMD on 2 virtual devices) 1e-5 on losses and 1e-4 on every
gathered gradient leaf (summation order), on the logits path and with
``fused_ce`` (B12, in ``test_torch_mp_training_fused.py``). The port's
mp 2, dp 2 × mp 2 and cp 2 × mp 2 against its own mp 1 are in
``test_torch_mp_layouts.py`` and ``test_torch_mp_ranks.py``.
"""

import dataclasses

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
from test_torch_mp_ranks import (
    TINY,
    check_replicas,
    gathered_grads,
    mp_train_program,
    overrides,
)

@pytest.fixture(autouse=True)
def single_rank_mesh():
    """Each test starts, and leaves the process, on a single rank's mesh."""
    set_mesh(None)
    yield
    set_mesh(None)


def check_steps_against_the_jax_trainer_at_mp2(tmp_path, monkeypatch,
                                               fused):
    """One and two ``Trainer`` steps at mp 2 (2 gloo ranks) and dp 2 x mp 2
    (4 ranks, the same global batch) from the JAX init: the first step's
    loss and every gathered gradient leaf as JAX's mp 2 loss and gradients
    on 2 virtual devices, both steps' losses as the JAX ``Trainer``'s;
    every rank agrees, and the replicated parameters are equal on every
    rank after each run. ``fused``: B12 in place of the logits path."""
    monkeypatch.setenv("FLEETX_FORCE_FLASH", "1")
    extra = ("Distributed.mp_degree=2", "Global.local_batch_size=2",
             "Global.micro_batch_size=2", "Engine.max_steps=2",
             "Engine.logging_freq=1", f"Model.fused_ce={fused}")
    jcfg = jax_get_config(TINY, overrides=overrides(tmp_path, "jax", *extra),
                          nranks=2)
    jmod = jax_build_module(jcfg)
    assert jmod.gpt_config.fused_ce == fused
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
    assert len(jlosses) == 2

    tcfg = get_config(TINY, overrides=overrides(tmp_path, "torch", *extra),
                      nranks=2)
    gcfg = build_module(tcfg).gpt_config
    assert (gcfg.mp_degree, gcfg.fused_ce) == (2, fused)
    whole = dataclasses.replace(gcfg, mp_degree=1)
    init = {n: t.numpy() for n, t in
            params_from_jax({"params": params}, whole).items()}
    want = params_from_jax({"params": jax.tree.map(np.asarray, jgrads)},
                           whole)
    base = overrides(tmp_path, "torch", *extra)
    dpmp = base + ["Distributed.dp_degree=2", "Global.local_batch_size=1",
                   "Global.micro_batch_size=1"]
    for label, nprocs, over in (("mp2", 2, base), ("dp2xmp2", 4, dpmp)):
        runs = run_ranks(mp_train_program, nprocs, TINY, over, 2, init)
        np.testing.assert_allclose(runs[0]["losses"][0], float(jl),
                                   rtol=1e-5, err_msg=label)
        np.testing.assert_allclose(runs[0]["losses"], jlosses, rtol=1e-5,
                                   err_msg=label)
        assert runs[0]["losses"][1] != runs[0]["losses"][0]
        got = gathered_grads(runs, gcfg)
        assert want.keys() == got.keys()
        for name, g in want.items():
            np.testing.assert_allclose(got[name], g.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{label} {name}")
        check_replicas(runs, 2)
        assert runs[0]["n_params"] == sum(t.numel() for t in want.values())


def test_mp2_and_dp2_mp2_logits_steps_match_the_jax_trainer(tmp_path,
                                                            monkeypatch):
    """The logits path (``vocab_parallel_token_losses``) at mp 2 and dp 2 x
    mp 2 against JAX's mp 2 ``Trainer``; B12 is held the same way in
    ``test_torch_mp_training_fused.py``."""
    check_steps_against_the_jax_trainer_at_mp2(tmp_path, monkeypatch, False)


def test_mp_keeps_fused_ce_when_the_vocab_shard_fits(tmp_path):
    """As the JAX module (language_module.py:208-230): under mp the fused CE
    stays on when vocab / mp fits a lane-aligned block, and is demoted
    with a warning when it does not (vocab 256 over mp 8 is 32 wide)."""
    def module(vocab, mp):
        over = overrides(tmp_path, "torch", "Model.fused_ce=True",
                         f"Model.vocab_size={vocab}",
                         f"Distributed.mp_degree={mp}",
                         "Model.num_attention_heads=8")
        return build_module(get_config(TINY, overrides=over, nranks=mp))

    ok = module(128, 2)
    assert ok.gpt_config.fused_ce and ok.fused_ce_blocked is None
    blocked = module(256, 8)
    assert not blocked.gpt_config.fused_ce
    assert "vocab 256 / mp 8" in blocked.fused_ce_blocked
    jcfg = jax_get_config(TINY, overrides=overrides(
        tmp_path, "jax", "Model.fused_ce=True", "Model.vocab_size=256",
        "Distributed.mp_degree=8", "Model.num_attention_heads=8"), nranks=8)
    assert not jax_build_module(jcfg).gpt_config.fused_ce
    with pytest.raises(ValueError, match="does not split over mp_degree 3"):
        module(128, 3)
