"""Data- and context-parallel GPT training of the port against the JAX
package and against itself.

The tiny config (``configs/tiny/pretrain_gpt_tiny_cpu.yaml``, flash
attention on, fp32) at seq 256, so that each of the 2·cp zig-zag blocks
holds at least one 64-row tile. The port's ranks are spawned gloo
processes (``test_torch_cp_ranks.py``) that build everything through the
normal entry points. Tolerances: against JAX's cp 2 ``Trainer`` 1e-5 on
losses and 1e-4 on gradients (summation order); dp 2 × cp 2 and cp 2
against the port's cp 1, 2e-4 on losses (JAX test_cp_training.py:96-125).
"""

import logging
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from fleetx_tpu.core.engine import Trainer as JaxTrainer
from fleetx_tpu.data import build_dataloader as jax_build_dataloader
from fleetx_tpu.models import build_module as jax_build_module
from fleetx_tpu.parallel.mesh import use_mesh
from fleetx_tpu.utils.config import get_config as jax_get_config
from fleetx_tpu_torch.core.engine import Trainer
from fleetx_tpu_torch.data import build_dataloader
from fleetx_tpu_torch.models import build_module
from fleetx_tpu_torch.models.gpt.convert import params_from_jax
from fleetx_tpu_torch.parallel.mesh import mesh_from_config, set_mesh
from fleetx_tpu_torch.utils.config import get_config
from fleetx_tpu_torch.utils.log import logger
from test_torch_cp_ranks import run_ranks, train_program
from test_torch_training import write_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/tiny/pretrain_gpt_tiny_cpu.yaml")
SEQ = 256


def overrides(tmp_path, name, *extra):
    """The tiny config's overrides over a corpus of this package's own
    (each package caches its index maps next to the data)."""
    d = tmp_path / name
    d.mkdir(parents=True, exist_ok=True)
    write_corpus(str(d / "tiny"), n_docs=60)
    return [f"Data.Train.dataset.input_dir={d}/tiny",
            f"Data.Train.dataset.max_seq_len={SEQ}",
            f"Model.max_position_embeddings={SEQ}",
            "Model.use_flash_attention=True",
            "Model.hidden_dropout_prob=0.0",
            "Model.attention_probs_dropout_prob=0.0",
            "Optimizer.lr.warmup_steps=0", "Optimizer.lr.max_lr=1e-3",
            "Optimizer.lr.decay_steps=100",
            f"Engine.save_load.output_dir={d}/out", *extra]


@pytest.fixture(autouse=True)
def single_rank_mesh():
    """Each test starts, and leaves the process, on a single rank's mesh."""
    set_mesh(None)
    yield
    set_mesh(None)


def test_cp2_steps_match_the_jax_trainer_at_cp2(tmp_path, monkeypatch):
    """One and two ``Trainer`` steps at cp 2 (2 gloo ranks) from the JAX
    init: the first step's loss and every gradient leaf as JAX's cp 2
    loss and gradients on the 2 virtual devices, and both steps' losses as
    the JAX ``Trainer``'s; both ranks agree."""
    monkeypatch.setenv("FLEETX_FORCE_FLASH", "1")
    extra = ("Distributed.cp_degree=2", "Global.local_batch_size=2",
             "Global.micro_batch_size=2", "Engine.max_steps=2",
             "Engine.logging_freq=1")
    jcfg = jax_get_config(TINY, overrides=overrides(tmp_path, "jax", *extra),
                          nranks=2)
    jmod = jax_build_module(jcfg)
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
    assert gcfg.cp_degree == 2
    init = {n: t.numpy() for n, t in
            params_from_jax({"params": params}, gcfg).items()}
    config_over = overrides(tmp_path, "torch", *extra)
    runs = run_ranks(train_program, 2, TINY, config_over, 2, init)
    np.testing.assert_allclose(runs[0]["losses"][0], float(jl), rtol=1e-5)
    np.testing.assert_allclose(runs[0]["losses"], jlosses, rtol=1e-5)
    assert runs[0]["losses"][1] != runs[0]["losses"][0]
    want = params_from_jax({"params": jax.tree.map(np.asarray, jgrads)},
                           gcfg)
    assert want.keys() == runs[0]["grads"].keys()
    for name, g in want.items():
        np.testing.assert_allclose(runs[0]["grads"][name], g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    assert runs[1]["losses"] == runs[0]["losses"]
    assert runs[1]["checksum"] == runs[0]["checksum"]


def _cp1_steps(config_over, steps):
    cfg = get_config(TINY, overrides=config_over, nranks=1)
    trainer = Trainer(cfg, build_module(cfg), device="cpu")
    trainer.init_state()
    loader = iter(build_dataloader(cfg, "Train"))
    return [float(trainer.train_step(trainer._to_device(next(loader)))[
        "loss"]) for _ in range(steps)]


def test_dp2_cp2_and_cp2_match_cp1_and_split_batches_by_dp(tmp_path):
    """Two steps at attention dropout 0.1 (hidden dropout 0): cp 2 (2
    ranks) and dp 2 x cp 2 (4 ranks) give the cp 1 losses within 2e-4,
    every rank the same losses and parameters; the dp ranks read different
    rows and the ranks of one cp group the same."""
    drop = "Model.attention_probs_dropout_prob=0.1"
    base = overrides(tmp_path, "torch", drop, "Global.micro_batch_size=1")
    want = _cp1_steps(base + ["Global.local_batch_size=2"], 2)
    cp2 = run_ranks(train_program, 2, TINY,
                    base + ["Global.local_batch_size=2",
                            "Distributed.cp_degree=2"], 2, None)
    dpcp = run_ranks(train_program, 4, TINY,
                     base + ["Global.local_batch_size=1",
                             "Distributed.cp_degree=2",
                             "Distributed.dp_degree=2"], 2, None)
    for runs in (cp2, dpcp):
        np.testing.assert_allclose(runs[0]["losses"], want, rtol=2e-4)
        assert all(r["losses"] == runs[0]["losses"] for r in runs)
        assert all(r["checksum"] == runs[0]["checksum"] for r in runs)
    tokens = [r["tokens"] for r in dpcp]
    assert np.array_equal(tokens[0], tokens[1])
    assert np.array_equal(tokens[2], tokens[3])
    assert not np.array_equal(tokens[0], tokens[2])
    assert tokens[0].shape == (1, SEQ)


@pytest.mark.parametrize("key", ["Distributed.ep_degree",
                                 "Distributed.sharding.sharding_degree"])
def test_unported_degrees_raise_naming_a6(tmp_path, key):
    # sharding stages 1 and 2 are ported, stage 3 (the parameters sharded)
    # is not. ep_degree loads as JAX reads it: neither package reads it
    # (an MoE model's experts split over the data ranks), so the mesh and
    # the trainer build as without it
    if key.endswith("ep_degree"):
        over = overrides(tmp_path, "torch", f"{key}=2")
        cfg = get_config(TINY, overrides=over, nranks=1)
        jcfg = jax_get_config(TINY, overrides=over, nranks=1)
        assert cfg.Distributed.ep_degree == jcfg.Distributed.ep_degree == 2
        mesh = mesh_from_config(cfg)
        assert (mesh.world, mesh.data_world) == (1, 1)
        trainer = Trainer(cfg, build_module(cfg), device="cpu")
        assert trainer.mesh is mesh and trainer.ep_world == 1
        return
    extra = ("Distributed.sharding.sharding_stage=3",)
    cfg = get_config(TINY, overrides=overrides(tmp_path, "torch",
                                               f"{key}=2", *extra), nranks=2)
    match = re.escape('ROADMAP Queue A, "ZeRO stage 3 (parameter '
                      'sharding)"')
    with pytest.raises(NotImplementedError, match=match):
        mesh_from_config(cfg)
    with pytest.raises(NotImplementedError, match=match):
        Trainer(cfg, build_module(cfg), device="cpu")


def test_cp_turns_fused_ce_off_with_jax_warning(tmp_path):
    """Under cp the fused CE is turned off with a warning, as the JAX
    module does (language_module.py:208-230): the loss takes the logits."""
    over = ("Model.fused_ce=True", "Distributed.cp_degree=2")
    cfg = get_config(TINY, overrides=overrides(tmp_path, "torch", *over),
                     nranks=2)
    jcfg = jax_get_config(TINY, overrides=overrides(tmp_path, "jax", *over),
                          nranks=2)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger.addHandler(handler)
    try:
        module = build_module(cfg)
    finally:
        logger.removeHandler(handler)
    assert module.gpt_config.cp_degree == 2
    assert not module.gpt_config.fused_ce
    assert not jax_build_module(jcfg).gpt_config.fused_ce
    assert any("Model.fused_ce disabled: cp_degree=2" in r.getMessage()
               for r in records)


def test_cp_prepare_gives_each_rank_its_zigzag_blocks(tmp_path):
    """``cp_prepare`` at cp 2: rank r's tokens, true positions, labels and
    mask are its two zig-zag blocks of each row (blocks r and 3 - r)."""
    from fleetx_tpu_torch.parallel.mesh import Mesh

    cfg = get_config(TINY, overrides=overrides(
        tmp_path, "torch", "Distributed.cp_degree=2"), nranks=2)
    module = build_module(cfg)
    tokens = torch.arange(2 * SEQ).view(2, SEQ)
    batch = {"tokens": tokens, "labels": tokens + 1,
             "loss_mask": torch.ones(2, SEQ)}
    blk = SEQ // 4
    for rank in (0, 1):
        set_mesh(Mesh(1, 2, rank))  # the layout the config asks for
        toks, pos, labels, mask = module.cp_prepare(batch)
        want = torch.cat([torch.arange(rank * blk, (rank + 1) * blk),
                          torch.arange((3 - rank) * blk,
                                       (4 - rank) * blk)])
        assert torch.equal(pos[0], want) and torch.equal(toks[1],
                                                         SEQ + want)
        assert torch.equal(labels, toks + 1) and mask.shape == (2, SEQ // 2)
