"""The step sentry, fault injection and preemption of the port's
``Trainer``.

Against the JAX package: ``_Selector`` parses the JAX grammar to the same
index sets, ``FaultPlan.from_env`` reads the training variables as JAX's
does, ``validate_restore_mesh`` accepts and refuses the same (saved, now)
meshes, and a NaN batch fed to both Trainers from the same bridged
weights at dropout 0 is skipped at the same step with the same consumed
samples, the port's losses and final parameters within the 1e-5
relative of ``test_trainer_loss_path_matches_jax_trainer`` of JAX's (the
key bias, whose exact gradient is zero, aside). The JAX model runs its
Pallas kernels in interpret mode (``FLEETX_FORCE_FLASH=1``).

Against the port itself, bit for bit at dropout 0.1: a skipped NaN step
leaves parameters, AdamW state and the dropout generator where a run
that never saw the batch has them; the sentry aborts after
``FLEETX_SENTRY_MAX_SKIPS`` with the meta-advanced rewrite (JAX
``tests/test_resilience.py:103-127``); the loss and gradient-norm
thresholds trigger; SIGTERM mid-``fit`` saves and returns, and a fresh
trainer resumes there as the uninterrupted run; a host loss raises
before its step, once.
"""

import importlib
import os
import signal

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from fleetx_tpu.core.engine import Trainer as JaxTrainer
from fleetx_tpu.parallel.mesh import MeshConfig
from fleetx_tpu.models import build_module as jax_build_module
from fleetx_tpu_torch.core.engine import SentryAbort, Trainer
from fleetx_tpu_torch.data import build_dataloader
from fleetx_tpu_torch.models import build_module
from fleetx_tpu_torch.models.gpt.convert import params_from_jax
from fleetx_tpu_torch.parallel.mesh import Mesh
from fleetx_tpu_torch.resilience import elastic
from fleetx_tpu_torch.resilience.faults import HostLossFault, faults
from test_torch_checkpoint import (
    ckpt_root,
    clean_process_state,  # noqa: F401 - autouse fixture
    fit,
    losses,
    tiny_cfg,
)
from test_torch_ckpt_ranks import assert_states_equal, trainer_state
from test_torch_training import configs

# the modules (each package's resilience/__init__ binds ``faults`` to the
# injector)
jax_elastic = importlib.import_module("fleetx_tpu.resilience.elastic")
jax_faults = importlib.import_module("fleetx_tpu.resilience.faults")
port_faults = importlib.import_module("fleetx_tpu_torch.resilience.faults")


@pytest.fixture(autouse=True)
def inert_jax_faults():
    jax_faults.faults.reset()
    yield
    jax_faults.faults.reset()


def batches(cfg, n):
    """The first ``n`` batches of ``cfg``'s loader, as a list."""
    it = iter(build_dataloader(cfg, "Train"))
    return [next(it) for _ in range(n)]


def state_of(trainer):
    return trainer_state(trainer)


# ------------------------------------------------------------ against JAX

SELECTOR_SPECS = ["3", "1,4", "2+", "1,3", "0+", "5, 2+", " 7 ,", "4,4,6+"]


@pytest.mark.parametrize("spec", SELECTOR_SPECS)
def test_selector_parses_the_jax_grammar_to_the_same_sets(spec):
    """``_Selector`` holds the same indices as JAX's over 0..19 and is
    as truthy; an entry that is no int raises in both."""
    ours, theirs = port_faults._Selector(spec), jax_faults._Selector(spec)
    assert [i in ours for i in range(20)] == [i in theirs for i in range(20)]
    assert bool(ours) == bool(theirs)
    assert ours.exact == theirs.exact and ours.from_ == theirs.from_


@pytest.mark.parametrize("env", [
    {}, {"FLEETX_FAULT_NAN_BATCH": "2"},
    {"FLEETX_FAULT_DATA_RAISE_BATCH": "1,3", "FLEETX_FAULT_DATA_SLOW_S": "0.5",
     "FLEETX_FAULT_DATA_SLOW_BATCH": "0+"},
    {"FLEETX_FAULT_CKPT_SAVE_STEP": "4", "FLEETX_FAULT_HOST_LOSS_STEP": "2+"},
    {"FLEETX_FAULT_DATA_SLOW_S": "0.2"}],
    ids=["none", "nan", "data", "ckpt-host", "only-a-delay"])
def test_fault_plan_reads_the_training_variables_as_jax(env):
    ours = port_faults.FaultPlan.from_env(env)
    theirs = jax_faults.FaultPlan.from_env(env)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        for field in ("nan_batch", "data_raise_batch", "data_slow_batch",
                      "data_slow_s", "ckpt_save_step", "host_loss_step"):
            assert getattr(ours, field) == getattr(theirs, field), field
    with pytest.raises(ValueError, match="FLEETX_FAULT_DATA_SLOW_S"):
        port_faults.FaultPlan.from_env({"FLEETX_FAULT_DATA_SLOW_S": "x"})


MESH_PAIRS = [
    ({"dp": 4, "fsdp": 1, "mp": 1}, (2, 1, 1)),
    ({"dp": 2}, (2, 1, 1)),
    ({"dp": 1, "mp": 2, "cp": 1}, (4, 1, 2)),
    ({"dp": 2, "mp": 2}, (2, 1, 1)),
    ({"dp": 2, "pp": 2}, (2, 1, 1)),
    ({"dp": 2, "cp": 2}, (2, 1, 1)),
    ({"dp": 1, "cp": 1}, (1, 2, 1)),
    ({"dp": 1, "mp": 1, "pp": 1, "cp": 1, "fsdp": 2}, (1, 1, 1)),
    ({"dp": 2, "mp": 4, "cp": 2}, (1, 1, 2)),
    ({"dp": 1, "mp": None}, (1, 1, 1)),
]


@pytest.mark.parametrize("saved,now", MESH_PAIRS,
                         ids=[f"pair{i}" for i in range(len(MESH_PAIRS))])
def test_validate_restore_mesh_accepts_and_refuses_as_jax(saved, now):
    """The same verdict and message as JAX's for a saved mesh against
    the (dp, cp, mp) one restoring it (the port's has no fsdp or pp)."""
    dp, cp, mp = now

    def verdict(fn, mesh, mismatch):
        try:
            fn(saved, mesh, step=7)
        except mismatch as e:
            return str(e)
        return None

    ours = verdict(elastic.validate_restore_mesh, Mesh(dp, cp, mp=mp),
                   elastic.ElasticMeshMismatch)
    theirs = verdict(jax_elastic.validate_restore_mesh,
                     MeshConfig(dp=dp, cp=cp, mp=mp),
                     jax_elastic.ElasticMeshMismatch)
    assert ours == theirs


def test_nan_batch_is_skipped_as_the_jax_trainer_skips_it(tmp_path,
                                                          monkeypatch):
    """Five batches with the third poisoned (``loss_mask`` NaN), from the
    same bridged weights at dropout 0: both Trainers skip it, count five
    batches as consumed and apply four steps; the port's losses and final
    parameters lie within 1e-5 relative (1e-7 absolute) of JAX's."""
    monkeypatch.setenv("FLEETX_FORCE_FLASH", "1")
    extra = ("Engine.max_steps=5", "Engine.logging_freq=1",
             "Optimizer.lr.warmup_steps=1", "Optimizer.lr.max_lr=1e-3",
             "Optimizer.lr.decay_steps=100")
    tcfg, jcfg = configs(tmp_path, *extra)
    data = batches(tcfg, 5)
    jmod = jax_build_module(jcfg)
    jlosses = []
    monkeypatch.setattr(jmod, "training_step_end",
                        lambda log: jlosses.append(log["loss"]))
    jtrainer = JaxTrainer(jcfg, jmod)
    jtrainer.init_state(data[0])
    params = jax.tree.map(np.asarray, nn.meta.unbox(jtrainer.state.params))
    jax_faults.faults.configure(nan_batch="2")
    jtrainer.fit(data)

    tmod = build_module(tcfg)
    trainer = Trainer(tcfg, tmod, device="cpu")
    trainer.init_state(params_from_jax({"params": params}, tmod.gpt_config))
    faults.configure(nan_batch="2")
    trainer.fit(data)
    assert faults.injected["nan"] == jax_faults.faults.injected["nan"] == 1
    assert trainer.sentry_skips == jtrainer.sentry_skips == 1
    assert trainer.step == int(jtrainer.state.step) == 4
    assert trainer.consumed_samples == jtrainer.consumed_samples == 5 * 4
    np.testing.assert_allclose(losses(trainer), jlosses, rtol=1e-5)
    want = params_from_jax({"params": jax.tree.map(
        np.asarray, nn.meta.unbox(jtrainer.state.params))}, tmod.gpt_config)
    gcfg = tmod.gpt_config
    for name, p in tmod.nets.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        if name.endswith("qkv_proj.bias"):
            # the key bias adds q·b_k to every score of a row, which the
            # softmax cancels: its exact gradient is 0, and each side
            # moves it by Adam's normalised rounding noise, at most lr a
            # step. The query and value biases are held as the rest.
            hd = gcfg.hidden_size // gcfg.num_attention_heads
            got, ref = (x.reshape(-1, 3, hd) for x in (got, ref))
            for side in (got, ref):
                assert np.abs(side[:, 1]).max() <= 4 * 1e-3
            got, ref = got[:, [0, 2]], ref[:, [0, 2]]
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7,
                                   err_msg=name)


# ------------------------------------------------------- the port's sentry

def test_nan_skip_equals_never_seeing_the_batch(tmp_path):
    """At dropout 0.1: five batches with the third NaN against batches
    0, 1, 3, 4: the same four losses, parameters, AdamW state (step
    counts included) and generator, bit for bit; the skipped batch is
    consumed."""
    cfg = tiny_cfg(tmp_path, "clean", "Engine.save_load.save_steps=0",
                   "Engine.max_steps=5")
    data = batches(cfg, 5)
    clean = fit(cfg, data=[data[0], data[1], data[3], data[4]])
    faults.configure(nan_batch="2")
    faulty = fit(tiny_cfg(tmp_path, "faulty", "Engine.save_load.save_steps=0",
                          "Engine.max_steps=5"), data=data)
    assert faulty.sentry_skips == 1 and clean.sentry_skips == 0
    assert faulty.step == clean.step == 4
    assert faulty.consumed_samples == 5 * 4 and clean.consumed_samples == 16
    assert losses(faulty) == losses(clean)
    assert_states_equal(state_of(clean), state_of(faulty))


def test_skip_puts_the_generator_back(tmp_path):
    """A skipped ``train_step`` draws its dropout seeds, then returns the
    generator to its state before the step; no parameter, moment or step
    count moves; an applied step moves the generator."""
    cfg = tiny_cfg(tmp_path)
    trainer = Trainer(cfg, build_module(cfg), device="cpu")
    trainer.init_state()
    good, bad = batches(cfg, 2)
    trainer.train_step(trainer._to_device(good))
    before, gen = state_of(trainer), trainer.generator.get_state()
    bad = dict(bad, loss_mask=np.full_like(bad["loss_mask"], np.nan))
    out = trainer.train_step(trainer._to_device(bad))
    assert out["skipped"] and not np.isfinite(float(out["loss"]))
    assert torch.equal(trainer.generator.get_state(), gen)
    assert trainer.step == 1
    assert_states_equal(before, state_of(trainer))
    assert all(p.grad is None for p in trainer.module.nets.parameters())
    out = trainer.train_step(trainer._to_device(good))
    assert not out["skipped"] and trainer.step == 2
    assert not torch.equal(trainer.generator.get_state(), gen)


def test_sentry_off_applies_the_nan_step(tmp_path, monkeypatch):
    """``FLEETX_SENTRY=0``: the NaN batch is applied and poisons the
    weights, as it would without the sentry."""
    monkeypatch.setenv("FLEETX_SENTRY", "0")
    faults.configure(nan_batch="1")
    cfg = tiny_cfg(tmp_path, "out", "Engine.save_load.save_steps=0",
                   "Engine.max_steps=2")
    trainer = fit(cfg)
    assert trainer.step == 2 and trainer.sentry_skips == 0
    assert not np.isfinite(
        trainer.module.nets.gpt.final_norm.scale.detach().numpy()).all()


def test_sentry_aborts_after_consecutive_skips_with_the_rewrite(
        tmp_path, monkeypatch):
    """Batches from 2 on poisoned, ``FLEETX_SENTRY_MAX_SKIPS=2``, a save
    every 2 steps: two healthy steps, two skips, then the step-2
    checkpoint is rewritten with the advanced consumed samples and
    ``SentryAbort`` raised; a fresh trainer resumes past the poisoned
    batches."""
    monkeypatch.setenv("FLEETX_SENTRY_MAX_SKIPS", "2")
    monkeypatch.setenv("FLEETX_FAULT_NAN_BATCH", "2+")
    faults.configure_from_env()
    cfg = tiny_cfg(tmp_path, "out", "Engine.max_steps=8")
    with pytest.raises(SentryAbort, match="2 consecutive"):
        fit(cfg)
    faults.reset()
    t2 = Trainer(cfg, build_module(cfg), device="cpu")
    t2.init_state()
    assert t2.step == 2 and t2.consumed_samples == 4 * 4
    assert os.listdir(ckpt_root(cfg)) == ["2"]


@pytest.mark.parametrize("knob,value", [("FLEETX_SENTRY_GNORM_MAX", "1e-12"),
                                        ("FLEETX_SENTRY_LOSS_MAX", "1e-3")])
def test_thresholds_trigger(tmp_path, monkeypatch, knob, value):
    """A finite gradient norm (or loss) over its threshold is an anomaly:
    with an absurdly low one every step is skipped, and the run aborts
    after ``FLEETX_SENTRY_MAX_SKIPS``."""
    monkeypatch.setenv(knob, value)
    monkeypatch.setenv("FLEETX_SENTRY_MAX_SKIPS", "2")
    cfg = tiny_cfg(tmp_path, "out", "Engine.max_steps=8")
    trainer = Trainer(cfg, build_module(cfg), device="cpu")
    with pytest.raises(SentryAbort):
        trainer.fit(build_dataloader(cfg, "Train"))
    assert trainer.sentry_skips == 2 and trainer.step == 0


# ----------------------------------------------------------- preemption

def test_sigterm_mid_fit_saves_returns_and_resumes(tmp_path, monkeypatch):
    """SIGTERM to this process during step 3: ``fit`` finishes the step,
    saves step 3 and returns (the previous handler back in place); a fresh
    trainer resumes there and ends at step 6 as a run never preempted."""
    extra = ("Engine.max_steps=6", "Engine.save_load.save_steps=0")
    whole = fit(tiny_cfg(tmp_path, "whole", *extra))
    cfg = tiny_cfg(tmp_path, "out", *extra)
    trainer = Trainer(cfg, build_module(cfg), device="cpu")
    trainer.init_state()
    step = trainer.train_step

    def preempted_at_3(batch):
        if trainer.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(batch)

    trainer.train_step = preempted_at_3
    previous = signal.getsignal(signal.SIGTERM)
    trainer.fit(build_dataloader(cfg, "Train"))
    assert signal.getsignal(signal.SIGTERM) is previous
    assert trainer.step == 3 and os.listdir(ckpt_root(cfg)) == ["3"]
    resumed = fit(cfg, resume_from=3)
    assert losses(trainer) + losses(resumed) == losses(whole)
    assert_states_equal(state_of(whole), state_of(resumed))


def test_host_loss_raises_before_its_step_once(tmp_path):
    """``FLEETX_FAULT_HOST_LOSS_STEP=2`` raises before applied step 2 runs
    (its batch fetched, not applied); a second fit does not raise again;
    a slow batch is slept through and counted."""
    faults.configure(host_loss_step="2", data_slow_batch="0", data_slow_s=0.01)
    cfg = tiny_cfg(tmp_path, "out", "Engine.save_load.save_steps=0")
    trainer = Trainer(cfg, build_module(cfg), device="cpu")
    with pytest.raises(HostLossFault, match="before step 2"):
        trainer.fit(build_dataloader(cfg, "Train"))
    assert trainer.step == 2 and trainer.consumed_samples == 8
    assert faults.injected["host_loss"] == 1
    assert faults.injected["data_slow"] == 1
    trainer.fit(build_dataloader(cfg, "Train"))
    assert trainer.step == 4 and faults.injected["host_loss"] == 1
