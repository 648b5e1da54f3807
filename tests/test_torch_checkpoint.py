"""Checkpoints of the port's ``Trainer`` on one rank.

Against the JAX package: the port's ``meta.json`` equals the JAX
``Trainer._save_meta`` for the same config, mesh and consumed samples.
Against the port itself, bit for bit, on the tiny config at dropout 0.1
(so the dropout generator is part of what must resume): save → load →
continue equals the uninterrupted run, through the synchronous save and
the async snapshot, through ``load(step=...)``, ``init_state``'s resume
and ``tools/train.py``'s; and the failure paths of JAX
``tests/test_resilience.py``: a mid-file truncation, a wrong step
counter, a missing key or a wrong shape is quarantined and the prior
step loads; every candidate bad raises ``CheckpointUnrestorable``; an
explicit bad step raises and stays; a ``CkptFault`` is survived and
counted; a raising data stream banks an emergency save; a rewrite that
meets a fault puts the old copy back; ``max_to_keep`` keeps three steps.
"""

import functools
import json
import os

import pytest
import torch

from fleetx_tpu.core.engine import Trainer as JaxTrainer
from fleetx_tpu.models import build_module as jax_build_module
from fleetx_tpu.parallel.mesh import MeshConfig
from fleetx_tpu.utils.config import get_config as jax_get_config
from fleetx_tpu_torch.core.checkpoint import CheckpointStore, state_file
from fleetx_tpu_torch.core.engine import CheckpointUnrestorable, Trainer
from fleetx_tpu_torch.data import build_dataloader
from fleetx_tpu_torch.models import build_module
from fleetx_tpu_torch.parallel.mesh import Mesh, set_mesh
from fleetx_tpu_torch.resilience.faults import CkptFault, DataFault, faults
from fleetx_tpu_torch.utils.config import get_config
from test_torch_ckpt_ranks import assert_states_equal, trainer_state
from test_torch_training import TINY, write_corpus


@pytest.fixture(autouse=True)
def clean_process_state(monkeypatch):
    """An inert fault injector, a single rank's mesh and no trainer knob
    from the environment, before and after each test."""
    for name in ("FLEETX_CKPT_ASYNC_SNAPSHOT", "FLEETX_SENTRY",
                 "FLEETX_SENTRY_LOSS_MAX", "FLEETX_SENTRY_GNORM_MAX",
                 "FLEETX_SENTRY_MAX_SKIPS"):
        monkeypatch.delenv(name, raising=False)
    faults.reset()
    set_mesh(None)
    yield
    faults.reset()
    set_mesh(None)


def tiny_cfg(tmp_path, out="out", *extra, loader=get_config):
    """The tiny config at dropout 0.1 (flash attention on, fp32) over a
    corpus of its own under ``tmp_path``, writing to ``tmp_path/out``:
    4 steps, a log line and a save every 2."""
    prefix = tmp_path / ("jax" if loader is jax_get_config else "torch")
    if not (prefix / "tiny_ids.npy").exists():
        prefix.mkdir(parents=True, exist_ok=True)
        write_corpus(str(prefix / "tiny"))
    return loader(TINY, overrides=[
        f"Data.Train.dataset.input_dir={prefix}/tiny",
        "Model.use_flash_attention=True", "Engine.max_steps=4",
        "Engine.logging_freq=1", "Engine.save_load.save_steps=2",
        "Optimizer.lr.warmup_steps=1", "Optimizer.lr.max_lr=1e-3",
        f"Engine.save_load.output_dir={tmp_path / out}", *extra], nranks=1)


def fit(cfg, resume_from=None, data=None):
    """A fresh trainer of ``cfg`` fitted through the normal entry points.
    ``resume_from``: the step ``load`` must restore before the fit (the
    sampler then starts after the consumed samples, as ``tools/train.py``
    sets it). ``data`` replaces the loader."""
    trainer = Trainer(cfg, build_module(cfg), device="cpu")
    trainer.init_state()
    loader = build_dataloader(cfg, "Train") if data is None else data
    if resume_from is not None:
        assert trainer.load(step=resume_from)
        if data is None:
            loader.batch_sampler.consumed_samples = trainer.consumed_samples
    trainer.fit(loader)
    return trainer


def losses(trainer):
    return [float(h["loss"]) for h in trainer.history]


def ckpt_root(cfg):
    return os.path.join(cfg.Engine.save_load.output_dir, "checkpoints")


# ------------------------------------------------------------ against JAX

@pytest.mark.parametrize("dp,cp,mp", [(1, 1, 1), (2, 1, 1), (1, 2, 1),
                                      (2, 1, 2)])
def test_meta_matches_jax_save_meta(tmp_path, dp, cp, mp):
    """``_save_meta`` equals the JAX ``Trainer``'s for the same config,
    mesh, epoch and consumed samples; on one rank ``meta.json`` on disk is
    exactly it."""
    tcfg = tiny_cfg(tmp_path)
    jcfg = tiny_cfg(tmp_path, "jax-out", loader=jax_get_config)
    trainer = Trainer(tcfg, build_module(tcfg), device="cpu")
    jtrainer = JaxTrainer(jcfg, jax_build_module(jcfg))
    trainer.mesh = Mesh(dp, cp, mp=mp)
    jtrainer.mesh_cfg = MeshConfig(dp=dp, cp=cp, mp=mp)
    for t in (trainer, jtrainer):
        t.consumed_samples = 1234
    assert trainer._save_meta(3) == jtrainer._save_meta(3)
    if (dp, cp, mp) == (1, 1, 1):
        trainer.init_state()
        trainer.save(epoch=3)
        with open(os.path.join(ckpt_root(tcfg), "0", "meta.json")) as f:
            assert json.load(f) == jtrainer._save_meta(3)


# ------------------------------------------------------- resume, bit for bit

@pytest.mark.parametrize("snapshot", ["sync", "async"])
def test_save_load_continue_is_bit_identical(tmp_path, monkeypatch,
                                             snapshot):
    """A run saving at steps 2 and 4 (synchronously, or as host snapshots
    written by the uploader thread); a fresh trainer that loads step 2
    and continues: the same losses for steps 3 and 4, and the same
    parameters, AdamW state, generator and consumed samples at step 4.
    Without the generator's restore the losses differ."""
    monkeypatch.setenv("FLEETX_CKPT_ASYNC_SNAPSHOT",
                       "1" if snapshot == "async" else "0")
    cfg = tiny_cfg(tmp_path)
    a = fit(cfg)
    assert (a._upload_thread is None and a.last_save["step"] == 4
            and a.last_save["total_s"] >= a.last_save["blocking_s"] > 0)
    assert CheckpointStore(ckpt_root(cfg)).all_steps() == [2, 4]
    b = fit(cfg, resume_from=2)
    assert b._ckpt_async == (snapshot == "async")
    assert losses(b) == losses(a)[2:] and b.step == 4
    assert b.consumed_samples == a.consumed_samples == 16
    assert_states_equal(trainer_state(a), trainer_state(b))

    c = Trainer(cfg, build_module(cfg), device="cpu")
    c.init_state()
    c.load(step=2)
    c.generator.manual_seed(c.seed)  # the planted fault: no generator
    loader = build_dataloader(cfg, "Train")
    loader.batch_sampler.consumed_samples = c.consumed_samples
    c.fit(loader)
    assert losses(c) != losses(a)[2:]


def test_init_state_resumes_the_newest_step(tmp_path):
    """``init_state`` on an output directory that holds steps restores the
    newest: step, epoch, consumed samples, parameters and AdamW state;
    ``load()`` after it does not restore again."""
    cfg = tiny_cfg(tmp_path)
    a = fit(cfg)
    b = Trainer(cfg, build_module(cfg), device="cpu")
    b.init_state()
    assert (b.step, b.start_epoch, b.consumed_samples) == (4, 0, 16)
    assert_states_equal(trainer_state(a), trainer_state(b))
    assert b.load() is True and b.step == 4


def test_train_cli_resumes_with_ckpt_dir(tmp_path, monkeypatch):
    """``tools/train.py`` to step 2, then relaunched to step 4 with
    ``Engine.save_load.ckpt_dir`` set: the joined losses and the final
    parameters equal one launch to step 4."""
    from fleetx_tpu_torch.tools import train as cli

    monkeypatch.setattr(cli, "Trainer",
                        functools.partial(Trainer, device="cpu"))
    tiny_cfg(tmp_path)  # the corpus
    base = ["-c", TINY, "-o",
            f"Data.Train.dataset.input_dir={tmp_path}/torch/tiny",
            "-o", "Model.use_flash_attention=True",
            "-o", "Engine.save_load.save_steps=2",
            "-o", "Engine.logging_freq=1"]
    whole = cli.main(base + ["-o", "Engine.max_steps=4", "-o",
                             f"Engine.save_load.output_dir={tmp_path}/w"])
    out = f"Engine.save_load.output_dir={tmp_path}/r"
    first = cli.main(base + ["-o", "Engine.max_steps=2", "-o", out])
    second = cli.main(base + ["-o", "Engine.max_steps=4", "-o", out, "-o",
                              f"Engine.save_load.ckpt_dir={tmp_path}/r"])
    assert first.step == 2 and second.step == 4
    assert losses(first) + losses(second) == losses(whole)
    assert_states_equal(trainer_state(whole), trainer_state(second))


# -------------------------------------------------------- failure paths

def _truncate(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)


def _rewrite_state(path, edit):
    state = torch.load(path, weights_only=True)
    edit(state)
    torch.save(state, path)


CORRUPTIONS = {
    "truncated mid-file": _truncate,
    "wrong step counter": functools.partial(
        _rewrite_state, edit=lambda s: s.update(step=s["step"] + 1)),
    "missing key": functools.partial(
        _rewrite_state, edit=lambda s: s["params"].pop("gpt.final_norm.bias")),
    "wrong shape": functools.partial(
        _rewrite_state, edit=lambda s: s["params"].update({
            "gpt.final_norm.bias": torch.zeros(3)})),
    "moment of another shape": functools.partial(
        _rewrite_state, edit=lambda s: s["optimizer"]["state"][
            "gpt.final_norm.bias"].update(exp_avg=torch.zeros(3))),
}


@pytest.mark.parametrize("corruption", sorted(CORRUPTIONS))
def test_bad_newest_step_is_quarantined_and_the_prior_loads(tmp_path,
                                                          corruption):
    """The newest step made unrestorable is moved to
    ``<output_dir>/quarantine/4``; the resume falls back to step 2, bit
    for bit the state a run holds at step 2."""
    cfg = tiny_cfg(tmp_path)
    fit(cfg)
    ref = fit(tiny_cfg(tmp_path, "ref", "Engine.max_steps=2"))
    CORRUPTIONS[corruption](os.path.join(ckpt_root(cfg), "4",
                                         state_file(0)))
    b = Trainer(cfg, build_module(cfg), device="cpu")
    b.init_state()
    assert b.step == 2 and b.consumed_samples == 8
    assert_states_equal(trainer_state(ref), trainer_state(b))
    assert CheckpointStore(ckpt_root(cfg)).all_steps() == [2]
    qdir = os.path.join(cfg.Engine.save_load.output_dir, "quarantine")
    assert os.listdir(qdir) == ["4"]


def test_every_candidate_bad_raises_and_explicit_step_is_kept(tmp_path):
    """``load(step=4)`` of a bad step raises and quarantines nothing;
    with every step bad, the walk quarantines them all and raises
    ``CheckpointUnrestorable``; with none, ``load`` returns False."""
    cfg = tiny_cfg(tmp_path)
    fit(cfg)
    for step in (2, 4):
        _truncate(os.path.join(ckpt_root(cfg), str(step), state_file(0)))
    b = Trainer(tiny_cfg(tmp_path, "fresh"), build_module(cfg),
                device="cpu")
    b.init_state()  # its own output directory holds nothing
    assert b.load() is False
    b.output_dir, b._store = cfg.Engine.save_load.output_dir, None
    with pytest.raises(Exception, match="zip|archive|central directory"):
        b.load(step=4)
    assert CheckpointStore(ckpt_root(cfg)).all_steps() == [2, 4]
    with pytest.raises(CheckpointUnrestorable, match=r"\[4, 2\]"):
        b.load()
    assert CheckpointStore(ckpt_root(cfg)).all_steps() == []
    qdir = os.path.join(cfg.Engine.save_load.output_dir, "quarantine")
    assert sorted(os.listdir(qdir)) == ["2", "4"]


def test_ckpt_fault_is_survived_and_counted(tmp_path):
    """A ``CkptFault`` at step 2 fails that save; the run goes on, counts
    it, and saves step 4; no partial step is listed."""
    faults.configure(ckpt_save_step="2")
    cfg = tiny_cfg(tmp_path)
    a = fit(cfg)
    assert a.step == 4 and a.save_failures == 1 and faults.injected["ckpt"]
    assert os.listdir(ckpt_root(cfg)) == ["4"]


def test_async_upload_failure_is_counted(tmp_path, monkeypatch):
    """A snapshot whose write fails in the uploader thread is counted as
    a failed save; its partial step is dropped; the run goes on."""
    monkeypatch.setenv("FLEETX_CKPT_ASYNC_SNAPSHOT", "1")
    cfg = tiny_cfg(tmp_path)
    write = CheckpointStore.write_state

    def failing(self, step, mp_rank, state):
        if step == 2:
            raise OSError("disk full")
        return write(self, step, mp_rank, state)

    monkeypatch.setattr(CheckpointStore, "write_state", failing)
    a = fit(cfg)
    assert a.save_failures == 1 and os.listdir(ckpt_root(cfg)) == ["4"]


def test_raising_stream_banks_an_emergency_save(tmp_path):
    """The data stream raising at batch 3 re-raises out of ``fit`` after
    a checkpoint of step 3 is written; a fresh trainer resumes there."""
    faults.configure(data_raise_batch="3")
    cfg = tiny_cfg(tmp_path)
    with pytest.raises(DataFault):
        fit(cfg)
    faults.reset()
    assert CheckpointStore(ckpt_root(cfg)).all_steps() == [2, 3]
    b = Trainer(cfg, build_module(cfg), device="cpu")
    b.init_state()
    assert b.step == 3 and b.consumed_samples == 12


def test_rewrite_meeting_a_fault_reattaches_the_old_copy(tmp_path):
    """A save of a step already on disk with advanced meta detaches the
    old copy and rewrites it; when the rewrite meets a ``CkptFault`` the
    old copy, meta and all, is put back and the fault surfaces."""
    cfg = tiny_cfg(tmp_path, "out", "Engine.max_steps=2")
    a = fit(cfg)
    step_dir = os.path.join(ckpt_root(cfg), "2")
    with open(os.path.join(step_dir, "meta.json")) as f:
        before = json.load(f)
    a.consumed_samples += 4  # as a sentry skip advances it
    faults.configure(ckpt_save_step="2")
    with pytest.raises(CkptFault):
        a.save(epoch=0)
    with open(os.path.join(step_dir, "meta.json")) as f:
        assert json.load(f) == before
    assert not os.listdir(os.path.join(cfg.Engine.save_load.output_dir,
                                       "rewrite"))
    faults.reset()
    a.save(epoch=0)  # the rewrite goes through: the meta moves on
    with open(os.path.join(step_dir, "meta.json")) as f:
        assert json.load(f)["consumed_samples"] == 12
    a.save(epoch=0)  # unchanged meta: the duplicate is skipped
    assert a.last_save["step"] == 2


def test_store_keeps_the_newest_three_and_never_lists_a_torn_step(tmp_path):
    """Five saves leave steps 3, 4 and 5; a ``<step>.tmp`` directory (a
    write that never committed) is not a step."""
    cfg = tiny_cfg(tmp_path, "out", "Engine.max_steps=5",
                   "Engine.save_load.save_steps=1")
    fit(cfg)
    store = CheckpointStore(ckpt_root(cfg))
    os.makedirs(os.path.join(store.root, "6.tmp"))
    assert store.all_steps() == [3, 4, 5]
    assert sorted(os.listdir(store.step_dir(5))) == ["meta.json",
                                                     "state-mp0.pt"]
