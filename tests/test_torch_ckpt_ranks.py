"""Checkpoints of the port's ``Trainer`` over several ranks, held against
the port itself bit for bit.

JAX-free on purpose: :func:`fleetx_tpu_torch.parallel.launch.spawn` runs
:func:`resume_program` in fresh processes (the ranks of one gloo group on
the CPU, or ranks that share the card), which import this module and
nothing of JAX. At dp 2, cp 2 and mp 2 on the tiny config (dropout 0.1,
so the dropout generator is part of what must resume): a run that saves
at step 2 and a fresh trainer resumed from a copy of that step alone
end at step 4 with the same losses, parameters, AdamW state and
generator, bit for bit. A dp 2 checkpoint loads at dp 1 with the state
the ranks held when they saved it; a cp 2 or mp 2 checkpoint is refused
at cp 1 or mp 1 and quarantined nowhere. SIGTERM to one rank of dp 2
stops both after the same step.
"""

import os
import shutil

import numpy as np
import pytest

from fleetx_tpu_torch.parallel.mesh import set_mesh
from test_torch_cp_ranks import run_ranks
from test_torch_mp_ranks import TINY, overrides

STEPS, SAVE_AT = 4, 2


def trainer_state(trainer) -> dict:
    """numpy copies of a trainer's parameters, AdamW state (by parameter
    name; whole moments, gathered under the ZeRO update shard: every rank
    calls it) and generator state."""
    params = dict(trainer.module.nets.named_parameters())
    moments = {n: {k: v.detach().cpu().numpy().copy() for k, v in s.items()}
               for n, s in trainer.optimizer_state().items()}
    return {"params": {n: p.detach().cpu().numpy().copy()
                       for n, p in params.items()},
            "moments": moments,
            "generator": trainer.generator.get_state().numpy().copy()}


def assert_states_equal(a: dict, b: dict) -> None:
    """Parameters, AdamW state and generator equal bit for bit."""
    assert a["params"].keys() == b["params"].keys()
    for n in a["params"]:
        np.testing.assert_array_equal(a["params"][n], b["params"][n],
                                      err_msg=n)
        assert a["moments"][n].keys() == b["moments"][n].keys(), n
        for k in a["moments"][n]:
            np.testing.assert_array_equal(a["moments"][n][k],
                                          b["moments"][n][k],
                                          err_msg=f"{n} {k}")
    np.testing.assert_array_equal(a["generator"], b["generator"])


def _fit(cfg, device, resume=False, at_save=None):
    """A fresh trainer of ``cfg`` fitted to ``Engine.max_steps`` through
    the normal entry points; with ``resume``, it restores its output
    directory's newest step first and the sampler starts after the
    consumed samples (as ``tools/train.py`` does). ``at_save`` collects
    the state each save sees."""
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module

    trainer = Trainer(cfg, build_module(cfg), device=device)
    if at_save is not None:
        save = trainer.save

        def recorded(epoch=0):
            at_save.append((trainer.step, trainer_state(trainer)))
            return save(epoch)

        trainer.save = recorded
    trainer.init_state()
    loader = build_dataloader(cfg, "Train")
    if resume:
        assert trainer.step == SAVE_AT
        loader.batch_sampler.consumed_samples = trainer.consumed_samples
    trainer.fit(loader)
    return trainer


def resume_program(config, over, out_a, out_b, device="cpu"):
    """On this rank: (a) ``STEPS`` steps saving every ``SAVE_AT`` into
    ``out_a``; (b) rank 0 copies step ``SAVE_AT`` alone into ``out_b``;
    (c) a fresh trainer resumes there and trains to ``STEPS``. Returns
    both runs' per-step losses, final states, steps and consumed samples,
    and the state (a) held when it saved step ``SAVE_AT``."""
    import torch.distributed as dist

    from fleetx_tpu_torch.utils.config import get_config

    def cfg(out):
        return get_config(config, overrides=list(over) + [
            f"Engine.save_load.output_dir={out}",
            f"Engine.max_steps={STEPS}",
            f"Engine.save_load.save_steps={SAVE_AT}"])

    at_save = []
    a = _fit(cfg(out_a), device, at_save=at_save)
    if dist.get_rank() == 0:
        shutil.copytree(os.path.join(out_a, "checkpoints", str(SAVE_AT)),
                        os.path.join(out_b, "checkpoints", str(SAVE_AT)))
    dist.barrier()
    b = _fit(cfg(out_b), device, resume=True)
    mesh = a.mesh
    return {"coords": (mesh.dp_rank, mesh.cp_rank, mesh.mp_rank),
            "losses": [[float(h["loss"]) for h in t.history] for t in (a, b)],
            "states": [trainer_state(t) for t in (a, b)],
            "steps": [a.step, b.step],
            "consumed": [a.consumed_samples, b.consumed_samples],
            "at_save": dict(at_save)[SAVE_AT]}


def preempt_program(config, over, out, device="cpu"):
    """On this rank: a trainer of ``config`` fitted through the normal
    entry points, rank 1 sending itself SIGTERM as its step 3 begins.
    Returns the step this rank stopped at, the consumed samples and the
    committed steps."""
    import signal

    import torch.distributed as dist

    from fleetx_tpu_torch.core.checkpoint import CheckpointStore
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.utils.config import get_config

    cfg = get_config(config, overrides=list(over) + [
        f"Engine.save_load.output_dir={out}", "Engine.max_steps=6",
        "Engine.save_load.save_steps=0"])
    trainer = Trainer(cfg, build_module(cfg), device=device)
    trainer.init_state()
    step = trainer.train_step

    def preempted(batch):
        if dist.get_rank() == 1 and trainer.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(batch)

    trainer.train_step = preempted
    trainer.fit(build_dataloader(cfg, "Train"))
    return {"step": trainer.step, "consumed": trainer.consumed_samples,
            "steps": CheckpointStore(os.path.join(out, "checkpoints"))
            .all_steps()}


# ---------------------------------------------------------------- tests

@pytest.fixture(autouse=True)
def single_rank_mesh():
    """Each test starts, and leaves the process, on a single rank's mesh."""
    set_mesh(None)
    yield
    set_mesh(None)


LAYOUTS = {"dp2": (["Distributed.dp_degree=2", "Global.local_batch_size=2",
                    "Global.micro_batch_size=2"], 64),
           "cp2": (["Distributed.cp_degree=2"], 256),
           "mp2": (["Distributed.mp_degree=2", "Global.local_batch_size=2",
                    "Global.micro_batch_size=2"], 64)}


def _layout_overrides(tmp_path, name):
    extra, seq = LAYOUTS[name]
    return overrides(tmp_path, "torch", "Model.hidden_dropout_prob=0.1",
                     "Model.attention_probs_dropout_prob=0.1",
                     "Engine.logging_freq=1", *extra, seq=seq)


def _single_rank_trainer(over, out):
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.utils.config import get_config

    cfg = get_config(TINY, overrides=list(over) + [
        f"Engine.save_load.output_dir={out}"], nranks=1)
    return Trainer(cfg, build_module(cfg), device="cpu")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_save_load_continue_is_bit_identical_over_ranks(tmp_path, layout):
    """On 2 gloo ranks, a trainer resumed in fresh state from step 2
    alone continues as the uninterrupted run: the same losses for steps 3
    and 4, parameters, AdamW state and generator at step 4, and consumed
    samples, on every rank. Then the single-rank load of that checkpoint:
    a dp 2 step loads at dp 1 with the ranks' state at the save; a cp 2
    step is refused at cp 1 and an mp 2 step at mp 1, and neither is
    quarantined."""
    from fleetx_tpu_torch.resilience.elastic import ElasticMeshMismatch

    over = _layout_overrides(tmp_path, layout)
    out_a, out_b = str(tmp_path / "a"), str(tmp_path / "b")
    runs = run_ranks(resume_program, 2, TINY, over, out_a, out_b)
    for r in runs:
        a_losses, b_losses = r["losses"]
        assert len(a_losses) == STEPS and b_losses == a_losses[SAVE_AT:]
        assert r["steps"] == [STEPS, STEPS]
        assert r["consumed"][0] == r["consumed"][1] > 0
        assert_states_equal(*r["states"])
    assert sorted(os.listdir(os.path.join(out_b, "checkpoints"))) == [
        str(SAVE_AT), str(STEPS)]
    names = sorted(os.listdir(os.path.join(out_a, "checkpoints", "2")))
    assert names == (["meta.json", "state-mp0.pt", "state-mp1.pt"]
                     if layout == "mp2" else ["meta.json", "state-mp0.pt"])
    single = [o for o in over if not o.startswith(
        ("Distributed.", "Global.local_batch_size", "Global.micro_batch"))]
    trainer = _single_rank_trainer(single, out_b)
    if layout == "dp2":
        trainer.init_state()
        assert trainer.step == STEPS
        assert trainer.load(step=SAVE_AT)
        assert trainer.step == SAVE_AT
        assert_states_equal(trainer_state(trainer), runs[0]["at_save"])
        return
    with pytest.raises(ElasticMeshMismatch, match=f"{layout[:2]} 2->1"):
        trainer.init_state()
    assert sorted(os.listdir(os.path.join(out_b, "checkpoints"))) == [
        str(SAVE_AT), str(STEPS)]
    assert not os.path.exists(os.path.join(out_b, "quarantine"))


def test_sigterm_to_one_rank_stops_every_rank_after_the_same_step(tmp_path):
    """At dp 2, SIGTERM reaches rank 1 alone during step 3: both ranks
    finish step 3, save it together and return (a rank that went on would
    wait in the next gradient all-reduce for ever)."""
    over = _layout_overrides(tmp_path, "dp2")
    runs = run_ranks(preempt_program, 2, TINY, over, str(tmp_path / "out"))
    assert [r["step"] for r in runs] == [3, 3]
    assert [r["steps"] for r in runs] == [[3], [3]]
    assert runs[0]["consumed"] == runs[1]["consumed"] == 3 * 4
