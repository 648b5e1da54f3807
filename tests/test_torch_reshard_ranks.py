"""Reshard-on-load of the port's ``Trainer``: a checkpoint written under
the ZeRO update shard at sharding 2 holds whole tensors, and loads at
another data-parallel layout byte for byte.

JAX-free: :func:`fleetx_tpu_torch.parallel.launch.spawn` runs the rank
programs here in fresh gloo processes. On the tiny config (dropout 0.1,
so the dropout generator is part of what must resume) two steps at
sharding 2 (stage 2) save step 2; the AdamW slices are gathered to the
writer first. Restored on the same mesh (2 ranks, each taking its slices
back) and at dp 1 (one process, the whole moments), the parameters, the
whole moments, the generator, the step, the epoch and the consumed
samples are equal bit for bit, and equal to what the ranks held when
they saved. The same checkpoint restored at mp 2 is refused with
``ElasticMeshMismatch`` and quarantined nowhere.
"""

import json
import os

import pytest

from fleetx_tpu_torch.parallel.mesh import set_mesh
from test_torch_ckpt_ranks import assert_states_equal, trainer_state
from test_torch_cp_ranks import run_ranks
from test_torch_mp_ranks import TINY, overrides
from test_torch_zero_ranks import FSDP2

SAVE_AT = 2


def _trainer(config, over, out, device="cpu"):
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.utils.config import get_config

    cfg = get_config(config, overrides=list(over) + [
        f"Engine.save_load.output_dir={out}",
        f"Engine.max_steps={SAVE_AT}",
        f"Engine.save_load.save_steps={SAVE_AT}"])
    return cfg, Trainer(cfg, build_module(cfg), device=device)


def save_program(config, over, out, device="cpu"):
    """``SAVE_AT`` steps from the seeded init that save the last: the
    state the ranks held at the save (whole moments) and the trainer's
    step and consumed samples."""
    from fleetx_tpu_torch.data import build_dataloader

    cfg, trainer = _trainer(config, over, out, device)
    trainer.init_state()
    trainer.fit(build_dataloader(cfg, "Train"))
    return {"state": trainer_state(trainer), "step": trainer.step,
            "consumed": trainer.consumed_samples,
            "zero": trainer.zero is not None}


def restore_program(config, over, out, device="cpu"):
    """A fresh trainer of the config resumed from ``out``: its state
    (whole moments), step, epoch, consumed samples and mesh; or, when the
    load is refused, the refusal's message and what the checkpoint root
    and the quarantine hold afterwards."""
    from fleetx_tpu_torch.resilience.elastic import ElasticMeshMismatch

    _, trainer = _trainer(config, over, out, device)
    try:
        trainer.init_state()
    except ElasticMeshMismatch as e:
        return {"refused": str(e),
                "steps": sorted(os.listdir(os.path.join(out, "checkpoints"))),
                "quarantine": os.path.exists(os.path.join(out,
                                                          "quarantine"))}
    mesh = trainer.mesh
    return {"state": trainer_state(trainer), "step": trainer.step,
            "epoch": trainer.start_epoch,
            "consumed": trainer.consumed_samples,
            "mesh": (mesh.dp, mesh.fsdp, mesh.mp),
            "zero": trainer.zero is not None}


@pytest.fixture(autouse=True)
def single_rank_mesh():
    """Each test starts, and leaves the process, on a single rank's mesh."""
    set_mesh(None)
    yield
    set_mesh(None)


def test_sharding2_checkpoint_reshards_onto_dp1_byte_for_byte(tmp_path):
    """Step 2 saved at sharding 2 under the update shard: its meta records
    fsdp 2; restored on the same 2-rank mesh and at dp 1 in this process,
    parameters, whole moments, generator, step, epoch and consumed samples
    equal each other and the state the ranks saved, bit for bit."""
    over = overrides(tmp_path, "torch", *FSDP2,
                     "Model.hidden_dropout_prob=0.1",
                     "Model.attention_probs_dropout_prob=0.1",
                     "Global.local_batch_size=2", "Global.micro_batch_size=1")
    out = str(tmp_path / "out")
    saved = run_ranks(save_program, 2, TINY, over, out)
    assert [s["zero"] for s in saved] == [True, True]
    assert_states_equal(saved[0]["state"], saved[1]["state"])
    with open(os.path.join(out, "checkpoints", str(SAVE_AT),
                           "meta.json")) as f:
        meta = json.load(f)
    assert meta["mesh"] == {"dp": 1, "fsdp": 2, "mp": 1, "pp": 1, "cp": 1}
    assert meta["consumed_samples"] == saved[0]["consumed"] == SAVE_AT * 4
    same = run_ranks(restore_program, 2, TINY, over, out)
    single = [o for o in over if not o.startswith(
        ("Distributed.", "Global.local_batch_size", "Global.micro_batch"))]
    dp1 = restore_program(TINY, single + ["Global.local_batch_size=4",
                                          "Global.micro_batch_size=2"], out)
    assert dp1["mesh"] == (1, 1, 1) and not dp1["zero"]
    assert [r["mesh"] for r in same] == [(1, 2, 1)] * 2
    for r in same + [dp1]:
        assert (r["step"], r["epoch"], r["consumed"]) == (
            SAVE_AT, 0, SAVE_AT * 4)
        assert_states_equal(r["state"], dp1["state"])
    assert_states_equal(dp1["state"], saved[0]["state"])
    assert dp1["state"]["moments"]["gpt.word_embeddings"]["exp_avg"].shape \
        == (128, 64)


def test_an_mp_change_is_refused_and_quarantines_nothing(tmp_path):
    """The sharding-2 checkpoint restored at mp 2 on 2 ranks raises
    ``ElasticMeshMismatch`` naming the mp change on both, and the step
    stays where it was: nothing is quarantined."""
    over = overrides(tmp_path, "torch", *FSDP2, "Global.local_batch_size=2",
                     "Global.micro_batch_size=1")
    out = str(tmp_path / "out")
    run_ranks(save_program, 2, TINY, over, out)
    mp2 = [o for o in over if not o.startswith("Distributed.")] + [
        "Distributed.mp_degree=2", "Global.local_batch_size=4",
        "Global.micro_batch_size=2"]
    refused = run_ranks(restore_program, 2, TINY, mp2, out)
    for r in refused:
        assert "mp 1->2" in r["refused"]
        assert r["steps"] == [str(SAVE_AT)]
        assert not r["quarantine"]
