"""The port's elastic supervisor over real ranks: a host loss shrinks the
mesh and the run resumes through reshard-on-load.

JAX-free: :func:`fleetx_tpu_torch.parallel.launch.spawn` runs
:func:`elastic_program` in fresh gloo processes. It mirrors the JAX
package's ``tools/chaos_check.py`` ``scenario_train_elastic``
(:1199-1291): a dp 4 run of global batch 8 loses a host before step 3
(``FLEETX_FAULT_HOST_LOSS_STEP=3``); every rank checkpoints step 3, the
mesh shrinks to dp 2 with the global batch held (local batch 2 -> 4),
ranks 2 and 3 leave (exit code 0), ranks 0 and 1 re-form the process
group, resume from step 3 and finish 6 steps. Every batch is consumed
exactly once, and the losses before and after the shrink lie within
``atol 2e-5`` of an uninterrupted dp 2 run over the same batches (dp 4
and dp 2 differ only in the order of fp32 sums).
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from fleetx_tpu_torch.parallel import launch
from fleetx_tpu_torch.parallel.mesh import set_mesh
from test_torch_cp_ranks import RANK_TIMEOUT, run_ranks
from test_torch_mp_ranks import ROOT, TINY, overrides

STEPS, GBS = 6, 8


def elastic_program(config, over, host_loss_step=None, device="cpu"):
    """``fit`` of the config through the normal entry points under
    ``run_elastic`` (``make_loader`` as ``tools/train.py`` passes it),
    with the host-loss fault at ``host_loss_step``. Returns whether this
    rank left, the losses of every applied step (the first trainer's,
    then the resumed one's), the final trainer's step, restored step,
    consumed samples, skips and data-parallel degree, and the faults
    injected."""
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.resilience.elastic import run_elastic
    from fleetx_tpu_torch.resilience.faults import faults
    from fleetx_tpu_torch.utils.config import get_config

    cfg = get_config(config, overrides=list(over) + [
        f"Engine.max_steps={STEPS}", "Engine.logging_freq=1"])
    trainers = [Trainer(cfg, build_module(cfg), device=device)]

    def build_trainer(c):
        trainers.append(Trainer(c, build_module(c), device=device))
        return trainers[-1]

    if host_loss_step is not None:
        faults.configure(host_loss_step=host_loss_step)
    try:
        trainers[0].init_state()
        final = run_elastic(
            cfg, trainers[0], build_dataloader(cfg, "Train"),
            build_trainer=build_trainer,
            make_loader=lambda c, consumed: build_dataloader(c, "Train"))
        injected = dict(faults.injected)
    finally:
        faults.reset()
    out = {"left": final is None, "injected": injected,
           "losses": [float(h["loss"]) for t in trainers
                      for h in t.history]}
    if final is not None:
        out.update(step=final.step, restored=final._restored_step,
                   consumed=final.consumed_samples, skips=final.sentry_skips,
                   dp=final.mesh.dp, world=final.mesh.world)
    return out


@pytest.fixture(autouse=True)
def single_rank_mesh():
    """Each test starts, and leaves the process, on a single rank's mesh."""
    set_mesh(None)
    yield
    set_mesh(None)


def test_host_loss_shrinks_dp4_to_dp2_and_resumes(tmp_path):
    """dp 4 → dp 2 at step 3 on 4 gloo ranks against an uninterrupted dp 2
    run: 6/6 batches consumed once, the restored step 3, the losses of
    all six steps within 2e-5, ranks 2 and 3 gone with exit code 0."""
    base = overrides(tmp_path, "torch")
    ref = run_ranks(elastic_program, 2, TINY, base + [
        "Distributed.dp_degree=2", "Global.local_batch_size=4",
        "Global.micro_batch_size=4",
        f"Engine.save_load.output_dir={tmp_path}/ref"])
    runs = run_ranks(elastic_program, 4, TINY, base + [
        "Distributed.dp_degree=4", "Global.local_batch_size=2",
        "Global.micro_batch_size=2",
        f"Engine.save_load.output_dir={tmp_path}/elastic"], "3")
    assert launch.last_exitcodes == [0, 0, 0, 0]
    assert [r["left"] for r in runs] == [False, False, True, True]
    assert len(ref[0]["losses"]) == STEPS and not ref[0]["left"]
    for r in runs:
        assert r["injected"]["host_loss"] == 1
    for r in runs[:2]:
        assert (r["step"], r["restored"], r["dp"], r["world"]) == (
            STEPS, 3, 2, 2)
        assert r["consumed"] == STEPS * GBS and r["skips"] == 0
        assert len(r["losses"]) == STEPS
        np.testing.assert_allclose(r["losses"], ref[0]["losses"], rtol=0,
                                   atol=2e-5)
    for r in runs[2:]:  # the departed ranks applied the first three steps
        np.testing.assert_array_equal(r["losses"], runs[0]["losses"][:3])


def test_host_loss_fires_once_per_step_index():
    """``FLEETX_FAULT_HOST_LOSS_STEP=3``: the step path raises before step
    3 once; the resumed run passes step 3 again without a second loss."""
    from fleetx_tpu_torch.resilience.faults import HostLossFault, faults

    faults.configure(host_loss_step="3")
    try:
        faults.on_train_step(2)
        with pytest.raises(HostLossFault):
            faults.on_train_step(3)
        faults.on_train_step(3)
        faults.on_train_step(4)
        assert faults.injected["host_loss"] == 1
    finally:
        faults.reset()


def shrink_program(world):
    """Shrink this group to its first ``world`` ranks with the launcher's
    flag set, as ``python -m torch.distributed.run`` sets it for its
    workers (a ``tcp://`` rendezvous then makes every rank a client of the
    launcher's store), and sum the kept ranks' ids over the new group.
    Returns (kept, world size after, the sum)."""
    import torch
    import torch.distributed as dist

    from fleetx_tpu_torch.parallel.env import get_world_size, shrink_dist_env

    os.environ["TORCHELASTIC_USE_AGENT_STORE"] = "True"
    rank = dist.get_rank()
    if not shrink_dist_env(world, "cpu"):
        return False, get_world_size(), None
    total = torch.tensor([float(rank)])
    dist.all_reduce(total)
    return True, get_world_size(), float(total)


def test_shrink_serves_its_own_store_under_the_launcher_flag():
    """4 ranks shrink to 2 with ``TORCHELASTIC_USE_AGENT_STORE=True``: rank
    0 serves the new group's store itself, ranks 0 and 1 sum over a group
    of 2, ranks 2 and 3 hold no group, every rank exits 0."""
    assert run_ranks(shrink_program, 4, 2) == [
        (True, 2, 1.0), (True, 2, 1.0), (False, 1, None), (False, 1, None)]
    assert launch.last_exitcodes == [0, 0, 0, 0]


# each torchrun worker: tools/train.py's main with its group and trainer
# on the CPU (as the CLI tests of test_torch_training.py set them), then
# what it finished with, written to <out>/rank<RANK>.json
TRAIN_WORKER = """
import functools, json, os, sys
import torch
torch.set_num_threads(1)
from fleetx_tpu_torch.parallel.env import init_dist_env
from fleetx_tpu_torch.tools import train as cli
cli.init_dist_env = functools.partial(init_dist_env, "cpu")
cli.Trainer = functools.partial(cli.Trainer, device="cpu")
flag = os.environ.get("TORCHELASTIC_USE_AGENT_STORE")
trainer = cli.main(sys.argv[2:])
out = {"flag": flag, "left": trainer is None}
if trainer is not None:
    out.update(step=trainer.step, restored=trainer._restored_step,
               consumed=trainer.consumed_samples, dp=trainer.mesh.dp,
               fsdp=trainer.mesh.fsdp,
               losses=[float(h["loss"]) for h in trainer.history])
with open(os.path.join(sys.argv[1], "rank%s.json" % os.environ["RANK"]),
          "w") as f:
    json.dump(out, f)
"""


def test_tools_train_under_torchrun_shrinks_and_finishes(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 4`` of
    ``tools/train.py`` at dp 2 x sharding 2 with
    ``FLEETX_FAULT_HOST_LOSS_STEP=3``: the mesh shrinks to sharding 2 on
    2 ranks, ranks 2 and 3 leave, ranks 0 and 1 re-form the group under
    the launcher, resume from step 3 through reshard-on-load and finish
    6 steps (48 samples); the launcher exits 0, and the resumed losses lie
    within 2e-5 of an uninterrupted sharding 2 run over the same batches."""
    base = overrides(tmp_path, "torch") + ["Engine.logging_freq=1"]
    ref = run_ranks(elastic_program, 2, TINY, base + [
        "Distributed.sharding.sharding_degree=2",
        "Global.local_batch_size=4", "Global.micro_batch_size=4",
        f"Engine.save_load.output_dir={tmp_path}/ref"])
    worker = tmp_path / "worker.py"
    worker.write_text(TRAIN_WORKER)
    out = tmp_path / "ranks"
    out.mkdir()
    over = base + ["Distributed.dp_degree=2",
                   "Distributed.sharding.sharding_degree=2",
                   "Global.local_batch_size=2", "Global.micro_batch_size=2",
                   f"Engine.max_steps={STEPS}",
                   f"Engine.save_load.output_dir={tmp_path}/elastic"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", "4", "--master-addr", "127.0.0.1",
           "--master-port", str(launch.free_port()),
           "--local-addr", "127.0.0.1", "--max-restarts", "0",
           str(worker), str(out), "-c", TINY,
           *[x for o in over for x in ("-o", o)]]
    env = dict(os.environ, FLEETX_FAULT_HOST_LOSS_STEP="3",
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=RANK_TIMEOUT)
    finally:
        if proc.poll() is None:  # the launcher stops its workers on SIGTERM
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    assert proc.returncode == 0, log[-4000:]
    runs = [json.loads((out / f"rank{r}.json").read_text())
            for r in range(4)]
    assert [r["flag"] for r in runs] == ["True"] * 4
    assert [r["left"] for r in runs] == [False, False, True, True]
    for r in runs[:2]:
        assert (r["step"], r["restored"], r["dp"], r["fsdp"]) == (
            STEPS, 3, 1, 2)
        assert r["consumed"] == STEPS * GBS
        np.testing.assert_allclose(r["losses"], ref[0]["losses"][3:],
                                   rtol=0, atol=2e-5)
