"""Rank programs of the port's optimizer tests, and the tests that need
nothing but the port.

JAX-free on purpose: :func:`fleetx_tpu_torch.parallel.launch.spawn` runs
these programs in fresh processes that import this module and nothing of
JAX. ``test_torch_optimizer.py`` holds them against the JAX ``Trainer``;
the tests here hold ``moment_dtype: bfloat16`` under the ZeRO update
shard: a bf16 first moment on the slices, 0.75 of the fp32 run's state
bytes, and a checkpoint that saves and restores it as bf16.
"""

import os

import numpy as np
import torch

from test_torch_cp_ranks import run_ranks
from test_torch_mp_ranks import TINY, overrides
from test_torch_zero_ranks import FSDP2, zero_fit_program

STEPS = 3
# Momentum with the block-RMS clip, SGD (nesterov) with the by-value clip;
# each clip's limit small enough to act on the tiny model's gradients
OPT_CASES = {
    "momentum-blockrms": FSDP2 + (
        "Optimizer.name=Momentum", "Optimizer.momentum=0.9",
        "Optimizer.use_nesterov=False", "Optimizer.weight_decay=0.01",
        "Optimizer.grad_clip.name=ClipGradByNorm",
        "Optimizer.grad_clip.clip_norm=0.002"),
    "sgd-value": FSDP2 + (
        "Optimizer.name=SGD", "Optimizer.use_nesterov=True",
        "Optimizer.weight_decay=0.01",
        "Optimizer.grad_clip.name=ClipGradByValue",
        "Optimizer.grad_clip.clip_value=0.001"),
}


def optim_cases_program(config, over, steps, params):
    """Every case of :data:`OPT_CASES`, each with the update shard on
    (``"1"``) and off (``"0"``), ``steps`` steps from ``params`` on this
    rank: ``{(case, zero): parameters (numpy, by name)}``. Each run gets
    its own copy of ``params``: a trainer on the CPU trains the tensors it
    is given in place."""
    out = {}
    for case, extra in OPT_CASES.items():
        for zero in ("1", "0"):
            run = zero_fit_program(config, list(over) + list(extra), steps,
                                   {n: p.copy() for n, p in params.items()},
                                   zero=zero)
            out[case, zero] = run["params"]
    return out


def moment_dtype_program(config, over, out_dir):
    """Two steps at sharding 2 with the update shard, fp32 and bf16 first
    moments; the bf16 run saves, a fresh trainer loads it. Returns the
    state bytes of both runs, the dtypes of this rank's slices and of the
    restored moments, and whether the restore kept every value."""
    os.environ["FLEETX_ZERO_UPDATE"] = "1"
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.utils.config import get_config

    res = {}
    for dtype in ("float32", "bfloat16"):
        cfg = get_config(config, overrides=list(over) + list(FSDP2) + [
            f"Optimizer.moment_dtype={dtype}", "Engine.max_steps=2",
            f"Engine.save_load.output_dir={out_dir}/{dtype}",
            "Engine.save_load.save_steps=2"])
        trainer = Trainer(cfg, build_module(cfg), device="cpu")
        trainer.fit(build_dataloader(cfg, "Train"))
        res[dtype] = trainer.opt_state_device_bytes()
        if dtype == "bfloat16":
            res["slice_dtypes"] = sorted({str(s["exp_avg"].dtype) for s in
                                          trainer.optimizer.state.values()})
            before = trainer.optimizer_state()
            fresh = Trainer(cfg, build_module(cfg), device="cpu")
            fresh.init_state()  # resumes from the saved step
            after = fresh.optimizer_state()
            res["restored_step"] = fresh.step
            res["restored_dtypes"] = sorted(
                {str(s["exp_avg"].dtype) for s in after.values()})
            res["restored_bytes"] = fresh.opt_state_device_bytes()
            res["restored_equal"] = all(
                torch.equal(before[n][k], after[n][k])
                for n in before for k in ("exp_avg", "exp_avg_sq"))
    return res


def test_bf16_moments_under_the_update_shard_and_checkpoints(tmp_path):
    """At sharding 2 with the update shard, ``moment_dtype: bfloat16``
    keeps each rank's first-moment slices in bf16, its state bytes are
    0.75 of the fp32 run's (one fp32 and one bf16 moment against two
    fp32), and a checkpoint restores the moments as bf16, bit for bit."""
    runs = run_ranks(moment_dtype_program, 2, TINY,
                     overrides(tmp_path, "torch"), str(tmp_path / "out"))
    for r in runs:
        assert r["slice_dtypes"] == ["torch.bfloat16"]
        assert r["restored_dtypes"] == ["torch.bfloat16"]
        assert r["restored_step"] == 2 and r["restored_equal"]
        assert r["restored_bytes"] == r["bfloat16"]
        np.testing.assert_allclose(r["bfloat16"] / r["float32"], 0.75,
                                   rtol=0.01)
