"""Rank programs of the port's ZeRO (sharded data parallel) tests, and the
tests that need nothing but the port.

JAX-free on purpose: :func:`fleetx_tpu_torch.parallel.launch.spawn` runs
these programs in fresh processes (the ranks of one gloo group on the CPU,
or ranks that share the card), which import this module and nothing of
JAX. The parity tests against the JAX package (``test_torch_zero.py``),
the layouts with mp and pp (``test_torch_zero_layouts.py``), the elastic
tests (``test_torch_elastic_ranks.py``) and the card tests
(``test_torch_cuda.py``) call them. The tests here hold the ZeRO
weight-update shard against the replicated update of the port itself
(``FLEETX_ZERO_UPDATE=0``) at sharding 2 (stage 2) on the tiny config in
fp32: it moves where the update runs, never its math, so the two agree
within ``test_zero_update.py``'s ``atol 2e-6`` (only the norm's
summation order differs), a sentry skip under it is bit-equal to a run
that never saw the batch, and it halves the AdamW state of a rank.
"""

import itertools
import os

import numpy as np
import pytest

from fleetx_tpu_torch.parallel.mesh import set_mesh
from test_torch_cp_ranks import run_ranks
from test_torch_mp_ranks import TINY, overrides

ATOL = 2e-6  # test_zero_update.py's bound on ZeRO against the replicated
STEPS = 3
FSDP2 = ("Distributed.sharding.sharding_degree=2",
         "Distributed.sharding.sharding_stage=2")


# ------------------------------------------------------------ rank programs

def zero_fit_program(config, over, steps=STEPS, params=None, zero="1",
                     nan_batch=None, drop=None, device="cpu"):
    """``fit`` over ``steps`` batches of the config's train loader on this
    rank, with ``FLEETX_ZERO_UPDATE=zero``, from ``params`` (the whole
    model's numpy state dict, cut to this rank's stage and mp shards;
    None: the seeded init). ``nan_batch`` poisons that fetched batch
    (``faults``); ``drop`` removes that batch from the stream instead.
    Returns the losses and grad norms, the parameters (numpy, by name),
    the whole AdamW moments (gathered: every rank calls it), the AdamW
    state's bytes on this rank, the step, skips, consumed samples and the
    mesh coordinates (pp, dp, fsdp, cp, mp)."""
    os.environ["FLEETX_ZERO_UPDATE"] = zero
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.models.gpt.convert import local_params
    from fleetx_tpu_torch.resilience.faults import faults
    from fleetx_tpu_torch.utils.config import get_config

    import torch

    cfg = get_config(config, overrides=list(over) + [
        f"Engine.max_steps={steps}", "Engine.logging_freq=1"])
    module = build_module(cfg)
    trainer = Trainer(cfg, module, device=device)
    mesh = trainer.mesh
    trainer.init_state(None if params is None else local_params(
        {n: torch.from_numpy(p) for n, p in params.items()},
        module.gpt_config, mesh.mp_rank, mesh.pp_rank))
    batches = list(itertools.islice(build_dataloader(cfg, "Train"),
                                    steps + 1))
    if drop is not None:
        del batches[drop]
    if nan_batch is not None:
        faults.configure(nan_batch=nan_batch)
    try:
        trainer.fit(batches)
    finally:
        faults.reset()
    moments = {n: {k: v.detach().cpu().numpy().copy() for k, v in s.items()}
               for n, s in trainer.optimizer_state().items()}
    return {"losses": [float(h["loss"]) for h in trainer.history],
            "grad_norms": [float(h["grad_norm"]) for h in trainer.history],
            "params": {n: p.detach().cpu().numpy().copy()
                       for n, p in module.nets.named_parameters()},
            "moments": moments,
            "opt_bytes": trainer.opt_state_device_bytes(),
            "zero": trainer.zero is not None, "step": trainer.step,
            "skips": trainer.sentry_skips,
            "consumed": trainer.consumed_samples,
            "coords": (mesh.pp_rank, mesh.dp_rank, mesh.fsdp_rank,
                       mesh.cp_rank, mesh.mp_rank)}


def shards_program(dp, fsdp, shapes):
    """``ZeroShards`` on this rank of a dp × fsdp mesh over parameters of
    ``shapes`` (whole, the same on every rank): this rank's plans, the
    slices of the summed gradients (each rank's gradient is its rank + 1
    times a shared draw), the norm of those slices over the zero group,
    and, after each rank adds k + 1 to its slice k, the whole parameters
    the all-gather leaves and the whole tensors ``whole`` rebuilds from
    the slices."""
    from fleetx_tpu_torch.optims.optimizer import global_norm
    from fleetx_tpu_torch.parallel.mesh import build_mesh
    from fleetx_tpu_torch.parallel.sharding import ZeroShards

    import torch

    mesh = build_mesh(dp=dp, fsdp=fsdp)
    gen = torch.Generator().manual_seed(0)
    named = [(f"p{i}", torch.nn.Parameter(torch.randn(s, generator=gen)))
             for i, s in enumerate(shapes)]
    base = [torch.randn(s, generator=gen) for s in shapes]
    zero = ZeroShards(named, {}, mesh)
    grads = zero.reduce_scatter([b * (mesh.rank + 1) for b in base])
    norm = global_norm(grads, zero_parts=[p.parts for p in zero.plans],
                       zero_group=mesh.zero_group)
    with torch.no_grad():
        for shard, plan in zip(zero.shards, zero.plans):
            shard.add_(plan.slices[mesh.data_rank] + 1)
    whole = zero.whole(zero.shards)
    zero.all_gather()
    return {"plans": [(p.dim, p.axes, p.slices) for p in zero.plans],
            "staged": list(zero.staged),
            "grads": [g.numpy().copy() for g in grads],
            "norm": float(norm),
            "params": [p.detach().numpy().copy() for _, p in named],
            "whole": [w.numpy().copy() for w in whole]}


# ---------------------------------------------------------------- helpers

def assert_close(a: dict, b: dict, atol: float = ATOL) -> None:
    """Two runs' parameters and whole moments within ``atol``."""
    assert a["params"].keys() == b["params"].keys()
    for n in a["params"]:
        np.testing.assert_allclose(a["params"][n], b["params"][n], rtol=0,
                                   atol=atol, err_msg=n)
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(a["moments"][n][k],
                                       b["moments"][n][k], rtol=0,
                                       atol=atol, err_msg=f"{n} {k}")


def assert_replicas_equal(runs) -> None:
    """Every rank's parameters (and whole moments) bit-equal to those of
    the first rank with its (pp, mp) coordinate: the all-gather's
    contract."""
    first = {}
    for r in runs:
        pp, _, _, _, mp = r["coords"]
        ref = first.setdefault((pp, mp), r)
        for n, p in r["params"].items():
            np.testing.assert_array_equal(p, ref["params"][n], err_msg=n)
            for k, v in r["moments"][n].items():
                np.testing.assert_array_equal(v, ref["moments"][n][k],
                                              err_msg=f"{n} {k}")


# ---------------------------------------------------------------- tests

@pytest.fixture(autouse=True)
def single_rank_mesh():
    """Each test starts, and leaves the process, on a single rank's mesh."""
    set_mesh(None)
    yield
    set_mesh(None)


@pytest.fixture(scope="module")
def fsdp2(tmp_path_factory):
    """Three steps at sharding 2 (stage 2) on 2 ranks, the update shard on
    and off, from the seeded init."""
    tmp = tmp_path_factory.mktemp("fsdp2")
    over = overrides(tmp, "torch", *FSDP2, "Global.local_batch_size=2",
                     "Global.micro_batch_size=1")
    return {z: run_ranks(zero_fit_program, 2, TINY, over, STEPS, None, z)
            for z in ("1", "0")}


def test_zero_on_equals_zero_off_at_sharding2(fsdp2):
    """The update shard against the replicated update at sharding 2 with
    two microbatches: the same losses within 1e-6, the same parameters and
    whole AdamW moments within 2e-6, every rank bit-equal to the other
    (the all-gather), the losses falling; on is on and off is off."""
    on, off = fsdp2["1"], fsdp2["0"]
    assert [r["zero"] for r in on] == [True, True]
    assert [r["zero"] for r in off] == [False, False]
    assert [r["coords"] for r in on] == [(0, 0, 0, 0, 0), (0, 0, 1, 0, 0)]
    for runs in (on, off):
        assert_replicas_equal(runs)
        assert runs[0]["losses"] == runs[1]["losses"]
        assert runs[0]["step"] == STEPS
    np.testing.assert_allclose(on[0]["losses"], off[0]["losses"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(on[0]["grad_norms"], off[0]["grad_norms"],
                               rtol=1e-6)
    assert on[0]["losses"][-1] < on[0]["losses"][0]
    assert_close(on[0], off[0])


def ulp_gaps(a: dict, b: dict, lr: float) -> dict:
    """Per parameter, how far ``a``'s step-1 values lie from ``b``'s in
    units of the limit one clip-scale rounding allows: two fp32 ulps of
    the value plus ``lr · 2**-20`` (a few ulps of AdamW's unit ratio
    m / (sqrt(v) + eps) at the step's learning rate). At most 1 when the
    runs differ only in the clip's scale."""
    out = {}
    for n, x in a["params"].items():
        y = b["params"][n]
        limit = (2 * np.spacing(np.maximum(np.abs(x), np.abs(y)))
                 + lr * 2.0 ** -20)
        out[n] = float((np.abs(x - y) / limit).max())
    return out


@pytest.mark.parametrize("clip", ["on", "forced_off"])
def test_zero_departs_from_the_replicated_update_only_by_the_clip_scale(
        tmp_path, clip):
    """Where the update shard and the replicated update may differ: only
    in the clip's scale, from the norm's summation order. With the clip's
    scale forced to 1 on both sides (``clip_norm`` far above the norm),
    three steps at sharding 2 are bit-equal on and off (losses,
    parameters, whole moments). With the clip on, step 1's loss is equal,
    its grad norms lie within 1e-6 relative, and every parameter within
    two fp32 ulps of its value plus ``lr · 2**-20``; a deviation of the
    weight decay's size (``lr · wd``) breaks that limit."""
    steps = STEPS if clip == "forced_off" else 1
    extra = (("Optimizer.grad_clip.clip_norm=1e9",) if clip == "forced_off"
             else ())
    over = overrides(tmp_path, "torch", *FSDP2, "Global.local_batch_size=2",
                     "Global.micro_batch_size=1", *extra)
    on, off = (run_ranks(zero_fit_program, 2, TINY, over, steps, None, z)
               for z in ("1", "0"))
    assert on[0]["zero"] and not off[0]["zero"]
    if clip == "forced_off":
        assert max(on[0]["grad_norms"]) < 1e9
        np.testing.assert_array_equal(on[0]["losses"], off[0]["losses"])
        assert_close(on[0], off[0], atol=0.0)
        return
    assert on[0]["grad_norms"][0] > 1.0  # the clip scales this step
    assert on[0]["losses"] == off[0]["losses"]
    np.testing.assert_allclose(on[0]["grad_norms"], off[0]["grad_norms"],
                               rtol=1e-6)
    lr = 1e-3  # the step-1 rate overrides() sets (no warmup)
    assert max(ulp_gaps(on[0], off[0], lr).values()) <= 1.0
    decayed = {**on[0], "params": {n: p * (1 - lr * 0.01) for n, p in
                                   on[0]["params"].items()}}
    assert max(ulp_gaps(decayed, off[0], lr).values()) > 1.0


def test_opt_state_bytes_halve_at_two_ranks(fsdp2):
    """``opt_state_device_bytes`` per rank under the update shard is at
    most 0.55 of the replicated run's (the moments halve; the step
    counters and what nothing divides stay whole)."""
    on, off = fsdp2["1"][0]["opt_bytes"], fsdp2["0"][0]["opt_bytes"]
    assert fsdp2["1"][1]["opt_bytes"] == on
    assert 0 < on <= 0.55 * off


def test_sentry_skip_under_zero_is_bit_equal_to_a_clean_run(tmp_path):
    """At sharding 2 with the update shard on, a NaN batch (the second
    fetched) is skipped: the parameters and whole AdamW moments after it
    and two clean steps equal, bit for bit, those of a run that never
    saw the batch; the skip counts its samples as consumed."""
    over = overrides(tmp_path, "torch", *FSDP2, "Global.local_batch_size=2",
                     "Global.micro_batch_size=1")
    poisoned = run_ranks(zero_fit_program, 2, TINY, over, STEPS, None, "1",
                         "1")
    clean = run_ranks(zero_fit_program, 2, TINY, over, STEPS, None, "1",
                      None, 1)
    for p, c in zip(poisoned, clean):
        assert p["skips"] == 1 and c["skips"] == 0
        assert p["step"] == c["step"] == STEPS
        assert p["consumed"] == c["consumed"] + 4
        assert_close(p, c, atol=0.0)
        np.testing.assert_array_equal(p["losses"], c["losses"])


def test_zero_shards_cut_sum_and_gather_every_kind_of_plan():
    """On 4 gloo ranks at dp 2 × fsdp 2: a leaf whose first dim 4 divides
    (a view of its dim 0), one whose first dim only 2 divides (sliced over
    dp, the fsdp ranks holding the same slice), one cut along dim 1 (a
    staged copy), one cut over dp along dim 1, and one nothing divides
    (whole on every rank). The reduce-scatter leaves each rank the sum of
    its slice, the norm over the zero group is the summed gradients' norm
    with each slice counted once, and the all-gather and ``whole`` rebuild
    every rank's updated slices, equal on every rank."""
    import torch

    shapes = [(8, 3), (6, 5), (3, 8), (5, 6), (3,)]
    runs = run_ranks(shards_program, 4, 2, 2, shapes)
    assert runs[0]["plans"] == [
        (0, ("dp", "fsdp"), (0, 1, 2, 3)), (0, ("dp",), (0, 0, 1, 1)),
        (1, ("dp", "fsdp"), (0, 1, 2, 3)), (1, ("dp",), (0, 0, 1, 1)),
        (None, (), (0, 0, 0, 0))]
    assert runs[0]["staged"] == [False, False, True, True, False]
    g = torch.Generator().manual_seed(0)  # the rank program's draws
    init = [torch.randn(s, generator=g).numpy() for s in shapes]
    base = [torch.randn(s, generator=g).numpy() for s in shapes]
    summed = [b * (1 + 2 + 3 + 4) for b in base]
    want_norm = np.sqrt(sum(float((s.astype(np.float64) ** 2).sum())
                            for s in summed))
    for rank, r in enumerate(runs):
        np.testing.assert_allclose(r["norm"], want_norm, rtol=1e-5)
        for (dim, _, slices), got, s in zip(r["plans"], r["grads"], summed):
            if dim is None:
                np.testing.assert_allclose(got, s, rtol=1e-5)
                continue
            n = s.shape[dim] // (max(slices) + 1)
            want = np.take(s, range(slices[rank] * n,
                                    (slices[rank] + 1) * n), axis=dim)
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=rank)
        for (dim, _, slices), p, w, p0 in zip(r["plans"], r["params"],
                                              r["whole"], init):
            np.testing.assert_array_equal(p, w)
            parts = 1 if dim is None else max(slices) + 1
            n = p0.shape[dim or 0] // parts
            offset = np.repeat(np.arange(1, parts + 1, dtype=np.float32), n)
            shape = [1] * p0.ndim
            shape[dim or 0] = -1
            np.testing.assert_allclose(p, p0 + offset.reshape(shape),
                                       rtol=1e-6)
        for p, p0 in zip(r["params"], runs[0]["params"]):
            np.testing.assert_array_equal(p, p0)


@pytest.mark.parametrize("extra,item", [
    (("Distributed.sharding.sharding_stage=3",),
     "ZeRO stage 3 (parameter sharding)"),
    (("Distributed.sharding.sharding_offload=True",),
     "ZeRO sharding offload"),
], ids=["stage3", "offload"])
def test_stage3_and_offload_raise_naming_their_items(tmp_path, extra, item):
    """Sharding stage 3 (the parameters sharded) and the moments offloaded
    to the host raise ``NotImplementedError`` naming their ROADMAP items,
    before any group is built; stages 1 and 2 build a mesh."""
    import re

    from fleetx_tpu_torch.parallel.mesh import mesh_from_config
    from fleetx_tpu_torch.utils.config import get_config

    over = overrides(tmp_path, "torch",
                     "Distributed.sharding.sharding_degree=2", *extra)
    cfg = get_config(TINY, overrides=over, nranks=2)
    with pytest.raises(NotImplementedError,
                       match=re.escape(f'ROADMAP Queue A, "{item}"')):
        mesh_from_config(cfg)
