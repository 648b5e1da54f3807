"""Expert parallelism of the port's MoE GPT over two gloo ranks, held
against one rank.

JAX-free on purpose: the rank programs run in processes that import this
module and nothing of JAX (:func:`fleetx_tpu_torch.parallel.launch.spawn`).
On the tiny config at hidden 32, ffn 64, 4 experts, 2 layers, fp32,
gshard top 2, dropout 0.1 (the hash dropout keys on the global row, the
routing keys come from the one generator): at dp 2 each rank holds 2 of
the 4 experts and routes the global batch, so every layer's expert ids
and keep flags equal one rank's bit for bit, and the losses, ``lm_loss``,
``balance_loss``, grad norms (the MoE clip's, over both ranks' experts)
and every gathered gradient and parameter after 3 steps agree with one
rank's within fp32 summation order (1e-5 relative on losses and norms;
1e-4 relative plus 1e-5 absolute on gradients and parameters); again at ``capacity_factor`` 0.5, where
tokens are dropped; again under full recompute (the rerun routes and
exchanges again) and the per-block clip (an expert leaf's RMS over both
ranks' blocks). A dp 2 checkpoint holds every expert leaf and its
AdamW moments whole: resumed at dp 2 it continues bit for bit, loaded at
dp 1 it holds the dp 2 state bit for bit and trains on. MoE under mp,
pp, cp or a sharding degree, experts a data world does not divide, and
every decode entry point refuse by name.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from fleetx_tpu_torch.parallel.mesh import Mesh, set_mesh
from test_torch_cp_ranks import run_ranks
from test_torch_mp_ranks import TINY, overrides

MOE = ("Model.module=MoEModule", "Model.hidden_size=32",
       "Model.ffn_hidden_size=64", "Model.num_attention_heads=2",
       "Model.num_experts=4", "Model.top_k=2", "Model.gate=gshard",
       "Model.hidden_dropout_prob=0.1",
       "Model.attention_probs_dropout_prob=0.1",
       "Optimizer.grad_clip.name=ClipGradForMOEByGlobalNorm",
       "Optimizer.grad_clip.clip_norm=0.05")
STEPS, BATCH, SEQ = 3, 4, 64
TIGHT = "Model.capacity_factor=0.5"
# full recompute (a rerun routes and exchanges again) under the per-block
# clip, whose RMS of an expert leaf spans both ranks' blocks
RERUN = ("Model.use_recompute=True", "Optimizer.grad_clip.name=ClipGradByNorm",
         "Optimizer.grad_clip.clip_norm=0.001")
RUNS = ((), (TIGHT,), RERUN)


def global_batches(seed=7, steps=STEPS, vocab=120):
    """``steps`` global batches of ``BATCH`` rows (numpy, seeded)."""
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int64),
             "labels": rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int64),
             "loss_mask": (rng.rand(BATCH, SEQ) > 0.1).astype(np.float32),
             "position_ids": np.tile(np.arange(SEQ), (BATCH, 1))}
            for _ in range(steps)]


def _numpy(t):
    return t.detach().cpu().numpy().copy()


def watch_routing(calls):
    """Record every forward's routing (expert ids, keep) into ``calls``;
    returns the function that stops it."""
    from fleetx_tpu_torch.parallel import moe

    real = moe.route

    def route(probs, cfg, key):
        out = real(probs, cfg, key)
        calls.append((_numpy(out[0]), _numpy(out[3])))
        return out

    moe.route = route
    return lambda: setattr(moe, "route", real)


def ep_train(config, over, batches, device="cpu", params=None):
    """A trainer of ``config`` (this rank's rows of each global batch),
    ``len(batches)`` steps through ``train_step``: per step the loss,
    ``lm_loss``, ``balance_loss`` and grad norm, the first step's routing
    and the gradients the update saw, and the final parameters and AdamW
    moments (this rank's blocks of the experts)."""
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.utils.config import get_config

    cfg = get_config(config, overrides=list(over))
    trainer = Trainer(cfg, build_module(cfg), device=device)
    trainer.init_state(params)
    mesh = trainer.mesh
    grads = []
    step = trainer.optimizer.step

    def stepped(*a, **k):
        grads.append({n: _numpy(p.grad) for n, p in
                      trainer.module.nets.named_parameters()})
        return step(*a, **k)

    trainer.optimizer.step = stepped
    rows = slice(mesh.data_rank * BATCH // mesh.data_world,
                 (mesh.data_rank + 1) * BATCH // mesh.data_world)
    routing, out = [], []
    for i, batch in enumerate(batches):
        stop = watch_routing(routing) if i == 0 else None
        got = trainer.train_step(trainer._to_device(
            {k: v[rows] for k, v in batch.items()}))
        if stop:
            stop()
        out.append({k: float(got[k]) for k in
                    ("loss", "lm_loss", "balance_loss", "grad_norm")})
    return {"steps": out, "routing": routing, "grads": grads,
            "params": {n: _numpy(p) for n, p in
                       trainer.module.nets.named_parameters()},
            "ep_world": trainer.ep_world, "experts": sorted(trainer.experts),
            "n_params": trainer.n_params}


def ep_program(config, over_dp2, device="cpu"):
    """On this rank of dp 2: the gshard run, the tight-capacity run and
    the recomputed, block-clipped run."""
    batches = global_batches()
    return [ep_train(config, list(over_dp2) + list(extra), batches, device)
            for extra in RUNS]


def joined(a: dict, b: dict) -> dict:
    """One state from two data ranks' (experts joined in rank order)."""
    from fleetx_tpu_torch.models.gpt.convert import gather_experts

    return {n: v.numpy() for n, v in gather_experts(
        [{n: torch.from_numpy(v) for n, v in a.items()},
         {n: torch.from_numpy(v) for n, v in b.items()}]).items()}


def _assert_run_equal(ranks, one):
    """Two dp 2 ranks' run against one rank's."""
    for r in ranks:
        assert r["ep_world"] == 2 and r["experts"]
        assert r["n_params"] == one["n_params"]
        assert [s["loss"] for s in r["steps"]] == \
            [s["loss"] for s in ranks[0]["steps"]]
        # the global routing: every layer's ids and keep equal one rank's
        assert len(r["routing"]) == len(one["routing"]) >= 2
        for (ids, keep), (ids1, keep1) in zip(r["routing"], one["routing"]):
            np.testing.assert_array_equal(ids, ids1)
            np.testing.assert_array_equal(keep, keep1)
    for k in ("loss", "lm_loss", "balance_loss", "grad_norm"):
        np.testing.assert_allclose([s[k] for s in ranks[0]["steps"]],
                                   [s[k] for s in one["steps"]], rtol=1e-5,
                                   err_msg=k)
    for step, g1 in enumerate(one["grads"]):
        g2 = joined(ranks[0]["grads"][step], ranks[1]["grads"][step])
        assert g2.keys() == g1.keys()
        for n in g1:
            np.testing.assert_allclose(g2[n], g1[n], rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {step} {n}")
    p2 = joined(ranks[0]["params"], ranks[1]["params"])
    for n, v in one["params"].items():
        np.testing.assert_allclose(p2[n], v, rtol=1e-4, atol=1e-5,
                                   err_msg=n)


def test_dp2_experts_route_and_step_as_one_rank(tmp_path):
    over = overrides(tmp_path, "moe", *MOE)
    dp2 = over + ["Distributed.dp_degree=2",
                  f"Global.local_batch_size={BATCH // 2}",
                  f"Global.micro_batch_size={BATCH // 2}"]
    runs = run_ranks(ep_program, 2, TINY, dp2)
    set_mesh(None)
    batches = global_batches()
    for i, extra in enumerate(RUNS):
        one = ep_train(TINY, over + [f"Global.local_batch_size={BATCH}",
                                     f"Global.micro_batch_size={BATCH}"]
                       + list(extra), batches)
        _assert_run_equal([runs[0][i], runs[1][i]], one)
        kept = [int(keep.sum()) for _, keep in one["routing"]]
        slots = [keep.size for _, keep in one["routing"]]
        if TIGHT in extra:  # capacity 0.5: tokens are dropped
            assert all(k < s * 0.6 for k, s in zip(kept, slots)), kept
        # each rank's expert blocks are half of every expert leaf
        assert all(runs[0][i]["params"][n].shape[0] == 2
                   for n in runs[0][i]["experts"])


SAVE_AT, RESUME_STEPS = 2, 4


def ckpt_program(config, over, out_a, out_b, device="cpu"):
    """On this rank of dp 2: (a) ``RESUME_STEPS`` steps saving at
    ``SAVE_AT`` into ``out_a``; (b) rank 0 copies that step alone to
    ``out_b`` and a fresh trainer resumes there. Both runs' losses and
    final states, and (a)'s state at the save."""
    import torch.distributed as dist

    from test_torch_ckpt_ranks import _fit, trainer_state
    from fleetx_tpu_torch.utils.config import get_config

    def cfg(out):
        return get_config(config, overrides=list(over) + [
            f"Engine.save_load.output_dir={out}",
            f"Engine.max_steps={RESUME_STEPS}",
            f"Engine.save_load.save_steps={SAVE_AT}"])

    at_save = []
    a = _fit(cfg(out_a), device, at_save=at_save)
    if dist.get_rank() == 0:
        shutil.copytree(os.path.join(out_a, "checkpoints", str(SAVE_AT)),
                        os.path.join(out_b, "checkpoints", str(SAVE_AT)))
    dist.barrier()
    b = _fit(cfg(out_b), device, resume=True)
    return {"losses": [[float(h["loss"]) for h in t.history]
                       for t in (a, b)],
            "states": [trainer_state(t) for t in (a, b)],
            "at_save": dict(at_save)[SAVE_AT]}


def test_dp2_checkpoint_resumes_and_loads_at_one_rank(tmp_path,
                                                      monkeypatch):
    """A dp 2 checkpoint (experts whole): resumed at dp 2 it ends bit for
    bit where the uninterrupted run ends; loaded at dp 1 the trainer
    holds the dp 2 ranks' parameters and moments joined bit for bit, and
    its steps 3–4 follow the dp 2 run's losses within 1e-5."""
    import test_torch_ckpt_ranks as ckpt

    monkeypatch.setattr(ckpt, "SAVE_AT", SAVE_AT)
    over = overrides(tmp_path, "ckpt", *MOE, "Global.local_batch_size=2",
                     "Global.micro_batch_size=2")
    out_a, out_b = str(tmp_path / "a"), str(tmp_path / "b")
    runs = run_ranks(ckpt_program, 2, TINY,
                     over + ["Distributed.dp_degree=2"], out_a, out_b)
    set_mesh(None)
    for r in runs:
        assert r["losses"][1] == r["losses"][0][SAVE_AT:]
        ckpt.assert_states_equal(r["states"][0], r["states"][1])
    # at one rank: the whole experts and their moments, bit for bit
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.utils.config import get_config

    out_c = str(tmp_path / "c")
    shutil.copytree(os.path.join(out_a, "checkpoints", str(SAVE_AT)),
                    os.path.join(out_c, "checkpoints", str(SAVE_AT)))
    cfg = get_config(TINY, overrides=over + [
        "Global.local_batch_size=4", "Global.micro_batch_size=4",
        f"Engine.save_load.output_dir={out_c}",
        f"Engine.max_steps={RESUME_STEPS}", "Engine.logging_freq=1"])
    trainer = Trainer(cfg, build_module(cfg), device="cpu")
    trainer.init_state()
    assert trainer.step == SAVE_AT
    state = ckpt.trainer_state(trainer)
    saved = [r["at_save"] for r in runs]
    want = joined(saved[0]["params"], saved[1]["params"])
    for n, v in state["params"].items():
        np.testing.assert_array_equal(v, want[n], err_msg=n)
    for k in ("exp_avg", "exp_avg_sq"):
        whole = joined({n: m[k] for n, m in saved[0]["moments"].items()},
                       {n: m[k] for n, m in saved[1]["moments"].items()})
        for n, m in state["moments"].items():
            np.testing.assert_array_equal(m[k], whole[n], err_msg=(n, k))
    np.testing.assert_array_equal(state["generator"], saved[0]["generator"])
    loader = build_dataloader(cfg, "Train")
    loader.batch_sampler.consumed_samples = trainer.consumed_samples
    trainer.fit(loader)
    assert trainer.step == RESUME_STEPS
    np.testing.assert_allclose([float(h["loss"]) for h in trainer.history],
                               runs[0]["losses"][0][SAVE_AT:], rtol=1e-5)


TITLE = re.escape('ROADMAP Queue A, "Experts under mp, pp, cp or ZeRO"')


@pytest.mark.parametrize("key,extra", [
    ("Distributed.mp_degree", ()),
    ("Distributed.pp_degree", ()),
    ("Distributed.cp_degree", ()),
    ("Distributed.sharding.sharding_degree", ())])
def test_moe_refuses_mp_pp_cp_and_zero_by_title(tmp_path, key, extra):
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.utils.config import get_config

    cfg = get_config(TINY, overrides=overrides(tmp_path, "x", *MOE,
                                               f"{key}=2", *extra),
                     nranks=2)
    with pytest.raises(NotImplementedError, match=TITLE):
        build_module(cfg)


def test_experts_a_data_world_does_not_divide_raise_naming_both(
        tmp_path, monkeypatch):
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.models import language_module
    from fleetx_tpu_torch.utils.config import get_config

    cfg = get_config(TINY, overrides=overrides(
        tmp_path, "x", *MOE, "Model.num_experts=3",
        "Distributed.dp_degree=2"), nranks=2)
    monkeypatch.setattr(language_module, "mesh_from_config",
                        lambda c: Mesh(dp=2))
    with pytest.raises(ValueError, match="3 experts do not split over 2 "
                                         "data ranks"):
        build_module(cfg)


def test_decoding_an_moe_model_is_refused_by_title(tmp_path):
    """``GPTGenerationModule``, ``generate()``, the ``ServingEngine`` and
    the cached forward refuse an ``expert_mode`` model by name."""
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.models.gpt.generation import (
        GenerationConfig,
        generate,
        init_decode_cache,
    )
    from fleetx_tpu_torch.serving import ServingEngine
    from fleetx_tpu_torch.utils.config import get_config

    title = re.escape('ROADMAP Queue A, "MoE serving"')
    over = overrides(tmp_path, "x", *MOE)
    with pytest.raises(NotImplementedError, match=title):
        build_module(get_config(TINY, overrides=over + [
            "Model.module=GPTGenerationModule"]))
    module = build_module(get_config(TINY, overrides=over))
    model = module.nets
    model.load_state_dict(module.init_params(0, "cpu"), assign=True)
    ids = torch.zeros(1, 4, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match=title):
        generate(model, ids, GenerationConfig(max_length=2))
    with pytest.raises(NotImplementedError, match=title):
        ServingEngine(model, dict(model.state_dict()), device="cpu")
    cache = init_decode_cache(model, 1, cache_len=8, device="cpu")
    with pytest.raises(NotImplementedError, match=title):
        model(ids, None, cache=cache)
