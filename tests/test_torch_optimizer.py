"""The port's optimizers and clips (``fleetx_tpu_torch/optims/
optimizer.py``) against the JAX package's optax chains.

The same fp32 parameters and gradients, made from a numpy seed, go
through JAX ``build_optimizer`` (optax) and the port's
``build_optimizer``/``build_grad_clip`` for three steps at a fixed
learning rate; the parameters (and the moments, where they are compared)
agree within ``ATOL``. The names mix decayed leaves with the LayerNorm
and bias leaves that the decay mask skips. The trainer-level checks
(Momentum and SGD with their clips at sharding 2, the update shard on
and off, against the JAX ``Trainer``) are at the end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from fleetx_tpu.core.engine import Trainer as JaxTrainer
from fleetx_tpu.data import build_dataloader as jax_build_dataloader
from fleetx_tpu.models import build_module as jax_build_module
from fleetx_tpu.optims.optimizer import build_grad_clip as jax_build_clip
from fleetx_tpu.optims.optimizer import build_optimizer as jax_build_opt
from fleetx_tpu.utils.config import get_config as jax_get_config
from fleetx_tpu_torch.models import build_module
from fleetx_tpu_torch.models.gpt.convert import params_from_jax
from fleetx_tpu_torch.optims.optimizer import build_grad_clip, build_optimizer
from fleetx_tpu_torch.parallel.mesh import set_mesh
from fleetx_tpu_torch.utils.config import get_config
from test_torch_cp_ranks import run_ranks
from test_torch_mp_ranks import TINY, overrides
from test_torch_optim_ranks import OPT_CASES, optim_cases_program

ATOL = 1e-6
LR = 1e-2
STEPS = 3
# leaf -> shape; norm1/scale and proj/bias take no decay
SHAPES = {"w": (16, 8), "norm1.scale": (8,), "proj.bias": (8,),
          "up.weight": (4, 32)}


def _tree(flat):
    """``{"a.b": x}`` -> ``{"a": {"b": x}}``."""
    out = {}
    for name, v in flat.items():
        node = out
        *head, last = name.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _draws(seed=0):
    rng = np.random.RandomState(seed)
    params = {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: (rng.randn(*s) * rng.choice([0.01, 1.0, 30.0])).astype(
        np.float32) for n, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def _jax_run(opt_cfg, params, grads):
    tx = jax_build_opt(opt_cfg, lr_schedule=lambda count: LR)
    p = jax.tree.map(jnp.asarray, _tree(params))
    state = tx.init(p)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, _tree(g)), state, p)
        p = optax.apply_updates(p, upd)
    return {n: np.asarray(v) for n, v in _flat(p).items()}, state


def _torch_run(opt_cfg, params, grads):
    named = [(n, torch.nn.Parameter(torch.from_numpy(v.copy())))
             for n, v in params.items()]
    opt = build_optimizer(opt_cfg, named)
    clip = build_grad_clip(opt_cfg.get("grad_clip"))
    for g in grads:
        for n, p in named:
            p.grad = torch.from_numpy(g[n].copy())
        if clip is not None:
            clip([p.grad for _, p in named])
        for group in opt.param_groups:
            group["lr"] = LR
        opt.step()
    return {n: p.detach().numpy() for n, p in named}, opt, named


def test_bf16_first_moment_matches_optax_mu_dtype():
    """``moment_dtype: bfloat16``: three AdamW steps give optax's
    parameters and its bf16 first moment (the fp32 second moment too);
    the port's first moment is stored in bf16. Before the repair the key
    was ignored and the moment stayed fp32."""
    cfg = {"name": "AdamW", "weight_decay": 0.1, "moment_dtype": "bfloat16",
           "epsilon": 1e-6}
    params, grads = _draws()
    want, state = _jax_run(cfg, params, grads)
    got, opt, named = _torch_run(cfg, params, grads)
    adam = state[0]
    mu, nu = _flat(adam.mu), _flat(adam.nu)
    for n, p in named:
        s = opt.state[p]
        assert s["exp_avg"].dtype == torch.bfloat16, n
        assert s["exp_avg_sq"].dtype == torch.float32, n
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=ATOL,
                                   err_msg=n)
        np.testing.assert_array_equal(
            s["exp_avg"].float().numpy(),
            np.asarray(mu[n].astype(jnp.float32)), err_msg=n)
        np.testing.assert_allclose(s["exp_avg_sq"].numpy(),
                                   np.asarray(nu[n]), rtol=1e-6, err_msg=n)


@pytest.mark.parametrize("name,nesterov,clip", [
    ("Momentum", False, None),
    ("Momentum", True, {"name": "ClipGradByNorm", "clip_norm": 0.5}),
    ("SGD", True, {"name": "ClipGradByValue", "clip_value": 0.3}),
    ("SGD", False, {"name": "ClipGradByGlobalNorm", "clip_norm": 1.0}),
    ("AdamW", False, {"name": "ClipGradByNorm", "clip_norm": 0.2}),
], ids=["momentum", "nesterov-blockrms", "sgd-value", "sgd-global",
        "adamw-blockrms"])
def test_optimizers_and_clips_match_optax(name, nesterov, clip):
    """Momentum (coupled L2 decay before the buffer, nesterov on or off)
    and SGD, with each clip, give optax's parameters after three steps."""
    cfg = {"name": name, "weight_decay": 0.05, "momentum": 0.8,
           "use_nesterov": nesterov, "epsilon": 1e-6}
    if clip is not None:
        cfg["grad_clip"] = clip
    params, grads = _draws(1)
    want, _ = _jax_run(cfg, params, grads)
    got, _, _ = _torch_run(cfg, params, grads)
    for n in SHAPES:
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=ATOL,
                                   err_msg=n)


def test_block_rms_is_optax_clip_by_block_rms():
    """The per-block clip scales each leaf by its RMS (not its L2 norm)
    over the threshold, as optax computes it."""
    rng = np.random.RandomState(3)
    grads = {n: (rng.randn(*s) * 5).astype(np.float32)
             for n, s in SHAPES.items()}
    tx = jax_build_clip({"name": "ClipGradByNorm", "clip_norm": 0.7})
    want, _ = tx.update(jax.tree.map(jnp.asarray, _tree(grads)),
                        tx.init(None))
    got = [torch.from_numpy(grads[n].copy()) for n in SHAPES]
    build_grad_clip({"name": "ClipGradByNorm", "clip_norm": 0.7})(got)
    for n, g in zip(SHAPES, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(_flat(want)[n]),
                                   rtol=1e-6, atol=0, err_msg=n)


@pytest.mark.parametrize("bad", [
    lambda: build_optimizer({"name": "Lamb"}, [("w", torch.nn.Parameter(
        torch.zeros(2)))]),
    lambda: build_grad_clip({"name": "ClipGradByNothing"}),
], ids=["optimizer", "clip"])
def test_unknown_names_raise_value_error(bad):
    with pytest.raises(ValueError, match="unknown"):
        bad()


@pytest.fixture
def single_rank_mesh():
    set_mesh(None)
    yield
    set_mesh(None)


def test_trainer_optimizers_match_the_jax_trainer(tmp_path, monkeypatch,
                                                  single_rank_mesh):
    """Momentum with the block-RMS clip and SGD (nesterov) with the
    by-value clip, three steps of the tiny model at sharding 2 on 2 gloo
    ranks with the update shard on and off, against the JAX ``Trainer``
    on the same 2-device mesh from the same init: every parameter within
    ``ATOL`` (the block RMS of a stacked JAX leaf sums the decoder layers'
    copies, and a slice's squares over the zero group)."""
    monkeypatch.setenv("FLEETX_FORCE_FLASH", "1")
    monkeypatch.setenv("FLEETX_ZERO_UPDATE", "1")
    want, start = {}, None
    gcfg = build_module(get_config(
        TINY, overrides=overrides(tmp_path, "torch"), nranks=1)).gpt_config
    for case, extra in OPT_CASES.items():
        jcfg = jax_get_config(TINY, overrides=overrides(
            tmp_path, "jax", *extra, f"Engine.max_steps={STEPS}"),
            nranks=2)
        jmod = jax_build_module(jcfg)
        jloader = jax_build_dataloader(jcfg, "Train")
        batch = {k: jnp.asarray(v) for k, v in next(iter(jloader)).items()}
        jtrainer = JaxTrainer(jcfg, jmod)
        jtrainer.init_state(batch)
        init = jax.tree.map(np.asarray, nn.meta.unbox(jtrainer.state.params))
        if start is None:
            start = {n: t.numpy() for n, t in
                     params_from_jax({"params": init}, gcfg).items()}
        monkeypatch.setattr(jmod, "training_step_end", lambda log: None)
        jtrainer.fit(jloader)
        want[case] = params_from_jax({"params": jax.tree.map(
            np.asarray, nn.meta.unbox(jtrainer.state.params))}, gcfg)
    runs = run_ranks(optim_cases_program, 2, TINY,
                     overrides(tmp_path, "torch"), STEPS, start)
    for case in OPT_CASES:
        for zero in ("1", "0"):
            got = runs[0][case, zero]
            for n, w in want[case].items():
                np.testing.assert_array_equal(got[n], runs[1][case, zero][n],
                                              err_msg=n)
                np.testing.assert_allclose(got[n], w.numpy(), rtol=0,
                                           atol=ATOL,
                                           err_msg=f"{case} zero={zero} {n}")
