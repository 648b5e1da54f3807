"""The MoE GPT of the PyTorch port, its module and trainer, against the
JAX package.

The tiny config (``configs/tiny/pretrain_gpt_tiny_cpu.yaml`` at hidden 32,
ffn 64, 4 experts, 2 layers, fp32, dropout 0) through both packages'
``MoEModule`` on the JAX init bridged by ``params_from_jax``: loss,
``lm_loss``, ``balance_loss`` (1e-5) and every gradient (1e-4), for the
naive gate and gshard in eval mode (flax derives gshard's training key
per module: ROADMAP Queue C, "Model-level dropout streams"); a 4-step
``Trainer.fit`` against the JAX ``Trainer`` under the MoE clip (1e-5
relative); the decay mask over the MoE names; full recompute and a
save-set naming ``ffn_gelu`` bit-equal to none with gshard's draws on,
one balance loss recorded a layer.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from fleetx_tpu.data import build_dataloader as jax_build_dataloader
from fleetx_tpu.models import build_module as jax_build_module
from fleetx_tpu.optims.optimizer import build_optimizer as jax_build_optimizer
from fleetx_tpu.utils.config import get_config as jax_get_config
from fleetx_tpu_torch.core.engine import Trainer
from fleetx_tpu_torch.data import build_dataloader
from fleetx_tpu_torch.models import build_module
from fleetx_tpu_torch.models.gpt.convert import params_from_jax
from fleetx_tpu_torch.optims.optimizer import decay_mask
from fleetx_tpu_torch.parallel import moe
from fleetx_tpu_torch.utils.config import get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/tiny/pretrain_gpt_tiny_cpu.yaml")
MOE = ("Model.module=MoEModule", "Model.hidden_size=32",
       "Model.ffn_hidden_size=64", "Model.num_attention_heads=2",
       "Model.num_experts=4", "Model.top_k=2", "Model.gate=naive")


def write_corpus(prefix, seed=0, n_docs=50, vocab=120):
    rng = np.random.RandomState(seed)
    docs = [rng.randint(0, vocab, size=rng.randint(50, 200)).astype(np.int32)
            for _ in range(n_docs)]
    np.save(prefix + "_ids.npy", np.concatenate(docs))
    np.savez(prefix + "_idx.npz",
             lens=np.array([len(d) for d in docs], np.int32))


def configs(tmp_path, *extra):
    """(port cfg, JAX cfg) of the tiny MoE config on two copies of one
    corpus."""
    out = []
    for name, loader in (("torch", get_config), ("jax", jax_get_config)):
        d = tmp_path / name
        d.mkdir(parents=True, exist_ok=True)
        write_corpus(str(d / "tiny"))
        over = [f"Data.Train.dataset.input_dir={d}/tiny",
                f"Data.Eval.dataset.input_dir={d}/tiny",
                "Model.use_flash_attention=True",
                "Model.hidden_dropout_prob=0.0",
                "Model.attention_probs_dropout_prob=0.0",
                f"Engine.save_load.output_dir={d}/out", *MOE, *extra]
        out.append(loader(TINY, overrides=over, nranks=1))
    return out


def _jax_params(jmod, batch, seed=0):
    variables = jmod.init_params(jax.random.PRNGKey(seed),
                                 {"tokens": jnp.asarray(batch["tokens"])})
    return jax.tree.map(np.asarray, nn.meta.unbox(variables))["params"]


@pytest.mark.parametrize("gate", ["naive", "gshard"])
def test_moe_module_loss_and_grads_match_jax(tmp_path, gate):
    """``MoEModule.loss_fn`` (gshard in eval mode: flax derives its
    training key per module) against JAX's: loss, ``lm_loss`` and
    ``balance_loss`` within 1e-5, every gradient within 1e-4."""
    tcfg, jcfg = configs(tmp_path, f"Model.gate={gate}")
    jmod, tmod = jax_build_module(jcfg), build_module(tcfg)
    batch = next(iter(build_dataloader(tcfg, "Train")))
    params = _jax_params(jmod, batch)
    assert "moe_mlp" in params["gpt"]["layers"]["layer"]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jaux), jgrads = jax.value_and_grad(
        lambda p: jmod.loss_fn(p, jbatch, None, train=False),
        has_aux=True)(params)
    gcfg = tmod.gpt_config
    assert gcfg.expert_mode and gcfg.num_experts == 4 and gcfg.gate == gate
    tmod.nets.load_state_dict(params_from_jax({"params": params}, gcfg),
                              assign=True)
    loss = tmod.loss_fn({k: torch.as_tensor(v) for k, v in batch.items()},
                        None, train=False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for k in ("lm_loss", "balance_loss"):
        np.testing.assert_allclose(tmod.metrics[k].item(), float(jaux[k]),
                                   rtol=1e-5, err_msg=k)
    want = params_from_jax({"params": jax.tree.map(np.asarray, jgrads)},
                           gcfg)
    got = dict(tmod.nets.named_parameters())
    assert want.keys() == got.keys()
    assert "gpt.layers.1.moe_mlp.w_up" in got
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_moe_trainer_fit_matches_jax_trainer(tmp_path, monkeypatch):
    """4 steps of ``Trainer.fit`` on both sides (naive gate, fp32,
    dropout 0, the MoE clip): per-step losses within 1e-5 relative, and
    the step's ``lm_loss``/``balance_loss`` beside them."""
    from fleetx_tpu.core.engine import Trainer as JaxTrainer

    extra = ("Engine.max_steps=4", "Engine.logging_freq=1",
             "Optimizer.lr.warmup_steps=1", "Optimizer.lr.max_lr=1e-2",
             "Optimizer.lr.decay_steps=100",
             "Optimizer.grad_clip.name=ClipGradForMOEByGlobalNorm",
             "Optimizer.grad_clip.clip_norm=0.5")
    tcfg, jcfg = configs(tmp_path, *extra)
    jmod = jax_build_module(jcfg)
    jlosses = []
    monkeypatch.setattr(jmod, "training_step_end",
                        lambda log: jlosses.append(log["loss"]))
    jloader = jax_build_dataloader(jcfg, "Train")
    jtrainer = JaxTrainer(jcfg, jmod)
    jtrainer.init_state(next(iter(jloader)))
    params = jax.tree.map(np.asarray, nn.meta.unbox(jtrainer.state.params))
    jtrainer.fit(jloader)

    tmod = build_module(tcfg)
    tlosses = []
    tmod.training_step_end = lambda log: tlosses.append(log["loss"])
    trainer = Trainer(tcfg, tmod, device="cpu")
    trainer.init_state(params_from_jax({"params": params}, tmod.gpt_config))
    trainer.fit(build_dataloader(tcfg, "Train"))
    assert trainer.step == 4 and len(jlosses) == 4
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] != tlosses[1]
    for h in trainer.history:
        w = tmod.gpt_config.balance_loss_weight
        np.testing.assert_allclose(
            float(h["lm_loss"]) + w * float(h["balance_loss"]),
            float(h["loss"]), rtol=1e-6)


def test_moe_decay_mask_matches_jax(tmp_path):
    """With zero grads optax's AdamW moves exactly the decayed leaves: the
    gate and all four expert leaves (``b_up``/``b_down`` are no ``bias``
    in JAX's mask), as the port's mask names them."""
    tcfg, jcfg = configs(tmp_path)
    jmod, tmod = jax_build_module(jcfg), build_module(tcfg)
    batch = next(iter(build_dataloader(tcfg, "Train")))
    shapes = jax.eval_shape(lambda: nn.meta.unbox(jmod.init_params(
        jax.random.PRNGKey(1), {"tokens": jnp.asarray(batch["tokens"])})))
    params = jax.tree.map(lambda a: np.ones(a.shape, a.dtype),
                          shapes)["params"]
    tx = jax_build_optimizer({"name": "AdamW", "weight_decay": 0.5,
                              "lr": {"name": "CosineAnnealingWithWarmupDecay",
                                     "max_lr": 1.0, "min_lr": 1.0,
                                     "decay_steps": 10}})
    zero = jax.tree.map(np.zeros_like, params)
    updates, _ = tx.update(zero, tx.init(params), params)
    moved = params_from_jax(
        {"params": jax.tree.map(lambda u: np.asarray(u != 0), updates)},
        tmod.gpt_config)
    want = {name for name, t in moved.items() if t.any()}
    got = {name for name, _ in tmod.nets.named_parameters()
           if decay_mask(name)}
    assert got == want
    assert {f"gpt.layers.0.moe_mlp.{n}" for n in
            ("gate.weight",) + moe.EXPERT_LEAVES} <= got


def test_moe_recompute_is_bit_identical_with_the_gshard_draws(tmp_path):
    """At dropout 0.1 with gshard's random routing: full recompute and
    none give the same loss, balance loss and gradients bit for bit and
    leave the generator alike; each forward records one balance loss a
    layer (a recomputed layer's rerun records none)."""
    drop = ("Model.hidden_dropout_prob=0.1",
            "Model.attention_probs_dropout_prob=0.1", "Model.gate=gshard")
    runs = {}
    batch = params = None
    for label, extra in (("off", ()), ("full", ("Model.use_recompute=True",)),
                         ("core_attn+ffn_gelu", (
                             "Model.use_recompute=True",
                             "Model.recompute_granularity=core_attn",
                             "Model.recompute_extra_saves=[ffn_gelu]"))):
        tcfg, _ = configs(tmp_path / label.replace("+", "_"), *drop, *extra)
        tmod = build_module(tcfg)
        if params is None:
            batch = {k: torch.as_tensor(v) for k, v in next(iter(
                build_dataloader(tcfg, "Train"))).items()}
            params = tmod.init_params(seed=3, device="cpu")
        tmod.nets.load_state_dict({k: v.clone() for k, v in params.items()},
                                  assign=True)
        gen = torch.Generator().manual_seed(11)
        loss = tmod.loss_fn(batch, gen, train=True)
        assert len(tmod.nets.gpt.balance_losses) == 2
        loss.backward()
        assert len(tmod.nets.gpt.balance_losses) == 2
        grads = {n: p.grad.clone() for n, p in tmod.nets.named_parameters()}
        runs[label] = (loss.detach(), tmod.metrics["balance_loss"], grads,
                       gen.get_state())
    loss0, aux0, grads0, state0 = runs.pop("off")
    for label, (loss, aux, grads, state) in runs.items():
        assert torch.equal(loss, loss0) and torch.equal(aux, aux0), label
        assert torch.equal(state, state0), label
        for name, g in grads0.items():
            assert torch.equal(grads[name], g), (label, name)
