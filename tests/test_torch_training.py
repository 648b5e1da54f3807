"""The GPT pretraining path of the PyTorch port against the JAX package.

On the tiny config (``configs/tiny/pretrain_gpt_tiny_cpu.yaml``, flash
attention on, fp32, dropout 0) with the JAX weights bridged through
``params_from_jax``: the training forward's logits, loss and every
gradient leaf (through the logits, through the fused LM-head
cross-entropy under ``fused_ce``, and under full recompute); one and two
AdamW + global-norm-clip updates against optax's on the same gradients;
the five lr schedules; the data loader's batches; a 4-step
``Trainer.fit`` loss path and ``Trainer.evaluate`` against the JAX
``Trainer`` fed the same corpus. The JAX model runs its Pallas flash and
cross-entropy kernels in interpret mode (``FLEETX_FORCE_FLASH=1``).
Tolerances are fp32 summation-order ones: 1e-5 relative on logits,
losses and updated parameters, 1e-4 on gradients. Recompute on and off is
held bit for bit at dropout 0.1.
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
from fleetx_tpu.optims import lr_scheduler as jax_lr
from fleetx_tpu.optims.optimizer import build_optimizer as jax_build_optimizer
from fleetx_tpu.utils.config import get_config as jax_get_config
from fleetx_tpu_torch.core.engine import Trainer, model_flops_per_token
from fleetx_tpu_torch.data import build_dataloader
from fleetx_tpu_torch.models import build_module
from fleetx_tpu_torch.models.gpt.convert import params_from_jax
from fleetx_tpu_torch.models.gpt.model import pretraining_loss
from fleetx_tpu_torch.optims import lr_scheduler as torch_lr
from fleetx_tpu_torch.optims.optimizer import (
    build_grad_clip,
    build_optimizer,
    decay_mask,
)
from fleetx_tpu_torch.utils.config import get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/tiny/pretrain_gpt_tiny_cpu.yaml")


def write_corpus(prefix, seed=0, n_docs=50, vocab=120):
    """The verify recipe's synthetic corpus: ``{prefix}_ids.npy`` and
    ``{prefix}_idx.npz`` from a numpy seed."""
    rng = np.random.RandomState(seed)
    docs = [rng.randint(0, vocab, size=rng.randint(50, 200)).astype(np.int32)
            for _ in range(n_docs)]
    np.save(prefix + "_ids.npy", np.concatenate(docs))
    np.savez(prefix + "_idx.npz",
             lens=np.array([len(d) for d in docs], np.int32))


def configs(tmp_path, *extra, n_docs=50):
    """(port cfg, JAX cfg) of the tiny config on two copies of one corpus
    (each package builds and caches its own index maps), its ``Eval`` split
    too."""
    out = []
    for name, loader in (("torch", get_config), ("jax", jax_get_config)):
        d = tmp_path / name
        d.mkdir(parents=True, exist_ok=True)
        write_corpus(str(d / "tiny"), n_docs=n_docs)
        over = [f"Data.Train.dataset.input_dir={d}/tiny",
                f"Data.Eval.dataset.input_dir={d}/tiny",
                "Model.use_flash_attention=True",
                "Model.hidden_dropout_prob=0.0",
                "Model.attention_probs_dropout_prob=0.0",
                f"Engine.save_load.output_dir={d}/out", *extra]
        out.append(loader(TINY, overrides=over, nranks=1))
    return out


@pytest.fixture
def force_flash(monkeypatch):
    monkeypatch.setenv("FLEETX_FORCE_FLASH", "1")


def _jax_params(jmod, batch, seed=0):
    variables = jmod.init_params(jax.random.PRNGKey(seed),
                                 {"tokens": jnp.asarray(batch["tokens"])})
    return jax.tree.map(np.asarray, nn.meta.unbox(variables))["params"]


def _first_batch(cfg):
    return next(iter(build_dataloader(cfg, "Train")))


def test_training_forward_loss_and_grads_match_jax(tmp_path, force_flash):
    tcfg, jcfg = configs(tmp_path)
    jmod, tmod = jax_build_module(jcfg), build_module(tcfg)
    batch = _first_batch(tcfg)
    params = _jax_params(jmod, batch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        return jmod.loss_fn(p, jbatch, None, train=False)[0]

    jlogits = np.asarray(jmod.nets.apply({"params": params},
                                         jbatch["tokens"],
                                         jbatch["position_ids"],
                                         deterministic=True))
    jl, jgrads = jax.value_and_grad(jloss)(params)

    gcfg = tmod.gpt_config
    assert gcfg.use_flash_attention and gcfg.dtype == torch.float32
    tmod.nets.load_state_dict(params_from_jax({"params": params}, gcfg),
                              assign=True)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    logits = tmod.nets(tbatch["tokens"], tbatch["position_ids"])
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=1e-5,
                               atol=1e-5)
    loss = tmod.loss_fn(tbatch, None, train=False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    want = params_from_jax({"params": jax.tree.map(np.asarray, jgrads)},
                           gcfg)
    got = dict(tmod.nets.named_parameters())
    assert want.keys() == got.keys()
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_train_step_runs_each_flash_path_once_per_layer(tmp_path,
                                                       monkeypatch):
    """With dropout on, one train step runs B1 in every layer's forward
    and B2, B3 in its backward exactly once (on the CPU: their plain
    versions, behind the same wrappers the card launches from)."""
    from fleetx_tpu_torch.ops import flash_attention as fa

    refs = {"flash_fwd": "flash_attention_fwd_ref",
            "flash_bwd_dq": "flash_bwd_dq_ref",
            "flash_bwd_dkv": "flash_bwd_dkv_ref"}
    calls = dict.fromkeys(refs, 0)
    for name, ref in refs.items():
        def counted(*a, _real=getattr(fa, ref), _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(fa, ref, counted)
    tcfg, _ = configs(tmp_path, "Model.attention_probs_dropout_prob=0.1",
                      "Model.hidden_dropout_prob=0.1")
    tmod = build_module(tcfg)
    trainer = Trainer(tcfg, tmod, device="cpu")
    trainer.init_state()
    out = trainer.train_step(trainer._to_device(_first_batch(tcfg)))
    assert calls == dict.fromkeys(refs, tmod.gpt_config.num_layers)
    assert np.isfinite(out["loss"].item()) and trainer.step == 1


def _opt_cfg(clip_norm):
    return {"name": "FusedAdamW", "weight_decay": 0.01, "beta1": 0.9,
            "beta2": 0.999, "epsilon": 1e-8, "lr": 1e-3,
            "grad_clip": {"name": "ClipGradByGlobalNorm",
                          "clip_norm": clip_norm}}


@pytest.mark.parametrize("clip_norm", [0.5, 1e6], ids=["clipping", "below"])
def test_adamw_and_clip_updates_match_optax(tmp_path, clip_norm):
    """Two updates (bias corrections of count 1 and 2) from the same
    params and grads; the clip either scales (norm above clip_norm) or
    passes the grads through."""
    import optax

    tcfg, jcfg = configs(tmp_path)
    jmod, tmod = jax_build_module(jcfg), build_module(tcfg)
    params = _jax_params(jmod, _first_batch(tcfg), seed=1)
    rng = np.random.RandomState(2)
    grads = [jax.tree.map(lambda p: rng.normal(0, 0.3, p.shape).astype(
        np.float32), params) for _ in range(2)]

    tx = jax_build_optimizer(_opt_cfg(clip_norm))
    state = tx.init(params)
    jp = params
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)

    gcfg = tmod.gpt_config
    nets = tmod.nets
    nets.load_state_dict(params_from_jax({"params": params}, gcfg),
                         assign=True)
    opt = build_optimizer(_opt_cfg(clip_norm), nets.named_parameters())
    clip = build_grad_clip(_opt_cfg(clip_norm)["grad_clip"])
    named = dict(nets.named_parameters())
    for g in grads:
        for name, t in params_from_jax({"params": g}, gcfg).items():
            named[name].grad = t.clone()
        norm = clip([p.grad for p in named.values()])
        want_norm = float(optax.global_norm(g))
        np.testing.assert_allclose(norm.item(), want_norm, rtol=1e-6)
        for group in opt.param_groups:
            group["lr"] = 1e-3
        opt.step()
    want = params_from_jax({"params": jax.tree.map(np.asarray, jp)}, gcfg)
    for name, t in want.items():
        np.testing.assert_allclose(named[name].detach().numpy(), t.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_decay_mask_matches_jax(tmp_path):
    """The decayed set: with zero grads, optax's AdamW moves exactly the
    decayed params (adam's step is 0/(0+eps)); the port's mask names the
    same ones."""
    import optax

    tcfg, jcfg = configs(tmp_path)
    jmod, tmod = jax_build_module(jcfg), build_module(tcfg)
    params = _jax_params(jmod, _first_batch(tcfg), seed=1)
    tx = jax_build_optimizer(dict(_opt_cfg(1.0), weight_decay=0.5))
    zero = jax.tree.map(np.zeros_like, params)
    updates, _ = tx.update(zero, tx.init(params), params)
    moved = params_from_jax(
        {"params": jax.tree.map(lambda u: np.asarray(u != 0), updates)},
        tmod.gpt_config)
    want = {name for name, t in moved.items() if t.any()}
    got = {name for name, _ in tmod.nets.named_parameters()
           if decay_mask(name)}
    assert got == want
    assert "gpt.word_embeddings" in got and not any(
        n.endswith(".bias") or "norm" in n for n in got)


@pytest.mark.parametrize("name,kw", [
    ("CosineAnnealingWithWarmupDecay",
     dict(max_lr=5e-5, min_lr=1e-5, warmup_rate=0.01, decay_steps=3600)),
    ("CosineAnnealingWithWarmupDecay",
     dict(max_lr=1e-3, min_lr=0.0, warmup_steps=1, decay_steps=50)),
    ("LinearDecayWithWarmup", dict(learning_rate=2e-5, total_steps=400,
                                   warmup=0.1)),
    ("LinearDecayWithWarmup", dict(max_lr=1e-4, total_steps=400, warmup=7)),
    ("ViTLRScheduler", dict(learning_rate=3e-3, epochs=10,
                            step_each_epoch=40, warmup_epochs=2)),
    ("ViTLRScheduler", dict(learning_rate=3e-3, epochs=10,
                            step_each_epoch=40, decay_type="linear")),
    ("MultiStepDecay", dict(learning_rate=0.1, milestones=[30, 60, 90],
                            gamma=0.1)),
    ("CosineDecay", dict(learning_rate=0.05, decay_steps=300, alpha=0.1)),
])
def test_lr_schedules_match_jax(name, kw):
    """Update n uses lr(n), n from 0: under warmup lr(0) = 0."""
    want = jax_lr.build_lr_scheduler({"name": name, **kw})
    got = torch_lr.build_lr_scheduler({"name": name, **kw})
    peak = max(v for k, v in kw.items() if k in ("max_lr", "learning_rate"))
    for step in (0, 1, 2, 5, 7, 29, 30, 31, 36, 40, 50, 80, 99, 100, 150,
                 299, 300, 301, 399, 400, 1000, 3600, 5000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-6 * peak, err_msg=str(step))
    if "warmup_rate" in kw or "warmup_steps" in kw:
        assert got(0) == 0.0


def test_dataloader_batches_byte_identical_to_jax(tmp_path):
    tcfg, jcfg = configs(tmp_path)
    tl, jl = build_dataloader(tcfg, "Train"), jax_build_dataloader(jcfg,
                                                                   "Train")
    assert len(tl) == len(jl) > 6
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert a.keys() == b.keys() == {"tokens", "position_ids", "labels",
                                        "loss_mask"}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), (i, k)
        if i == 6:
            break


def test_trainer_loss_path_matches_jax_trainer(tmp_path, force_flash,
                                               monkeypatch):
    """4 steps of ``Trainer.fit`` on both sides: same corpus, same
    bridged init, warmup of 1 step (so update 0 uses lr 0), fp32,
    dropout 0. Per-step losses within 1e-5 relative."""
    from fleetx_tpu.core.engine import Trainer as JaxTrainer

    extra = ("Engine.max_steps=4", "Engine.logging_freq=1",
             "Optimizer.lr.warmup_steps=1", "Optimizer.lr.max_lr=1e-3",
             "Optimizer.lr.decay_steps=100")
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
    assert [float(h["loss"]) for h in trainer.history] == pytest.approx(
        tlosses)
    assert tlosses[-1] != tlosses[1]  # the updates moved the weights


def test_trainer_defaults_to_cuda(tmp_path):
    tcfg, _ = configs(tmp_path)
    module = build_module(tcfg)
    if torch.cuda.is_available():
        assert Trainer(tcfg, module).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(tcfg, module)


def test_model_flops_match_bench():
    import bench

    args = (354_000_000, 24, 1024, 1024)
    assert model_flops_per_token(*args) == bench.model_flops_per_token(*args)


def test_yaml_345m_training_config_resolves_like_jax():
    """Global/Engine/Model/Optimizer of the 345M pretraining config read
    the same through both packages' loaders; the module picks bf16 compute
    over fp32 params and the flash path."""
    path = os.path.join(ROOT, "configs/nlp/gpt/"
                        "pretrain_gpt_345M_single_card.yaml")
    ours, theirs = get_config(path, nranks=1), jax_get_config(path, nranks=1)
    for section in ("Global", "Engine", "Model", "Optimizer", "Data"):
        assert dict(ours[section]) == dict(theirs[section]), section
    module = build_module(ours)
    gcfg = module.gpt_config
    assert (gcfg.num_layers, gcfg.hidden_size, gcfg.num_attention_heads,
            gcfg.ffn_size, gcfg.vocab_size) == (24, 1024, 16, 4096, 50304)
    assert gcfg.dtype == torch.bfloat16 and gcfg.use_flash_attention
    assert ours.Global.local_batch_size == 8
    assert ours.Data.Train.dataset.max_seq_len == 1024
    assert ours.Engine.accumulate_steps == 1
    assert all(p.device.type == "meta" for p in module.nets.parameters())


def _loss_and_grads(tmod, batch, generator=None, train=False):
    """The port's loss (one ``loss_fn``) and its gradients by name."""
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    tmod.nets.zero_grad(set_to_none=True)
    loss = tmod.loss_fn(tbatch, generator, train=train)
    loss.backward()
    return loss, {n: p.grad.clone()
                  for n, p in tmod.nets.named_parameters()}


@pytest.mark.parametrize("extra", [
    ("Model.fused_ce=True",),
    ("Model.use_recompute=True", "Model.recompute_granularity=full")],
    ids=["fused_ce", "recompute"])
def test_fused_ce_and_recompute_loss_and_grads_match_jax(tmp_path,
                                                         force_flash, extra):
    """The loss and every gradient leaf against the JAX model with the same
    switch: the fused LM-head CE (JAX: its Pallas kernels in interpret
    mode), or full recompute; and against the port's own plain path."""
    tcfg, jcfg = configs(tmp_path, *extra)
    jmod, tmod = jax_build_module(jcfg), build_module(tcfg)
    gcfg = tmod.gpt_config
    assert jmod.gpt_config.fused_ce == gcfg.fused_ce
    assert jmod.gpt_config.use_recompute == gcfg.use_recompute
    batch = _first_batch(tcfg)
    params = _jax_params(jmod, batch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jgrads = jax.value_and_grad(
        lambda p: jmod.loss_fn(p, jbatch, None, train=False)[0])(params)
    tmod.nets.load_state_dict(params_from_jax({"params": params}, gcfg),
                              assign=True)
    loss, grads = _loss_and_grads(tmod, batch)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = params_from_jax({"params": jax.tree.map(np.asarray, jgrads)},
                           gcfg)
    assert want.keys() == grads.keys()
    for name, g in want.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    plain = build_module(configs(tmp_path / "plain")[0])
    plain.nets.load_state_dict(params_from_jax({"params": params}, gcfg),
                               assign=True)
    ploss, pgrads = _loss_and_grads(plain, batch)
    np.testing.assert_allclose(loss.item(), ploss.item(), rtol=1e-5)
    for name, g in pgrads.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_recompute_is_bit_identical_at_dropout(tmp_path):
    """At dropout 0.1, with the fused CE: full recompute, recompute with
    layer 0 opted out, and no recompute give the same loss and gradients
    bit for bit, and leave the dropout generator in the same state (the
    seeds are drawn before any layer runs, so a recomputed layer reuses its
    forward's masks)."""
    drop = ("Model.hidden_dropout_prob=0.1",
            "Model.attention_probs_dropout_prob=0.1", "Model.fused_ce=True")
    runs = {}
    batch = params = None
    for label, extra in (
            ("off", ()),
            ("full", ("Model.use_recompute=True",)),
            ("full but layer 0", ("Model.use_recompute=True",
                                  "Model.no_recompute_layers=[0]"))):
        tcfg, _ = configs(tmp_path / label.replace(" ", "_"), *drop, *extra)
        tmod = build_module(tcfg)
        if params is None:
            batch = _first_batch(tcfg)
            params = tmod.init_params(seed=3, device="cpu")
        tmod.nets.load_state_dict({k: v.clone() for k, v in params.items()},
                                  assign=True)
        gen = torch.Generator().manual_seed(11)
        loss, grads = _loss_and_grads(tmod, batch, gen, train=True)
        runs[label] = (loss, grads, gen.get_state())
    loss0, grads0, state0 = runs.pop("off")
    for label, (loss, grads, state) in runs.items():
        assert torch.equal(loss, loss0), label
        assert torch.equal(state, state0), label
        for name, g in grads0.items():
            assert torch.equal(grads[name], g), (label, name)


def _count_plain_calls(monkeypatch):
    """Count the plain versions of B1–B6 (what the CPU runs behind the
    wrappers the card launches from), keyed by kernel name."""
    from fleetx_tpu_torch.ops import ce_loss as ce
    from fleetx_tpu_torch.ops import flash_attention as fa

    refs = {(fa, "flash_fwd"): "flash_attention_fwd_ref",
            (fa, "flash_bwd_dq"): "flash_bwd_dq_ref",
            (fa, "flash_bwd_dkv"): "flash_bwd_dkv_ref",
            (ce, "ce_fwd"): "fused_ce_fwd_ref",
            (ce, "ce_dh"): "fused_ce_dh_ref", (ce, "ce_dw"): "fused_ce_dw_ref"}
    calls = {name: 0 for _, name in refs}
    for (mod, name), ref in refs.items():
        def counted(*a, _real=getattr(mod, ref), _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, ref, counted)
    return calls


def test_fit_evaluates_every_eval_freq_through_b4_only(tmp_path,
                                                       monkeypatch):
    """``fit`` with an Eval loader evaluates at steps 2 and 4 over
    ``eval_iters`` batches. Under fused_ce and full recompute a train step
    runs B4, B5, B6 once, B1 twice per layer and B2, B3 once; an eval batch
    runs B4 and B1 once per layer and no backward kernel (the counts
    chip_smoke asserts on the card)."""
    calls = _count_plain_calls(monkeypatch)
    tcfg, _ = configs(tmp_path, "Model.fused_ce=True",
                      "Model.use_recompute=True", "Engine.max_steps=4",
                      "Engine.eval_freq=2", "Engine.eval_iters=2",
                      "Model.hidden_dropout_prob=0.1",
                      "Model.attention_probs_dropout_prob=0.1", n_docs=400)
    tmod = build_module(tcfg)
    evals = []
    monkeypatch.setattr(tmod, "validation_step_end", evals.append)
    trainer = Trainer(tcfg, tmod, device="cpu")
    trainer.fit(build_dataloader(tcfg, "Train"),
                build_dataloader(tcfg, "Eval"))
    steps, batches, layers = 4, 2 * 2, tmod.gpt_config.num_layers
    assert [e["batch"] for e in evals] == [2, 4]
    assert all(np.isfinite(e["loss"]) for e in evals)
    assert calls == {"ce_fwd": steps + batches, "ce_dh": steps,
                     "ce_dw": steps,
                     "flash_fwd": layers * (2 * steps + batches),
                     "flash_bwd_dq": layers * steps,
                     "flash_bwd_dkv": layers * steps}


@pytest.mark.parametrize("fused_ce", [False, True], ids=["logits", "fused"])
def test_evaluate_matches_jax_trainer(tmp_path, force_flash, fused_ce):
    """``Trainer.evaluate``: the mean loss over ``eval_iters`` batches of
    the Eval split, same weights and batches as the JAX ``Trainer``, within
    1e-5 relative; logged through the ``[eval]`` line's fields."""
    from fleetx_tpu.core.engine import Trainer as JaxTrainer

    extra = ("Engine.eval_iters=3", f"Model.fused_ce={fused_ce}")
    tcfg, jcfg = configs(tmp_path, *extra, n_docs=400)
    jmod = jax_build_module(jcfg)
    jloader = jax_build_dataloader(jcfg, "Eval")
    assert len(jloader) >= 3
    jtrainer = JaxTrainer(jcfg, jmod)
    jtrainer.init_state(next(iter(jax_build_dataloader(jcfg, "Train"))))
    params = jax.tree.map(np.asarray, nn.meta.unbox(jtrainer.state.params))
    want = jtrainer.evaluate(jloader)

    tmod = build_module(tcfg)
    logged = []
    tmod.validation_step_end = logged.append
    trainer = Trainer(tcfg, tmod, device="cpu")
    trainer.init_state(params_from_jax({"params": params}, tmod.gpt_config))
    got = trainer.evaluate(build_dataloader(tcfg, "Eval"), epoch=0)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert logged[0]["loss"] == got and logged[0]["batch"] == 0
    assert trainer.step == 0  # evaluation trains nothing


def test_train_cli_builds_the_eval_loader(tmp_path, monkeypatch):
    """``tools/train.py`` passes an Eval loader to ``fit`` when
    ``Data.Eval`` and ``Engine.eval_freq`` are set, and none without
    ``eval_freq``."""
    import functools

    from fleetx_tpu_torch.tools import train as cli

    monkeypatch.setattr(cli, "Trainer",
                        functools.partial(Trainer, device="cpu"))
    write_corpus(str(tmp_path / "tiny"), n_docs=400)
    base = ["-c", TINY, "-o", f"Data.Train.dataset.input_dir={tmp_path}/tiny",
            "-o", f"Data.Eval.dataset.input_dir={tmp_path}/tiny",
            "-o", "Engine.max_steps=2", "-o", "Engine.eval_iters=1",
            "-o", f"Engine.save_load.output_dir={tmp_path}/out"]
    evals = []
    monkeypatch.setattr(Trainer, "evaluate",
                        lambda self, data, epoch=0: evals.append(len(data)))
    trainer = cli.main(base + ["-o", "Engine.eval_freq=1"])
    assert trainer.step == 2 and len(evals) == 2 and evals[0] > 0
    cli.main(base + ["-o", "Engine.eval_freq=0"])
    assert len(evals) == 2


def test_fused_ce_gate_demotes_on_the_cpu_only(tmp_path, caplog):
    """An unaligned vocab demotes fused_ce to the logits path with a
    warning, as in JAX; a batch whose token count 8 does not divide takes
    the logits path on the CPU. (On the card both raise: the CUDA test
    ``test_cuda_fused_ce_never_takes_the_logits_path``.)"""
    tcfg, jcfg = configs(tmp_path, "Model.fused_ce=True",
                         "Model.vocab_size=1000")
    tmod, jmod = build_module(tcfg), jax_build_module(jcfg)
    assert not tmod.gpt_config.fused_ce and not jmod.gpt_config.fused_ce
    assert "lane-aligned" in tmod.fused_ce_blocked
    tcfg, _ = configs(tmp_path / "aligned", "Model.fused_ce=True")
    tmod = build_module(tcfg)
    assert tmod.gpt_config.fused_ce and tmod.fused_ce_blocked is None
    tmod.nets.load_state_dict(tmod.init_params(seed=0, device="cpu"),
                              assign=True)
    batch = {k: torch.as_tensor(v)[:1, :7]
             for k, v in _first_batch(tcfg).items()}
    logits = tmod.nets(batch["tokens"], batch["position_ids"])
    want = pretraining_loss(logits, batch["labels"], batch["loss_mask"])
    assert torch.equal(tmod.loss_fn(batch, None, train=False), want)


def test_yaml_13b_training_config_resolves_like_jax():
    """The 1.3B single-card config reads the same through both packages'
    loaders; the module takes bf16 compute, flash attention, full
    recompute and (with ``-o Model.fused_ce=True``) the fused CE."""
    path = os.path.join(ROOT, "configs/nlp/gpt/"
                        "pretrain_gpt_1.3B_single_card.yaml")
    over = ["Model.fused_ce=True"]
    ours = get_config(path, overrides=over, nranks=1)
    theirs = jax_get_config(path, overrides=over, nranks=1)
    for section in ("Global", "Engine", "Model", "Optimizer", "Data"):
        assert dict(ours[section]) == dict(theirs[section]), section
    module, jmod = build_module(ours), jax_build_module(theirs)
    gcfg = module.gpt_config
    assert (gcfg.num_layers, gcfg.hidden_size, gcfg.num_attention_heads,
            gcfg.head_dim, gcfg.ffn_size, gcfg.vocab_size) == (
                24, 2048, 16, 128, 8192, 50304)
    for key in ("use_recompute", "recompute_granularity",
                "no_recompute_layers", "fused_ce", "hidden_dropout_prob"):
        assert getattr(gcfg, key) == getattr(jmod.gpt_config, key), key
    assert gcfg.use_recompute and gcfg.recompute_granularity == "full"
    assert gcfg.fused_ce and gcfg.dtype == torch.bfloat16
    assert ours.Engine.eval_freq == 500 and ours.Engine.eval_iters == 10
    n_params = sum(p.numel() for p in module.nets.parameters())
    assert 1.31e9 < n_params < 1.32e9
