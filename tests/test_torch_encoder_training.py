"""ERNIE and ViT training in the port, against the JAX package (CPU).

The tiny configs of ``torch_encoder_configs`` (fp32, 2 layers at hidden
32, 2 heads of 16) through both packages' ``ErnieModule`` and
``GeneralClsModule`` on the JAX init bridged by ``params_from_jax``, the
JAX models on their Pallas kernels in interpret mode
(``FLEETX_FORCE_FLASH=1``), the port's on the flash kernels' plain
versions:

- the training loss at dropout 0 within 1e-6 relative and every gradient
  leaf (JAX's grad tree bridged too) within 1e-4 relative and 1e-6
  absolute; ERNIE under both mask forms (per-row key lengths, the flash
  path; the dense mask, the dense path), ViT with label smoothing;
- mixup at a given λ with label smoothing against JAX's formula;
- one encoder layer and one ViT block at dropout 0.1 against JAX's, each
  site given the seed JAX drew there (captured at the site): outputs and
  gradients agree, so the masks are JAX's bit for bit;
- the AdamW decay mask against optax's, leaf for leaf;
- recompute bit-equal to none with every dropout, drop path and mixup on.

The model-level seed streams differ by design (ROADMAP Queue C,
"Model-level dropout streams").
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from fleetx_tpu.models import build_module as jax_build_module
from fleetx_tpu.optims.optimizer import build_optimizer as jax_build_optimizer
from fleetx_tpu.utils.config import get_config as jax_get_config
from fleetx_tpu_torch.data import build_dataloader
from fleetx_tpu_torch.models import build_module
from fleetx_tpu_torch.models.ernie import convert as ernie_convert
from fleetx_tpu_torch.models.vision import convert as vit_convert
from fleetx_tpu_torch.optims.optimizer import decay_mask
from fleetx_tpu_torch.parallel.mesh import mesh_from_config
from fleetx_tpu_torch.utils.config import get_config
from torch_encoder_configs import ernie_yaml, vit_yaml, write_ernie_corpus


@pytest.fixture(autouse=True)
def force_flash(monkeypatch):
    monkeypatch.setenv("FLEETX_FORCE_FLASH", "1")


def configs(tmp_path, family, *over):
    """(port cfg, JAX cfg) of the family's tiny config with ``over``."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    if family == "ernie":
        write_ernie_corpus(str(tmp_path / "er"))
        path = ernie_yaml(tmp_path / "e.yaml", str(tmp_path / "er"),
                          str(tmp_path / "out"))
    else:
        path = vit_yaml(tmp_path / "v.yaml", str(tmp_path / "out"))
    return (get_config(path, overrides=list(over), nranks=1),
            jax_get_config(path, overrides=list(over), nranks=1))


def convert(family):
    return ernie_convert if family == "ernie" else vit_convert


def port_config(tmod):
    return getattr(tmod, "ernie_config", None) or tmod.vit_config


def first_batch(cfg):
    return next(iter(build_dataloader(cfg, "Train")))


def jax_params(jmod, batch, seed=0):
    """The JAX module's init on ``batch`` (jitted), unboxed numpy
    leaves."""
    variables = jax.jit(jmod.init_params)(
        jax.random.PRNGKey(seed),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, nn.meta.unbox(variables))["params"]


def jax_loss_and_grads(jmod, params, batch, rng=None, train=True):
    """The JAX module's jitted ``value_and_grad`` of ``loss_fn``."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(3) if rng is None else rng
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jmod.loss_fn(p, jbatch, rng, train=train),
        has_aux=True))(params)
    return float(loss), {k: float(v) for k, v in aux.items()}, grads


def port_loss(tmod, family, params, batch, generator=None, train=True):
    tmod.nets.load_state_dict(
        convert(family).params_from_jax({"params": params},
                                        port_config(tmod)), assign=True)
    loss = tmod.loss_fn({k: torch.as_tensor(v) for k, v in batch.items()},
                        generator or torch.Generator().manual_seed(0),
                        train=train)
    loss.backward()
    return loss


def assert_grads(tmod, family, jgrads):
    want = convert(family).params_from_jax(
        {"params": jax.tree.map(np.asarray, jgrads)}, port_config(tmod))
    got = dict(tmod.nets.named_parameters())
    assert want.keys() == got.keys()
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("right_padded", [True, False],
                         ids=["kv_lens", "dense"])
def test_ernie_training_loss_and_grads_match_jax(tmp_path, right_padded):
    """``ErnieModule.loss_fn`` at dropout 0 (train mode): ``lm_loss``,
    ``sop_loss`` and their sum, and every gradient, against JAX's, with
    the mask as per-row key lengths (B1-B3 plain versions against the
    Pallas kernels) and as the dense mask."""
    tcfg, jcfg = configs(tmp_path, "ernie",
                         f"Model.right_padded_inputs={right_padded}")
    jmod, tmod = jax_build_module(jcfg), build_module(tcfg)
    batch = first_batch(tcfg)
    lens = (batch["input_ids"] != 0).sum(1)
    assert lens.min() < 64 and len(set(lens.tolist())) > 1  # ragged
    params = jax_params(jmod, batch)
    jl, jaux, jgrads = jax_loss_and_grads(jmod, params, batch)
    loss = port_loss(tmod, "ernie", params, batch)
    np.testing.assert_allclose(loss.item(), jl, rtol=1e-6)
    for k in ("lm_loss", "sop_loss"):
        np.testing.assert_allclose(tmod.metrics[k].item(), jaux[k],
                                   rtol=1e-6, err_msg=k)
    assert_grads(tmod, "ernie", jgrads)


def test_vit_training_loss_and_grads_match_jax(tmp_path):
    """``GeneralClsModule.loss_fn`` at dropout 0 without mixup (train
    mode, label smoothing 0.1): loss, ``acc`` and every gradient against
    JAX's; the 17 tokens padded to the kernels' tile in both packages."""
    tcfg, jcfg = configs(tmp_path, "vit")
    jmod, tmod = jax_build_module(jcfg), build_module(tcfg)
    batch = first_batch(tcfg)
    params = jax_params(jmod, batch)
    jl, jaux, jgrads = jax_loss_and_grads(jmod, params, batch)
    loss = port_loss(tmod, "vit", params, batch)
    np.testing.assert_allclose(loss.item(), jl, rtol=1e-6)
    np.testing.assert_allclose(tmod.metrics["acc"].item(), jaux["acc"])
    assert_grads(tmod, "vit", jgrads)


def test_mixup_and_smoothed_ce_match_jax_formula(tmp_path):
    """Mixup at a given λ (images and one-hot targets rolled by one row)
    bit for bit, and the label-smoothed soft cross-entropy of the mixed
    targets within 1e-6, against JAX's formula (vision_module.py:
    102-103, ``_soft_ce``)."""
    from fleetx_tpu.models.vision_module import _soft_ce
    from fleetx_tpu_torch.models.vision_module import soft_ce_sum

    tcfg, _ = configs(tmp_path, "vit", "Model.mixup_alpha=0.8")
    tmod = build_module(tcfg)
    rng = np.random.RandomState(5)
    images = rng.randn(6, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, 6)
    logits = rng.randn(6, 10).astype(np.float32)
    lam = float(np.float32(rng.beta(0.8, 0.8)))
    jlam = jnp.float32(lam)
    jt = jax.nn.one_hot(jnp.asarray(labels), 10)
    want_x = jlam * images + (1.0 - jlam) * jnp.roll(images, 1, axis=0)
    want_t = jlam * jt + (1.0 - jlam) * jnp.roll(jt, 1, axis=0)
    got_x, got_t = tmod.mixed(
        torch.from_numpy(images),
        torch.nn.functional.one_hot(torch.from_numpy(labels), 10).float(),
        lam, mesh_from_config(tcfg))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    got = soft_ce_sum(torch.from_numpy(logits), got_t, 0.1) / 6
    np.testing.assert_allclose(
        got.item(), float(_soft_ce(jnp.asarray(logits), want_t, 0.1)),
        rtol=1e-6)


def _captured_seeds(monkeypatch, module):
    """Record the seed of every dropout site JAX traces: the hash
    dropouts' (the int32 passed to ``dropout_keep_scale``) and the
    attention's (the int32 the flash kernel folds from ``dropout_rng``),
    in call order, as traced values."""
    from fleetx_tpu.ops import dropout as jdrop

    seeds = []
    keep_scale = jdrop.dropout_keep_scale

    def record_hash(seed, *a, **k):
        seeds.append(("hidden", jnp.asarray(seed, jnp.int32)))
        return keep_scale(seed, *a, **k)

    attention = module.causal_attention

    def record_attn(*a, dropout_rng=None, **k):
        if dropout_rng is not None:
            bits = jax.random.bits(dropout_rng, (1,), "uint32")
            seeds.append(("attn", bits.astype(jnp.int32)[0]))
        return attention(*a, dropout_rng=dropout_rng, **k)

    monkeypatch.setattr(jdrop, "dropout_keep_scale", record_hash)
    monkeypatch.setattr(module, "causal_attention", record_attn)
    return seeds


def _jax_site_run(apply, variables, x, seeds):
    """``apply(variables, x)`` jitted with its VJP under the seeded
    cotangent: (output, (variable grads, input grad), the sites' kinds,
    their int seeds)."""
    kinds = []

    def run(p, xx):
        seeds.clear()
        out, vjp = jax.vjp(apply, p, xx)
        kinds[:] = [k for k, _ in seeds]
        drawn = jnp.stack([v for _, v in seeds])
        return out, vjp(jnp.asarray(_cotangent(out.shape))), drawn

    out, grads, drawn = jax.jit(run)(variables, jnp.asarray(x))
    return out, grads, kinds, [int(v) for v in np.asarray(drawn)]


def _cotangent(shape):
    return np.random.RandomState(8).randn(*shape).astype(np.float32)


def _check_layer(jout, jgrads, out, x, layer, bridged_grads):
    """Output, input gradient and every parameter gradient (under the
    seeded cotangent) against JAX's."""
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    out.backward(torch.from_numpy(_cotangent(tuple(out.shape))))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrads[1]),
                               rtol=1e-4, atol=1e-5)
    got = dict(layer.named_parameters())
    for name, g in bridged_grads.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_ernie_layer_dropout_sites_take_jax_seeds(monkeypatch):
    """One ERNIE encoder layer at hidden and attention dropout 0.1 over a
    ragged right-padded batch (key lengths: B1-B3's non-causal mode): the
    port's layer given the seeds JAX drew at its three sites gives JAX's
    output and gradients (a mask one bit off would not)."""
    from fleetx_tpu.models.ernie import model as jm
    from fleetx_tpu_torch.models.ernie.model import (
        ErnieConfig,
        ErnieEncoderLayer,
    )

    kw = dict(vocab_size=128, hidden_size=32, num_layers=1,
              num_attention_heads=2, ffn_hidden_size=64,
              hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    jlayer = jm.ErnieEncoderLayer(jm.ErnieConfig(**kw, dtype=jnp.float32))
    rng = np.random.RandomState(0)
    x = rng.randn(3, 64, 32).astype(np.float32)
    lens = np.array([64, 40, 7], np.int32)
    masks = (None, jnp.asarray(lens))
    variables = jax.jit(jlayer.init)(jax.random.PRNGKey(1), jnp.asarray(x),
                                     masks)
    seeds = _captured_seeds(monkeypatch, jm)

    def f(p, xx):
        return jlayer.apply(p, xx, masks, deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(9)})

    jout, jgrads, kinds, drawn = _jax_site_run(f, variables, x, seeds)
    assert kinds == ["attn", "hidden", "hidden"], kinds
    cfg = ErnieConfig(**kw, dtype=torch.float32)
    layer = ErnieEncoderLayer(cfg, device="meta")
    tree = jax.tree.map(np.asarray, nn.meta.unbox(variables))["params"]
    layer.load_state_dict(_strip(ernie_convert.params_from_jax(
        _as_ernie(tree), cfg)), assign=True)
    xt = torch.from_numpy(x).requires_grad_()
    out = layer(xt, (None, torch.from_numpy(lens)), deterministic=False,
                seeds=tuple(drawn))
    bridged = _strip(ernie_convert.params_from_jax(_as_ernie(
        jax.tree.map(np.asarray, nn.meta.unbox(jgrads[0]))["params"]),
        cfg))
    _check_layer(jout, jgrads, out, xt, layer, bridged)


def _as_ernie(layer_tree):
    """A one-layer ERNIE tree around a layer's params (the bridge's
    input), with placeholder embeddings and pooler."""
    z = np.zeros((1, 32), np.float32)
    return {"ernie": {
        "word_embeddings": z, "position_embeddings": z,
        "token_type_embeddings": z,
        "embed_norm": {"scale": z[0], "bias": z[0]},
        "pooler": {"kernel": np.zeros((32, 32), np.float32)},
        "layers_0": {"layer": layer_tree}}}


def _strip(state):
    """The layer's entries of a bridged one-layer state dict."""
    pre = "ernie.layers.0."
    return {k[len(pre):]: v for k, v in state.items() if k.startswith(pre)}


def test_vit_block_dropout_sites_take_jax_seeds(monkeypatch):
    """One ViT block at ``drop_rate`` and ``attn_drop_rate`` 0.1 (drop
    path 0: its bits differ by design) over 17 tokens padded to the tile:
    the port's block given the seeds JAX drew at its three sites gives
    JAX's output and gradients."""
    from fleetx_tpu.models.vision import vit as jv
    from fleetx_tpu_torch.models.vision.vit import ViTBlock, ViTConfig

    kw = dict(image_size=32, patch_size=8, num_classes=10, hidden_size=32,
              num_layers=1, num_attention_heads=2, drop_rate=0.1,
              attn_drop_rate=0.1)
    jblock = jv.ViTBlock(jv.ViTConfig(**kw, dtype=jnp.float32))
    x = np.random.RandomState(2).randn(4, 17, 32).astype(np.float32)
    variables = jax.jit(jblock.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    seeds = _captured_seeds(monkeypatch, jv)

    def f(p, xx):
        return jblock.apply(p, xx, False,
                            rngs={"dropout": jax.random.PRNGKey(4)})

    jout, jgrads, kinds, s = _jax_site_run(f, variables, x, seeds)
    assert kinds == ["attn", "hidden", "hidden"], kinds
    cfg = ViTConfig(**kw, dtype=torch.float32)
    block = ViTBlock(cfg, 0.0, device="meta")
    pre = "blocks.0."

    def bridged(tree):
        full = vit_convert.params_from_jax(_as_vit(jax.tree.map(
            np.asarray, nn.meta.unbox(tree))["params"]), cfg)
        return {k[len(pre):]: v for k, v in full.items()
                if k.startswith(pre)}

    block.load_state_dict(bridged(variables), assign=True)
    xt = torch.from_numpy(x).requires_grad_()
    out = block(xt, deterministic=False,
                draws=(s[0], s[1], None, s[2], None))
    _check_layer(jout, jgrads, out, xt, block, bridged(jgrads[0]))


def _as_vit(block_tree):
    """A one-block ViT tree around a block's params (the bridge's input),
    with placeholder patch embedding, tokens, norm and head."""
    z = np.zeros(32, np.float32)
    return {"patch_embed": {"kernel": np.zeros((8, 8, 3, 32), np.float32),
                            "bias": z},
            "cls_token": np.zeros((1, 1, 32), np.float32),
            "pos_embed": np.zeros((1, 17, 32), np.float32),
            "block_0": block_tree,
            "final_norm": {"scale": z, "bias": z},
            "head": {"kernel": np.zeros((32, 10), np.float32),
                     "bias": np.zeros(10, np.float32)}}


@pytest.mark.parametrize("family", ["ernie", "vit"])
def test_decay_mask_matches_jax(tmp_path, family, monkeypatch):
    """With zero gradients optax's AdamW moves exactly the decayed leaves;
    the port's mask names the same parameters (ERNIE's ``embed_norm`` and
    ``transform_norm`` scales, its tables and ``decoder_bias``, ViT's
    ``cls_token`` and ``pos_embed`` decay; ``norm1``, ``norm2``,
    ``final_norm`` and every ``bias`` do not)."""
    monkeypatch.delenv("FLEETX_FORCE_FLASH")  # shapes only: the dense path
    tcfg, jcfg = configs(tmp_path, family)
    jmod, tmod = jax_build_module(jcfg), build_module(tcfg)
    batch = first_batch(tcfg)
    shapes = jax.eval_shape(lambda: nn.meta.unbox(jmod.init_params(
        jax.random.PRNGKey(1), {k: jnp.asarray(v)
                                for k, v in batch.items()})))["params"]
    params = jax.tree.map(lambda a: np.ones(a.shape, a.dtype), shapes)
    tx = jax_build_optimizer({"name": "AdamW", "weight_decay": 0.5,
                              "lr": {"name": "CosineAnnealingWithWarmupDecay",
                                     "max_lr": 1.0, "min_lr": 1.0,
                                     "decay_steps": 10}})
    zero = jax.tree.map(np.zeros_like, params)
    updates, _ = jax.jit(tx.update)(zero, tx.init(params), params)
    moved = convert(family).params_from_jax(
        {"params": jax.tree.map(lambda u: np.asarray(u != 0), updates)},
        port_config(tmod))
    want = {name for name, t in moved.items() if t.any()}
    got = {name for name, _ in tmod.nets.named_parameters()
           if decay_mask(name)}
    assert got == want
    decayed = ({"ernie.embed_norm.scale", "lm_head.transform_norm.scale",
                "ernie.word_embeddings", "lm_head.decoder_bias"}
               if family == "ernie" else {"cls_token", "pos_embed"})
    assert decayed <= got


@pytest.mark.parametrize("family", ["ernie", "vit"])
def test_recompute_is_bit_identical_with_every_draw_on(tmp_path, family):
    """Dropout 0.1 everywhere (and for ViT drop path 0.1 and mixup):
    ``use_recompute`` on and off give the same loss and gradients bit for
    bit and leave the generator alike."""
    drop = (("Model.hidden_dropout_prob=0.1",
             "Model.attention_probs_dropout_prob=0.1") if family == "ernie"
            else ("Model.drop_rate=0.1", "Model.attn_drop_rate=0.1",
                  "Model.drop_path_rate=0.1", "Model.mixup_alpha=0.8"))
    runs, batch, params = [], None, None
    for on in (False, True):
        tcfg, _ = configs(tmp_path / str(on), family, *drop,
                          f"Model.use_recompute={on}")
        tmod = build_module(tcfg)
        if params is None:
            batch = {k: torch.as_tensor(v)
                     for k, v in first_batch(tcfg).items()}
            params = tmod.init_params(seed=3, device="cpu")
        tmod.nets.load_state_dict({k: v.clone() for k, v in params.items()},
                                  assign=True)
        gen = torch.Generator().manual_seed(11)
        loss = tmod.loss_fn(batch, gen, train=True)
        loss.backward()
        runs.append((loss.detach(), {n: p.grad.clone() for n, p in
                                     tmod.nets.named_parameters()},
                     gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    for name, g in g0.items():
        assert torch.equal(g1[name], g), name
    # the draws took effect: the dropped model's loss is not the plain one
    tcfg, _ = configs(tmp_path / "plain", family)
    tmod = build_module(tcfg)
    tmod.nets.load_state_dict(params, assign=True)
    with torch.no_grad():
        plain = tmod.loss_fn(batch, torch.Generator().manual_seed(11),
                             train=True)
    assert not torch.equal(plain, l0)


def test_dataclass_fields_match_jax():
    """The port's ``ErnieConfig`` and ``ViTConfig`` carry JAX's training
    fields with JAX's defaults (ERNIE without ``scan_layers``)."""
    from fleetx_tpu.models.ernie.model import ErnieConfig as JE
    from fleetx_tpu.models.vision.vit import ViTConfig as JV
    from fleetx_tpu_torch.models.ernie.model import ErnieConfig
    from fleetx_tpu_torch.models.vision.vit import ViTConfig

    for port, jax_cls, skip in ((ErnieConfig, JE, {"scan_layers"}),
                                (ViTConfig, JV, set())):
        want = {f.name: f.default for f in dataclasses.fields(jax_cls)
                if f.name not in skip | {"dtype"}}
        got = {f.name: f.default for f in dataclasses.fields(port)
               if f.name != "dtype"}
        assert got == want
