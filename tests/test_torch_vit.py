"""The port's ViT against JAX's on the same weights (CPU, fp32).

Seeded channels-last images go through both packages in backbone mode
(``num_classes`` 0) and classification mode, with and without
``representation_size`` and ``qkv_bias``: JAX's ViT on its dense attention
path (the setting of its own tests on the CPU), the port's through the
flash forward's plain version (the tokens padded to the 64-row tile, the
pads masked by ``kv_lens``) and through its dense path; the training
forward too. Tolerance: 2e-5 absolute and relative
(``torch_encoder_cases.TOL``). A head dim outside the flash kernel's is
refused at construction, by its ROADMAP title.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fleetx_tpu.models.vision.vit import VIT_PRESETS as JAX_PRESETS
from fleetx_tpu.models.vision.vit import ViTConfig as JaxViTConfig
from fleetx_tpu.models.vision.vit import (
    build_vision_model as jax_build_vision_model,
)
from fleetx_tpu_torch.models.vision.vit import (
    HEAD_DIM_ITEM,
    VIT_PRESETS,
    DropPath,
    ViT,
    ViTConfig,
    build_vision_model,
)
from fleetx_tpu_torch.utils.config import parse_config
from torch_encoder_cases import TOL, images, vit_pair

VIT_CONFIGS = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "vis", "vit", "*.yaml")))

CASES = {
    "backbone": dict(num_classes=0),
    "classify": dict(num_classes=10),
    "backbone_repr": dict(num_classes=0, representation_size=24),
    "classify_repr_no_qkv_bias": dict(num_classes=10, representation_size=24,
                                      qkv_bias=False),
    "two_layers_16px": dict(num_classes=0, image_size=16, num_layers=2),
}


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "dense"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_vit_matches_jax(case, use_flash):
    model, tree, port = vit_pair(seed=2, use_flash=use_flash, **CASES[case])
    size = port.cfg.image_size
    x = np.stack(images(3, shape=(size, size, 3)))
    want = np.asarray(model.apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    width = (port.cfg.num_classes or port.cfg.representation_size
             or port.cfg.hidden_size)
    assert got.shape == (3, width) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_a_head_dim_outside_the_kernel_is_refused_by_name():
    with pytest.raises(NotImplementedError, match="ViT head dims outside "
                                                  "the flash kernel"):
        ViT(ViTConfig(hidden_size=80, num_attention_heads=1, num_layers=1),
            device="meta")
    for name in ("ViT_huge_patch14_224", "ViT_g_patch14_224",
                 "ViT_G_patch14_224", "ViT_6B_patch14_224"):
        with pytest.raises(NotImplementedError) as e:
            build_vision_model(name, device="meta")
        assert HEAD_DIM_ITEM in str(e.value)
    for name in ("ViT_tiny_patch16_224", "ViT_base_patch16_224",
                 "ViT_large_patch16_384"):
        assert build_vision_model(name, device="meta").cfg.head_dim in (
            64,)
    assert VIT_PRESETS == JAX_PRESETS


def test_drop_path_is_the_identity_when_deterministic():
    x = torch.randn(64, 3, 5)
    dp = DropPath(0.5)
    assert dp(x) is x and DropPath(0.0)(x, deterministic=False) is x
    y = dp(x, deterministic=False,
           generator=torch.Generator().manual_seed(0))
    kept = (y != 0).flatten(1).all(1)
    assert 0 < kept.sum() < 64
    torch.testing.assert_close(y[kept], x[kept] * 2.0)


def test_unknown_preset_is_refused():
    with pytest.raises(ValueError, match="unknown vision model"):
        build_vision_model("ViT_nope")


def test_training_forward_runs_and_matches_jax():
    """The training forward (``deterministic=False``): at dropout and drop
    path 0 it is JAX's train-mode forward; with drop path 0.5 it runs, finite, and
    moves the logits off the deterministic forward's."""
    model, tree, port = vit_pair(num_classes=10, num_layers=2)
    imgs = np.stack(images(4))
    want = model.apply(tree, jnp.asarray(imgs), deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
    gen = torch.Generator().manual_seed(0)
    got = port(torch.from_numpy(imgs), deterministic=False, generator=gen)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    cfg = dataclasses.replace(port.cfg, drop_path_rate=0.5)
    dropped = ViT(cfg, device="meta")
    dropped.load_state_dict(port.state_dict(), assign=True)
    out = dropped(torch.from_numpy(imgs), deterministic=False, generator=gen)
    assert torch.isfinite(out).all()
    assert (out - got).abs().max() > 1e-3


@pytest.mark.parametrize("path", VIT_CONFIGS, ids=os.path.basename)
def test_config_from_a_model_section_resolves_its_preset(path):
    """The ``Model`` section of every ViT config gives JAX's
    ``GeneralClsModule`` model config: the preset ``name`` names,
    overridden by the section's own keys."""
    section = dict(parse_config(path).Model)
    cfg = ViTConfig.from_model_config(section)
    jax_fields = {f.name for f in dataclasses.fields(JaxViTConfig)}
    want = jax_build_vision_model(section["name"], **{
        k: v for k, v in section.items()
        if k in jax_fields and v is not None}).cfg
    for f in dataclasses.fields(ViTConfig):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(want, f.name), f.name
    assert cfg.hidden_size == VIT_PRESETS[section["name"]]["hidden_size"]
    with pytest.raises(ValueError, match="unknown vision model"):
        ViTConfig.from_model_config(dict(section, name="ViT_nope"))
