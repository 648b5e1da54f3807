"""Shared cases of the port's ERNIE and ViT parity files.

Tiny encoder configs at fp32, and weights drawn once with numpy into the
JAX model's own param tree (``draw_tree``), then bridged to the port with
each family's ``params_from_jax``: both packages run the same weights. The
draws are wider than the flax initialisers' (normal 0.3, norm scales near
1), so that argmax outputs are far from ties.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from fleetx_tpu.models.ernie.model import ErnieConfig as JaxErnieConfig
from fleetx_tpu.models.ernie.model import (
    ErnieForPretraining as JaxErnieForPretraining,
)
from fleetx_tpu.models.vision.vit import ViT as JaxViT
from fleetx_tpu.models.vision.vit import ViTConfig as JaxViTConfig
from fleetx_tpu_torch.models.ernie import convert as ernie_convert
from fleetx_tpu_torch.models.ernie.model import (
    ErnieConfig,
    ErnieForPretraining,
)
from fleetx_tpu_torch.models.vision import convert as vit_convert
from fleetx_tpu_torch.models.vision.vit import ViT, ViTConfig

# test_protocol.py's zoo (hd 16: a head dim of the flash kernel)
ERNIE_ZOO = dict(vocab_size=97, hidden_size=32, num_layers=1,
                 num_attention_heads=2, ffn_hidden_size=64,
                 max_position_embeddings=32, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0)
VIT_ZOO = dict(image_size=8, patch_size=4, in_channels=3, num_classes=0,
               hidden_size=32, num_layers=1, num_attention_heads=2,
               drop_rate=0.0, attn_drop_rate=0.0)
IMAGE = (8, 8, 3)
# fp32 on the CPU, port against JAX: summation order alone
TOL = dict(rtol=2e-5, atol=2e-5)


def draw_tree(model, *init_args, seed=0, std=0.3):
    """A param tree of ``model``'s shapes drawn with numpy: normal(0, std)
    leaves, norm scales 1 + 0.1·normal."""
    shapes = jax.eval_shape(lambda: nn.meta.unbox(model.init(
        jax.random.PRNGKey(0), *init_args)))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        noise = rng.normal(0.0, std, s.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        return 1.0 + 0.1 * noise if name.endswith("['scale']") else noise

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _known(cls, kw):
    """The entries of ``kw`` that the port's config ``cls`` has."""
    return {k: v for k, v in kw.items()
            if k in {f.name for f in dataclasses.fields(cls)}}


def ernie_pair(seed=0, cls=JaxErnieForPretraining, port_cls=None, **over):
    """``(jax model, tree, port model)`` of ERNIE (``ERNIE_ZOO`` with
    ``over``), the port model loaded with the bridged tree."""
    kw = dict(ERNIE_ZOO, **over)
    model = cls(JaxErnieConfig(**kw, dtype=jnp.float32))
    tree = draw_tree(model, jnp.ones((2, 8), jnp.int32), seed=seed)
    cfg = ErnieConfig(**_known(ErnieConfig, kw), dtype=torch.float32)
    port = (port_cls or ErnieForPretraining)(cfg, device="meta")
    port.load_state_dict(ernie_convert.params_from_jax(tree, cfg),
                         assign=True)
    return model, tree, port


def vit_pair(seed=1, use_flash=True, **over):
    """``(jax model, tree, port model)`` of ViT (``VIT_ZOO`` with
    ``over``): JAX's on its dense path (its tests' setting on the CPU), the
    port's with ``use_flash`` (the flash forward's plain version)."""
    kw = dict(VIT_ZOO, **over)
    cfg = JaxViTConfig(**kw, dtype=jnp.float32, use_flash_attention=False)
    model = JaxViT(cfg)
    shape = (1, kw["image_size"], kw["image_size"], kw["in_channels"])
    tree = draw_tree(model, np.zeros(shape, np.float32), seed=seed)
    pcfg = ViTConfig(**_known(ViTConfig, kw), dtype=torch.float32,
                     use_flash_attention=use_flash)
    port = ViT(pcfg, device="meta")
    port.load_state_dict(vit_convert.params_from_jax(tree, pcfg),
                         assign=True)
    return model, tree, port


def images(n, seed=7, shape=IMAGE):
    """``n`` seeded images, channels-last float32."""
    return [np.random.RandomState(seed + i).rand(*shape).astype(np.float32)
            for i in range(n)]
