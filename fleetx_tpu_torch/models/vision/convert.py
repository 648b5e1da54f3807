"""ViT weights for the port: the bridge from the JAX param tree, and a
seeded initialiser with the same shapes and distributions.

Both return a state dict (fp32 tensors, PyTorch's ``Linear`` layout) for
:class:`~fleetx_tpu_torch.models.vision.vit.ViT`, loaded with
``model.load_state_dict(params, assign=True)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from fleetx_tpu_torch.models.ernie.convert import (
    dense_entries,
    leaf,
    norm_entries,
)
from fleetx_tpu_torch.models.vision.vit import ViT, ViTConfig
from fleetx_tpu_torch.utils.device import resolve_device

__all__ = ["init_params", "params_from_jax"]


def params_from_jax(tree, cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """State dict from a flax ViT tree (``{"params": ...}`` or the inner
    dict; leaves numpy-convertible or boxed), its blocks unrolled
    (``block_{i}``):

    - ``patch_embed.kernel`` [p, p, C, h] → ``patch_embed.weight`` [h,
      p·p·C] (the patch GEMM, rows of the flattened kernel in (row,
      column, channel) order);
    - ``qkv_proj.kernel`` [E, nh, 3·hd] → ``weight`` [nh·3·hd, E] (a zero
      bias without ``qkv_bias``), ``out_proj.kernel`` [nh, hd, E] →
      ``weight`` [E, nh·hd], the other kernels [in, out] → [out, in];
    - ``cls_token``, ``pos_embed`` and the norms as they are.

    A JAX gradient tree has the same structure and bridges the same way,
    so gradients compare leaf for leaf."""
    root = tree.get("params", tree)
    out = dense_entries("patch_embed", root["patch_embed"])
    out["cls_token"] = torch.from_numpy(leaf(root["cls_token"]))
    out["pos_embed"] = torch.from_numpy(leaf(root["pos_embed"]))
    for i in range(cfg.num_layers):
        node, pre = root[f"block_{i}"], f"blocks.{i}."
        for name in ("qkv_proj", "out_proj", "fc1", "fc2"):
            out.update(dense_entries(pre + name, node[name]))
        for name in ("norm1", "norm2"):
            out.update(norm_entries(pre + name, node[name]))
    out.update(norm_entries("final_norm", root["final_norm"]))
    for name in ("pre_logits", "head"):
        if name in root:
            out.update(dense_entries(name, root[name]))
    return out


def init_params(cfg: ViTConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None
                ) -> Dict[str, torch.Tensor]:
    """Random fp32 weights drawn on ``device`` (CUDA by default) from one
    ``torch.Generator`` seeded with ``seed``, with the flax initialisers'
    distributions: normal(0, 0.02) for every kernel and ``pos_embed``,
    zeros for biases and ``cls_token``, ones for norm scales (the draws
    differ from JAX's); ``GeneralClsModule.init_params``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = {}
    for name, meta in ViT(cfg, device="meta").state_dict().items():
        if name.endswith(".scale"):
            out[name] = torch.ones(meta.shape, device=dev)
        elif name.endswith("bias") or name == "cls_token":
            out[name] = torch.zeros(meta.shape, device=dev)
        else:
            out[name] = torch.empty(meta.shape, device=dev).normal_(
                0.0, 0.02, generator=gen)
    return out
