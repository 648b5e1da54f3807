"""ERNIE weights for the port: the bridge from the JAX param tree, and a
seeded initialiser with the same shapes and distributions.

Both return a state dict (fp32 tensors in PyTorch's ``Linear`` layout) for
:class:`~fleetx_tpu_torch.models.ernie.model.ErnieForPretraining` or
:class:`~fleetx_tpu_torch.models.ernie.model.ErnieForSequenceClassification`,
loaded with ``model.load_state_dict(params, assign=True)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from fleetx_tpu_torch.models.ernie.model import (
    ErnieConfig,
    ErnieForPretraining,
    ErnieForSequenceClassification,
)
from fleetx_tpu_torch.utils.device import resolve_device

__all__ = ["init_params", "params_from_jax", "dense_entries",
           "norm_entries", "leaf"]


def leaf(a) -> np.ndarray:
    """A flax leaf as a numpy array (a boxed ``nn.Partitioned`` holds it
    under ``value``)."""
    return np.asarray(getattr(a, "value", a), np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(leaf(a)))


def dense_entries(prefix: str, node, index=None) -> Dict[str, torch.Tensor]:
    """``{prefix.weight, prefix.bias}`` of a flax ``Dense``/``DenseGeneral``
    whose kernel is ``[in..., out...]``: for ``qkv_proj`` ``[E, nh, 3·hd]``
    (weight ``[nh·3·hd, E]``), for an attention ``out_proj`` ``[nh, hd,
    E]`` (weight ``[E, nh·hd]``), else ``[in, out]``. ``index`` picks one
    layer of a scan-stacked ``[L, ...]`` leaf. A kernel without a bias
    gets a zero bias."""
    kern = leaf(node["kernel"])
    if index is not None:
        kern = kern[index]
    out_axes = 2 if prefix.endswith("qkv_proj") else 1
    if prefix.endswith("out_proj"):
        kern = kern.reshape(-1, kern.shape[-1])
    else:
        n_in = kern.ndim - out_axes
        kern = kern.reshape(int(np.prod(kern.shape[:n_in])), -1)
    if "bias" in node:
        bias = leaf(node["bias"])
        bias = (bias[index] if index is not None else bias).reshape(-1)
    else:
        bias = np.zeros(kern.shape[1], np.float32)
    return {prefix + ".weight": torch.from_numpy(
                np.ascontiguousarray(kern.T)),
            prefix + ".bias": torch.from_numpy(np.ascontiguousarray(bias))}


def norm_entries(prefix: str, node, index=None
                 ) -> Dict[str, torch.Tensor]:
    """``{prefix.scale, prefix.bias}`` of a flax ``LayerNorm`` (``index``
    picks one layer of a scan-stacked leaf)."""
    pick = (lambda a: leaf(a)[index]) if index is not None else leaf
    return {prefix + ".scale": torch.from_numpy(pick(node["scale"])),
            prefix + ".bias": torch.from_numpy(pick(node["bias"]))}


def params_from_jax(tree, cfg: ErnieConfig) -> Dict[str, torch.Tensor]:
    """State dict from a flax ERNIE tree (``{"params": ...}`` or the inner
    dict; leaves numpy-convertible or boxed): ``ernie/...`` with the
    encoder scan-stacked (``layers/layer/...``, a leading ``[L]`` axis) or
    unrolled (``layers_{i}/layer/...``), and whichever heads the tree
    holds (``lm_head`` and ``sop_head``, or ``classifier``). A JAX
    gradient tree has the same structure and bridges the same way, so
    gradients compare leaf for leaf."""
    root = tree.get("params", tree)
    ernie = root["ernie"]
    out = {f"ernie.{n}": _t(ernie[n]) for n in (
        "word_embeddings", "position_embeddings", "token_type_embeddings")}
    out.update(norm_entries("ernie.embed_norm", ernie["embed_norm"]))
    for i in range(cfg.num_layers):
        if "layers" in ernie:
            node, index = ernie["layers"]["layer"], i
        else:
            node, index = ernie[f"layers_{i}"]["layer"], None
        pre = f"ernie.layers.{i}."
        for name in ("qkv_proj", "out_proj"):
            out.update(dense_entries(pre + "attn." + name,
                                     node["attn"][name], index))
        for name in ("linear1", "linear2"):
            out.update(dense_entries(pre + name, node[name], index))
        for name in ("norm1", "norm2"):
            out.update(norm_entries(pre + name, node[name], index))
    out.update(dense_entries("ernie.pooler", ernie["pooler"]))
    if "lm_head" in root:
        head = root["lm_head"]
        out.update(dense_entries("lm_head.transform", head["transform"]))
        out.update(norm_entries("lm_head.transform_norm",
                                head["transform_norm"]))
        out["lm_head.decoder_bias"] = _t(head["decoder_bias"])
    for name in ("sop_head", "classifier"):
        if name in root:
            out.update(dense_entries(name, root[name]))
    return out


def init_params(cfg: ErnieConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                num_classes: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """Random fp32 weights drawn on ``device`` (CUDA by default) from one
    ``torch.Generator`` seeded with ``seed``, with the flax initialisers'
    distributions: normal(0, 0.02) for every kernel, normal(0,
    ``initializer_range``) for the embeddings, zeros for biases and ones
    for norm scales (the draws differ from JAX's). For
    :class:`ErnieForPretraining` (``ErnieModule.init_params``), or with
    ``num_classes`` for :class:`ErnieForSequenceClassification`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    model = (ErnieForPretraining(cfg, device="meta") if num_classes is None
             else ErnieForSequenceClassification(cfg, num_classes,
                                                 device="meta"))
    out = {}
    for name, meta in model.state_dict().items():
        if name.endswith(".scale"):
            out[name] = torch.ones(meta.shape, device=dev)
        elif name.endswith("bias"):
            out[name] = torch.zeros(meta.shape, device=dev)
        else:
            std = (cfg.initializer_range if name.endswith("embeddings")
                   else 0.02)
            out[name] = torch.empty(meta.shape, device=dev).normal_(
                0.0, std, generator=gen)
    return out
