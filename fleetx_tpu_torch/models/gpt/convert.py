"""GPT weights for the port: the bridge from the JAX param tree, and a
seeded initialiser with the same shapes and distributions.

Both return a state dict for :class:`GPTForPretraining` (fp32 tensors in
PyTorch's ``Linear`` layout), loaded with
``model.load_state_dict(params, assign=True)``. Under tensor parallelism
(``cfg.mp_degree > 1``) both build the whole model's state dict and hand
back one rank's shards of it (:func:`shard_params`), so an mp run starts
from the weights an mp 1 run starts from; :func:`gather_params` puts the
shards back together.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from fleetx_tpu_torch.models.gpt.model import GPTConfig, GPTForPretraining
from fleetx_tpu_torch.parallel.tensor_parallel import mp_split_axes
from fleetx_tpu_torch.utils.device import resolve_device

__all__ = ["init_params", "params_from_jax", "shard_params",
           "gather_params"]


def _whole(cfg: GPTConfig) -> GPTConfig:
    return dataclasses.replace(cfg, mp_degree=1)


def _split_axes(cfg: GPTConfig) -> Dict[str, int]:
    """What the model's layers split over mp, by name (an unallocated
    model's :func:`mp_split_axes`)."""
    return mp_split_axes(GPTForPretraining(_whole(cfg), device="meta"))


def shard_params(full: Dict[str, torch.Tensor], cfg: GPTConfig,
                 mp_rank: int) -> Dict[str, torch.Tensor]:
    """Rank ``mp_rank``'s shards of the whole model's state dict ``full``
    (the same names) for ``cfg.mp_degree`` ranks: each parameter that the
    model's layers split (``tensor_parallel.mp_split_axes``) cut into mp
    equal blocks along its axis (heads for qkv and out_proj, the MLP width
    for up and down, the vocab rows of the word embeddings), the others
    as they are. Shards are contiguous copies."""
    mp = cfg.mp_degree
    if not 0 <= mp_rank < mp:
        raise ValueError(f"mp_rank {mp_rank} outside mp_degree {mp}")
    if mp == 1:
        return dict(full)
    axes = _split_axes(cfg)
    return {name: (t.chunk(mp, dim=axes[name])[mp_rank].contiguous()
                   if name in axes else t) for name, t in full.items()}


def gather_params(shards: Sequence[Dict[str, torch.Tensor]],
                  cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    """The whole model's state dict from every mp rank's shards (in rank
    order) of the model ``cfg`` describes: the inverse of
    :func:`shard_params`. Replicated entries are taken from rank 0. Also
    gathers gradients, which share the names."""
    if len(shards) == 1:
        return dict(shards[0])
    axes = _split_axes(cfg)
    return {name: (torch.cat([s[name] for s in shards], dim=axes[name])
                   if name in axes else t) for name, t in shards[0].items()}


def params_from_jax(tree, cfg: GPTConfig,
                    mp_rank: int = 0) -> Dict[str, torch.Tensor]:
    """State dict from the flax GPT param tree (``{"params": {"gpt": ...}}``
    or the inner dict), given as numpy arrays with the decoder layers
    scan-stacked on a leading ``[L]`` axis:

    - ``qkv_proj.kernel`` [L, E, nh, 3·hd] (q|k|v per head on the last
      axis) → ``attn.qkv_proj.weight`` [nh·3·hd, E];
    - ``out_proj.kernel`` [L, nh, hd, E] → ``attn.out_proj.weight``
      [E, nh·hd];
    - ``up_proj``/``down_proj.kernel`` [L, in, out] → ``weight`` [out, in];
    - norms' ``scale``/``bias`` [L, E] and the embeddings as they are.

    Returned tensors are fp32 on the CPU; under mp, rank ``mp_rank``'s
    shards of them (:func:`shard_params`)."""
    gpt = tree.get("params", tree)["gpt"]
    stack = gpt["layers"]["layer"]

    def t(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=torch.float32)

    out = {"gpt.word_embeddings": t(gpt["word_embeddings"]),
           "gpt.position_embeddings": t(gpt["position_embeddings"])}
    for i in range(cfg.num_layers):
        pre = f"gpt.layers.{i}."
        attn, mlp = stack["attn"], stack["mlp"]
        qkv = np.asarray(attn["qkv_proj"]["kernel"][i])
        proj = np.asarray(attn["out_proj"]["kernel"][i])
        out.update({
            pre + "norm1.scale": t(stack["norm1"]["scale"][i]),
            pre + "norm1.bias": t(stack["norm1"]["bias"][i]),
            pre + "attn.qkv_proj.weight": t(qkv.reshape(qkv.shape[0], -1).T),
            pre + "attn.qkv_proj.bias": t(
                np.asarray(attn["qkv_proj"]["bias"][i]).reshape(-1)),
            pre + "attn.out_proj.weight": t(
                proj.reshape(-1, proj.shape[-1]).T),
            pre + "attn.out_proj.bias": t(attn["out_proj"]["bias"][i]),
            pre + "norm2.scale": t(stack["norm2"]["scale"][i]),
            pre + "norm2.bias": t(stack["norm2"]["bias"][i]),
            pre + "mlp.up_proj.weight": t(
                np.asarray(mlp["up_proj"]["kernel"][i]).T),
            pre + "mlp.up_proj.bias": t(mlp["up_proj"]["bias"][i]),
            pre + "mlp.down_proj.weight": t(
                np.asarray(mlp["down_proj"]["kernel"][i]).T),
            pre + "mlp.down_proj.bias": t(mlp["down_proj"]["bias"][i]),
        })
    out["gpt.final_norm.scale"] = t(gpt["final_norm"]["scale"])
    out["gpt.final_norm.bias"] = t(gpt["final_norm"]["bias"])
    return shard_params(out, cfg, mp_rank)


def init_params(cfg: GPTConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                mp_rank: int = 0) -> Dict[str, torch.Tensor]:
    """Random fp32 weights drawn from one ``torch.Generator`` seeded with
    ``seed``, with the flax initialisers' distributions: normal(0, 0.02)
    for every kernel, normal(0, ``initializer_range``) for the embeddings,
    zeros for biases and ones for norm scales. (The draws differ from
    JAX's; only the distributions match.) ``device`` defaults to CUDA.
    Under mp, the whole model is drawn and rank ``mp_rank``'s shards
    returned."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    shapes = GPTForPretraining(_whole(cfg), device="meta").state_dict()
    out = {}
    for name, meta in shapes.items():
        if name.endswith(".scale"):
            out[name] = torch.ones(meta.shape, device=dev)
        elif name.endswith(".bias"):
            out[name] = torch.zeros(meta.shape, device=dev)
        else:
            std = (cfg.initializer_range if name.endswith("embeddings")
                   else 0.02)
            out[name] = torch.empty(meta.shape, device=dev).normal_(
                0.0, std, generator=gen)
    return shard_params(out, cfg, mp_rank)
