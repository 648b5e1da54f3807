"""GPT weights for the port: the bridge from the JAX param tree, and a
seeded initialiser with the same shapes and distributions.

Both return a state dict for :class:`GPTForPretraining` (fp32 tensors in
PyTorch's ``Linear`` layout), loaded with
``model.load_state_dict(params, assign=True)``. Under tensor parallelism
(``cfg.mp_degree > 1``) both build the whole model's state dict and hand
back one rank's shards of it (:func:`shard_params`), so an mp run starts
from the weights an mp 1 run starts from; :func:`gather_params` puts the
shards back together. Under pipeline parallelism (``cfg.pp_degree > 1``)
they hand back one stage's part of that (:func:`stage_params`: the port's
form of JAX ``init_pipeline_params_via_sequential``), so a pipeline's
weights equal the unpipelined model's bit for bit; :func:`gather_stages`
joins the stages' state dicts, and :func:`params_from_checkpoint` reads
a checkpoint of any (pp, mp) layout back into the whole model's. Under
expert parallelism (an MoE model's experts split over ``ep_world`` data
ranks) both hand back data rank ``ep_rank``'s block of each stacked
expert leaf (:func:`expert_params`); :func:`gather_experts` joins them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from fleetx_tpu_torch.models.gpt.model import GPTConfig, GPTForPretraining
from fleetx_tpu_torch.parallel.moe import expert_block, is_expert_param
from fleetx_tpu_torch.parallel.pipeline import (
    maybe_pipeline_params_to_sequential,
)
from fleetx_tpu_torch.parallel.tensor_parallel import mp_split_axes
from fleetx_tpu_torch.utils.device import resolve_device

__all__ = ["init_params", "params_from_jax", "params_from_checkpoint",
           "shard_params", "gather_params", "stage_params", "gather_stages",
           "local_params", "expert_params", "gather_experts",
           "convert_qkv_layout", "qkv_state_layout"]


def _whole(cfg: GPTConfig) -> GPTConfig:
    """The unsplit, unpipelined model of ``cfg``."""
    return dataclasses.replace(cfg, mp_degree=1, pp_degree=1,
                               num_microbatches=1, virtual_pp_degree=1)


def _split_axes(cfg: GPTConfig, int8: bool = False) -> Dict[str, int]:
    """What the model's layers split over mp, by name (an unallocated
    model's :func:`mp_split_axes`; ``int8``: its int8 serving form)."""
    return mp_split_axes(GPTForPretraining(_whole(cfg), device="meta",
                                           int8=int8))


def shard_params(full: Dict[str, torch.Tensor], cfg: GPTConfig,
                 mp_rank: int) -> Dict[str, torch.Tensor]:
    """Rank ``mp_rank``'s shards of the whole model's state dict ``full``
    (the same names) for ``cfg.mp_degree`` ranks: each parameter that the
    model's layers split (``tensor_parallel.mp_split_axes``) cut into mp
    equal blocks along its axis (heads for qkv and out_proj, the MLP width
    for up and down, the vocab rows of the word embeddings), the others
    as they are. An int8 state dict (``ops/quant.quantize_tree_int8`` of
    the whole model) splits each ``_q8`` as its weight and each
    ``_scale`` as the layer declares it (``tensor_parallel._weight_split``;
    JAX ``serving_param_shardings``). Shards are contiguous copies."""
    mp = cfg.mp_degree
    if not 0 <= mp_rank < mp:
        raise ValueError(f"mp_rank {mp_rank} outside mp_degree {mp}")
    if mp == 1:
        return dict(full)
    axes = _split_axes(cfg, any(n.endswith("_q8") for n in full))
    # an axis mp does not divide (a serving model's vocab) stays whole, as
    # JAX's serving spec drops it (parallel/sharding.py:112, _fit_spec)
    return {name: (t.chunk(mp, dim=axes[name])[mp_rank].contiguous()
                   if name in axes and t.shape[axes[name]] % mp == 0
                   else t) for name, t in full.items()}


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


def stage_params(params: Dict[str, torch.Tensor], cfg: GPTConfig,
                 pp_rank: int) -> Dict[str, torch.Tensor]:
    """The entries of the whole model's state dict ``params`` (or of one mp
    rank's shards of it) that stage ``pp_rank`` of ``cfg``'s pipeline
    holds: its layers, the embeddings on the first stage, the final norm
    and the word embedding's copy on the last. At pp 1, all of them."""
    if cfg.pp_degree <= 1:
        return dict(params)
    names = GPTForPretraining(dataclasses.replace(cfg, mp_degree=1),
                              device="meta", pp_rank=pp_rank).state_dict()
    return {n: t for n, t in params.items() if n in names}


def gather_stages(stages: Sequence[Dict[str, torch.Tensor]]
                  ) -> Dict[str, torch.Tensor]:
    """One state dict from the stages' (in stage order; the same mp rank):
    each name from the first stage that holds it, so the tied word
    embedding (equal on the first and the last stage) once. Also joins
    gradients, which share the names."""
    out: Dict[str, torch.Tensor] = {}
    for part in stages:
        for n, t in part.items():
            out.setdefault(n, t)
    return out


def expert_params(full: Dict[str, torch.Tensor], cfg: GPTConfig,
                  ep_rank: int = 0, ep_world: int = 1
                  ) -> Dict[str, torch.Tensor]:
    """Data rank ``ep_rank``'s part of the state dict ``full`` (or of its
    gradients) when an MoE model's experts split over ``ep_world`` data
    ranks: its block of each stacked expert leaf ([E, ...] → [E/D, ...],
    contiguous copies), every other entry as it is."""
    if ep_world == 1:
        return dict(full)
    block = expert_block(cfg.num_experts, ep_world, ep_rank)
    return {n: (t[block].contiguous() if is_expert_param(n) else t)
            for n, t in full.items()}


def gather_experts(parts: Sequence[Dict[str, torch.Tensor]]
                   ) -> Dict[str, torch.Tensor]:
    """The whole state dict (or gradients) from every data rank's
    :func:`expert_params` (in data rank order): the expert leaves joined
    along the expert axis, the rest from rank 0."""
    return {n: (torch.cat([p[n] for p in parts]) if is_expert_param(n)
                else t) for n, t in parts[0].items()}


def local_params(full: Dict[str, torch.Tensor], cfg: GPTConfig,
                 mp_rank: int = 0, pp_rank: int = 0, ep_rank: int = 0,
                 ep_world: int = 1) -> Dict[str, torch.Tensor]:
    """Rank (``pp_rank``, ``mp_rank``)'s part of the whole model's state
    dict ``full``: its stage's entries, cut to its mp shards; under
    expert parallelism its data rank ``ep_rank``'s experts of
    ``ep_world``."""
    return expert_params(stage_params(shard_params(full, cfg, mp_rank), cfg,
                                      pp_rank), cfg, ep_rank, ep_world)


def params_from_jax(tree, cfg: GPTConfig, mp_rank: int = 0,
                    pp_rank: int = 0, ep_rank: int = 0,
                    ep_world: int = 1) -> Dict[str, torch.Tensor]:
    """State dict from the flax GPT param tree (``{"params": {"gpt": ...}}``
    or the inner dict), given as numpy arrays with the decoder layers
    scan-stacked on a leading ``[L]`` axis, or in a pipeline layout (JAX
    ``gpt/layers/pipe/...`` or ``pipe_chunk{j}``, mapped back to the
    sequential one as JAX ``maybe_pipeline_params_to_sequential`` maps
    it):

    - ``qkv_proj.kernel`` [L, E, nh, 3·hd] (q|k|v per head on the last
      axis) → ``attn.qkv_proj.weight`` [nh·3·hd, E]; in the split layout
      (``fuse_attn_qkv: False``) ``q_proj``/``k_proj``/``v_proj.kernel``
      [L, E, nh, hd] → ``attn.q_proj.weight`` (and k, v) [nh·hd, E];
    - ``out_proj.kernel`` [L, nh, hd, E] → ``attn.out_proj.weight``
      [E, nh·hd];
    - ``up_proj``/``down_proj.kernel`` [L, in, out] → ``weight`` [out, in];
    - norms' ``scale``/``bias`` [L, E] and the embeddings as they are;
    - under ``expert_mode``, ``moe_mlp/gate/kernel`` [L, E_h, n_exp] →
      ``moe_mlp.gate.weight`` [n_exp, E_h], and the stacked experts
      ``w_up``, ``b_up``, ``w_down``, ``b_down`` as they are.

    The decoder layers may also be unrolled (``gpt/layer_{i}``, JAX's
    ``scan_layers: False`` or ``no_recompute_layers``), each leaf without
    the [L] axis. Returned
    tensors are fp32 on the CPU; under mp, pp and expert parallelism,
    rank (``pp_rank``, ``mp_rank``, ``ep_rank``)'s part of them
    (:func:`local_params`). JAX gradient trees map alike."""
    gpt = maybe_pipeline_params_to_sequential(tree)
    gpt = gpt.get("params", gpt)["gpt"]

    def t(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=torch.float32)

    def walk(node, leaf):
        if isinstance(node, dict):
            return {k: walk(v, leaf) for k, v in node.items()}
        return leaf(node)

    scanned = (walk(gpt["layers"]["layer"], np.asarray)
               if "layers" in gpt else None)

    def layer_tree(i: int):
        """Layer i's subtree, its leaves without the scan axis."""
        if scanned is None:
            return gpt[f"layer_{i}"]
        return walk(scanned, lambda a: a[i])

    out = {"gpt.word_embeddings": t(gpt["word_embeddings"]),
           "gpt.position_embeddings": t(gpt["position_embeddings"])}
    for i in range(cfg.num_layers):
        pre = f"gpt.layers.{i}."
        stack = layer_tree(i)
        attn = stack["attn"]
        for name in ("qkv_proj", "q_proj", "k_proj", "v_proj"):
            if name in attn:
                kern = np.asarray(attn[name]["kernel"])
                out[pre + f"attn.{name}.weight"] = t(
                    kern.reshape(kern.shape[0], -1).T)
                out[pre + f"attn.{name}.bias"] = t(
                    np.asarray(attn[name]["bias"]).reshape(-1))
        proj = np.asarray(attn["out_proj"]["kernel"])
        out.update({
            pre + "norm1.scale": t(stack["norm1"]["scale"]),
            pre + "norm1.bias": t(stack["norm1"]["bias"]),
            pre + "attn.out_proj.weight": t(
                proj.reshape(-1, proj.shape[-1]).T),
            pre + "attn.out_proj.bias": t(attn["out_proj"]["bias"]),
            pre + "norm2.scale": t(stack["norm2"]["scale"]),
            pre + "norm2.bias": t(stack["norm2"]["bias"]),
        })
        if "moe_mlp" in stack:
            moe = stack["moe_mlp"]
            out[pre + "moe_mlp.gate.weight"] = t(
                np.asarray(moe["gate"]["kernel"]).T)
            out.update({pre + f"moe_mlp.{n}": t(moe[n])
                        for n in ("w_up", "b_up", "w_down", "b_down")})
            continue
        mlp = stack["mlp"]
        out.update({
            pre + "mlp.up_proj.weight": t(
                np.asarray(mlp["up_proj"]["kernel"]).T),
            pre + "mlp.up_proj.bias": t(mlp["up_proj"]["bias"]),
            pre + "mlp.down_proj.weight": t(
                np.asarray(mlp["down_proj"]["kernel"]).T),
            pre + "mlp.down_proj.bias": t(mlp["down_proj"]["bias"]),
        })
    out["gpt.final_norm.scale"] = t(gpt["final_norm"]["scale"])
    out["gpt.final_norm.bias"] = t(gpt["final_norm"]["bias"])
    return local_params(out, cfg, mp_rank, pp_rank, ep_rank, ep_world)


def convert_qkv_layout(gpt_params: dict, to_fused: bool) -> dict:
    """The attention projections of a flax-style GPT param tree between
    the fused layout (``qkv_proj``: kernel [..., embed, heads, 3·kv]) and
    the split one (``q_proj``/``k_proj``/``v_proj``: kernel [..., embed,
    heads, kv]), both directions: a numpy copy of the JAX package's
    ``convert_qkv_layout`` (models/gpt/model.py:930-972), at any nesting
    depth, scan-stacked ``[L, ...]`` leaves and the biases included."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k == "qkv_proj" and not to_fused and isinstance(v, dict):
                kern, bias = v.get("kernel"), v.get("bias")
                for idx, name in enumerate(("q_proj", "k_proj", "v_proj")):
                    part = {}
                    if kern is not None:
                        part["kernel"] = np.array_split(
                            np.asarray(kern), 3, axis=-1)[idx]
                    if bias is not None:
                        part["bias"] = np.array_split(
                            np.asarray(bias), 3, axis=-1)[idx]
                    out[name] = part
            elif k == "q_proj" and to_fused and isinstance(v, dict):
                parts = [node[n] for n in ("q_proj", "k_proj", "v_proj")]
                fused = {}
                if parts[0].get("kernel") is not None:
                    fused["kernel"] = np.concatenate(
                        [np.asarray(pp["kernel"]) for pp in parts], axis=-1)
                if parts[0].get("bias") is not None:
                    fused["bias"] = np.concatenate(
                        [np.asarray(pp["bias"]) for pp in parts], axis=-1)
                out["qkv_proj"] = fused
            elif k in ("k_proj", "v_proj") and to_fused:
                continue  # folded into qkv_proj above
            else:
                out[k] = walk(v)
        return out

    return walk(gpt_params)


def qkv_state_layout(params: Dict[str, torch.Tensor], cfg: GPTConfig,
                     to_fused: bool) -> Dict[str, torch.Tensor]:
    """A whole model's state dict with its attention projections in the
    other layout, through :func:`convert_qkv_layout`: each layer's
    ``qkv_proj`` (or ``q_proj``/``k_proj``/``v_proj``) weight and bias
    viewed as the flax kernel [E, nh, ·] and bias [nh, ·], converted,
    and mapped back; every other entry as it is."""
    nh, hd, e = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size
    names = ("q_proj", "k_proj", "v_proj") if to_fused else ("qkv_proj",)
    out = {}
    layers = sorted({int(n.split(".")[2]) for n in params
                     if n.startswith("gpt.layers.")})
    for n, v in params.items():
        if not any(f".attn.{m}." in n for m in names):
            out[n] = v
    for i in layers:
        pre = f"gpt.layers.{i}.attn."
        tree = {m: {"kernel": params[pre + m + ".weight"].detach().cpu()
                    .numpy().T.reshape(e, nh, -1),
                    "bias": params[pre + m + ".bias"].detach().cpu()
                    .numpy().reshape(nh, -1)} for m in names}
        for m, leaf in convert_qkv_layout(tree, to_fused).items():
            like = params[pre + names[0] + ".weight"]
            out[pre + m + ".weight"] = torch.tensor(
                leaf["kernel"].reshape(e, -1).T.copy(), dtype=like.dtype,
                device=like.device)
            out[pre + m + ".bias"] = torch.tensor(
                leaf["bias"].reshape(-1), dtype=like.dtype,
                device=like.device)
    return out


def params_from_checkpoint(step_dir: str, cfg: GPTConfig
                           ) -> Dict[str, torch.Tensor]:
    """The whole model's state dict (fp32, on the CPU) from the step
    directory ``step_dir`` of a ``Trainer`` checkpoint written under any
    pp and mp: every stage's file of each mp rank joined
    (:func:`gather_stages`), then the mp shards (:func:`gather_params`) of
    the model ``cfg`` describes."""
    from fleetx_tpu_torch.core.checkpoint import CheckpointStore

    root, step = os.path.split(os.path.abspath(step_dir))
    store = CheckpointStore(root)
    mesh = store.read_meta(int(step)).get("mesh") or {}
    pp, mp = int(mesh.get("pp") or 1), int(mesh.get("mp") or 1)
    shards = [gather_stages([
        store.read_state(int(step), m, p if pp > 1 else None)["params"]
        for p in range(pp)]) for m in range(mp)]
    return gather_params(shards, dataclasses.replace(cfg, mp_degree=mp))


def init_params(cfg: GPTConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                mp_rank: int = 0, pp_rank: int = 0, ep_rank: int = 0,
                ep_world: int = 1) -> Dict[str, torch.Tensor]:
    """Random fp32 weights drawn from one ``torch.Generator`` seeded with
    ``seed``, with the flax initialisers' distributions: normal(0, 0.02)
    for every kernel (the MoE gate and all four expert leaves, the
    expert biases included, as JAX's ``MoEMLP`` draws them),
    normal(0, ``initializer_range``) for the embeddings, zeros for biases
    and ones for norm scales. (The draws differ from JAX's; only the
    distributions match.) ``device`` defaults to CUDA. Under mp, pp and
    expert parallelism, the whole model is drawn and rank (``pp_rank``,
    ``mp_rank``, ``ep_rank``)'s part returned (:func:`local_params`)."""
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
    return local_params(out, cfg, mp_rank, pp_rank, ep_rank, ep_world)
