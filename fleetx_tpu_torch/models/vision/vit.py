"""Vision Transformer for the port.

Port of the JAX package's ViT (models/vision/vit.py:38-231): a patch
embedding, the class token and the learned positional embedding, pre-LN
encoder blocks with non-causal attention, the final LayerNorm, an optional
tanh ``pre_logits`` projection (``representation_size``) and the fp32
classification head; at ``num_classes == 0`` the model is a backbone and
returns the class token's features. Images are channels-last ``[b, H, W,
C]`` as in JAX.

The patch embedding, a ``p × p`` convolution of stride ``p`` in JAX, is
computed as what it is: each image is cut into its patches, each patch
flattened in (row, column, channel) order, and one GEMM maps them to the
hidden width (the flax kernel ``[p, p, C, h]`` is that GEMM's ``[p·p·C,
h]`` matrix). Attention runs through ``ops/attention.causal_attention``
with ``causal=False``: with ``use_flash_attention`` (the default) the
flash forward B1 over the 1 + (H/p)·(W/p) tokens padded to its 64-row tile
(197 → 256 at 224/16), the padded keys masked by ``kv_lens`` and the
padded query rows sliced off; without it, the dense path. B1 takes head
dims 16, 32, 64 and 128 only: a ViT whose head dim is another (huge, g, G
and 6B: 80, 88, 104, 145) is refused at construction with the flash path
on, never served by another path in its place.

The training forward (``deterministic=False``, JAX :101-223) has JAX's
dropouts at ``drop_rate`` after the positional embedding (``pos_drop``)
and on the attention and MLP outputs (``proj_drop``, ``mlp_drop``), the
attention probabilities' at ``attn_drop_rate`` (the flash kernels' hash),
and stochastic depth (:class:`DropPath`) on each residual branch at
JAX's linear depth rule. Every draw is made from the caller's
``torch.Generator`` before the first block runs
(:meth:`ViT.dropout_draws`), so a block recomputed in the backward under
``use_recompute`` draws the forward's masks again. Under data
parallelism a ``Shard`` places the rank's rows in the global batch: the
hashes key on the global element index and row, and drop path's keep
flags are drawn for the whole global batch (JAX's ``[B, 1, 1]``
bernoulli), the rank taking its rows. The draws are the port's own
(ROADMAP Queue C, "Model-level dropout streams"); so are drop path's
bits, uniforms from the generator in place of ``jax.random.bernoulli``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fleetx_tpu_torch.models.gpt.model import DTYPES, LayerNorm, _param
from fleetx_tpu_torch.ops import flash_attention as fa
from fleetx_tpu_torch.ops.attention import causal_attention
from fleetx_tpu_torch.ops.dropout import Shard, draw_site, dropout_layer
from fleetx_tpu_torch.parallel.tensor_parallel import Dense

__all__ = ["ViTConfig", "ViT", "ViTBlock", "DropPath", "VIT_PRESETS",
           "build_vision_model", "HEAD_DIM_ITEM"]

# the ROADMAP item a refused head dim names
HEAD_DIM_ITEM = ('ROADMAP Queue A, "ViT head dims outside the flash '
                 'kernel"')


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """ViT hyperparameters (the JAX ``ViTConfig`` fields)."""
    image_size: int = 224
    patch_size: int = 16
    in_channels: int = 3
    num_classes: int = 1000
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    representation_size: Optional[int] = None
    hidden_act: str = "gelu_tanh"  # or "gelu" (erf)
    # hash-based hidden dropout (ops/dropout.py); False: flax's threefry
    fast_dropout: bool = True
    use_flash_attention: bool = True
    use_recompute: bool = False  # each block recomputed in the backward
    dtype: torch.dtype = torch.bfloat16  # compute dtype; params fp32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def mlp_size(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @classmethod
    def from_model_config(cls, model_cfg) -> "ViTConfig":
        """The config from a ``Model`` section: the preset its ``name``
        gives (as ``build_vision_model``), overridden by the section's
        known keys; None values dropped, a dtype given by name."""
        section = dict(model_cfg)
        name = section.get("name")
        if name is not None and name not in VIT_PRESETS:
            raise ValueError(f"unknown vision model {name!r}; have "
                             f"{sorted(VIT_PRESETS)}")
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in section.items()
              if k in known and v is not None}
        if isinstance(kw.get("dtype"), str):
            kw["dtype"] = DTYPES[kw["dtype"]]
        return cls(**{**VIT_PRESETS.get(name, {}), **kw})


# name -> config overrides (JAX VIT_PRESETS, vit.py:85-98)
VIT_PRESETS = {
    "ViT_tiny_patch16_224": dict(patch_size=16, hidden_size=192, num_layers=12, num_attention_heads=3),
    "ViT_small_patch16_224": dict(patch_size=16, hidden_size=384, num_layers=12, num_attention_heads=6),
    "ViT_base_patch16_224": dict(patch_size=16, hidden_size=768, num_layers=12, num_attention_heads=12),
    "ViT_base_patch16_384": dict(image_size=384, patch_size=16, hidden_size=768, num_layers=12, num_attention_heads=12),
    "ViT_base_patch32_224": dict(patch_size=32, hidden_size=768, num_layers=12, num_attention_heads=12),
    "ViT_base_patch32_384": dict(image_size=384, patch_size=32, hidden_size=768, num_layers=12, num_attention_heads=12),
    "ViT_large_patch16_224": dict(patch_size=16, hidden_size=1024, num_layers=24, num_attention_heads=16),
    "ViT_large_patch16_384": dict(image_size=384, patch_size=16, hidden_size=1024, num_layers=24, num_attention_heads=16),
    "ViT_large_patch32_224": dict(patch_size=32, hidden_size=1024, num_layers=24, num_attention_heads=16),
    "ViT_large_patch32_384": dict(image_size=384, patch_size=32, hidden_size=1024, num_layers=24, num_attention_heads=16),
    "ViT_huge_patch14_224": dict(patch_size=14, hidden_size=1280, num_layers=32, num_attention_heads=16),
    "ViT_huge_patch14_384": dict(image_size=384, patch_size=14, hidden_size=1280, num_layers=32, num_attention_heads=16),
    "ViT_g_patch14_224": dict(patch_size=14, hidden_size=1408, num_layers=40, num_attention_heads=16, mlp_ratio=48 / 11),
    "ViT_G_patch14_224": dict(patch_size=14, hidden_size=1664, num_layers=48, num_attention_heads=16, mlp_ratio=64 / 13),
    "ViT_6B_patch14_224": dict(patch_size=14, hidden_size=2320, num_layers=80, num_attention_heads=16),
}


class DropPath(nn.Module):
    """Stochastic depth: each sample's residual branch dropped with
    probability ``rate`` (kept ones scaled by 1/(1 - rate)); the identity
    when ``deterministic`` or at rate 0. ``mask`` (bool [b], True = kept)
    gives the rows' keep flags; without it they are drawn from
    ``generator`` (:meth:`keep_flags`)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def keep_flags(self, rows: int, generator: Optional[torch.Generator],
                   deterministic: bool = False, shard: Optional[Shard] = None
                   ) -> Optional[torch.Tensor]:
        """Keep flags (bool, on the generator's device) of this rank's
        ``rows`` from one draw over the global batch ``shard`` places them
        in (None: they are all of it); None where the path draws
        nothing."""
        if self.rate == 0.0 or deterministic:
            return None
        b0, total = (0, rows) if shard is None else (shard.b0, shard.batch)
        dev = generator.device if generator is not None else "cpu"
        u = torch.rand(total, generator=generator, device=dev)
        return (u < 1.0 - self.rate)[b0:b0 + rows]

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.rate == 0.0 or deterministic:
            return x
        keep = 1.0 - self.rate
        if mask is None:
            mask = self.keep_flags(x.shape[0], generator)
        mask = mask.to(x.device).view((x.shape[0],) + (1,) * (x.dim() - 1))
        return torch.where(mask, x / keep, torch.zeros_like(x))


class ViTBlock(nn.Module):
    """Pre-LN encoder block: x + path(drop(attn(norm1(x)))), then
    x + path(drop(mlp(norm2(x)))), each branch through its dropout and
    :class:`DropPath`. The qkv projection is fused (per head q | k | v,
    the flax ``[E, nh, 3·hd]`` kernel); without ``qkv_bias`` its bias is
    held at zero."""

    def __init__(self, cfg: ViTConfig, drop_path: float = 0.0, device=None):
        super().__init__()
        self.cfg = cfg
        e, nh, hd = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
        self.norm1 = LayerNorm(e, cfg.dtype, device)
        self.qkv_proj = Dense(e, nh * 3 * hd, cfg.dtype, device)
        self.out_proj = Dense(nh * hd, e, cfg.dtype, device)
        self.proj_drop = dropout_layer(cfg.drop_rate, cfg.fast_dropout)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(e, cfg.dtype, device)
        self.fc1 = Dense(e, cfg.mlp_size, cfg.dtype, device)
        self.fc2 = Dense(cfg.mlp_size, e, cfg.dtype, device)
        self.mlp_drop = dropout_layer(cfg.drop_rate, cfg.fast_dropout)
        self.drop_path2 = DropPath(drop_path)

    def draws(self, rows: int, generator: Optional[torch.Generator],
              deterministic: bool, shard: Optional[Shard]) -> tuple:
        """``(attention seed, proj_drop draw, drop_path1 flags, mlp_drop
        draw, drop_path2 flags)`` of one training forward, in the order
        the sites run (None where a site draws nothing)."""
        cfg = self.cfg
        hidden = dict(hidden=True, fast=cfg.fast_dropout,
                      deterministic=deterministic)
        return (draw_site(generator, cfg.attn_drop_rate, hidden=False,
                          deterministic=deterministic),
                draw_site(generator, cfg.drop_rate, **hidden),
                self.drop_path1.keep_flags(rows, generator, deterministic,
                                           shard),
                draw_site(generator, cfg.drop_rate, **hidden),
                self.drop_path2.keep_flags(rows, generator, deterministic,
                                           shard))

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                draws=(None,) * 5, shard: Optional[Shard] = None
                ) -> torch.Tensor:
        """``draws``: :meth:`draws`; ``shard`` places x's rows in the
        global batch."""
        cfg = self.cfg
        b, s, _ = x.shape
        nh = cfg.num_attention_heads
        attn_seed, proj_seed, path1, mlp_seed, path2 = draws
        qkv = self.qkv_proj(self.norm1(x)).view(b, s, -1, 3 * cfg.head_dim)
        q, k, v = qkv.split(cfg.head_dim, dim=-1)
        b0 = 0 if shard is None else shard.b0
        y = causal_attention(q, k, v, causal=False,
                             dropout_rate=cfg.attn_drop_rate, seed=attn_seed,
                             deterministic=deterministic,
                             use_flash=cfg.use_flash_attention,
                             meta=(b0, 0, nh, nh, 0, 0))
        y = self.proj_drop(self.out_proj(y.reshape(b, s, -1)),
                           deterministic, seed=proj_seed, shard=shard)
        x = x + self.drop_path1(y, deterministic, mask=path1)
        y = F.gelu(self.fc1(self.norm2(x)),
                   approximate="none" if cfg.hidden_act == "gelu"
                   else "tanh")
        y = self.mlp_drop(self.fc2(y), deterministic, seed=mlp_seed,
                          shard=shard)
        return x + self.drop_path2(y, deterministic, mask=path2)


class ViT(nn.Module):
    """Patch embedding, class token, encoder, final norm and head (module
    docstring): logits [b, num_classes] in fp32, or at ``num_classes ==
    0`` the pooled features [b, representation_size or hidden] in the
    compute dtype."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        if cfg.use_flash_attention and cfg.head_dim not in fa.HEAD_DIMS:
            raise NotImplementedError(
                f"ViT head dim {cfg.head_dim} (hidden {cfg.hidden_size} "
                f"over {cfg.num_attention_heads} heads) is outside the "
                f"flash kernel's {fa.HEAD_DIMS}: not ported yet "
                f"({HEAD_DIM_ITEM})")
        self.cfg = cfg
        e, p, c = cfg.hidden_size, cfg.patch_size, cfg.in_channels
        self.patch_embed = Dense(p * p * c, e, cfg.dtype, device)
        self.cls_token = _param(1, 1, e, device=device)
        self.pos_embed = _param(1, cfg.num_patches + 1, e, device=device)
        self.pos_drop = dropout_layer(cfg.drop_rate, cfg.fast_dropout)
        # linearly increasing stochastic depth (JAX's dpr rule)
        self.blocks = nn.ModuleDict(
            (str(i), ViTBlock(cfg, cfg.drop_path_rate * i
                              / max(cfg.num_layers - 1, 1), device))
            for i in range(cfg.num_layers))
        self.final_norm = LayerNorm(e, cfg.dtype, device)
        width = e
        if cfg.representation_size:
            self.pre_logits = Dense(e, cfg.representation_size, cfg.dtype,
                                    device)
            width = cfg.representation_size
        if cfg.num_classes:
            self.head = Dense(width, cfg.num_classes, torch.float32, device)

    def patches(self, images: torch.Tensor) -> torch.Tensor:
        """``[b, H, W, C]`` → ``[b, (H/p)·(W/p), p·p·C]``: each patch in
        (row, column, channel) order, the patches row-major."""
        b, hh, ww, c = images.shape
        p = self.cfg.patch_size
        x = images.reshape(b, hh // p, p, ww // p, p, c)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, p * p * c)

    def dropout_draws(self, rows: int, deterministic: bool,
                      generator: Optional[torch.Generator],
                      shard: Optional[Shard] = None) -> tuple:
        """``(pos_drop's draw, [each block's draws])`` of one training
        forward over ``rows`` images, drawn from ``generator`` in the
        order the sites run, before any block runs (a block recomputed in
        the backward reuses them; the generator's stream is the same with
        recompute on or off)."""
        cfg = self.cfg
        pos = draw_site(generator, cfg.drop_rate, hidden=True,
                        fast=cfg.fast_dropout, deterministic=deterministic)
        return pos, [block.draws(rows, generator, deterministic, shard)
                     for block in self.blocks.values()]

    def forward(self, images: torch.Tensor, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                shard: Optional[Shard] = None) -> torch.Tensor:
        """Logits or features (class docstring); unless ``deterministic``,
        with the dropouts and drop path, drawn from ``generator``;
        ``shard`` places the rows in the global batch."""
        cfg = self.cfg
        b = images.shape[0]
        pos_seed, block_draws = self.dropout_draws(b, deterministic,
                                                   generator, shard)
        x = self.patch_embed(self.patches(images.to(cfg.dtype)))
        cls = self.cls_token.to(cfg.dtype).expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)
        x = self.pos_drop(x, deterministic, seed=pos_seed, shard=shard)
        recompute = cfg.use_recompute and torch.is_grad_enabled()
        for block, draws in zip(self.blocks.values(), block_draws):
            kw = dict(deterministic=deterministic, draws=draws, shard=shard)
            if recompute:
                # the draws come in, so the rerun needs no RNG state
                x = checkpoint(block, x, use_reentrant=False,
                               preserve_rng_state=False, **kw)
            else:
                x = block(x, **kw)
        x = self.final_norm(x)[:, 0]
        if cfg.representation_size:
            x = torch.tanh(self.pre_logits(x))
        if not cfg.num_classes:  # backbone mode: the pooled features
            return x
        return self.head(x.float())


def build_vision_model(name: str, device=None, **overrides) -> ViT:
    """The preset ``name`` with ``overrides`` (JAX ``build_vision_model``);
    unallocated weights on ``device`` (load them with
    ``load_state_dict(..., assign=True)``)."""
    if name not in VIT_PRESETS:
        raise ValueError(f"unknown vision model {name!r}; have "
                         f"{sorted(VIT_PRESETS)}")
    return ViT(ViTConfig(**{**VIT_PRESETS[name], **overrides}), device)
