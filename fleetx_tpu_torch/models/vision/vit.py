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

The forward is deterministic (the serving path): dropout and drop path
belong to ViT training, which the port does not have yet, and
``deterministic=False`` raises. :class:`DropPath` itself is here, the
identity when deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fleetx_tpu_torch.models.ernie.model import refuse_training
from fleetx_tpu_torch.models.gpt.model import DTYPES, LayerNorm, _param
from fleetx_tpu_torch.ops import flash_attention as fa
from fleetx_tpu_torch.ops.attention import causal_attention
from fleetx_tpu_torch.parallel.tensor_parallel import Dense

__all__ = ["ViTConfig", "ViT", "ViTBlock", "DropPath", "VIT_PRESETS",
           "build_vision_model", "HEAD_DIM_ITEM"]

# the ROADMAP item a refused head dim names
HEAD_DIM_ITEM = ('ROADMAP Queue A, "ViT head dims outside the flash '
                 'kernel"')


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """ViT hyperparameters (the JAX ``ViTConfig`` fields the port reads;
    its dropouts and training switches are not here)."""
    image_size: int = 224
    patch_size: int = 16
    in_channels: int = 3
    num_classes: int = 1000
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path_rate: float = 0.0
    representation_size: Optional[int] = None
    hidden_act: str = "gelu_tanh"  # or "gelu" (erf)
    use_flash_attention: bool = True
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
    when ``deterministic`` or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or deterministic:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class ViTBlock(nn.Module):
    """Pre-LN encoder block: x + attn(norm1(x)), then x + mlp(norm2(x)),
    each branch through its :class:`DropPath`. The qkv projection is fused
    (per head q | k | v, the flax ``[E, nh, 3·hd]`` kernel); without
    ``qkv_bias`` its bias is held at zero."""

    def __init__(self, cfg: ViTConfig, drop_path: float = 0.0, device=None):
        super().__init__()
        self.cfg = cfg
        e, nh, hd = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
        self.norm1 = LayerNorm(e, cfg.dtype, device)
        self.qkv_proj = Dense(e, nh * 3 * hd, cfg.dtype, device)
        self.out_proj = Dense(nh * hd, e, cfg.dtype, device)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(e, cfg.dtype, device)
        self.fc1 = Dense(e, cfg.mlp_size, cfg.dtype, device)
        self.fc2 = Dense(cfg.mlp_size, e, cfg.dtype, device)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        qkv = self.qkv_proj(self.norm1(x)).view(b, s, -1, 3 * cfg.head_dim)
        q, k, v = qkv.split(cfg.head_dim, dim=-1)
        y = causal_attention(q, k, v, causal=False,
                             use_flash=cfg.use_flash_attention)
        x = x + self.drop_path1(self.out_proj(y.reshape(b, s, -1)))
        y = F.gelu(self.fc1(self.norm2(x)),
                   approximate="none" if cfg.hidden_act == "gelu"
                   else "tanh")
        return x + self.drop_path2(self.fc2(y))


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

    def forward(self, images: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        refuse_training(deterministic, "ViT")
        cfg = self.cfg
        b = images.shape[0]
        x = self.patch_embed(self.patches(images.to(cfg.dtype)))
        cls = self.cls_token.to(cfg.dtype).expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)
        for block in self.blocks.values():
            x = block(x)
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
