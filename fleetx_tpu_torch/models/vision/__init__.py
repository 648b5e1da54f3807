"""Vision backbones: the ViT presets and their weight bridge."""

from fleetx_tpu_torch.models.vision.vit import (  # noqa: F401
    VIT_PRESETS,
    ViT,
    ViTConfig,
    build_vision_model,
)
