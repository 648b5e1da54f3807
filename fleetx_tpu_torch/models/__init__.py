"""Model families of the port, and ``build_module`` by config name."""

from __future__ import annotations

__all__ = ["build_module"]


def build_module(cfg):
    """The module named by ``cfg.Model.module`` (reference
    models/__init__.py). The port registers ``GPTModule``,
    ``GPTGenerationModule``, ``MoEModule``, ``ErnieModule`` and
    ``GeneralClsModule``."""
    from fleetx_tpu_torch.models.ernie_module import ErnieModule
    from fleetx_tpu_torch.models.language_module import GPTModule
    from fleetx_tpu_torch.models.language_module_generation import (
        GPTGenerationModule,
    )
    from fleetx_tpu_torch.models.moe_module import MoEModule
    from fleetx_tpu_torch.models.vision_module import GeneralClsModule

    modules = {"GPTModule": GPTModule,
               "GPTGenerationModule": GPTGenerationModule,
               "MoEModule": MoEModule, "ErnieModule": ErnieModule,
               "GeneralClsModule": GeneralClsModule}
    name = (cfg.get("Model") or {}).get("module") or "GPTModule"
    if name not in modules:
        raise ValueError(f"unknown module {name!r}; the port has "
                         f"{sorted(modules)}")
    return modules[name](cfg)
