"""Model families of the port, and ``build_module`` by config name."""

from __future__ import annotations

__all__ = ["build_module"]


def build_module(cfg):
    """The module named by ``cfg.Model.module`` (reference
    models/__init__.py). The port registers ``GPTModule``,
    ``GPTGenerationModule`` and ``MoEModule``."""
    from fleetx_tpu_torch.models.language_module import GPTModule
    from fleetx_tpu_torch.models.language_module_generation import (
        GPTGenerationModule,
    )
    from fleetx_tpu_torch.models.moe_module import MoEModule

    modules = {"GPTModule": GPTModule,
               "GPTGenerationModule": GPTGenerationModule,
               "MoEModule": MoEModule}
    name = (cfg.get("Model") or {}).get("module") or "GPTModule"
    if name not in modules:
        raise ValueError(f"unknown module {name!r}; the port has "
                         f"{sorted(modules)}")
    return modules[name](cfg)
