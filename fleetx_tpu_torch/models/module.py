"""Module contract: the boundary between the engine and a model family.

Port of the JAX package's ``BasicModule`` (models/module.py). A module
builds its network (``nets``), initialises its weights and computes the
training loss of a batch; the ``Trainer`` owns the loop, the optimizer
and the device. QAT and extra (non-parameter) training state are not
ported.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

__all__ = ["BasicModule"]


class BasicModule:
    """Subclasses provide the network, its initial weights and the loss."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.nets = self.get_model()

    def get_model(self) -> torch.nn.Module:
        raise NotImplementedError

    def init_params(self, seed: int, device) -> Dict[str, torch.Tensor]:
        """A state dict of fresh weights for ``nets`` drawn from ``seed``."""
        raise NotImplementedError

    def loss_fn(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator], train: bool
                ) -> torch.Tensor:
        """The scalar loss of one (micro)batch; ``train`` turns dropout on,
        its seeds drawn from ``generator``."""
        raise NotImplementedError

    def training_step_end(self, log: Dict[str, Any]) -> None:
        pass
