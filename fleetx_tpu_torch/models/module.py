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

from fleetx_tpu_torch.ops.dropout import Shard
from fleetx_tpu_torch.parallel.mesh import get_data_world

__all__ = ["BasicModule", "ENCODER_LAYOUTS_ITEM", "data_shard",
           "encoder_flops_per_sample", "refuse_encoder_layouts"]

# the ROADMAP item an encoder module at a refused layout names
ENCODER_LAYOUTS_ITEM = 'ROADMAP Queue A, "Encoders under mp, pp, cp or ZeRO"'


def data_shard(mesh, rows: int, seq: int) -> Optional[Shard]:
    """Where this rank's ``[rows, seq]`` activations lie in the global
    batch and sequence, for the dropout hashes (None: they are the whole
    of it). mp ranks share rows and positions; under cp the rank holds
    one ``seq``-long part of each sequence."""
    if mesh.data_world == 1:
        return None
    return Shard(b0=mesh.data_rank * rows, batch=get_data_world(mesh) * rows,
                 s0=mesh.cp_rank * seq, seq=mesh.cp * seq)


def encoder_flops_per_sample(dense_params: int, layers: int, hidden: int,
                             seq: int) -> float:
    """Model FLOPs of one trained sequence of ``seq`` tokens through a
    non-causal encoder (forward 2, backward 4 a product): 6 per dense
    (non-embedding) parameter per token, and the attention's score and
    value products over all s² (query, key) pairs, 4·h·s² a layer
    forward, 12·L·h·s² with the backward."""
    return 6.0 * dense_params * seq + 12.0 * layers * hidden * seq * seq


def refuse_encoder_layouts(cfg, family: str) -> None:
    """An encoder module trains under data parallelism only: at an mp, pp,
    cp or sharding degree above 1 it raises ``NotImplementedError`` naming
    its ROADMAP item."""
    dist_cfg = cfg.get("Distributed") or {}
    degrees = {"mp_degree": dist_cfg.get("mp_degree") or 1,
               "pp_degree": dist_cfg.get("pp_degree") or 1,
               "cp_degree": dist_cfg.get("cp_degree") or 1,
               "sharding_degree": (dist_cfg.get("sharding") or {}).get(
                   "sharding_degree") or 1}
    over = {k: v for k, v in degrees.items() if v > 1}
    if over:
        raise NotImplementedError(
            f"{family} at {', '.join(f'{k} {v}' for k, v in over.items())} "
            f"is not ported yet ({ENCODER_LAYOUTS_ITEM}); it trains over "
            "dp only")


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

    def model_flops_per_sample(self, n_params: int) -> Optional[float]:
        """Model FLOPs of one trained sample (forward and backward), for the
        trainer's MFU; None when the trainer counts them itself (GPT)."""
        return None

    def training_step_end(self, log: Dict[str, Any]) -> None:
        pass
