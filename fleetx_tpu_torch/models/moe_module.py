"""MoEModule: GPT pretraining with mixture-of-experts MLPs.

Port of the JAX package's ``MoEModule`` (models/moe_module.py:16-43): the
GPT module with every decoder layer's MLP an ``MoEMLP``
(``parallel/moe.py``), whose loss is the LM loss plus
``balance_loss_weight`` times the mean over the layers of their balance
losses. As in JAX its loss always takes the logits path: the override
never calls the fused cross-entropy, so ``Model.fused_ce`` is not read.

Under expert parallelism (the experts split over the data ranks) each
rank's LM loss is its share of the global masked mean, as in
``GPTModule``, and the balance loss is one global number that every rank
holds, its gradient flowing through the rank's own gate rows only: each
rank's loss carries it with the value ``1 / data_world`` of it and the
whole gradient of its own rows, so that the trainer's sums over the data
group count it once, in the loss and in the gradients.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from fleetx_tpu_torch.models.language_module import GPTModule
from fleetx_tpu_torch.models.module import data_shard
from fleetx_tpu_torch.parallel.mesh import mesh_from_config
from fleetx_tpu_torch.parallel.tensor_parallel import (
    vocab_parallel_token_losses,
)

__all__ = ["MoEModule"]


class MoEModule(GPTModule):
    """GPT + MoE MLP pretraining. :attr:`metrics` holds the last
    ``loss_fn`` call's ``lm_loss`` and ``balance_loss`` (this rank's
    shares of them, detached; summed over the data group they are the
    step's, as JAX's Trainer reports them, core/engine.py:546)."""

    metrics: Optional[Dict[str, torch.Tensor]] = None

    def loss_fn(self, batch, generator: Optional[torch.Generator],
                train: bool) -> torch.Tensor:
        """LM loss + ``balance_loss_weight`` × the layers' mean balance
        loss (JAX ``MoEModule.loss_fn``), through the logits."""
        mesh = mesh_from_config(self.cfg)
        tokens, position_ids, labels, loss_mask = self.cp_prepare(batch)
        logits = self.nets(tokens, position_ids, deterministic=not train,
                           generator=generator,
                           shard=data_shard(mesh, *tokens.shape))
        lm = self._masked_mean(vocab_parallel_token_losses(
            logits, labels, mesh.mp_group), loss_mask, mesh)
        losses = self.nets.gpt.balance_losses
        balance = (torch.stack(losses).sum() / len(losses) if losses
                   else torch.zeros((), device=logits.device))
        # the value 1/D of the global loss, the gradient of the whole
        share = balance - balance.detach() * (1.0 - 1.0 / mesh.data_world)
        self.metrics = {"lm_loss": lm.detach(),
                        "balance_loss": share.detach()}
        return lm + self.gpt_config.balance_loss_weight * share
