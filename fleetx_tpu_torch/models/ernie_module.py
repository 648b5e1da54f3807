"""ErnieModule: masked-LM and sentence-order-prediction pretraining.

Port of the JAX package's ``ErnieModule`` (models/ernie_module.py:29-68):
the loss of a batch is ``lm_loss + sop_loss`` (``ernie_pretraining_loss``;
without ``Model.binary_head`` the SOP term is zero), the model computing
in the dtype ``Engine.mix_precision`` gives, with its dropouts when
training. The batch contract is ``ErnieDataset``'s (``data/
ernie_dataset.py``): ``input_ids``, ``token_type_ids`` [b, s],
``masked_positions``, ``masked_labels``, ``masked_weights`` [b, P] and
``sop_labels`` [b]; as in JAX the attention mask comes from the pad
tokens, as per-row key lengths under ``right_padded_inputs``.

Over several data ranks each rank's loss is its share of JAX's over the
global batch: the weighted masked-token sum over the global batch's
weight sum (one all-reduce over the data group), the SOP sum over the
global rows; the trainer's sum over the data group gives JAX's loss and
gradients. ``metrics`` holds the two terms (the rank's shares), which the
trainer reports like an MoE module's. ERNIE trains over dp only: an mp,
pp, cp or sharding degree above 1 raises, naming "Encoders under mp, pp,
cp or ZeRO".
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from fleetx_tpu_torch.data.ernie_dataset import max_predictions
from fleetx_tpu_torch.models.ernie.convert import init_params
from fleetx_tpu_torch.models.ernie.model import (
    ErnieConfig,
    ErnieForPretraining,
    ernie_pretraining_loss,
)
from fleetx_tpu_torch.models.language_module import (
    LanguageModule,
    resolve_compute_dtype,
)
from fleetx_tpu_torch.models.module import (
    data_shard,
    encoder_flops_per_sample,
    refuse_encoder_layouts,
)
from fleetx_tpu_torch.parallel.mesh import mesh_from_config

__all__ = ["ErnieModule"]

_EMBEDDINGS = ("ernie.word_embeddings", "ernie.position_embeddings",
               "ernie.token_type_embeddings")


class ErnieModule(LanguageModule):
    """ERNIE pretraining (JAX ``ErnieModule``): :attr:`metrics` holds the
    last ``loss_fn`` call's ``lm_loss`` and ``sop_loss`` (this rank's
    shares, detached)."""

    metrics: Optional[Dict[str, torch.Tensor]] = None

    def get_model(self):
        refuse_encoder_layouts(self.cfg, "ERNIE")
        model_cfg = self.cfg.Model
        ecfg = ErnieConfig.from_model_config(model_cfg)
        eng = self.cfg.get("Engine") or {}
        self.ernie_config = ErnieConfig(**{
            **ecfg.__dict__, "dtype": resolve_compute_dtype(eng)})
        self.binary_head = bool(model_cfg.get("binary_head", True))
        return ErnieForPretraining(self.ernie_config, device="meta")

    def init_params(self, seed: int, device) -> Dict[str, torch.Tensor]:
        return init_params(self.ernie_config, seed=seed, device=device)

    def loss_fn(self, batch, generator: Optional[torch.Generator],
                train: bool) -> torch.Tensor:
        """``lm_loss + sop_loss`` of the batch (JAX ``loss_fn``), this
        rank's share of the global batch's over several data ranks."""
        mesh = mesh_from_config(self.cfg)
        ids = batch["input_ids"]
        mlm, sop = self.nets(ids, batch.get("token_type_ids"), None, None,
                             batch["masked_positions"],
                             deterministic=not train, generator=generator,
                             shard=data_shard(mesh, *ids.shape))
        lm_loss, sop_loss = ernie_pretraining_loss(
            mlm, sop, batch["masked_labels"], batch["masked_weights"],
            batch.get("sop_labels") if self.binary_head else None,
            group=mesh.data_group if mesh.data_world > 1 else None)
        self.metrics = {"lm_loss": lm_loss.detach(),
                        "sop_loss": sop_loss.detach()}
        return lm_loss + sop_loss

    def model_flops_per_sample(self, n_params: int) -> float:
        """:func:`encoder_flops_per_sample` at the dataset's sequence
        length, the three embedding tables left out of the dense
        parameters, plus the MLM head's logits on the tied word embedding
        (6·P·h·V a sequence, P masked slots)."""
        cfg = self.ernie_config
        ds = self.cfg.Data.Train.dataset
        seq = ds.get("max_seq_len") or 512
        slots = max_predictions(seq, ds.get("masked_lm_prob") or 0.15,
                                ds.get("max_predictions_per_seq"))
        tables = sum(p.numel() for n, p in self.nets.named_parameters()
                     if n in _EMBEDDINGS)
        return (encoder_flops_per_sample(n_params - tables, cfg.num_layers,
                                         cfg.hidden_size, seq)
                + 6.0 * slots * cfg.hidden_size * cfg.vocab_size)
