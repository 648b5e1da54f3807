"""Language-model modules.

Port of the JAX package's ``LanguageModule`` and ``GPTModule``
(models/language_module.py:28-71, 187-306): the ``ips:`` and ``[eval]``
log lines and the GPT pretraining loss, through the logits or, under
``Model.fused_ce``, through the fused LM-head cross-entropy (B4–B6).
Pipeline, context parallelism and pretrained warm starts are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from fleetx_tpu_torch.models.gpt.convert import init_params
from fleetx_tpu_torch.models.gpt.model import (
    GPTConfig,
    GPTForPretraining,
    masked_loss_mean,
    pretraining_loss,
)
from fleetx_tpu_torch.models.module import BasicModule
from fleetx_tpu_torch.ops.ce_loss import fit_vocab_block
from fleetx_tpu_torch.utils.log import logger

__all__ = ["LanguageModule", "GPTModule", "resolve_compute_dtype"]


class LanguageModule(BasicModule):
    """Adds LM-style logging: loss, lr, step cost, ips (tokens/s) and MFU
    — the ``ips:`` keyword line benchmark harnesses parse."""

    def training_step_end(self, log: Dict) -> None:
        mfu = log.get("mfu")
        logger.train(
            "[train] epoch: %d, batch: %d, loss: %.9f, avg_batch_cost: %.5f sec, "
            "speed: %.2f step/s, ips_total: %.0f tokens/s, ips: %.0f tokens/s, "
            "mfu: %s, learning rate: %.3e",
            log["epoch"],
            log["batch"],
            log["loss"],
            log["batch_cost"],
            1.0 / max(log["batch_cost"], 1e-9),
            log["ips_total"],
            log["ips"],
            ("%.4f" % mfu) if mfu is not None else "-",
            log["lr"],
        )

    def validation_step_end(self, log: Dict) -> None:
        logger.eval(
            "[eval] epoch: %d, batch: %d, loss: %.9f, avg_eval_cost: %.5f sec",
            log["epoch"],
            log["batch"],
            log["loss"],
            log["batch_cost"],
        )


def resolve_compute_dtype(engine_cfg) -> torch.dtype:
    """AMP config → compute dtype: ``mix_precision.dtype`` if set, else
    bf16 under ``use_pure_fp16`` and fp32 otherwise; fp16 maps to bf16 (no
    loss scaling), as in the JAX package."""
    mp = (engine_cfg.get("mix_precision") or {}) \
        if isinstance(engine_cfg, dict) else {}
    name = mp.get("dtype") or ("bfloat16" if mp.get("use_pure_fp16")
                               else "float32")
    return {"bfloat16": torch.bfloat16, "float16": torch.bfloat16,
            "float32": torch.float32}[str(name)]


class GPTModule(LanguageModule):
    """GPT pretraining: batch = tokens, position_ids, labels, loss_mask.

    ``Model.fused_ce`` takes the loss through the fused LM-head
    cross-entropy. As in JAX, a vocab with no lane-aligned block demotes
    it to the logits path with a warning, and so does (per batch) a token
    count that 8 does not divide; on the card either raises instead, so
    that the logits path is never taken there in silence."""

    fused_ce_blocked: Optional[str] = None  # why fused_ce was demoted

    def get_model(self):
        gcfg = GPTConfig.from_model_config(self.cfg.Model)
        eng = self.cfg.get("Engine") or {}
        gcfg = GPTConfig(**{**gcfg.__dict__,
                            "dtype": resolve_compute_dtype(eng)})
        if gcfg.fused_ce and fit_vocab_block(gcfg.vocab_size) is None:
            self.fused_ce_blocked = (
                f"vocab {gcfg.vocab_size} admits no lane-aligned block "
                "(128-multiple or 64)")
            logger.warning("Model.fused_ce disabled: %s; using the logits "
                           "path (a batch on the card raises)",
                           self.fused_ce_blocked)
            gcfg = GPTConfig(**{**gcfg.__dict__, "fused_ce": False})
        self.gpt_config = gcfg
        return GPTForPretraining(self.gpt_config, device="meta")

    def init_params(self, seed: int, device) -> Dict[str, torch.Tensor]:
        return init_params(self.gpt_config, seed=seed, device=device)

    def loss_fn(self, batch, generator: Optional[torch.Generator],
                train: bool) -> torch.Tensor:
        """The masked mean token loss (JAX ``loss_fn``, :279-306): through
        the fused kernels when ``fused_ce`` is on and 8 divides the batch's
        token count, else through the logits (CPU batches only when
        ``fused_ce`` was asked for)."""
        tokens, labels = batch["tokens"], batch["labels"]
        kw = dict(deterministic=not train, generator=generator)
        why = self.fused_ce_blocked
        if self.gpt_config.fused_ce:
            if labels.numel() % 8 == 0:
                token_loss = self.nets(tokens, batch["position_ids"],
                                       labels=labels, **kw)
                return masked_loss_mean(token_loss, batch["loss_mask"])
            why = f"8 does not divide the batch's {labels.numel()} tokens"
        if why is not None and tokens.is_cuda:
            raise ValueError(f"Model.fused_ce cannot run: {why}; on the "
                             "card the logits path is not taken instead")
        logits = self.nets(tokens, batch["position_ids"], **kw)
        return pretraining_loss(logits, labels, batch["loss_mask"])
