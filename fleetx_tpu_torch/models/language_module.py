"""Language-model modules.

Port of the JAX package's ``LanguageModule`` and ``GPTModule``
(models/language_module.py:28-71, 187-306): the ``ips:`` log line and the
GPT pretraining loss. Pipeline, context parallelism, the fused LM-head
loss and pretrained warm starts are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from fleetx_tpu_torch.models.gpt.convert import init_params
from fleetx_tpu_torch.models.gpt.model import (
    GPTConfig,
    GPTForPretraining,
    pretraining_loss,
)
from fleetx_tpu_torch.models.module import BasicModule
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
    """GPT pretraining: batch = tokens, position_ids, labels, loss_mask."""

    def get_model(self):
        gcfg = GPTConfig.from_model_config(self.cfg.Model)
        eng = self.cfg.get("Engine") or {}
        self.gpt_config = GPTConfig(**{**gcfg.__dict__,
                                       "dtype": resolve_compute_dtype(eng)})
        return GPTForPretraining(self.gpt_config, device="meta")

    def init_params(self, seed: int, device) -> Dict[str, torch.Tensor]:
        return init_params(self.gpt_config, seed=seed, device=device)

    def loss_fn(self, batch, generator: Optional[torch.Generator],
                train: bool) -> torch.Tensor:
        logits = self.nets(batch["tokens"], batch["position_ids"],
                           deterministic=not train, generator=generator)
        return pretraining_loss(logits, batch["labels"], batch["loss_mask"])
