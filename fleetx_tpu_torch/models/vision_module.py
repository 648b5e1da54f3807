"""GeneralClsModule: image-classification training and evaluation.

Port of the JAX package's ``GeneralClsModule`` (models/vision_module.py:
57-129): the ViT (the ``Model.name`` preset with the section's keys, in
the dtype ``Engine.mix_precision`` gives) under a soft cross-entropy with
``Model.label_smoothing``, and, when training with ``Model.mixup_alpha``
above 0, mixup: λ ~ Beta(α, α), then the images and the one-hot targets
mixed with themselves rolled by one row (``λ·x + (1 − λ)·roll(x, 1)``).
``metrics`` holds the batch's top-1 accuracy against the unmixed labels.
The batch contract: ``images`` [b, H, W, C] float32 and ``labels`` [b].

λ is one draw a micro-batch: an integer seed from the trainer's
``torch.Generator`` (the same on every rank) seeds numpy's Beta sampler
(JAX draws ``jax.random.beta``: ROADMAP Queue C, "Mixup's λ"). The roll
is over the global micro-batch, as JAX's under GSPMD: over several data
ranks a rank's first row pairs with the previous rank's last row (one
all-gather of the ranks' last rows), the first rank's with the last
rank's. Each rank's loss and accuracy are its sums over the global
micro-batch's rows, so that the trainer's sum over the data group gives
JAX's means. ViT trains over dp only: an mp, pp, cp or sharding degree
above 1 raises, naming "Encoders under mp, pp, cp or ZeRO".
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from fleetx_tpu_torch.models.language_module import resolve_compute_dtype
from fleetx_tpu_torch.models.module import (
    BasicModule,
    data_shard,
    encoder_flops_per_sample,
    refuse_encoder_layouts,
)
from fleetx_tpu_torch.models.vision.convert import init_params
from fleetx_tpu_torch.models.vision.vit import ViT, ViTConfig
from fleetx_tpu_torch.parallel.mesh import mesh_from_config
from fleetx_tpu_torch.utils.log import logger

__all__ = ["GeneralClsModule", "draw_beta", "global_roll",
           "log_images_per_sec", "soft_ce_sum"]

_TABLES = ("cls_token", "pos_embed")  # ViT's embedding parameters


def log_images_per_sec(cfg, log: Dict) -> None:
    """The vision train line (JAX ``log_images_per_sec``): images/s of the
    global batch over the step time (the trainer's element count is
    pixels for image batches), and the MFU."""
    images = cfg.Global.global_batch_size / max(log["batch_cost"], 1e-9)
    mfu = log.get("mfu")
    logger.train(
        "[train] epoch: %d, batch: %d, loss: %.9f, avg_batch_cost: %.5f sec, "
        "speed: %.2f step/s, ips_total: %.0f images/s, ips: %.0f images/s, "
        "mfu: %s, learning rate: %.3e",
        log["epoch"], log["batch"], log["loss"], log["batch_cost"],
        1.0 / max(log["batch_cost"], 1e-9), images, images,
        ("%.4f" % mfu) if mfu is not None else "-", log["lr"])


def soft_ce_sum(logits: torch.Tensor, targets: torch.Tensor,
                label_smoothing: float = 0.0) -> torch.Tensor:
    """The summed cross-entropy of ``logits`` [b, C] against dense
    (possibly mixed) ``targets`` [b, C], smoothed toward uniform (JAX
    ``_soft_ce`` before its mean)."""
    n_cls = logits.shape[-1]
    if label_smoothing > 0.0:
        targets = targets * (1.0 - label_smoothing) + label_smoothing / n_cls
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(targets * logp).sum(-1).sum()


def draw_beta(generator: Optional[torch.Generator], alpha: float) -> float:
    """λ ~ Beta(α, α): numpy's sampler seeded with one draw of
    ``generator``."""
    seed = int(torch.randint(0, 1 << 31, (1,), generator=generator))
    return float(np.random.RandomState(seed).beta(alpha, alpha))


def global_roll(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t``'s rows rolled by one over the global batch (``torch.roll(t,
    1, 0)`` on one data rank): row 0 takes the previous data rank's last
    row, the first rank's the last rank's."""
    world = mesh.data_world
    if world == 1:
        return torch.roll(t, 1, 0)
    group = mesh.data_group
    host = dist.get_backend(group) == "gloo"
    last = t[-1:].detach().to("cpu" if host else t.device).contiguous()
    parts = [torch.empty_like(last) for _ in range(world)]
    dist.all_gather(parts, last, group=group)
    prev = parts[(mesh.data_rank - 1) % world].to(t.device)
    return torch.cat([prev, t[:-1]])


class GeneralClsModule(BasicModule):
    """ViT classification training (JAX ``GeneralClsModule``)."""

    metrics: Optional[Dict[str, torch.Tensor]] = None

    def get_model(self):
        refuse_encoder_layouts(self.cfg, "ViT")
        model_cfg = self.cfg.Model
        eng = self.cfg.get("Engine") or {}
        vcfg = ViTConfig.from_model_config(model_cfg)
        self.vit_config = ViTConfig(**{**vcfg.__dict__,
                                       "dtype": resolve_compute_dtype(eng)})
        self.mixup_alpha = float(model_cfg.get("mixup_alpha") or 0.0)
        self.label_smoothing = float(model_cfg.get("label_smoothing") or 0.0)
        return ViT(self.vit_config, device="meta")

    def init_params(self, seed: int, device) -> Dict[str, torch.Tensor]:
        return init_params(self.vit_config, seed=seed, device=device)

    def mixed(self, images: torch.Tensor, targets: torch.Tensor, lam: float,
              mesh) -> tuple:
        """Mixup at ``lam`` (JAX :102-103): ``lam·x + (1 − lam)·roll(x,
        1)`` of the images and of the targets, in fp32."""
        lam_t = torch.tensor(lam, dtype=torch.float32, device=images.device)
        return (lam_t * images + (1.0 - lam_t) * global_roll(images, mesh),
                lam_t * targets + (1.0 - lam_t) * global_roll(targets, mesh))

    def loss_fn(self, batch, generator: Optional[torch.Generator],
                train: bool) -> torch.Tensor:
        """The soft cross-entropy of the (mixed, when training) batch,
        this rank's share of the global micro-batch's mean."""
        mesh = mesh_from_config(self.cfg)
        images, labels = batch["images"].float(), batch["labels"].long()
        cfg = self.vit_config
        targets = F.one_hot(labels, cfg.num_classes).float()
        if train and self.mixup_alpha > 0.0:
            lam = draw_beta(generator, self.mixup_alpha)
            images, targets = self.mixed(images, targets, lam, mesh)
        rows = images.shape[0]
        shard = data_shard(mesh, rows, cfg.num_patches + 1)
        logits = self.nets(images, deterministic=not train,
                           generator=generator, shard=shard)
        total = rows * mesh.data_world
        loss = soft_ce_sum(logits, targets, self.label_smoothing) / total
        acc = (logits.argmax(-1) == labels).float().sum() / total
        self.metrics = {"acc": acc.detach()}
        return loss

    def model_flops_per_sample(self, n_params: int) -> float:
        """:func:`encoder_flops_per_sample` over the 1 + (H/p)·(W/p)
        tokens, the class token and the positional table left out of the
        dense parameters."""
        cfg = self.vit_config
        tables = sum(p.numel() for n, p in self.nets.named_parameters()
                     if n in _TABLES)
        return encoder_flops_per_sample(n_params - tables, cfg.num_layers,
                                        cfg.hidden_size,
                                        cfg.num_patches + 1)

    def training_step_end(self, log: Dict) -> None:
        log_images_per_sec(self.cfg, log)

    def validation_step_end(self, log: Dict) -> None:
        acc = log.get("acc")
        logger.eval(
            "[eval] epoch: %d, batch: %d, loss: %.9f, acc: %s, "
            "avg_eval_cost: %.5f sec", log["epoch"], log["batch"],
            log["loss"], ("%.5f" % acc) if acc is not None else "-",
            log["batch_cost"])
