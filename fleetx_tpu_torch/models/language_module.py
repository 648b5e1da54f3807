"""Language-model modules.

Port of the JAX package's ``LanguageModule`` and ``GPTModule``
(models/language_module.py:28-71, 187-306): the ``ips:`` and ``[eval]``
log lines and the GPT pretraining loss, through the logits or, under
``Model.fused_ce``, through the fused LM-head cross-entropy (B4–B6).

Under data and context parallelism (``Distributed.dp_degree`` and
``cp_degree``, the current mesh of ``parallel/mesh.py``) each rank takes
its dp share of the batch from the loader and, under cp, its two zig-zag
blocks of each sequence (:meth:`GPTModule.cp_prepare`); its loss is the
local ``sum(loss·mask)`` over the mask count of the whole global batch, so
that the trainer's sum of the ranks' gradients over the data group (dp ×
cp) is the gradient of JAX's ``masked_loss_mean`` over the global batch.
Under tensor parallelism (``mp_degree``) the ranks of one mp group read
the same rows and hold one model between them; their loss is the same
replicated value, through the vocab-parallel logits loss or B12 (under
sequence parallelism each holds its part of the sequence between the
layers, and the head sees the gathered whole). Under
pipeline parallelism (``pp_degree``) every stage reads the batch, which
streams through the stages as ``Engine.accumulate_steps`` microbatches
(:meth:`GPTModule.pipeline_loss`, JAX :197-203); the loss is JAX's
whole-batch masked mean, on the last stage. Under ``expert_mode``
(an MoE model, ``models/moe_module.py``) the experts split over the data
ranks (expert parallelism); MoE under mp, pp, cp or a sharding degree
raises ``NotImplementedError`` naming "Experts under mp, pp, cp or
ZeRO". Pretrained warm starts are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from fleetx_tpu_torch.models.gpt.convert import init_params
from fleetx_tpu_torch.models.gpt.model import (
    GPTConfig,
    GPTForPretraining,
    masked_loss_mean,
)
from fleetx_tpu_torch.models.module import BasicModule, data_shard
from fleetx_tpu_torch.ops.ce_loss import fit_vocab_block
from fleetx_tpu_torch.ops.dropout import Shard
from fleetx_tpu_torch.parallel.context_parallel import zigzag_slice
from fleetx_tpu_torch.parallel.mesh import get_data_world, mesh_from_config
from fleetx_tpu_torch.parallel.pipeline import Pipeline, stage_chunks
from fleetx_tpu_torch.parallel.tensor_parallel import (
    vocab_parallel_token_losses,
)
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
    cross-entropy (under mp its vocab-parallel form B12). As in JAX, a
    vocab (per mp shard) with no lane-aligned block demotes it to the
    logits path with a warning, and so does (per batch) a token count that
    8 does not divide; on the card either raises instead, so that the
    logits path is never taken there in silence."""

    fused_ce_blocked: Optional[str] = None  # why fused_ce was demoted
    # held by the first stage (the lookup) and the last (the LM head)
    tied_parameters = ("gpt.word_embeddings",)
    pipelined = True  # Distributed.pp_degree splits the model in stages
    pp_rank = 0  # this rank's pipeline stage
    ep_world = 1  # the data ranks an MoE model's experts split over
    _pipeline: Optional[Pipeline] = None

    def get_model(self):
        gcfg = GPTConfig.from_model_config(self.cfg.Model)
        eng = self.cfg.get("Engine") or {}
        dist_cfg = self.cfg.get("Distributed") or {}
        cp = dist_cfg.get("cp_degree") or 1
        mp = dist_cfg.get("mp_degree") or 1
        pp = (dist_cfg.get("pp_degree") or 1) if self.pipelined else 1
        fsdp = (dist_cfg.get("sharding") or {}).get("sharding_degree") or 1
        if gcfg.expert_mode and max(mp, pp, cp, fsdp) > 1:
            raise NotImplementedError(
                f"MoE at mp_degree {mp}, pp_degree {pp}, cp_degree {cp}, "
                f"sharding_degree {fsdp} is not ported yet (ROADMAP Queue "
                "A, \"Experts under mp, pp, cp or ZeRO\"); the experts "
                "split over dp")
        extra = {"dtype": resolve_compute_dtype(eng), "cp_degree": cp,
                 "mp_degree": mp, "pp_degree": pp}
        if pp > 1:
            # the pipeline streams the accumulation's microbatches (JAX
            # :197-203)
            extra["num_microbatches"] = max(eng.get("accumulate_steps")
                                            or 1, 1)
            self.pp_rank = mesh_from_config(self.cfg).pp_rank
        gcfg = GPTConfig(**{**gcfg.__dict__, **extra})
        if gcfg.expert_mode:
            # the experts split over the data ranks (JAX's "expert" axis
            # over ("dp", "fsdp"), parallel/sharding.py:71-74); MoEMLP
            # raises when they do not divide the experts
            self.ep_world = mesh_from_config(self.cfg).data_world
        if gcfg.fused_ce and (cp > 1 or pp > 1):
            # as the JAX module (:208-230): the fused kernel would gather
            # the sequence-split hidden states under cp, and pp runs the
            # loss outside its validated path; the logits path is taken
            logger.warning("Model.fused_ce disabled: cp_degree=%d/"
                           "pp_degree=%d (validated for 1/1); using the "
                           "logits path", cp, pp)
            gcfg = GPTConfig(**{**gcfg.__dict__, "fused_ce": False})
        if gcfg.fused_ce and fit_vocab_block(gcfg.vocab_size // mp) is None:
            self.fused_ce_blocked = (
                f"vocab {gcfg.vocab_size} / mp {mp} admits no lane-aligned "
                "block (128-multiple or 64)")
            logger.warning("Model.fused_ce disabled: %s; using the logits "
                           "path (a batch on the card raises)",
                           self.fused_ce_blocked)
            gcfg = GPTConfig(**{**gcfg.__dict__, "fused_ce": False})
        self.gpt_config = gcfg
        return GPTForPretraining(self.gpt_config, device="meta",
                                 pp_rank=self.pp_rank,
                                 ep_world=self.ep_world)

    def init_params(self, seed: int, device) -> Dict[str, torch.Tensor]:
        """This rank's weights: under mp and pp, its stage's part and its
        shards of the whole model's seeded draw; under expert parallelism
        its data rank's experts."""
        mesh = mesh_from_config(self.cfg)
        return init_params(self.gpt_config, seed=seed, device=device,
                           mp_rank=mesh.mp_rank, pp_rank=mesh.pp_rank,
                           ep_rank=mesh.data_rank if self.ep_world > 1
                           else 0, ep_world=self.ep_world)

    def cp_prepare(self, batch):
        """``(tokens, position_ids, labels, loss_mask)`` of this rank (JAX
        ``cp_prepare``, :254-277): the batch as it is without context
        parallelism; under cp, this rank's two zig-zag blocks of each
        sequence, with the true position ids (ring attention is the only
        position-sensitive op, and the masked losses do not depend on the
        order)."""
        tokens = batch["tokens"]
        position_ids = batch.get("position_ids")
        labels, loss_mask = batch.get("labels"), batch.get("loss_mask")
        cp = self.gpt_config.cp_degree
        if cp <= 1:
            return tokens, position_ids, labels, loss_mask
        if position_ids is None:
            position_ids = torch.arange(
                tokens.shape[1], device=tokens.device).expand_as(tokens)
        rank = mesh_from_config(self.cfg).cp_rank
        return tuple(None if x is None else zigzag_slice(x, cp, rank)
                     for x in (tokens, position_ids, labels, loss_mask))

    def loss_fn(self, batch, generator: Optional[torch.Generator],
                train: bool) -> torch.Tensor:
        """The masked mean token loss (JAX ``loss_fn``, :279-306): through
        the fused kernels when ``fused_ce`` is on and 8 divides the batch's
        token count, else through the logits (CPU batches only when
        ``fused_ce`` was asked for). Over several data ranks, this rank's
        ``sum(loss·mask)`` over the global batch's mask count (an
        all-reduce of the counts over the data group): the ranks' losses
        sum to the global masked mean. Under mp the logits are this rank's
        vocab shard and their loss is combined over the mp group."""
        mesh = mesh_from_config(self.cfg)
        tokens, position_ids, labels, loss_mask = self.cp_prepare(batch)
        kw = dict(deterministic=not train, generator=generator,
                  shard=data_shard(mesh, *tokens.shape))
        why = self.fused_ce_blocked
        if self.gpt_config.fused_ce:
            if labels.numel() % 8 == 0:
                token_loss = self.nets(tokens, position_ids, labels=labels,
                                       **kw)
                return self._masked_mean(token_loss, loss_mask, mesh)
            why = f"8 does not divide the batch's {labels.numel()} tokens"
        if why is not None and tokens.is_cuda:
            raise ValueError(f"Model.fused_ce cannot run: {why}; on the "
                             "card the logits path is not taken instead")
        logits = self.nets(tokens, position_ids, **kw)
        token_loss = vocab_parallel_token_losses(logits, labels,
                                                 mesh.mp_group)
        return self._masked_mean(token_loss, loss_mask, mesh)

    @property
    def pipeline(self) -> Pipeline:
        """This stage's schedule and transport (made on first use)."""
        if self._pipeline is None:
            self._pipeline = Pipeline(mesh_from_config(self.cfg),
                                      self.gpt_config.virtual_pp)
        return self._pipeline

    def pipeline_loss(self, batch, generator: Optional[torch.Generator],
                      train: bool) -> torch.Tensor:
        """One step of the pipeline on this stage (every stage calls it
        with the same batch): the batch's ``num_microbatches``
        microbatches through the schedule, forward and, when ``train``,
        backward, so the parameters' ``.grad`` hold the sum over the
        microbatches. Returns this rank's share of the loss on the last
        stage (0 elsewhere): JAX's ``masked_loss_mean`` over the whole
        batch (model.py:976-980), Σ over microbatches of Σ(loss·mask)
        divided by the whole batch's mask count (summed over the data
        group), not the mean of the microbatches' means.

        Every stage draws the whole model's dropout seeds for each
        microbatch in order, as one stage accumulating over the same
        microbatches would, and each layer takes its own."""
        mesh = mesh_from_config(self.cfg)
        gcfg = self.gpt_config
        tokens, position_ids = batch["tokens"], batch.get("position_ids")
        labels, loss_mask = batch.get("labels"), batch.get("loss_mask")
        n = gcfg.num_microbatches
        rows, seq = tokens.shape
        if rows % n:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{n} microbatches")
        mb = rows // n
        gpt = self.nets.gpt
        seeds = [gpt.dropout_seeds(not train, generator) for _ in range(n)]
        shard = None
        if mesh.data_world > 1:
            shard = Shard(b0=mesh.data_rank * mb,
                          batch=get_data_world(mesh) * mb, s0=0, seq=seq)
        kw = dict(deterministic=not train, shard=shard)
        count = None
        if mesh.is_last_stage:
            count = loss_mask.float().sum()
            if mesh.data_world > 1:
                dist.all_reduce(count, group=mesh.data_group)
        layers = stage_chunks(gcfg.num_layers, gcfg.pp_degree,
                              gcfg.virtual_pp)  # by global chunk
        last = len(layers) - 1

        def stage(m: int, g: int, x: Optional[torch.Tensor]):
            part = slice(m * mb, (m + 1) * mb)
            embed_seed, layer_seeds = seeds[m]
            if g == 0:
                x = gpt.embed(tokens[part], None if position_ids is None
                              else position_ids[part], seed=embed_seed,
                              **kw)
            x = gpt.run_layers(x, layers[g], layer_seeds, **kw)
            if g < last:
                return x
            logits = self.nets.lm_head(gpt.final_norm(x))
            token_loss = vocab_parallel_token_losses(logits, labels[part],
                                                     mesh.mp_group)
            mask = loss_mask[part].float().reshape(token_loss.shape)
            return (token_loss * mask).sum() / count.clamp_min(1.0)

        # under sequence parallelism a stage hands on each mp rank's
        # [mb, s/mp, h] shard (JAX keeps act_seq on mp through the stages,
        # parallel/pipeline.py:236, 242)
        s_loc = seq // gcfg.mp_degree if gcfg.sp else seq
        return self.pipeline.run(n, stage, (mb, s_loc, gcfg.hidden_size),
                                 gcfg.dtype, tokens.device, train)

    @staticmethod
    def _masked_mean(token_loss, loss_mask, mesh) -> torch.Tensor:
        """:func:`masked_loss_mean` (JAX ``pretraining_loss``,
        model.py:983-991), with the mask count of every data rank's share
        of the global batch over several."""
        if mesh.data_world == 1:
            return masked_loss_mean(token_loss, loss_mask)
        mask = loss_mask.float().reshape(token_loss.shape)
        count = mask.sum()
        # each cp group's ranks hold disjoint tokens of the same rows, and
        # the dp groups disjoint rows: the sum over the data group is the
        # global count (the mp ranks hold the same tokens: not over them)
        dist.all_reduce(count, group=mesh.data_group)
        return (token_loss * mask).sum() / count.clamp_min(1.0)
