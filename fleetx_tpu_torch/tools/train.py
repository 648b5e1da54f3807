"""Pretraining entry point of the port (the JAX package's tools/train.py:
``fit`` runs under the elastic supervisor ``run_elastic``):

    python -m fleetx_tpu_torch.tools.train \
        -c configs/nlp/gpt/pretrain_gpt_1.3B_single_card.yaml \
        -o Model.fused_ce=True -o Data.Train.dataset.input_dir=<prefix> \
        -o Data.Eval.dataset.input_dir=<prefix> -o Engine.max_steps=100

ERNIE masked-LM + SOP pretraining (``ErnieModule`` over ``ErnieDataset``
token-id files ``<prefix>_ids.npy`` and ``<prefix>_idx.npz``) and ViT
image classification (``GeneralClsModule``, here on
``SyntheticClsDataset``) run the same way:

    python -m fleetx_tpu_torch.tools.train \
        -c configs/nlp/ernie/pretrain_ernie_base_345M_single_card.yaml \
        -o Data.Train.dataset.input_dir=<prefix> -o Engine.max_steps=4
    python -m fleetx_tpu_torch.tools.train \
        -c configs/vis/vit/vit_base_patch16_224.yaml \
        -o Engine.max_steps=4 -o Engine.eval_freq=2

Runs on the GPU and raises without one. The run checkpoints into
``<Engine.save_load.output_dir>/checkpoints`` every
``Engine.save_load.save_steps`` steps and when it is sent SIGTERM (then
it exits 0). Relaunched with ``-o Engine.save_load.ckpt_dir=<output_dir>``
(as in the JAX tool, setting it asks for the resume, and the steps are
read from ``output_dir``), it restores the newest good step and feeds the
data from the first sample it had not consumed, so it continues as the
uninterrupted run would. Under a launcher, each process
is one rank of ``Distributed.pp_degree`` × ``dp_degree`` × ``cp_degree``
× ``mp_degree``; ranks that share a card talk over gloo, ranks with a
card each over NCCL. Context parallelism:

    python -m torch.distributed.run --nproc_per_node 2 \
        -m fleetx_tpu_torch.tools.train \
        -c configs/nlp/gpt/pretrain_gpt_1.3B_longcontext_cp8.yaml \
        -o Distributed.cp_degree=2 -o Data.Train.dataset.max_seq_len=16384 \
        -o Global.local_batch_size=1 -o Data.Train.dataset.input_dir=<prefix>

Tensor parallelism (heads, MLP and vocab split over 2 ranks; the loss
through the vocab-parallel fused cross-entropy):

    python -m torch.distributed.run --nproc_per_node 2 \
        -m fleetx_tpu_torch.tools.train \
        -c configs/nlp/gpt/pretrain_gpt_1.3B_single_card.yaml \
        -o Distributed.mp_degree=2 -o Model.fused_ce=True \
        -o Data.Train.dataset.input_dir=<prefix>

Pipeline parallelism (12 of the 24 layers on each of 2 stages; the batch
of 8 streams through them as ``local_batch_size / micro_batch_size`` = 4
microbatches of 2; add ``-o Model.virtual_pp_degree=2`` for two chunks of
6 layers per stage):

    python -m torch.distributed.run --nproc_per_node 2 \
        -m fleetx_tpu_torch.tools.train \
        -c configs/nlp/gpt/pretrain_gpt_1.3B_single_card.yaml \
        -o Distributed.pp_degree=2 -o Global.micro_batch_size=2 \
        -o Data.Train.dataset.input_dir=<prefix>

Sharded data parallelism (ZeRO stage 2 over 2 ranks: the gradients
reduce-scattered, AdamW and its state on half of every parameter, the
parameters all-gathered; 8 of the 32 layers of GPT-6.7B):

    python -m torch.distributed.run --nproc_per_node 2 \
        -m fleetx_tpu_torch.tools.train \
        -c configs/nlp/gpt/pretrain_gpt_6.7B_sharding16.yaml \
        -o Distributed.sharding.sharding_degree=2 -o Model.num_layers=8 \
        -o Model.fused_ce=True -o Data.Train.dataset.input_dir=<prefix>

With ``FLEETX_FAULT_HOST_LOSS_STEP=3`` in the environment the step path
raises a host loss before step 3: every rank checkpoints, the mesh gives
up half its data-parallel ranks (dp first, then fsdp), the ranks outside
the smaller world exit 0, and the others re-form the process group,
resume from the checkpoint (each taking its slices of the AdamW state)
and finish the run over the same global batches.
"""

from __future__ import annotations

from typing import List, Optional

from fleetx_tpu_torch.core.engine import Trainer
from fleetx_tpu_torch.data import build_dataloader
from fleetx_tpu_torch.models import build_module
from fleetx_tpu_torch.parallel.env import destroy_dist_env, init_dist_env
from fleetx_tpu_torch.resilience.elastic import run_elastic
from fleetx_tpu_torch.utils.config import get_config, parse_args
from fleetx_tpu_torch.utils.log import advertise, logger


def main(argv: Optional[List[str]] = None) -> Optional[Trainer]:
    """Join the launcher's process group (a single process: none), parse
    ``-c``/``-o``, build the module, the loaders (``Eval`` when
    ``Data.Eval`` and ``Engine.eval_freq`` are set) and the trainer,
    resume when ``Engine.save_load.ckpt_dir`` is set, fit under
    ``run_elastic``, and leave the group. Returns the trainer that
    finished (None on a rank that left the run in an elastic shrink)."""
    args = parse_args(argv)
    init_dist_env()
    try:
        cfg = get_config(args.config, overrides=args.override, show=True)
        advertise()
        module = build_module(cfg)
        train_loader = build_dataloader(cfg, "Train")
        eval_loader = None
        if cfg.Data and cfg.Data.get("Eval") and cfg.Engine.eval_freq:
            eval_loader = build_dataloader(cfg, "Eval")
        trainer = Trainer(cfg, module)
        if (cfg.Engine.save_load or {}).get("ckpt_dir"):
            # a first launch (no checkpoint yet) trains from scratch; if
            # checkpoints exist but none restores, load() raises
            # CheckpointUnrestorable
            trainer.init_state()
            trainer.load()
            train_loader.batch_sampler.consumed_samples = (
                trainer.consumed_samples)
        # the elastic supervisor seam: a HostLossFault mid-fit takes the
        # emergency checkpoint, shrinks the mesh and resumes through
        # reshard-on-load; with no fault plan active this is trainer.fit()
        trainer = run_elastic(
            cfg, trainer, train_loader, eval_loader,
            make_loader=lambda c, consumed: build_dataloader(c, "Train"))
        if trainer is not None:
            logger.info("training done at step %d", trainer.step)
    finally:
        destroy_dist_env()
    return trainer


if __name__ == "__main__":
    main()
