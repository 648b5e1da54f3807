"""Pretraining entry point of the port (the JAX package's tools/train.py
without the elastic supervisor):

    python -m fleetx_tpu_torch.tools.train \
        -c configs/nlp/gpt/pretrain_gpt_1.3B_single_card.yaml \
        -o Model.fused_ce=True -o Data.Train.dataset.input_dir=<prefix> \
        -o Data.Eval.dataset.input_dir=<prefix> -o Engine.max_steps=100

Runs on the GPU and raises without one. Under a launcher, each process
is one rank of ``Distributed.dp_degree`` × ``cp_degree`` × ``mp_degree``;
ranks that share a card talk over gloo, ranks with a card each over NCCL.
Context parallelism:

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
"""

from __future__ import annotations

from typing import List, Optional

from fleetx_tpu_torch.core.engine import Trainer
from fleetx_tpu_torch.data import build_dataloader
from fleetx_tpu_torch.models import build_module
from fleetx_tpu_torch.parallel.env import destroy_dist_env, init_dist_env
from fleetx_tpu_torch.utils.config import get_config, parse_args
from fleetx_tpu_torch.utils.log import advertise, logger


def main(argv: Optional[List[str]] = None) -> Trainer:
    """Join the launcher's process group (a single process: none), parse
    ``-c``/``-o``, build the module, the loaders (``Eval`` when
    ``Data.Eval`` and ``Engine.eval_freq`` are set) and the trainer, fit,
    and leave the group."""
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
        trainer.fit(train_loader, eval_loader)
        logger.info("training done at step %d", trainer.step)
    finally:
        destroy_dist_env()
    return trainer


if __name__ == "__main__":
    main()
