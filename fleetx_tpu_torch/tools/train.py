"""Pretraining entry point of the port (the JAX package's tools/train.py
without the elastic supervisor):

    python -m fleetx_tpu_torch.tools.train \
        -c configs/nlp/gpt/pretrain_gpt_1.3B_single_card.yaml \
        -o Model.fused_ce=True -o Data.Train.dataset.input_dir=<prefix> \
        -o Data.Eval.dataset.input_dir=<prefix> -o Engine.max_steps=100

Runs on the GPU and raises without one.
"""

from __future__ import annotations

from typing import List, Optional

from fleetx_tpu_torch.core.engine import Trainer
from fleetx_tpu_torch.data import build_dataloader
from fleetx_tpu_torch.models import build_module
from fleetx_tpu_torch.utils.config import get_config, parse_args
from fleetx_tpu_torch.utils.log import advertise, logger


def main(argv: Optional[List[str]] = None) -> Trainer:
    """Parse ``-c``/``-o``, build the module, the loaders (``Eval`` when
    ``Data.Eval`` and ``Engine.eval_freq`` are set) and the trainer, and
    fit."""
    args = parse_args(argv)
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
    return trainer


if __name__ == "__main__":
    main()
