"""Pretraining entry point of the port (the JAX package's tools/train.py
without the elastic supervisor):

    python -m fleetx_tpu_torch.tools.train \
        -c configs/nlp/gpt/pretrain_gpt_345M_single_card.yaml \
        -o Data.Train.dataset.input_dir=<prefix> -o Engine.max_steps=100

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
    """Parse ``-c``/``-o``, build the module, loader and trainer, and fit."""
    args = parse_args(argv)
    cfg = get_config(args.config, overrides=args.override, show=True)
    advertise()
    if cfg.Engine.eval_freq:
        logger.warning("evaluation is not ported yet: Engine.eval_freq=%s "
                       "is ignored", cfg.Engine.eval_freq)
    module = build_module(cfg)
    train_loader = build_dataloader(cfg, "Train")
    trainer = Trainer(cfg, module)
    trainer.fit(train_loader)
    logger.info("training done at step %d", trainer.step)
    return trainer


if __name__ == "__main__":
    main()
