"""Leveled, colored logger with extra TRAIN/EVAL levels.

Copy of the JAX package's logger (reference ppfleetx/utils/log.py:33-151,
whose ``ips:`` keyword lines CI parses); process-0 gating reads the
``torch.distributed`` rank instead of a JAX process index.
"""

from __future__ import annotations

import functools
import logging
import os
import sys
import time

__all__ = ["logger", "get_timestamp", "advertise", "only_primary"]

TRAIN = 21
EVAL = 22
logging.addLevelName(TRAIN, "TRAIN")
logging.addLevelName(EVAL, "EVAL")

_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "TRAIN": "\033[35m",
    "EVAL": "\033[34m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
}
_RESET = "\033[0m"


class _Formatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if sys.stdout.isatty():
            color = _COLORS.get(record.levelname, "")
            if color:
                ts, _, rest = msg.partition(record.levelname)
                return f"{ts}{color}{record.levelname}{_RESET}{rest}"
        return msg


class _Logger(logging.Logger):
    def train(self, msg, *args, **kwargs):
        if self.isEnabledFor(TRAIN):
            self._log(TRAIN, msg, args, **kwargs)

    def eval(self, msg, *args, **kwargs):
        if self.isEnabledFor(EVAL):
            self._log(EVAL, msg, args, **kwargs)


logging.setLoggerClass(_Logger)
logger: _Logger = logging.getLogger("fleetx_tpu_torch")  # type: ignore[assignment]
logging.setLoggerClass(logging.Logger)

_handler = logging.StreamHandler(sys.stdout)
_handler.setFormatter(_Formatter("[%(asctime)s] [%(levelname)8s] %(message)s", "%Y-%m-%d %H:%M:%S"))
logger.addHandler(_handler)
logger.setLevel(os.environ.get("FLEETX_LOG_LEVEL", "INFO"))
logger.propagate = False


def _is_primary() -> bool:
    # Until a process group is up, every process counts as primary.
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return int(os.environ.get("FLEETX_PROCESS_ID", "0")) == 0


def only_primary(fn):
    """Decorator: run fn only on process 0 of a multi-process job."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _is_primary():
            return fn(*args, **kwargs)

    return wrapper


def get_timestamp() -> str:
    """Filesystem-safe timestamp string (reference log.py:181)."""
    return time.strftime("%Y%m%d_%H%M%S", time.localtime())


@only_primary
def advertise() -> None:
    """Startup banner (reference log.py:153)."""
    logger.info("=" * 64)
    logger.info("fleetx-tpu-torch — PyTorch/CUDA port for NVIDIA Hopper")
    logger.info("=" * 64)
