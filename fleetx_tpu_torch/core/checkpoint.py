"""The on-disk checkpoint store of the port's ``Trainer``.

Stands in for the orbax ``CheckpointManager`` of the JAX package's
``Trainer`` (core/engine.py:1010-1030) in torch's own format:

    <output_dir>/checkpoints/<step>/meta.json
    <output_dir>/checkpoints/<step>/state-mp<r>.pt        (one per mp rank)
    <output_dir>/checkpoints/<step>/state-pp<p>-mp<r>.pt  (at pp > 1)

``meta.json`` is the trainer's ``_save_meta`` (epoch, consumed samples,
dropout implementation, mesh); each state file holds ``{"step",
"params", "optimizer", "generator"}`` of mp rank ``r`` (of pipeline stage
``p`` at pp > 1; a stage's parameters keep the whole model's names), its
tensors by parameter name. A step is written into ``<step>.tmp`` and becomes
``<step>`` by one ``os.replace`` after every file in it was fsynced, so
a torn write is never listed: :meth:`CheckpointStore.all_steps` lists
digit directories only. The newest ``max_to_keep`` steps are kept, as
JAX's manager keeps them (:1021). Every rank of a multi-process run sees
the same directory (one host, or a shared filesystem); the trainer orders
the ranks around :meth:`begin`, :meth:`write_state` and :meth:`commit`.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional

import torch

__all__ = ["CheckpointStore", "META_FILE", "state_file"]

META_FILE = "meta.json"


def state_file(mp_rank: int, pp_rank: Optional[int] = None) -> str:
    """The name of mp rank ``mp_rank``'s state file in a step directory;
    with ``pp_rank`` (a pipeline's, pp > 1), of that stage's."""
    stage = "" if pp_rank is None else f"pp{pp_rank}-"
    return f"state-{stage}mp{mp_rank}.pt"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _move_aside(src: str, hold: str, name: str) -> str:
    """Move ``src`` to ``hold/name`` (``name.1``, ``name.2``, ... when
    taken); the destination path."""
    os.makedirs(hold, exist_ok=True)
    dst = os.path.join(hold, name)
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = os.path.join(hold, f"{name}.{n}")
    shutil.move(src, dst)
    return dst


class CheckpointStore:
    """Step directories under ``root`` (``<output_dir>/checkpoints``)."""

    def __init__(self, root: str, max_to_keep: int = 3):
        self.root = os.path.abspath(root)
        self.max_to_keep = max_to_keep

    # --------------------------------------------------------------- reading
    def all_steps(self) -> List[int]:
        """The committed steps, oldest first ([] when ``root`` is absent)."""
        if not os.path.isdir(self.root):
            return []
        return sorted(int(n) for n in os.listdir(self.root) if n.isdigit())

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, str(step))

    def read_meta(self, step: int) -> dict:
        with open(os.path.join(self.step_dir(step), META_FILE)) as f:
            return json.load(f)

    def read_state(self, step: int, mp_rank: int,
                   pp_rank: Optional[int] = None) -> dict:
        """The state of ``step`` of mp rank ``mp_rank`` (of stage
        ``pp_rank`` at pp > 1), its tensors on the CPU (tensors and plain
        containers only: ``weights_only``)."""
        path = os.path.join(self.step_dir(step), state_file(mp_rank,
                                                            pp_rank))
        return torch.load(path, map_location="cpu", weights_only=True)

    # --------------------------------------------------------------- writing
    def _tmp(self, step: int) -> str:
        return os.path.join(self.root, f"{step}.tmp")

    def begin(self, step: int) -> None:
        """Start writing ``step``: an empty ``<step>.tmp`` (a stale one from
        an earlier crash is removed). One rank calls it."""
        tmp = self._tmp(step)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

    def write_state(self, step: int, mp_rank: int, state: Dict,
                    pp_rank: Optional[int] = None) -> int:
        """Write the ``state`` of mp rank ``mp_rank`` (of stage ``pp_rank``
        at pp > 1) into ``<step>.tmp`` and fsync it; the file's bytes."""
        path = os.path.join(self._tmp(step), state_file(mp_rank, pp_rank))
        with open(path, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
            return f.tell()

    def commit(self, step: int, meta: dict) -> None:
        """Write ``meta.json``, make ``<step>.tmp`` the step ``step`` with
        one rename and drop the steps older than the newest
        ``max_to_keep``. One rank calls it, after every rank's
        :meth:`write_state` returned."""
        tmp = self._tmp(step)
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        os.replace(tmp, self.step_dir(step))
        _fsync_dir(self.root)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.step_dir(old), ignore_errors=True)

    def abort(self, step: int) -> None:
        """Drop a partial write of ``step``."""
        shutil.rmtree(self._tmp(step), ignore_errors=True)

    # ----------------------------------------------------------------- moves
    def quarantine(self, step: int, hold: str) -> Optional[str]:
        """Move the directory of ``step`` to ``hold`` (``<output_dir>/
        quarantine``), so that it is never listed again; its new path, or
        None when there is none."""
        src = self.step_dir(step)
        if not os.path.isdir(src):
            return None
        return _move_aside(src, hold, str(step))

    def detach(self, step: int, hold: str) -> Optional[str]:
        """Move the directory of ``step`` aside to ``hold/<step>``
        (``<output_dir>/rewrite``) before it is rewritten; the backup's
        path, or None when there is none. A stale backup is replaced."""
        src = self.step_dir(step)
        if not os.path.isdir(src):
            return None
        dst = os.path.join(hold, str(step))
        if os.path.exists(dst):
            shutil.rmtree(dst)
        os.makedirs(hold, exist_ok=True)
        shutil.move(src, dst)
        return dst

    def reattach(self, backup: str, step: int) -> None:
        """Put a detached ``backup`` back as ``step``, dropping whatever
        partial replacement (committed or not) stands there."""
        dst = self.step_dir(step)
        if os.path.exists(dst):
            shutil.rmtree(dst)
        self.abort(step)
        shutil.move(backup, dst)
