"""ERNIE fill-in-blank and scoring engine (encoder serving).

Port of the JAX package's ``ErnieScoringEngine`` (serving/ernie_engine.py:
40-107): a :class:`~fleetx_tpu_torch.serving.batch_engine.BatchingEngine`
over ``ErnieForPretraining``. Two request shapes ride one submit:

- fill-in-blank: a prompt holding mask tokens (``FLEETX_ERNIE_MASK_ID``,
  default 3): the output is the MLM argmax at each mask, in prompt order;
- scoring: a prompt with no mask: one token, the SOP argmax (0: the
  sentences in order, 1: swapped).

A batch is padded to a (rows, length) bucket, each a power of two (rows
capped at ``slots``, length at the 512 positions), with a fixed
``FLEETX_ERNIE_MAX_MASKS`` gathered positions per row. The prompts are
right-padded prefixes by construction, so each row's mask is its key
length: the forward takes them as ``kv_lens`` and runs the flash forward
B1 non-causally (JAX's engine passes the same prefixes as a dense mask to
its XLA path; the function is the same on every real row). Filler rows
have length 0 and are dropped.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from fleetx_tpu_torch.serving.batch_engine import BatchingEngine, _bucket
from fleetx_tpu_torch.serving.engine import _env_int
from fleetx_tpu_torch.serving.model_protocol import ModelCapabilities

__all__ = ["ErnieScoringEngine"]


class ErnieScoringEngine(BatchingEngine):
    """Dynamic-batching fill-in-blank and SOP scoring over one
    ``ErnieForPretraining`` (module docstring)."""

    def __init__(self, model, params, *, mask_token_id: Optional[int] = None,
                 max_masks: Optional[int] = None, **kw):
        self.capabilities = ModelCapabilities(
            family="ernie", has_kv_cache=False, supports_spec=False,
            cache_layout="none",
            max_input=int(model.cfg.max_position_embeddings))
        super().__init__(model, params, **kw)
        self.mask_token_id = (mask_token_id if mask_token_id is not None
                              else _env_int("FLEETX_ERNIE_MASK_ID", 3))
        self.max_masks = max(1, max_masks if max_masks is not None
                             else _env_int("FLEETX_ERNIE_MAX_MASKS", 8))

    def _validate(self, prompt: np.ndarray) -> None:
        if prompt.size > self.cache_len:
            raise ValueError(
                f"prompt of {prompt.size} tokens exceeds the ERNIE input "
                f"capacity ({self.cache_len})")
        n_masks = int((prompt == self.mask_token_id).sum())
        if n_masks > self.max_masks:
            raise ValueError(
                f"prompt holds {n_masks} mask tokens but the engine "
                f"gathers at most {self.max_masks} "
                "(FLEETX_ERNIE_MAX_MASKS)")

    def _run_batch(self, requests) -> List[List[int]]:
        b = _bucket(len(requests), self.slots)
        length = _bucket(max(r.prompt.size for r in requests),
                         self.cache_len)
        ids = np.full((b, length), self.model.cfg.pad_token_id, np.int64)
        lens = np.zeros(b, np.int32)
        # rows with fewer masks read position 0 in the rest (sliced off)
        positions = np.zeros((b, self.max_masks), np.int64)
        counts = []
        for i, r in enumerate(requests):
            ids[i, :r.prompt.size] = r.prompt
            lens[i] = r.prompt.size
            where = np.flatnonzero(r.prompt == self.mask_token_id)
            positions[i, :where.size] = where
            counts.append(int(where.size))
        dev = self.device
        mlm, sop = self.model(torch.from_numpy(ids).to(dev),
                              masked_positions=torch.from_numpy(
                                  positions).to(dev),
                              kv_lens=torch.from_numpy(lens).to(dev))
        mlm_ids = mlm.argmax(-1).cpu().numpy()
        sop_ids = sop.argmax(-1).cpu().numpy()
        return [[int(t) for t in mlm_ids[i, :n]] if n else [int(sop_ids[i])]
                for i, n in enumerate(counts)]
