"""Megatron-style GPT pretraining dataset.

Copy of the JAX package's ``GPTDataset`` (data/gpt_dataset.py:31-205) with
its numpy index-map functions (the sample index from the numpy fallback of
data/native/__init__.py:89, not the C++ extension), reading the same files:

- ``{prefix}_ids.npy`` — all documents' token ids, one flat 1-D array;
- ``{prefix}_idx.npz`` — key ``lens``: per-document token counts;
- cached index maps ``{prefix}_{name}_indexmap_{ns}ns_{sl}sl_{doc,sample,
  shuffle}_idx.npy``, built once by process 0 (others wait for them).

Samples cross document boundaries; each is seq_len+1 tokens split into
(tokens, labels) with eos positions masked out of the loss.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence

import numpy as np

from fleetx_tpu_torch.utils.log import logger

__all__ = ["GPTDataset", "build_sample_idx"]


def _train_valid_test_split(split: Sequence[float], n_docs: int) -> List[int]:
    """Cumulative doc boundaries from a ratio triple."""
    splits = list(split) + [0.0] * (3 - len(split))
    total = sum(splits)
    if total <= 0:
        raise ValueError(f"split ratios must sum > 0, got {split}")
    bounds = [0]
    for s in splits:
        bounds.append(bounds[-1] + int(round(s / total * n_docs)))
    bounds[-1] = n_docs
    if bounds[-1] - bounds[-2] < 0:
        raise ValueError(f"bad split {split}")
    return bounds


def _build_doc_idx(documents, num_epochs, rng, separate_last_epoch):
    if not separate_last_epoch or num_epochs == 1:
        doc_idx = np.tile(documents, num_epochs).astype(np.int32)
        rng.shuffle(doc_idx)
        return doc_idx
    first = _build_doc_idx(documents, num_epochs - 1, rng, False)
    last = _build_doc_idx(documents, 1, rng, False)
    return np.concatenate((first, last))


def _build_shuffle_idx(num_samples, total_size, rng):
    """Shuffle the first num_samples densely, the tail separately (the
    Megatron separate-last-epoch trick)."""
    dtype = (np.int64 if total_size >= (np.iinfo(np.uint32).max - 1)
             else np.uint32)
    first = np.arange(num_samples, dtype=dtype)
    rng.shuffle(first)
    if num_samples == total_size:
        return first
    last = np.arange(num_samples, total_size, dtype=dtype)
    rng.shuffle(last)
    return np.concatenate((first, last))


def build_sample_idx(sizes, doc_idx, seq_length, num_epochs,
                     tokens_per_epoch) -> np.ndarray:
    """[num_samples+1, 2] int64 (doc_idx position, token offset) pairs:
    where each (seq_length+1)-token sample starts."""
    num_samples = (num_epochs * tokens_per_epoch - 1) // seq_length
    out = np.empty((num_samples + 1, 2), dtype=np.int64)
    di, off = 0, 0
    out[0] = (di, off)
    for s in range(1, num_samples + 1):
        remaining = seq_length + 1
        while remaining != 0:
            doc_len = sizes[doc_idx[di]] - off
            remaining -= doc_len
            if remaining <= 0:
                off += remaining + doc_len - 1
                remaining = 0
            else:
                di += 1
                off = 0
        out[s] = (di, off)
    return out


def _is_primary_process() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


class GPTDataset:
    """mode: 'Train' | 'Eval' | 'Test'."""

    def __init__(
        self,
        input_dir,
        split=(949, 50, 1),
        max_seq_len: int = 1024,
        mode: str = "Train",
        seed: int = 1024,
        num_samples: Optional[int] = None,
        eos_id: int = 50256,
        build_data_file: Optional[bool] = None,
        **_,
    ):
        if isinstance(input_dir, str):
            prefix = input_dir
        else:
            assert len(input_dir) == 1, "GPT supports one dataset prefix"
            prefix = input_dir[0]
        for suffix in ("_ids.npy", "_idx.npz"):
            if not os.path.isfile(prefix + suffix):
                raise FileNotFoundError(prefix + suffix)

        self.sample_ids = np.load(prefix + "_ids.npy", mmap_mode="r",
                                  allow_pickle=True)
        lens = np.load(prefix + "_idx.npz")["lens"].astype(np.int32)
        self.max_seq_len = max_seq_len
        self.mode = mode
        self.name = "gpt_" + mode
        self.eos_id = eos_id

        bounds = _train_valid_test_split(split, len(lens))
        index = {"Train": 0, "Eval": 1, "Test": 2}[mode]
        documents = np.arange(bounds[index], bounds[index + 1],
                              dtype=np.int32)
        if len(documents) == 0:
            raise ValueError(f"split {split} leaves no documents for mode "
                             f"{mode}")
        if num_samples is None:
            num_samples = max(1, int(lens[documents].sum())
                              // (max_seq_len + 1))
        if build_data_file is None:
            build_data_file = _is_primary_process()

        self.doc_idx, self.sample_idx, self.shuffle_idx = self._indices(
            prefix, documents, lens, num_samples, max_seq_len, seed,
            build_data_file)
        self.start_pos = np.concatenate(([0], np.cumsum(lens))).astype(
            np.int64)

    def _indices(self, prefix, documents, lens, num_samples, seq_len, seed,
                 build):
        tokens_per_epoch = int(lens[documents].sum())
        num_epochs = 1
        while num_epochs * tokens_per_epoch < (num_samples * seq_len + 1):
            num_epochs += 1
        base = f"{prefix}_{self.name}_indexmap_{num_samples}ns_{seq_len}sl"
        files = {k: f"{base}_{k}_idx.npy" for k in ("doc", "sample",
                                                     "shuffle")}

        if build and not all(os.path.isfile(f) for f in files.values()):
            rng = np.random.RandomState(seed)
            if num_epochs == 1:
                separate_last = False
            else:
                from_prev = ((num_epochs - 1) * tokens_per_epoch - 1) \
                    // seq_len
                last_count = num_samples - from_prev
                per_epoch = (tokens_per_epoch - 1) // seq_len
                separate_last = last_count < int(0.8 * per_epoch)
            t0 = time.time()
            doc_idx = _build_doc_idx(documents, num_epochs, rng,
                                     separate_last)
            sample_idx = build_sample_idx(lens, doc_idx, seq_len,
                                          num_epochs, tokens_per_epoch)
            n_shuffle = (((num_epochs - 1) * tokens_per_epoch - 1) // seq_len
                         if separate_last else sample_idx.shape[0] - 1)
            shuffle_idx = _build_shuffle_idx(n_shuffle,
                                             sample_idx.shape[0] - 1, rng)
            np.save(files["doc"], doc_idx, allow_pickle=True)
            np.save(files["sample"], sample_idx, allow_pickle=True)
            np.save(files["shuffle"], shuffle_idx, allow_pickle=True)
            logger.info("built %s index maps (%d samples) in %.2fs",
                        self.name, sample_idx.shape[0] - 1, time.time() - t0)
        else:
            deadline = time.time() + 300
            while not all(os.path.isfile(f) for f in files.values()):
                if time.time() > deadline:
                    raise TimeoutError(f"waiting for index maps {base}")
                time.sleep(1.0)
        return tuple(np.load(files[k], allow_pickle=True, mmap_mode="r")
                     for k in ("doc", "sample", "shuffle"))

    def _tokens_for(self, idx: int) -> np.ndarray:
        doc_f, off_f = self.sample_idx[idx]
        doc_l, off_l = self.sample_idx[idx + 1]
        if doc_f == doc_l:
            start = self.start_pos[self.doc_idx[doc_f]]
            return np.asarray(self.sample_ids[start + off_f:
                                              start + off_l + 1])
        parts = []
        start = self.start_pos[self.doc_idx[doc_f]]
        end = self.start_pos[self.doc_idx[doc_f] + 1]
        parts.append(self.sample_ids[start + off_f:end])
        for i in range(doc_f + 1, doc_l):
            d = self.doc_idx[i]
            parts.append(self.sample_ids[self.start_pos[d]:
                                         self.start_pos[d + 1]])
        last = self.start_pos[self.doc_idx[doc_l]]
        parts.append(self.sample_ids[last:last + off_l + 1])
        return np.concatenate(parts)

    def __getitem__(self, index):
        seq = self._tokens_for(int(self.shuffle_idx[index])).astype(np.int64)
        tokens, labels = seq[:-1], seq[1:]
        loss_mask = (tokens != self.eos_id).astype(np.float32)
        position_ids = np.arange(len(tokens), dtype=np.int64)
        if self.mode == "Test":
            return {"tokens": tokens, "position_ids": position_ids}
        return {"tokens": tokens, "position_ids": position_ids,
                "labels": labels, "loss_mask": loss_mask}

    def __len__(self):
        return self.sample_idx.shape[0] - 1
