"""Batch sampler with consumed-samples resume.

Copy of the JAX package's ``GPTBatchSampler`` (data/sampler.py:21-80): it
yields global-batch index lists, each process taking its contiguous slice
(``process_index``/``process_count``).
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

__all__ = ["GPTBatchSampler"]


class GPTBatchSampler:
    """Index lists of global batches in dataset order (shuffled per epoch
    when ``shuffle``), resuming after ``consumed_samples``."""

    def __init__(self, dataset_len: int, batch_size: int,
                 shuffle: bool = False, drop_last: bool = True,
                 consumed_samples: int = 0, seed: int = 1024,
                 process_index: int = 0, process_count: int = 1, **_):
        if batch_size % process_count != 0:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{process_count} processes")
        self.dataset_len = dataset_len
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.consumed_samples = consumed_samples
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _order(self) -> np.ndarray:
        order = np.arange(self.dataset_len)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        return order

    def __iter__(self) -> Iterator[List[int]]:
        order = self._order()
        start = self.consumed_samples % self.dataset_len
        per_proc = self.batch_size // self.process_count
        batch_start = start
        while batch_start + self.batch_size <= self.dataset_len:
            batch = order[batch_start:batch_start + self.batch_size]
            lo = self.process_index * per_proc
            yield batch[lo:lo + per_proc].tolist()
            batch_start += self.batch_size
        if not self.drop_last and batch_start < self.dataset_len:
            batch = order[batch_start:]
            per = max(len(batch) // self.process_count, 1)
            lo = min(self.process_index * per, len(batch))
            yield batch[lo:lo + per].tolist()

    def __len__(self) -> int:
        n = self.dataset_len - (self.consumed_samples % self.dataset_len)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size
