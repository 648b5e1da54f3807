"""Threaded data loader and the collate functions.

Copy of the JAX package's data/dataloader.py: batches are dicts of numpy
arrays (the trainer moves them to the device), stacked sample by sample
whatever their dtype (int64 labels, float32 images); ``num_workers``
threads prefetch ``__getitem__`` + collate and order is preserved.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np

__all__ = ["DataLoader", "default_collate_fn", "gpt_collate_fn"]


def default_collate_fn(samples):
    """Stack a list of samples into [batch, ...] arrays: a dict of them for
    dict samples, a tuple for tuple or list samples, else one array."""
    if isinstance(samples[0], dict):
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    if isinstance(samples[0], (tuple, list)):
        return tuple(np.stack([s[i] for s in samples])
                     for i in range(len(samples[0])))
    return np.stack(samples)


gpt_collate_fn = default_collate_fn  # GPT samples are already dicts


class DataLoader:
    """Iterates a dataset by sampler-provided index batches; with
    ``num_workers`` > 0, that many threads prefetch in order."""

    def __init__(self, dataset, batch_sampler,
                 collate_fn: Optional[Callable] = None, num_workers: int = 0,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch = max(prefetch, 1)

    def _load(self, indices):
        return self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers <= 0:
            for indices in self.batch_sampler:
                yield self._load(indices)
            return
        yield from self._threaded_iter()

    def _threaded_iter(self):
        work: "queue.Queue" = queue.Queue(
            maxsize=self.prefetch * self.num_workers)
        done: Dict[int, object] = {}
        done_cv = threading.Condition(threading.Lock())
        stop = object()

        def worker():
            while True:
                item = work.get()
                if item is stop:
                    return
                i, indices = item
                try:
                    batch = self._load(indices)
                except Exception as e:  # surfaced in the consumer
                    batch = e
                with done_cv:
                    done[i] = batch
                    done_cv.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        def feeder():
            for i, indices in enumerate(self.batch_sampler):
                work.put((i, indices))
            for _ in threads:
                work.put(stop)

        feed_thread = threading.Thread(target=feeder, daemon=True)
        feed_thread.start()
        for i in range(len(self.batch_sampler)):
            with done_cv:
                while i not in done:
                    done_cv.wait()
                batch = done.pop(i)
            if isinstance(batch, Exception):
                raise batch
            yield batch
        feed_thread.join()
        for t in threads:
            t.join()

    def __len__(self):
        return len(self.batch_sampler)
