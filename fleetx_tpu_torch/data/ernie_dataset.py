"""ERNIE masked-LM + SOP pretraining dataset.

Copy of the JAX package's ``ErnieDataset`` (data/ernie_dataset.py), the
samples bit for bit: over the ``{prefix}_ids.npy`` + ``{prefix}_idx.npz``
token format of ``GPTDataset``, each sample is ``[CLS] segA [SEP] segB
[SEP]`` with n-gram span masking (p(n) ∝ 1/n), the 80/10/10
mask/random/keep policy and sentence-order (SOP) pairs, padded to static
shapes: ``[max_seq_len]`` inputs and ``[max_predictions_per_seq]`` masked
slots with a weights vector. Sampling is deterministic per (seed, epoch,
index); the trainer calls ``set_epoch`` each epoch so masks are drawn
anew.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from fleetx_tpu_torch.utils.log import logger

__all__ = ["ErnieDataset", "max_predictions"]


def max_predictions(max_seq_len: int, masked_lm_prob: float = 0.15,
                    given: Optional[int] = None) -> int:
    """The masked slots a sample has: ``given``, else 1.5 × the expected
    masked count."""
    return given or max(1, int(masked_lm_prob * max_seq_len * 3 // 2))


class ErnieDataset:
    """Each sample: [CLS] segA [SEP] segB [SEP] with ngram masking.

    vocab layout follows the reference ERNIE tokenizers: ids for the special
    tokens are configurable; random-replacement draws uniformly from
    [special_tokens_ceiling, vocab_size).
    """

    def __init__(
        self,
        input_dir,
        max_seq_len: int = 512,
        mode: str = "Train",
        seed: int = 1234,
        num_samples: Optional[int] = None,
        masked_lm_prob: float = 0.15,
        max_predictions_per_seq: Optional[int] = None,
        max_ngram: int = 3,
        vocab_size: int = 40000,
        cls_id: int = 1,
        sep_id: int = 2,
        mask_id: int = 3,
        pad_id: int = 0,
        binary_head: bool = True,
        split=None,  # accepted for config parity; doc split not needed
        **_unused,
    ):
        if isinstance(input_dir, (list, tuple)):
            assert len(input_dir) == 1, "ERNIE supports one dataset prefix"
            input_dir = input_dir[0]
        prefix = input_dir
        for suffix in ("_ids.npy", "_idx.npz"):
            if not os.path.isfile(prefix + suffix):
                raise FileNotFoundError(prefix + suffix)
        self.ids = np.load(prefix + "_ids.npy", mmap_mode="r", allow_pickle=True)
        lens = np.load(prefix + "_idx.npz")["lens"].astype(np.int64)
        self.start = np.concatenate([[0], np.cumsum(lens)])
        self.lens = lens
        self.mode = mode
        self.epoch = 0
        self.seed = seed + {"Train": 0, "Eval": 1, "Test": 2}.get(mode, 0)
        self.max_seq_len = max_seq_len
        self.masked_lm_prob = masked_lm_prob
        self.max_predictions = max_predictions(
            max_seq_len, masked_lm_prob, max_predictions_per_seq)
        self.max_ngram = max_ngram
        self.vocab_size = vocab_size
        self.cls_id, self.sep_id = cls_id, sep_id
        self.mask_id, self.pad_id = mask_id, pad_id
        self.binary_head = binary_head
        # usable docs: long enough to split into two non-empty segments
        self.docs = np.nonzero(lens >= 4)[0]
        if len(self.docs) == 0:
            raise ValueError("no document long enough for ERNIE pairs")
        self._num_samples = num_samples or len(self.docs)
        logger.info(
            "ErnieDataset[%s]: %d docs, %d samples, seq %d, %d preds/seq",
            mode, len(self.docs), self._num_samples, max_seq_len, self.max_predictions,
        )

    def __len__(self):
        return self._num_samples

    def set_epoch(self, epoch: int) -> None:
        """Re-mask per epoch: the engine calls this each epoch so every pass
        draws fresh crops/swaps/masks (reference pipeline re-masks per epoch)."""
        self.epoch = epoch

    def _doc_tokens(self, doc: int) -> np.ndarray:
        return np.asarray(self.ids[self.start[doc] : self.start[doc + 1]])

    def __getitem__(self, index):
        epoch = getattr(self, "epoch", 0)
        rng = np.random.RandomState(
            (self.seed * 2654435761 + epoch * 97003 + index) % (2**31)
        )
        doc = self.docs[index % len(self.docs)]
        tokens = self._doc_tokens(int(doc)).astype(np.int64)

        # two consecutive segments; budget leaves room for [CLS] + 2x[SEP]
        budget = self.max_seq_len - 3
        if len(tokens) > budget:
            off = rng.randint(0, len(tokens) - budget + 1)
            tokens = tokens[off : off + budget]
        cut = len(tokens) // 2
        a, b = tokens[:cut], tokens[cut:]
        sop_label = 1
        if self.binary_head and rng.rand() < 0.5:
            a, b = b, a
            sop_label = 0

        ids = np.concatenate([[self.cls_id], a, [self.sep_id], b, [self.sep_id]])
        token_type = np.concatenate(
            [np.zeros(len(a) + 2, np.int64), np.ones(len(b) + 1, np.int64)]
        )
        n = len(ids)

        # ngram span masking over non-special positions
        maskable = np.nonzero(
            (ids != self.cls_id) & (ids != self.sep_id)
        )[0]
        rng.shuffle(maskable)
        target = max(1, min(self.max_predictions, int(round(n * self.masked_lm_prob))))
        # favour short ngrams: p(n) ∝ 1/n (reference dataset_utils ngram policy)
        ngram_p = np.array([1.0 / g for g in range(1, self.max_ngram + 1)])
        ngram_p /= ngram_p.sum()

        covered = np.zeros(n, bool)
        positions = []
        for start_pos in maskable:
            if len(positions) >= target:
                break
            g = rng.choice(np.arange(1, self.max_ngram + 1), p=ngram_p)
            span = range(start_pos, min(start_pos + g, n))
            if any(covered[list(span)]) or any(
                ids[p] in (self.cls_id, self.sep_id) for p in span
            ):
                continue
            for p in span:
                if len(positions) >= target:
                    break
                covered[p] = True
                positions.append(p)
        positions = np.sort(np.array(positions[: self.max_predictions], np.int64))

        masked_ids = ids.copy()
        labels = ids[positions].copy()
        for i, p in enumerate(positions):
            r = rng.rand()
            if r < 0.8:
                masked_ids[p] = self.mask_id
            elif r < 0.9:
                masked_ids[p] = rng.randint(
                    max(self.mask_id, self.sep_id, self.cls_id, self.pad_id) + 1,
                    self.vocab_size,
                )
            # else keep original

        # pad everything to static shapes
        s, P = self.max_seq_len, self.max_predictions
        out_ids = np.full(s, self.pad_id, np.int64)
        out_ids[:n] = masked_ids
        out_type = np.zeros(s, np.int64)
        out_type[:n] = token_type
        mp_out = np.zeros(P, np.int64)
        ml_out = np.zeros(P, np.int64)
        mw_out = np.zeros(P, np.float32)
        k = len(positions)
        mp_out[:k] = positions
        ml_out[:k] = labels
        mw_out[:k] = 1.0
        return {
            "input_ids": out_ids,
            "token_type_ids": out_type,
            "masked_positions": mp_out,
            "masked_labels": ml_out,
            "masked_weights": mw_out,
            "sop_labels": np.int64(sop_label),
        }
