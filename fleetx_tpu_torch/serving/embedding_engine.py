"""KV-free embedding and classification engine for vision models.

Port of the JAX package's ``EmbeddingEngine`` (serving/embedding_engine.py:
40-106): a :class:`~fleetx_tpu_torch.serving.batch_engine.BatchingEngine`
whose batches are stacks of images through a ViT. Two modes, keyed on the
model config as the model itself keys them:

- ``num_classes == 0``, embedding: the pooled vector of each image, its
  float32 bits bit-cast to int32 tokens (lossless, :func:`decode_floats`
  inverts :func:`encode_floats`), so a vector rides the token channel and
  the router's migration and its byte-parity hold for it;
- ``num_classes > 0``, classification: one token, the argmax class.

A request is one channels-last ``[H, W, C]`` float32 image, flattened and
bit-cast to int32: exactly ``H·W·C`` elements (``_validate``), which also
makes a text prompt sent here fail loudly. Images need no padding; a
batch's rows are padded to a power of two with zero images, dropped.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from fleetx_tpu_torch.serving.batch_engine import BatchingEngine, _bucket
from fleetx_tpu_torch.serving.model_protocol import ModelCapabilities

__all__ = ["EmbeddingEngine", "decode_floats", "encode_floats"]


def encode_floats(arr) -> np.ndarray:
    """A float32 array flattened to its int32 bit pattern (the wire
    encoding; :func:`decode_floats` inverts it)."""
    return np.ascontiguousarray(
        np.asarray(arr, np.float32).reshape(-1)).view(np.int32)


def decode_floats(tokens) -> np.ndarray:
    """int32 wire tokens back to the flat float32 vector they encode."""
    return np.ascontiguousarray(
        np.asarray(tokens, np.int32).reshape(-1)).view(np.float32)


class EmbeddingEngine(BatchingEngine):
    """Dynamic-batching image embedding or classification over one ViT
    (module docstring)."""

    def __init__(self, model, params, *, family: str = "vit", **kw):
        cfg = model.cfg
        self.image_shape = (int(cfg.image_size), int(cfg.image_size),
                            int(cfg.in_channels))
        self.image_elems = int(np.prod(self.image_shape))
        self.classify = int(cfg.num_classes) > 0
        self.capabilities = ModelCapabilities(
            family=family, has_kv_cache=False, supports_spec=False,
            cache_layout="none", max_input=self.image_elems,
            emits="tokens" if self.classify else "floats")
        super().__init__(model, params, **kw)

    def request_rows(self, prompt: np.ndarray) -> int:
        """An image's rows of work: the ViT's tokens, its patches and the
        class token (197 at ViT-B/16's 224), not its wire length."""
        return int(self.model.cfg.num_patches) + 1

    def _validate(self, prompt: np.ndarray) -> None:
        if prompt.size != self.image_elems:
            raise ValueError(
                f"embedding request must be one {self.image_shape} "
                f"float32 image bit-cast to int32 ({self.image_elems} "
                f"elements, see serving.embedding_engine.encode_floats); "
                f"got {prompt.size}")

    def _run_batch(self, requests) -> List[List[int]]:
        images = np.zeros((_bucket(len(requests), self.slots),)
                          + self.image_shape, np.float32)
        for i, r in enumerate(requests):
            images[i] = decode_floats(r.prompt).reshape(self.image_shape)
        out = self.model(torch.from_numpy(images).to(self.device))
        n = len(requests)
        if self.classify:
            return [[int(c)] for c in out.argmax(-1)[:n].cpu().numpy()]
        vecs = out[:n].float().cpu().numpy()
        return [[int(t) for t in encode_floats(v)] for v in vecs]

    @property
    def submit_limit(self) -> int:
        """One past the exact image size (a smaller prompt fails in
        ``_validate`` with the shape)."""
        return self.image_elems + 1
