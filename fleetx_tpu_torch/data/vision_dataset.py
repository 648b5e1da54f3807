"""Image-classification datasets and their numpy transforms.

Copy of the JAX package's ``GeneralClsDataset`` and
``SyntheticClsDataset`` (data/vision_dataset.py:28-272, 370-388) and the
transforms they use, the samples bit for bit: train-time random resized
crop (nearest-neighbour resize), horizontal flip, ImageNet normalisation
and optional random erasing, eval-time centre crop; the draws of a train
sample come from a ``RandomState`` seeded per (seed, epoch, index).
Storage: ``{prefix}_images.npy`` [N, H, W, C] uint8 and
``{prefix}_labels.npy`` [N] opened with ``mmap_mode='r'``, or a small
``{prefix}.npz`` loaded whole. ``SyntheticClsDataset`` draws normal
images and uniform labels per index for benchmarks.
``ContrastiveViewsDataset`` (MoCo's views) is not ported yet (ROADMAP
Queue A, item 6c).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from fleetx_tpu_torch.utils.log import logger

__all__ = ["GeneralClsDataset", "SyntheticClsDataset"]

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _random_resized_crop(rng, img, out_size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = rng.uniform(*scale) * area
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if cw <= w and ch <= h:
            y = rng.randint(0, h - ch + 1)
            x = rng.randint(0, w - cw + 1)
            crop = img[y : y + ch, x : x + cw]
            return _resize(crop, out_size)
    return _center_crop(img, out_size)


def _resize(img, out_size):
    """Nearest-neighbour resize (no cv2/PIL dependency)."""
    h, w = img.shape[:2]
    ys = (np.arange(out_size) * h // out_size).clip(0, h - 1)
    xs = (np.arange(out_size) * w // out_size).clip(0, w - 1)
    return img[ys][:, xs]


def _center_crop(img, out_size):
    h, w = img.shape[:2]
    short = min(h, w)
    scaled = _resize(
        img[(h - short) // 2 : (h + short) // 2, (w - short) // 2 : (w + short) // 2],
        out_size,
    )
    return scaled


def _random_erasing(rng, img, p=0.5, sl=0.02, sh=0.4, r1=0.3, value=0.0,
                    attempts=100):
    """Zero (or fill) a random rectangle (reference RandomErasing,
    preprocess.py:350, 'const' mode). Mutates and returns ``img``."""
    if rng.rand() > p:
        return img
    h, w = img.shape[:2]
    area = h * w
    for _ in range(attempts):
        target = rng.uniform(sl, sh) * area
        ar = rng.uniform(r1, 1.0 / r1)
        eh = int(round(np.sqrt(target * ar)))
        ew = int(round(np.sqrt(target / ar)))
        if eh < h and ew < w:
            y = rng.randint(0, h - eh + 1)
            x = rng.randint(0, w - ew + 1)
            img[y : y + eh, x : x + ew] = value
            return img
    return img


class GeneralClsDataset:
    """Classification dataset over mmap .npz images with numpy augmentations
    (reference vision_dataset.py)."""
    def __init__(
        self,
        input_dir: str,
        image_size: int = 224,
        mode: str = "Train",
        seed: int = 1234,
        num_samples: Optional[int] = None,
        normalize: bool = True,
        random_erasing: float = 0.0,
        **_unused,
    ):
        prefix = input_dir
        if os.path.isdir(prefix):
            prefix = os.path.join(prefix, mode.lower())
        if os.path.isfile(prefix + "_images.npy"):
            # the scalable path: true mmap, O(1) resident memory
            self.images = np.load(prefix + "_images.npy", mmap_mode="r")
            self.labels = np.load(prefix + "_labels.npy", mmap_mode="r")
            path = prefix + "_images.npy"
        elif os.path.isfile(prefix + ".npz"):
            # .npz members cannot be mmapped — eager load, small sets only
            data = np.load(prefix + ".npz")
            self.images = data["images"]
            self.labels = data["labels"]
            path = prefix + ".npz"
            if self.images.nbytes > 1 << 30:
                logger.warning(
                    ".npz loads eagerly (%.1f GB in RAM); convert to the "
                    "_images.npy/_labels.npy pair for mmap", self.images.nbytes / 1e9,
                )
        else:
            raise FileNotFoundError(prefix + "_images.npy")
        self.image_size = image_size
        self.mode = mode
        self.seed = seed
        self.epoch = 0
        self.normalize = normalize
        self.random_erasing = random_erasing
        self._num_samples = num_samples or len(self.labels)
        logger.info(
            "GeneralClsDataset[%s]: %d images (%s), size %d",
            mode, self._num_samples, path, image_size,
        )

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        return self._num_samples

    def __getitem__(self, index):
        i = index % len(self.labels)
        img = np.asarray(self.images[i]).astype(np.float32) / 255.0
        if self.mode == "Train":
            rng = np.random.RandomState(
                (self.seed * 2654435761 + self.epoch * 97003 + index) % (2**31)
            )
            img = _random_resized_crop(rng, img, self.image_size)
            if rng.rand() < 0.5:
                img = img[:, ::-1]
        else:
            img = _center_crop(img, self.image_size)
        if self.normalize:
            img = (img - _IMAGENET_MEAN) / _IMAGENET_STD
        if self.mode == "Train" and self.random_erasing > 0:
            # post-normalize const erase (timm convention; reference
            # RandomErasing 'const' mode)
            img = _random_erasing(rng, np.ascontiguousarray(img),
                                  p=self.random_erasing)
        return {
            "images": np.ascontiguousarray(img, np.float32),
            "labels": np.int64(self.labels[i]),
        }


class SyntheticClsDataset:
    """Fake data for benchmarking (reference test_tipc fake-data path)."""

    def __init__(self, image_size=224, num_classes=1000, num_samples=1280,
                 mode="Train", seed=1234, **_unused):
        self.image_size = image_size
        self.num_classes = num_classes
        self._num_samples = num_samples
        self.seed = seed

    def __len__(self):
        return self._num_samples

    def __getitem__(self, index):
        rng = np.random.RandomState((self.seed + index) % (2**31))
        return {
            "images": rng.randn(self.image_size, self.image_size, 3).astype(np.float32),
            "labels": np.int64(rng.randint(0, self.num_classes)),
        }
