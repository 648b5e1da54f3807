"""The port's encoder datasets against the JAX package's, bit for bit.

``ErnieDataset`` (n-gram masking, the 80/10/10 replacement, SOP pairs,
the draws per (seed, epoch, index)) at 16 indices over 2 epochs, in
train and eval mode; ``GeneralClsDataset`` (random resized crop, flip,
normalisation and random erasing in train mode, the centre crop in eval
mode) over an ``.npz`` file and over the mmapped ``.npy`` pair;
``SyntheticClsDataset``; and the loaders' batches of both packages'
``build_dataloader`` (the default collate: int64 labels and float32
images stacked).
"""

import numpy as np
import pytest

from fleetx_tpu.data import build_dataloader as jax_build_dataloader
from fleetx_tpu.data.ernie_dataset import ErnieDataset as JaxErnieDataset
from fleetx_tpu.data.vision_dataset import (
    GeneralClsDataset as JaxGeneralClsDataset,
)
from fleetx_tpu.data.vision_dataset import (
    SyntheticClsDataset as JaxSyntheticClsDataset,
)
from fleetx_tpu.utils.config import get_config as jax_get_config
from fleetx_tpu_torch.data import build_dataloader, build_dataset
from fleetx_tpu_torch.data.ernie_dataset import ErnieDataset
from fleetx_tpu_torch.data.vision_dataset import (
    GeneralClsDataset,
    SyntheticClsDataset,
)
from fleetx_tpu_torch.utils.config import get_config
from torch_encoder_configs import ernie_yaml, vit_yaml, write_ernie_corpus


def _equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("mode", ["Train", "Eval"])
def test_ernie_samples_are_jax_samples(tmp_path, mode):
    prefix = str(tmp_path / "er")
    write_ernie_corpus(prefix, n_docs=30)
    # long documents too: the 64-token budget crops them at an offset
    write_ernie_corpus(str(tmp_path / "long"), seed=3, n_docs=10, vocab=90)
    kw = dict(max_seq_len=48, mode=mode, seed=11, vocab_size=128,
              max_predictions_per_seq=6, num_samples=64)
    for p in (prefix, str(tmp_path / "long")):
        ours, theirs = ErnieDataset(p, **kw), JaxErnieDataset(p, **kw)
        assert len(ours) == len(theirs)
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            for i in range(0, 64, 4):  # 16 indices
                _equal(ours[i], theirs[i])
    # unseen defaults: the slot count from the masking rate
    assert ErnieDataset(prefix, max_seq_len=64).max_predictions == \
        JaxErnieDataset(prefix, max_seq_len=64).max_predictions
    with pytest.raises(FileNotFoundError):
        ErnieDataset(str(tmp_path / "none"))


@pytest.mark.parametrize("layout", ["npz", "npy"])
@pytest.mark.parametrize("mode", ["Train", "Eval"])
def test_general_cls_samples_are_jax_samples(tmp_path, layout, mode):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 255, (6, 48, 40, 3)).astype(np.uint8)
    labels = rng.randint(0, 10, 6).astype(np.int64)
    prefix = tmp_path / mode.lower()
    if layout == "npz":
        np.savez(str(prefix) + ".npz", images=imgs, labels=labels)
    else:
        np.save(str(prefix) + "_images.npy", imgs)
        np.save(str(prefix) + "_labels.npy", labels)
    kw = dict(image_size=32, mode=mode, seed=5, random_erasing=0.5,
              num_samples=12)
    ours = GeneralClsDataset(str(tmp_path), **kw)
    theirs = JaxGeneralClsDataset(str(tmp_path), **kw)
    assert isinstance(ours.images, np.memmap) == (layout == "npy")
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(12):
            _equal(ours[i], theirs[i])


def test_synthetic_cls_samples_are_jax_samples():
    ours = SyntheticClsDataset(image_size=32, num_classes=10, num_samples=8)
    theirs = JaxSyntheticClsDataset(image_size=32, num_classes=10,
                                    num_samples=8)
    assert len(ours) == len(theirs) == 8
    for i in range(8):
        _equal(ours[i], theirs[i])
    built = build_dataset({"name": "SyntheticClsDataset", "image_size": 16},
                          mode="Eval", seed=3)
    _equal(built[2], JaxSyntheticClsDataset(image_size=16, seed=3)[2])


@pytest.mark.parametrize("family", ["ernie", "vit"])
def test_loader_batches_are_jax_batches(tmp_path, family):
    """Both packages' ``build_dataloader`` on one config: every batch of
    the first epoch equal, dtypes included (ERNIE's int64 ids and float32
    weights, ViT's float32 images and int64 labels)."""
    if family == "ernie":
        write_ernie_corpus(str(tmp_path / "er"))
        path = ernie_yaml(tmp_path / "c.yaml", str(tmp_path / "er"),
                          str(tmp_path / "out"))
    else:
        path = vit_yaml(tmp_path / "c.yaml", str(tmp_path / "out"))
    ours = build_dataloader(get_config(path, nranks=1), "Train")
    theirs = jax_build_dataloader(jax_get_config(path, nranks=1), "Train")
    assert len(ours) == len(theirs) > 2
    for got, want in zip(ours, theirs):
        _equal(got, want)
