"""The port's ERNIE against JAX's on the same weights (CPU, fp32).

``ErnieModel``, ``ErnieForPretraining`` and ``ErnieForSequenceClassification``
run the same seeded ids through both packages, under both mask forms: a
dense key mask (the exact positional meaning, with holes), and per-row key
lengths of a right-padded batch (``right_padded_inputs``; JAX's key-length
route as ``tests/test_ernie.py`` runs it on the CPU, the port's flash
forward's plain version). The rows are ragged: a full row, rows longer and
shorter than one 64-key tile and exactly one tile, a one-token row and a
filler row of length 0 (compared only for being finite and its attention
zeros; JAX's dense path gives such a row the mean of V). Tolerance: 2e-5
absolute and relative (``torch_encoder_cases.TOL``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fleetx_tpu.models.ernie.model import ErnieConfig as JaxErnieConfig
from fleetx_tpu.models.ernie.model import (
    ErnieForSequenceClassification as JaxErnieForSequenceClassification,
)
from fleetx_tpu.models.ernie.model import ErnieModel as JaxErnieModel
from fleetx_tpu.models.ernie.model import (
    ernie_pretraining_loss as jax_ernie_pretraining_loss,
)
from fleetx_tpu_torch.models.ernie.model import (
    ErnieForSequenceClassification,
    ernie_pretraining_loss,
)
from torch_encoder_cases import TOL, ernie_pair

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2,
           num_attention_heads=4, ffn_hidden_size=128,
           max_position_embeddings=128, type_vocab_size=2)
S = 80
LENS = [80, 65, 64, 17, 1, 0]  # > a tile, one past, exactly one, < one


@pytest.fixture(scope="module")
def pair():
    return ernie_pair(seed=3, **CFG)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    b = len(LENS)
    ids = rng.randint(4, CFG["vocab_size"], (b, S)).astype(np.int32)
    for i, n in enumerate(LENS):
        ids[i, n:] = 0  # right padding (pad_token_id 0)
    types = rng.randint(0, 2, (b, S)).astype(np.int32)
    positions = rng.randint(0, S, (b, 4)).astype(np.int32)
    return ids, types, positions


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


def _real(x):
    return x[[i for i, n in enumerate(LENS) if n]]


@pytest.mark.parametrize("form", ["dense", "kv_lens"])
def test_encoder_and_pooler_match_jax(pair, form):
    model, tree, port = pair
    ids, types, _ = _batch()
    jcfg = dataclasses.replace(model.cfg,
                               right_padded_inputs=form == "kv_lens")
    seq, pooled = JaxErnieModel(jcfg).apply(
        {"params": tree["params"]["ernie"]}, jnp.asarray(ids),
        jnp.asarray(types))
    port.ernie.cfg = dataclasses.replace(
        port.ernie.cfg, right_padded_inputs=form == "kv_lens")
    try:
        with torch.no_grad():
            pseq, ppooled = port.ernie(torch.from_numpy(ids).long(),
                                       torch.from_numpy(types).long())
    finally:
        port.ernie.cfg = dataclasses.replace(port.ernie.cfg,
                                             right_padded_inputs=False)
    valid = ids != 0
    _close(pseq[torch.from_numpy(valid)], np.asarray(seq)[valid])
    _close(_real(ppooled), _real(np.asarray(pooled)))
    assert torch.isfinite(pseq).all() and torch.isfinite(ppooled).all()


def test_dense_mask_with_holes_keeps_its_positional_meaning(pair):
    """A key mask that is not a prefix (holes mid-row) is held exactly,
    on the dense path."""
    model, tree, port = pair
    ids, types, positions = _batch(1)
    mask = (np.random.RandomState(5).rand(*ids.shape) > 0.3).astype(
        np.int32)
    mask[:, 0] = 1
    mlm, sop = model.apply(tree, jnp.asarray(ids), jnp.asarray(types),
                           attention_mask=jnp.asarray(mask),
                           masked_positions=jnp.asarray(positions))
    with torch.no_grad():
        pmlm, psop = port(torch.from_numpy(ids).long(),
                          torch.from_numpy(types).long(),
                          attention_mask=torch.from_numpy(mask),
                          masked_positions=torch.from_numpy(positions))
    _close(pmlm, mlm)
    _close(psop, sop)


def test_pretraining_heads_with_kv_lens_match_jax(pair):
    """The engine's form: explicit per-row key lengths (a 0-length filler
    row included) against JAX's dense prefix mask; the MLM and SOP logits
    of every real row agree, and one key fewer does not."""
    model, tree, port = pair
    ids, types, positions = _batch(2)
    lens = np.asarray(LENS, np.int32)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    positions = np.minimum(positions, np.maximum(lens - 1, 0)[:, None])
    mlm, sop = model.apply(tree, jnp.asarray(ids), jnp.asarray(types),
                           attention_mask=jnp.asarray(mask),
                           masked_positions=jnp.asarray(positions))
    args = (torch.from_numpy(ids).long(), torch.from_numpy(types).long())
    with torch.no_grad():
        pmlm, psop = port(*args, masked_positions=torch.from_numpy(
            positions), kv_lens=torch.from_numpy(lens))
        off, _ = port(*args, masked_positions=torch.from_numpy(positions),
                      kv_lens=torch.from_numpy(np.maximum(lens - 1, 0)))
    _close(_real(pmlm), _real(np.asarray(mlm)))
    _close(_real(psop), _real(np.asarray(sop)))
    assert torch.isfinite(pmlm).all() and torch.isfinite(psop).all()
    gap = np.abs(_real(off.numpy()) - _real(np.asarray(mlm))).max()
    assert gap > 1e-3, gap


def test_sequence_classification_matches_jax():
    model, tree, port = ernie_pair(
        seed=4, cls=lambda c: JaxErnieForSequenceClassification(
            c, num_classes=3),
        port_cls=lambda c, device: ErnieForSequenceClassification(
            c, 3, device=device), **CFG)
    ids, types, _ = _batch(3)
    want = model.apply(tree, jnp.asarray(ids), jnp.asarray(types))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(),
                   torch.from_numpy(types).long())
    assert got.shape == (len(LENS), 3) and got.dtype == torch.float32
    _close(_real(got), _real(np.asarray(want)))


def test_pretraining_loss_matches_jax():
    rng = np.random.RandomState(6)
    mlm = rng.normal(size=(3, 4, 11)).astype(np.float32)
    sop = rng.normal(size=(3, 2)).astype(np.float32)
    labels = rng.randint(0, 11, (3, 4)).astype(np.int32)
    weights = (rng.rand(3, 4) > 0.3).astype(np.float32)
    sop_labels = rng.randint(0, 2, (3,)).astype(np.int32)
    for with_sop in (True, False):
        want = jax_ernie_pretraining_loss(
            jnp.asarray(mlm), jnp.asarray(sop), jnp.asarray(labels),
            jnp.asarray(weights),
            jnp.asarray(sop_labels) if with_sop else None)
        got = ernie_pretraining_loss(
            torch.from_numpy(mlm), torch.from_numpy(sop),
            torch.from_numpy(labels), torch.from_numpy(weights),
            torch.from_numpy(sop_labels) if with_sop else None)
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g.item(), float(w_), rtol=1e-6,
                                       atol=1e-6)


def test_config_from_a_model_section():
    from fleetx_tpu_torch.models.ernie.model import ErnieConfig

    section = dict(module="ErnieModule", vocab_size=40000, hidden_size=768,
                   num_layers=12, num_attention_heads=12,
                   ffn_hidden_size=3072, right_padded_inputs=True,
                   binary_head=True, dtype="bfloat16", type_vocab_size=None)
    cfg = ErnieConfig.from_model_config(section)
    want = JaxErnieConfig.from_model_config(section)
    assert (cfg.head_dim, cfg.ffn_size, cfg.right_padded_inputs,
            cfg.type_vocab_size) == (want.head_dim, want.ffn_size,
                                     want.right_padded_inputs,
                                     want.type_vocab_size)
    assert cfg.dtype == torch.bfloat16


def test_training_forward_runs_and_matches_jax():
    """The training forward (``deterministic=False``): at dropout 0 it is
    JAX's train-mode forward (the right-padded rows as key lengths, the real
    rows compared); at dropout 0.1 it runs, finite, and its hash masks
    move the logits off the deterministic forward's."""
    model, tree, port = ernie_pair(seed=5, right_padded_inputs=True,
                                   hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0, **CFG)
    ids, types, positions = _batch(3)
    lens = np.asarray(LENS)
    positions = np.minimum(positions, np.maximum(lens - 1, 0)[:, None])
    mlm, sop = model.apply(tree, jnp.asarray(ids), jnp.asarray(types),
                           masked_positions=jnp.asarray(positions),
                           deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0)})
    args = (torch.from_numpy(ids).long(), torch.from_numpy(types).long())
    gen = torch.Generator().manual_seed(0)
    pmlm, psop = port(*args, masked_positions=torch.from_numpy(positions),
                      deterministic=False, generator=gen)
    _close(_real(pmlm), _real(np.asarray(mlm)))
    _close(_real(psop), _real(np.asarray(sop)))
    cfg = dataclasses.replace(port.cfg, hidden_dropout_prob=0.1,
                              attention_probs_dropout_prob=0.1)
    dropped = type(port)(cfg, device="meta")
    dropped.load_state_dict(port.state_dict(), assign=True)
    tmlm, _ = dropped(*args, masked_positions=torch.from_numpy(positions),
                      deterministic=False, generator=gen)
    assert torch.isfinite(tmlm).all()
    assert (_real(tmlm) - _real(pmlm)).abs().max() > 1e-3
