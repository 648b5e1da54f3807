"""The fused LM-head cross-entropy of the PyTorch port (``ops/ce_loss.py``)
against the Pallas kernels of ``fleetx_tpu/ops/pallas/ce_loss.py``.

The JAX side runs ``fused_linear_ce`` with no mesh, so its kernels run in
interpret mode on the CPU, as ``tests/test_ce_loss.py`` runs them; the port
runs the plain versions (CPU tensors) behind the same wrappers the card
launches from. Inputs come from numpy under a seed. Tolerances: fp32 is
summation order only (1e-5 relative on the loss, 1e-4 on dh and dW); bf16
products take the same rounded operands and round dl to bf16 before its
product on both sides, so the loss keeps the fp32 limit and dh, dW (bf16
outputs) differ by at most a few bf16 ulps (``BF16_GRAD_ULPS``).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fleetx_tpu.ops.pallas import ce_loss as jce
from fleetx_tpu_torch.ops import ce_loss as ce

BF16_GRAD_ULPS = 4  # dh, dW: |got - want| <= 4 ulps of max|want| + 2 ulps


def _case(n, e, v, seed=0):
    """h [n, E], W [V, E], labels [n] (with -1 and both vocab ends) and a
    0/1 loss mask [n], as numpy fp32/int32."""
    rng = np.random.RandomState(seed)
    h = rng.randn(n, e).astype(np.float32)
    w = (rng.randn(v, e) / np.sqrt(e) * 3).astype(np.float32)
    labels = rng.randint(0, v, n).astype(np.int32)
    labels[:4] = [-1, 0, v - 1, v + 5]
    mask = (rng.rand(n) > 0.3).astype(np.float32)
    return h, w, labels, mask


def _jax_loss_and_grads(h, w, labels, mask, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    hj, wj = jnp.asarray(h, jdt), jnp.asarray(w, jdt)
    lj, mj = jnp.asarray(labels), jnp.asarray(mask)

    def loss(h_, w_):
        tok = jce.fused_linear_ce(h_, w_, lj)
        return (tok * mj).sum() / mj.sum(), tok

    (value, tok), (dh, dw) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(hj, wj)
    return (float(value), np.asarray(tok),
            np.asarray(dh.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)))


def _torch_loss_and_grads(h, w, labels, mask, dtype):
    ht = torch.from_numpy(h).to(dtype).requires_grad_()
    wt = torch.from_numpy(w).to(dtype).requires_grad_()
    m = torch.from_numpy(mask)
    tok = ce.fused_linear_ce(ht, wt, torch.from_numpy(labels))
    value = (tok * m).sum() / m.sum()
    value.backward()
    assert ht.grad.dtype == dtype and wt.grad.dtype == dtype
    return (value.item(), tok.detach().numpy(), ht.grad.float().numpy(),
            wt.grad.float().numpy())


def test_block_fitting_matches_jax():
    for v in list(range(1, 2300)) + [1000, 25152, 50257, 50304, 130048]:
        assert ce.fit_vocab_block(v) == jce.fit_vocab_block(v), v
    for n in range(0, 2300):
        assert ce._fit_token_block(n) == jce._fit_token_block(n), n
    assert ce.fit_vocab_block(50304) == 384


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,e,v", [(64, 32, 384), (512, 128, 1152)],
                         ids=["one-block", "several-blocks"])
def test_fused_linear_ce_loss_and_grads_match_pallas(n, e, v, dtype):
    """Loss, per-token loss, dh and dW under a random loss mask; n 512
    spans two token blocks of 256 and V 1152 three vocab blocks of 384."""
    h, w, labels, mask = _case(n, e, v)
    want = _jax_loss_and_grads(h, w, labels, mask, dtype)
    got = _torch_loss_and_grads(h, w, labels, mask, dtype)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    for name, g, wg in zip(("dh", "dW"), got[2:], want[2:]):
        if dtype == torch.float32:
            np.testing.assert_allclose(g, wg, rtol=1e-4, atol=1e-6,
                                       err_msg=name)
        else:
            ulp = 2.0 ** -8
            atol = BF16_GRAD_ULPS * ulp * np.abs(wg).max()
            np.testing.assert_allclose(g, wg, rtol=2 * ulp, atol=atol,
                                       err_msg=name)
        assert np.abs(g).max() > 0


def test_unmatched_labels_give_the_lse():
    """-1 and out-of-range labels match no column: loss == lse there (and
    only there), as in the Pallas kernel."""
    h, w, labels, _ = _case(64, 32, 384)
    ht, wt = torch.from_numpy(h), torch.from_numpy(w)
    lt = torch.from_numpy(labels)
    loss, lse = ce.fused_ce_fwd(ht, wt, lt)
    assert loss.dtype == lse.dtype == torch.float32
    for i in (0, 3):  # labels -1 and V + 5
        assert loss[i].item() == lse[i].item()
    assert (loss[1:3] != lse[1:3]).all()
    np.testing.assert_allclose(
        lse.numpy(), torch.logsumexp(ht @ wt.t(), -1).numpy(), rtol=1e-6)
    jl = np.asarray(jce.fused_linear_ce(jnp.asarray(h), jnp.asarray(w),
                                        jnp.asarray(labels)))
    np.testing.assert_allclose(loss.numpy(), jl, rtol=1e-5, atol=1e-6)


def test_entry_raises_as_jax_does():
    h = torch.zeros(64, 32)
    with pytest.raises(ValueError, match="lane-aligned"):
        ce.fused_linear_ce(h, torch.zeros(1000, 32),
                           torch.zeros(64, dtype=torch.int32))
    with pytest.raises(ValueError, match="8 must divide"):
        ce.fused_linear_ce(torch.zeros(60, 32), torch.zeros(384, 32),
                           torch.zeros(60, dtype=torch.int32))
    with pytest.raises(ValueError):  # JAX raises for both too
        jce.fused_linear_ce(jnp.zeros((64, 32)), jnp.zeros((1000, 32)),
                            jnp.zeros(64, jnp.int32))


def test_wrappers_reject_what_they_do_not_take():
    h, w = torch.zeros(64, 32), torch.zeros(384, 32)
    lab = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="one dtype"):
        ce.fused_ce_fwd(h, w.to(torch.bfloat16), lab)
    with pytest.raises(ValueError, match="int32"):
        ce.fused_ce_fwd(h, w, lab.long())
    with pytest.raises(ValueError, match=r"\[n, E\]"):
        ce.fused_ce_fwd(h, torch.zeros(384, 16), lab)
    vec = torch.zeros(64)
    with pytest.raises(ValueError, match="fp32"):
        ce.fused_ce_dh(h, w, lab, vec.double(), vec, vec)


def test_wrappers_take_the_plain_versions_on_the_cpu_and_count_nothing():
    h, w, labels, _ = _case(64, 32, 384)
    args = (torch.from_numpy(h), torch.from_numpy(w),
            torch.from_numpy(labels))
    before = dict(ce.launches)
    loss, lse = ce.fused_ce_fwd(*args)
    g = torch.rand(64)
    dh = ce.fused_ce_dh(*args, g, -g, lse)
    dw = ce.fused_ce_dw(*args, g, -g, lse)
    assert ce.launches == before
    ref = ce.fused_ce_fwd_ref(*args)
    assert torch.equal(loss, ref[0]) and torch.equal(lse, ref[1])
    assert torch.equal(dh, ce.fused_ce_dh_ref(*args, g, -g, lse))
    assert torch.equal(dw, ce.fused_ce_dw_ref(*args, g, -g, lse))


def test_planted_fault_knobs_move_the_plain_version():
    """The knobs the card's checks plant faults through: the running sum
    left unscaled moves the lse; dl kept in fp32 moves bf16 gradients."""
    h, w, labels, _ = _case(64, 32, 1152)
    ht, wt = torch.from_numpy(h), torch.from_numpy(w)
    lt = torch.from_numpy(labels)
    _, lse = ce._fwd_plain(ht, wt, lt)
    _, bad = ce._fwd_plain(ht, wt, lt, rescale=False)
    assert (bad - lse).abs().max() > 1e-3
    hb, wb = ht.to(torch.bfloat16), wt.to(torch.bfloat16)
    g = torch.rand(64)
    args = (hb, wb, lt, g, -g, lse)
    good = ce._grad_plain(*args, wrt="h")
    fault = ce._grad_plain(*args, wrt="h", dl_dtype=torch.float32)
    assert not torch.equal(good, fault)


# (n, V, E, wrt): chunk, chunks, rows of the last chunk. GPT-1.3B's LM
# head (V 50304) and its mp-2 shard (V_loc 25152) at 8192 tokens, a small
# case that takes one chunk, and E 2048 with 2056 tokens / 2112 vocab rows
# that leaves a ragged last chunk of 8 / 64 rows
CHUNK_CASES = {
    "1.3B-dh": ((8192, 50304, 2048, "h"), 2048, 4, 2048),
    "1.3B-dW": ((8192, 50304, 2048, "w"), 2048, 25, 1152),
    "shard-dh": ((8192, 25152, 2048, "h"), 2048, 4, 2048),
    "shard-dW": ((8192, 25152, 2048, "w"), 2048, 13, 576),
    "small-dh": ((520, 1216, 128, "h"), 520, 1, 520),
    "small-dW": ((520, 1216, 128, "w"), 1216, 1, 1216),
    "ragged-dh": ((2056, 2112, 2048, "h"), 2048, 2, 8),
    "ragged-dW": ((2056, 2112, 2048, "w"), 2048, 2, 64),
}


@pytest.mark.parametrize("case", list(CHUNK_CASES), ids=list(CHUNK_CASES))
def test_chunk_plan(case):
    """The bf16 B5/B6 chunk planner: chunk rows (a multiple of the 128-row
    tile unless one chunk takes all rows), the ragged last chunk, the
    scratch's shape and bytes (one chunk of bf16 dl, rows as long as the
    other operand's rows, within 256 MB) and its 16-byte row stride, which
    the kernels' TMA loads need."""
    (n, v, e, wrt), chunk, count, last = CHUNK_CASES[case]
    rows, width = (n, v) if wrt == "h" else (v, n)
    assert ce._plan_chunk(n, v, e, wrt) == (chunk, width)
    assert -(-rows // chunk) == count
    assert rows - (count - 1) * chunk == last
    assert chunk * width * 2 <= ce._SCRATCH_BYTES == 256 * 2 ** 20
    assert (width * 2) % 16 == 0
    assert chunk % 128 == 0 or chunk == rows


def test_chunk_plan_at_the_1_3b_head_fills_the_card_and_bounds_the_scratch():
    """At E 2048 a chunk's second product is [2048, 2048]: 256 output
    tiles of 128x128 (about two per SM of 132); dh's scratch is 206 MB,
    dW's 33.5 MB; a vocab so wide that 2048 rows would pass 256 MB takes
    fewer rows per chunk."""
    chunk, width = ce._plan_chunk(8192, 50304, 2048, "h")
    assert (chunk // 128) * (2048 // 128) == 256
    assert chunk * width * 2 == 206_045_184
    assert math.prod(ce._plan_chunk(8192, 50304, 2048, "w")) * 2 == 33_554_432
    chunk, width = ce._plan_chunk(8192, 262144, 2048, "h")
    assert chunk == 512 and chunk * width * 2 <= ce._SCRATCH_BYTES


def test_chunk_plan_refuses_rows_off_16_bytes():
    with pytest.raises(ValueError, match="16-byte"):
        ce._plan_chunk(64, 1220, 64, "h")  # dh's scratch rows are V long
    with pytest.raises(ValueError, match="16-byte"):
        ce._plan_chunk(60, 384, 64, "w")  # dW's are n long
    with pytest.raises(ValueError, match="wrt"):
        ce._plan_chunk(64, 384, 64, "x")
    assert ce._plan_chunk(60, 384, 64, "h") == (60, 384)


def test_params_mirror_the_kernels_struct():
    """``_CEParams`` lists the fields of ``CEParams`` in csrc/ce_loss.cu
    in order (pointers, then ints), the scratch and its chunk among them;
    the wrapper's chunks are whole tiles of the kernels' gemm::BM rows."""
    import re
    from pathlib import Path

    src = (Path(ce.__file__).parent / "csrc" / "ce_loss.cu").read_text()
    body = re.search(r"struct CEParams \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*[\w\s\*]*?[\s\*](\w+);", body, re.M)
    assert fields == [name for name, _ in ce._CEParams._fields_]
    assert {"scratch", "chunk"} <= set(fields)
    bm = re.search(r"constexpr int BM = (\d+);", src).group(1)
    assert int(bm) == ce._TILE_ROWS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_backward_wrappers_keep_signatures_outputs_and_counts(dtype):
    """fused_ce_dh / fused_ce_dw keep their signatures (h, w, labels, a, b,
    lse); on CPU tensors they return the plain versions' dh [n, E] and dW
    [V, E] in the operands' dtype, allocate no scratch and count no
    launch."""
    import inspect

    for fn in (ce.fused_ce_dh, ce.fused_ce_dw):
        assert list(inspect.signature(fn).parameters) == [
            "h", "w", "labels", "a", "b", "lse"]
    h, w, labels, _ = _case(64, 32, 384, seed=3)
    args = (torch.from_numpy(h).to(dtype), torch.from_numpy(w).to(dtype),
            torch.from_numpy(labels))
    _, lse = ce.fused_ce_fwd(*args)
    g = torch.from_numpy(np.random.RandomState(3).rand(64).astype(
        np.float32))
    before = dict(ce.launches)
    dh = ce.fused_ce_dh(*args, g, -g, lse)
    dw = ce.fused_ce_dw(*args, g, -g, lse)
    assert ce.launches == before
    assert dh.dtype == dw.dtype == dtype
    assert dh.shape == (64, 32) and dw.shape == (384, 32)
    assert torch.equal(dh, ce.fused_ce_dh_ref(*args, g, -g, lse))
    assert torch.equal(dw, ce.fused_ce_dw_ref(*args, g, -g, lse))
    # only the bf16 kernels take a scratch (fp32 keeps the one-pass design)
    assert (ce._scratch(args[0], args[1], "h") is None) == (
        dtype == torch.float32)
