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


def _plain_dl(h, w, labels, a, b, lse, dl_dtype=None):
    """The dl [n, V] the plain B5/B6 multiply, in fp32: rounded to
    ``dl_dtype`` (the operand dtype unless a planted fault names
    another)."""
    mm = ce._mm_dtype(h.dtype)
    hm = h.to(mm).float()
    out = torch.empty((h.shape[0], w.shape[0]), dtype=torch.float32)
    for lo, hi in ce._vocab_blocks(w.shape[0]):
        out[:, lo:hi] = ce._dl_block(hm, w[lo:hi].to(mm).float(), labels, a,
                                     b, lse, lo, hi).to(dl_dtype or mm).float()
    return out


def _flip_case(wrt, seed=5, n=32, e=64, v=256):
    """A stand-in for a bf16 B5 (``wrt="h"``) or B6 on the CPU: bf16
    operands, the plain version's output ``want`` and its dl (rounded to
    nearest), and the exact dl's other bf16 neighbour at every element
    (``other``, where that neighbour lies within one bf16 step of the
    exact dl: ``flippable``), with the element whose flip moves its output
    row the most."""
    rng = np.random.RandomState(seed)
    bf16 = torch.bfloat16
    h = torch.from_numpy(rng.randn(n, e).astype(np.float32)).to(bf16)
    w = torch.from_numpy((rng.randn(v, e) * 3 / np.sqrt(e)).astype(
        np.float32)).to(bf16)
    labels = torch.from_numpy(rng.randint(0, v, n).astype(np.int32))
    a = torch.from_numpy((rng.rand(n) + 0.5).astype(np.float32))
    b = -a
    _, lse = ce._fwd_plain(h, w, labels)
    args = (h, w, labels, a, b, lse)
    want = ce._grad_plain(*args, wrt=wrt)
    near = _plain_dl(*args).double()
    exact = ce._exact_dl(*args, 0, n)
    step = ce._bf16_step(near)
    other = torch.where(exact > near, near + step, near - step)
    flippable = ((other - exact).abs() <= ce._bf16_step(exact)) & (
        other.to(bf16).double() == other)
    rows = (w if wrt == "h" else h).double().abs().amax(1)
    move = (other - near).abs() * (rows[None, :] if wrt == "h"
                                   else rows[:, None])
    i, j = divmod(int(torch.where(flippable, move, 0.0).argmax()), v)
    return args, want, near, other, (i, j)


def _output(args, dl, wrt):
    """The output a kernel makes of ``dl``: its fp32 product with the other
    operand, rounded to bf16 once."""
    h, w = args[:2]
    prod = dl.float() @ w.float() if wrt == "h" else dl.float().t() @ h.float()
    return prod.to(torch.bfloat16)


@pytest.mark.parametrize("wrt", ["h", "w"])
def test_grads_check_accepts_a_one_step_dl_flip(wrt):
    """The flip-aware bf16 grads check (``grads_gaps``): an output whose dl
    took the exact dl's other bf16 neighbour at one element moves a whole
    row past CE_TOL's strict bound, and passes, since that dl is within
    one bf16 step of the exact dl and the output holds against the fp64
    product of it. CE_TOL itself is unchanged."""
    args, want, near, other, (i, j) = _flip_case(wrt)
    dl = near.clone()
    dl[i, j] = other[i, j]
    got = _output(args, dl, wrt)
    strict = ce.ce_gaps(got, want, torch.bfloat16, "grads")
    assert not strict["ok"] and strict["tol_ratio"] > 1.0
    gaps = ce.grads_gaps(got, want,
                         lambda: ce._dl_readings(*args, dl.float(), wrt))
    assert gaps["ok"], gaps
    assert gaps["beyond"] > 0 and gaps["accepted"] == gaps["beyond"]
    assert gaps["tol_ratio"] == strict["tol_ratio"]
    # the sound output (dl rounded to nearest) needs no readings at all
    sound = ce.grads_gaps(_output(args, near, wrt), want, None)
    assert sound["ok"] and sound["beyond"] == 0


@pytest.mark.parametrize("wrt", ["h", "w"])
@pytest.mark.parametrize("fault", ["product", "two steps", "dl in fp32",
                                   "one NaN", "all NaN"])
def test_grads_check_catches_planted_faults(wrt, fault):
    """What the flips do not explain still fails: a product fault (one row
    of the other operand scaled by 1.25 inside the product, from the right
    dl), a dl two bf16 steps off at the flipped element, dl kept in fp32
    (no bf16 value, the planted fault of the card's phase 12), and NaN
    written over one element or the whole output of the sound dl (as an
    unwritten tile or a race would leave it)."""
    args, want, near, other, (i, j) = _flip_case(wrt)
    dl = near.clone()
    if fault == "product":
        h, w = args[:2]
        if wrt == "h":
            w2 = w.float().clone()
            w2[j] *= 1.25
            got = (dl.float() @ w2).to(torch.bfloat16)
        else:
            h2 = h.float().clone()
            h2[i] *= 1.25
            got = (dl.float().t() @ h2).to(torch.bfloat16)
    elif fault == "two steps":
        dl[i, j] = near[i, j] + 2 * (other[i, j] - near[i, j])
        got = _output(args, dl, wrt)
    elif fault == "dl in fp32":
        dl = _plain_dl(*args, dl_dtype=torch.float32).double()
        got = ce._grad_plain(*args, wrt=wrt, dl_dtype=torch.float32)
    else:
        got = _output(args, dl, wrt)
        if fault == "one NaN":
            got[i if wrt == "h" else j, 0] = math.nan
        else:
            got.fill_(math.nan)
    gaps = ce.grads_gaps(got, want,
                         lambda: ce._dl_readings(*args, dl.float(), wrt))
    assert not gaps["ok"], gaps
    assert gaps["accepted"] < gaps["beyond"] or gaps["moved_share"] > 0.1


# B4's plan at the 1.3B head (V 50304), its mp 2 shard (25152) and the
# card tests' ragged vocab (1216): bf16 splits (one per 256-column tile of
# ce_stats_kernel) and the columns of the last tile
FWD_PLANS = {50304: (197, 128), 25152: (99, 64), 1216: (5, 192)}


@pytest.mark.parametrize("v", sorted(FWD_PLANS), ids=str)
def test_forward_plan_mirrors_the_kernel(v):
    """The bf16 B4's scratch: one vocab split per 256-column tile of the
    stats GEMM (``gemm::BN`` in csrc/ce_loss.cu), so ``partial`` [3,
    splits, n] holds each token's (max, Σ exp, label logit) per tile;
    19.4 MB at the 1.3B head's 8192 tokens."""
    import re
    from pathlib import Path

    splits, last = FWD_PLANS[v]
    src = (Path(ce.__file__).parent / "csrc" / "ce_loss.cu").read_text()
    assert int(re.search(r"constexpr int BN = (\d+);", src).group(1)) == \
        ce._VOCAB_TILE == 256
    assert ce._fwd_splits(8192, v, torch.bfloat16) == splits == -(-v // 256)
    assert v - (splits - 1) * ce._VOCAB_TILE == last
    if v == 50304:
        assert 3 * splits * 8192 * 4 == 19_365_888


def _tile_stats_then_combine(h, w, labels, tile=256):
    """B4 as the bf16 kernel computes it, in plain fp32: per 256-column
    tile of s = h·Wᵀ, each row's max m_t, l_t = Σ exp(s - m_t) and the
    label logit (columns past V left out); then, per token in tile order,
    m = max m_t, l = Σ l_t·exp(m_t - m), lse = m + log l, loss = lse -
    label logit."""
    s = h.float() @ w.float().t()
    col = torch.arange(w.shape[0])
    stats = []
    for lo in range(0, w.shape[0], tile):
        st = s[:, lo:lo + tile]
        m_t = st.amax(-1)
        stats.append((m_t, torch.exp(st - m_t[:, None]).sum(-1),
                      torch.where(labels.long()[:, None] == col[lo:lo + tile],
                                  st, 0.0).sum(-1)))
    m = torch.stack([m_t for m_t, _, _ in stats]).amax(0)
    l = sum(l_t * torch.exp(m_t - m) for m_t, l_t, _ in stats)
    lse = m + torch.log(l)
    return lse - sum(lab for _, _, lab in stats), lse


@pytest.mark.parametrize("n,e,v", [(64, 32, 384), (520, 64, 1216)],
                         ids=["one-block", "ragged-tiles"])
def test_tile_stats_then_combine_matches_plain_version_and_pallas(n, e, v):
    """The bf16 kernel's order of work (256-column tile statistics, then a
    combine over the tiles; 1216 columns leave a last tile of 192) in
    fp32 against the plain version's online log-sum-exp and JAX's
    ``fused_linear_ce`` forward (Pallas in interpret mode): fp32
    association only."""
    h, w, labels, _ = _case(n, e, v)
    ht, wt, lt = (torch.from_numpy(x) for x in (h, w, labels))
    loss, lse = _tile_stats_then_combine(ht, wt, lt)
    want_loss, want_lse = ce.fused_ce_fwd_ref(ht, wt, lt)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(loss.numpy(), want_loss.numpy(), rtol=1e-6,
                               atol=1e-6)
    jl = np.asarray(jce.fused_linear_ce(jnp.asarray(h), jnp.asarray(w),
                                        jnp.asarray(labels)))
    np.testing.assert_allclose(loss.numpy(), jl, rtol=1e-6, atol=1e-6)
    assert torch.equal(loss[[0, 3]], lse[[0, 3]])  # labels -1 and V + 5
