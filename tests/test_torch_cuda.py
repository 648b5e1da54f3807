"""The port's CUDA kernels on the card, held against their plain versions.

JAX-free on purpose: the machine with the card has PyTorch but no JAX, so
run this file there without the suite's conftest (which pins JAX to the
CPU):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Every test carries the ``cuda`` marker and skips when no card is present.
``paged_case`` also feeds the JAX parity tests of the plain version.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fleetx_tpu_torch.models.gpt import model as gpt_model
from fleetx_tpu_torch.ops import decode_attention as da
from fleetx_tpu_torch.tools.ce_backward_check import ce_case

GARBAGE = 3.0e4  # large FINITE values: the Pallas kernel zeroes p, not V


def split_windows(cap):
    """Windows that the kernels' split of a row's reach into 64-position
    pieces cuts every way (``cap`` positions, a multiple of 8 above 200):
    the whole reach (many splits), one position inside a split and a
    tile, one from inside a tile across a split border, from position 0
    over two splits and into a third, an empty window, and one whose end
    passes the reach (clamped to it)."""
    return [(0, cap), (70, 71), (60, 130), (0, 150), (5, 5),
            (cap - 10, cap + 50)]


def paged_case(page_size, *, b=4, h=2, d=16, n_logical=6, seed=0,
               windows=None):
    """Windows covering every edge: a full table, ``end=1``, an end on a
    page boundary with ``starts > 0``, and a random window; rows 0 and 3
    share their first two physical pages. ``windows`` [(start, end)]
    replaces them (one row each; ends past the reach are clamped to it).
    The trash page, every unallocated table entry and every slot outside
    a row's window hold garbage."""
    rng = np.random.RandomState(seed)
    cap = n_logical * page_size
    ends = np.array([cap, 1, 3 * page_size, rng.randint(2 * page_size, cap)],
                    np.int32)
    starts = np.array([0, 0, page_size + 3, 0], np.int32)
    if windows is not None:
        starts, ends = (np.array(x, np.int32) for x in zip(*windows))
        b = len(windows)
    num_pages = 1 + b * n_logical
    tables = np.zeros((b, n_logical), np.int32)
    for r in range(b):
        for j in range(starts[r] // page_size,
                       (min(ends[r], cap) - 1) // page_size + 1):
            tables[r, j] = 1 + r * n_logical + j
    tables[3, :2] = tables[0, :2]
    q = rng.randn(b, 1, h, d).astype(np.float32)
    k = rng.randn(num_pages, page_size, h, d).astype(np.float32)
    v = rng.randn(num_pages, page_size, h, d).astype(np.float32)
    live = np.zeros((num_pages, page_size), bool)
    for r in range(b):
        for p in range(starts[r], min(ends[r], cap)):
            live[tables[r, p // page_size], p % page_size] = True
    k[~live] = GARBAGE
    v[~live] = -GARBAGE
    return q, k, v, tables, starts, ends


def contiguous_case(cache_len, *, b=4, h=2, d=16, seed=0, scalar_end=None,
                    windows=None):
    """A contiguous cache ``[b, cache_len, h, d]`` with windows covering
    every edge: the full cache, ``end=1``, a window with ``starts > 0``
    ending on a tile border (8 and 256 both divide ``cache_len // 2`` when
    it is a multiple of 256), and a random one. ``scalar_end`` gives every
    row that one end (the one-shot ``generate()`` layout), with starts at
    or below it; ``windows`` [(start, end)] replaces them (one row each).
    Every slot outside a row's window holds garbage."""
    rng = np.random.RandomState(seed)
    if scalar_end is None:
        ends = np.array([cache_len, 1, 8 * (cache_len // 16),
                         rng.randint(2, cache_len)], np.int32)[:b]
    else:
        ends = np.full(b, scalar_end, np.int32)
    starts = np.minimum(np.array([0, 0, 3, rng.randint(0, 9)], np.int32)[:b],
                        ends - 1)
    if windows is not None:
        starts, ends = (np.array(x, np.int32) for x in zip(*windows))
        b = len(windows)
    q = rng.randn(b, 1, h, d).astype(np.float32)
    k = rng.randn(b, cache_len, h, d).astype(np.float32)
    v = rng.randn(b, cache_len, h, d).astype(np.float32)
    pos = np.arange(cache_len)
    dead = (pos[None] < starts[:, None]) | (pos[None] >= ends[:, None])
    k[dead] = GARBAGE
    v[dead] = -GARBAGE
    return q, k, v, starts, (scalar_end if scalar_end is not None else ends)


def quantize_np(x):
    """Per-vector absmax int8 of ``x`` [..., d] with fp32 scales [..., 1],
    as ``ops/quant.quantize_kv`` computes it (numpy rounds half to even
    too); garbage slots stay large and finite after dequantization."""
    x = np.asarray(x, np.float32)
    scale = np.abs(x).max(-1, keepdims=True) / np.float32(127.0)
    q = np.clip(np.round(x / np.maximum(scale, np.float32(1e-12))), -127, 127)
    return q.astype(np.int8), scale.astype(np.float32)


def _torch(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _launched(before):
    """Kernel launches since the snapshot ``before`` of ``da.launches``."""
    return {n: da.launches[n] - before[n] for n in da.NAMES
            if da.launches[n] != before[n]}


def _twice(fn, *args, **kw):
    """``fn``'s output, after a second launch on the same inputs has given
    the same bits (the kernels' sums run in one order)."""
    got = fn(*args, **kw)
    again = fn(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    return got


# the decode cases' windows: every edge of the first design's tests, or
# split_windows (1, 2 and many 64-position splits, a start inside a tile,
# an empty window, an end clamped at the reach; paged rows 0 and 3 share
# pages) over reaches of 320 (paged) and 296 / 512 (contiguous)
DECODE_WINDOWS = ["edges", "splits"]


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("windows", DECODE_WINDOWS)
def test_paged_decode_kernel_matches_plain_version(head_dim, dtype, windows):
    """B8: the decode template over pools in the operand dtype, held
    within DECODE_TOL as B7, B9 and B10 are, launched twice with equal
    bits."""
    _need_card()
    for page_size in (8, 16):
        n_logical = 6 if windows == "edges" else 320 // page_size
        q, k, v, tables, starts, ends = paged_case(
            page_size, d=head_dim, n_logical=n_logical,
            windows=None if windows == "edges" else split_windows(320))
        args = [_torch(x, dtype).cuda() for x in (q, k, v)]
        kw = dict(tables=_torch(tables).cuda(), end=_torch(ends).cuda(),
                  starts=_torch(starts).cuda())
        before = dict(da.launches)
        got = _twice(da.paged_decode_attention, *args, **kw)
        assert _launched(before) == {"paged_decode": 2}
        want = da.paged_decode_attention_ref(*args, **kw)
        assert got.abs().max() < 10  # no garbage leaked into the output
        gaps = da.decode_gaps(got, want)
        assert gaps["ok"], gaps


def _contiguous_layouts(windows):
    """(cache_len, scalar_end, windows) of the contiguous card cases."""
    if windows == "edges":
        return [(296, None, None), (512, None, None), (296, 201, None),
                (512, 300, None)]
    return [(n, None, split_windows(n)) for n in (296, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["B7", "B9"])
@pytest.mark.parametrize("windows", DECODE_WINDOWS)
def test_contiguous_decode_kernels_match_plain_versions(head_dim, dtype,
                                                        quant, windows):
    """B7 and B9 on caches whose ``fit_decode_blocks`` tile is 8 (296 =
    8 x 37) and 256 (512), with per-row and scalar ends, launched twice
    with equal bits."""
    _need_card()
    for cache_len, scalar_end, rows in _contiguous_layouts(windows):
        assert da.fit_decode_blocks(cache_len)[0] == (
            8 if cache_len == 296 else 256)
        q, k, v, starts, ends = contiguous_case(
            cache_len, d=head_dim, scalar_end=scalar_end, windows=rows)
        kw = dict(end=ends if scalar_end else _torch(ends).cuda(),
                  starts=_torch(starts).cuda())
        if quant:
            (k, ks), (v, vs) = quantize_np(k), quantize_np(v)
            kw.update(k_scale=_torch(ks).cuda(), v_scale=_torch(vs).cuda())
            k, v = _torch(k).cuda(), _torch(v).cuda()
        else:
            k, v = _torch(k, dtype).cuda(), _torch(v, dtype).cuda()
        q = _torch(q, dtype).cuda()
        before = dict(da.launches)
        got = _twice(da.decode_attention, q, k, v, **kw)
        assert _launched(before) == {"decode_q8" if quant else "decode": 2}
        want = da.decode_attention_ref(q, k, v, **kw)
        assert got.abs().max() < 10  # no garbage leaked into the output
        gaps = da.decode_gaps(got, want)
        assert gaps["ok"], gaps


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("windows", DECODE_WINDOWS)
def test_paged_q8_kernel_matches_plain_version(head_dim, dtype, windows):
    """B10: the paged kernel over int8 pools and their fp32 scale pools,
    launched twice with equal bits."""
    _need_card()
    for page_size in (8, 16):
        n_logical = 6 if windows == "edges" else 320 // page_size
        q, k, v, tables, starts, ends = paged_case(
            page_size, d=head_dim, n_logical=n_logical,
            windows=None if windows == "edges" else split_windows(320))
        (k, ks), (v, vs) = quantize_np(k), quantize_np(v)
        args = [_torch(q, dtype).cuda(), _torch(k).cuda(), _torch(v).cuda()]
        kw = dict(tables=_torch(tables).cuda(), end=_torch(ends).cuda(),
                  starts=_torch(starts).cuda(), k_scale=_torch(ks).cuda(),
                  v_scale=_torch(vs).cuda())
        before = dict(da.launches)
        got = _twice(da.paged_decode_attention, *args, **kw)
        assert _launched(before) == {"paged_decode_q8": 2}
        want = da.paged_decode_attention_ref(*args, **kw)
        gaps = da.decode_gaps(got, want)
        assert gaps["ok"], gaps


@pytest.mark.cuda
def test_decode_kernels_reject_what_they_do_not_take():
    """On the card a contract violation raises before any launch: a page
    wider than the kernels tile, a cache no 8-row tile divides, and int8
    K/V without scales."""
    _need_card()
    q, k, v, tables, _, ends = paged_case(8)
    wide = np.repeat(k, 64, axis=1)  # 512-position pages
    before = dict(da.launches)
    with pytest.raises(ValueError):
        da.paged_decode_attention(
            _torch(q).cuda(), _torch(wide).cuda(), _torch(wide).cuda(),
            tables=_torch(tables).cuda(), end=_torch(ends).cuda())
    q, k, v, starts, ends = contiguous_case(512)
    q, k, v = (_torch(x).cuda() for x in (q, k, v))
    with pytest.raises(ValueError):
        da.decode_attention(q, k[:, :500].contiguous(),
                            v[:, :500].contiguous(), end=_torch(ends).cuda())
    with pytest.raises(ValueError):
        da.decode_attention(q, k.to(torch.int8), v.to(torch.int8),
                            end=_torch(ends).cuda())
    assert _launched(before) == {}


@pytest.mark.cuda
def test_cuda_engine_decodes_through_the_kernel(monkeypatch):
    """A tiny fp32 engine on the card: every decode tick launches the
    kernel once per layer, and its greedy streams equal an engine whose
    decode attention is the plain version."""
    _need_card()
    from fleetx_tpu_torch.models.gpt.convert import init_params
    from fleetx_tpu_torch.models.gpt.generation import GenerationConfig
    from fleetx_tpu_torch.models.gpt.model import GPTConfig, GPTForPretraining
    from fleetx_tpu_torch.serving import ServingEngine

    cfg = GPTConfig(vocab_size=61, hidden_size=64, num_layers=2,
                    num_attention_heads=2, ffn_hidden_size=128,
                    max_position_embeddings=128, dtype=torch.float32)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 61, n) for n in (5, 17, 40)]

    def serve():
        params = init_params(cfg, seed=0)
        engine = ServingEngine(GPTForPretraining(cfg, device="meta"), params,
                               slots=2, cache_len=64, page_size=8,
                               gen_cfg=GenerationConfig(
                                   decode_strategy="greedy",
                                   eos_token_id=-1))
        for p in prompts:
            engine.submit(p, max_length=12)
        ticks = 0
        while engine.scheduler.queue_depth or engine.cache_manager.active_count:
            ticks += engine.step()["decoded"] > 0
        out = engine.drain()
        return [out[i].tokens.tolist() for i in range(len(prompts))], ticks

    before = dict(da.launches)
    got, ticks = serve()
    assert _launched(before) == {"paged_decode": ticks * cfg.num_layers}
    assert ticks > 0
    monkeypatch.setattr(gpt_model, "paged_decode_attention",
                        da.paged_decode_attention_ref)
    want, _ = serve()
    assert got == want


def _tiny_cuda_cfg(**kw):
    from fleetx_tpu_torch.models.gpt.model import GPTConfig

    return GPTConfig(vocab_size=61, hidden_size=64, num_layers=2,
                     num_attention_heads=2, ffn_hidden_size=128,
                     max_position_embeddings=128, dtype=torch.float32, **kw)


@pytest.mark.cuda
def test_cuda_int8_engine_decodes_through_b10(monkeypatch):
    """A tiny fp32 engine at ``kv_dtype="int8"`` on the card: every decode
    tick launches B10 once per layer (and never B8), its pools are int8
    with fp32 scale pools, and its greedy streams equal an engine whose
    decode attention is the plain version."""
    _need_card()
    from fleetx_tpu_torch.models.gpt.convert import init_params
    from fleetx_tpu_torch.models.gpt.generation import GenerationConfig
    from fleetx_tpu_torch.models.gpt.model import GPTForPretraining
    from fleetx_tpu_torch.serving import ServingEngine

    cfg = _tiny_cuda_cfg()
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 61, n) for n in (5, 17, 40)]

    def serve():
        engine = ServingEngine(GPTForPretraining(cfg, device="meta"),
                               init_params(cfg, seed=0), slots=2,
                               cache_len=64, page_size=8, kv_dtype="int8",
                               gen_cfg=GenerationConfig(
                                   decode_strategy="greedy",
                                   eos_token_id=-1))
        assert engine.cache_manager.cache["key"].dtype == torch.int8
        assert engine.cache_manager.cache["key_scale"].dtype == torch.float32
        for p in prompts:
            engine.submit(p, max_length=12)
        ticks = 0
        while engine.scheduler.queue_depth or engine.cache_manager.active_count:
            ticks += engine.step()["decoded"] > 0
        out = engine.drain()
        assert engine.cache_manager.pages_in_use == 0
        return [out[i].tokens.tolist() for i in range(len(prompts))], ticks

    before = dict(da.launches)
    got, ticks = serve()
    assert _launched(before) == {"paged_decode_q8": ticks * cfg.num_layers}
    assert ticks > 0
    monkeypatch.setattr(gpt_model, "paged_decode_attention",
                        da.paged_decode_attention_ref)
    want, _ = serve()
    assert got == want


# chip_smoke.LOGIT_TOL: logits of one position through two decode paths
SERVING_LOGIT_TOL = 5e-2


def _tiny_engine(cfg, **kw):
    from fleetx_tpu_torch.models.gpt.convert import init_params
    from fleetx_tpu_torch.models.gpt.generation import GenerationConfig
    from fleetx_tpu_torch.models.gpt.model import GPTForPretraining
    from fleetx_tpu_torch.serving import ServingEngine

    kw = dict(dict(slots=2, cache_len=64, page_size=8), **kw)
    return ServingEngine(GPTForPretraining(cfg, device="meta"),
                         init_params(cfg, seed=0),
                         gen_cfg=GenerationConfig(decode_strategy="greedy",
                                                  eos_token_id=-1), **kw)


def _serve_ticks(engine, prompts, max_length=12):
    for p in prompts:
        engine.submit(p, max_length=max_length)
    ticks = 0
    while engine.scheduler.queue_depth or engine.cache_manager.active_count:
        ticks += engine.step()["decoded"] > 0
    out = engine.drain()
    engine.cache_manager.check_invariants()
    assert engine.cache_manager.free_count == engine.slots
    return [out[i].tokens.tolist() for i in sorted(out)], ticks


@pytest.mark.cuda
def test_cuda_slot_engine_decodes_through_b7(monkeypatch):
    """A tiny fp32 slot engine (``paged=False``) on the card: every decode
    tick launches B7 once per layer and never B8, and its greedy streams
    equal an engine whose B7 is the plain version."""
    _need_card()
    cfg = _tiny_cuda_cfg()
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 61, n) for n in (5, 17, 40)]
    before = dict(da.launches)
    got, ticks = _serve_ticks(_tiny_engine(cfg, paged=False), prompts)
    assert _launched(before) == {"decode": ticks * cfg.num_layers}
    assert ticks > 0
    monkeypatch.setattr(gpt_model, "decode_attention",
                        da.decode_attention_ref)
    want, _ = _serve_ticks(_tiny_engine(cfg, paged=False), prompts)
    assert got == want


@pytest.mark.cuda
def test_cuda_spec_verify_logits_match_plain_ticks(monkeypatch):
    """A tiny fp32 paged engine drafting with itself (k 3): each position
    the dense verify scores lies within the serving logit tolerance of the
    logits the plain engine's B8 ticks gave the same token, the streams are
    equal, and the plain ticks launched B8 while the draft steps launched
    B7."""
    _need_card()
    cfg = _tiny_cuda_cfg()
    prompt = np.random.RandomState(3).randint(0, 61, 21)
    plain = _tiny_engine(cfg)
    rows = []
    sample = plain._sample

    def kept(reqs, logits):
        rows.append(logits[0].float().clone())
        return sample(reqs, logits)

    plain._sample = kept
    want, _ = _serve_ticks(plain, [prompt], max_length=16)
    monkeypatch.setenv("FLEETX_SERVING_SPEC_DRAFT", "self")
    spec = _tiny_engine(cfg, spec=True, spec_k=3)
    gaps = []
    accept = spec._accept

    def compared(logits, draft, dlen):
        out, emitted, accepted = accept(logits, draft, dlen)
        (slot, req), = spec._active.items()
        for j in range(int(emitted[slot])):
            ref = rows[len(req.tokens) + j]
            gaps.append((logits[slot, j] - ref).abs().max().item())
        return out, emitted, accepted

    spec._accept = compared
    single = []
    forward = spec.executor.forward

    def counted(cache, ids, *args, **kw):
        single.append(ids.shape[1] == 1)
        return forward(cache, ids, *args, **kw)

    spec.executor.forward = counted
    before = dict(da.launches)
    got, _ = _serve_ticks(spec, [prompt], max_length=16)
    assert got == want
    assert gaps and max(gaps) <= SERVING_LOGIT_TOL, max(gaps)
    want_launches = {"decode": spec._proposer.single_token_forwards,
                     "paged_decode": sum(single)}
    assert _launched(before) == {n: c * cfg.num_layers
                                 for n, c in want_launches.items() if c}
    assert want_launches["decode"] > 0


@pytest.mark.cuda
def test_cuda_chunked_paged_engine_matches_unchunked():
    """A tiny fp32 paged engine with ``prefill_chunk`` 8: the streams of
    the unchunked engine, B8 launched once per layer of each tick."""
    _need_card()
    cfg = _tiny_cuda_cfg()
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 61, n) for n in (5, 37, 21)]
    want, _ = _serve_ticks(_tiny_engine(cfg), prompts)
    before = dict(da.launches)
    engine = _tiny_engine(cfg, prefill_chunk=8)
    got, ticks = _serve_ticks(engine, prompts)
    assert got == want
    assert engine.metrics.prefill_chunks == 5 + 3
    assert _launched(before) == {"paged_decode": ticks * cfg.num_layers}


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8"], ids=["B7", "B9"])
def test_cuda_generate_launches_the_decode_kernel_per_layer_and_step(
        kv, monkeypatch):
    """One-shot ``generate()`` of a tiny fp32 model on the card: each
    decode step launches B7 (B9 at int8) once per layer, and the greedy
    tokens equal a run whose decode attention is the plain version."""
    _need_card()
    from fleetx_tpu_torch.models.gpt import generation as gen
    from fleetx_tpu_torch.models.gpt.convert import init_params
    from fleetx_tpu_torch.models.gpt.model import GPTForPretraining

    cfg = _tiny_cuda_cfg(use_flash_attention=True, decode_kv_dtype=kv)
    model = GPTForPretraining(cfg, device="meta")
    model.load_state_dict(init_params(cfg, seed=0), assign=True)
    rng = np.random.RandomState(2)
    ids = torch.tensor(rng.randint(0, 61, (3, 11)))
    mask = torch.ones(3, 11, dtype=torch.int32)
    mask[1, :4] = 0
    gcfg = gen.GenerationConfig(decode_strategy="greedy", max_length=9,
                                eos_token_id=-1)
    steps = []
    step = gen.decode_step
    monkeypatch.setattr(gen, "decode_step",
                        lambda *a, **k: steps.append(1) or step(*a, **k))
    before = dict(da.launches)
    got = gen.generate(model, ids, gcfg, attention_mask=mask)
    name = "decode" if kv is None else "decode_q8"
    assert _launched(before) == {name: (len(steps) - 1) * cfg.num_layers}
    assert len(steps) == 9  # the prefill and 8 decode steps
    monkeypatch.setattr(gpt_model, "decode_attention",
                        da.decode_attention_ref)
    want = gen.generate(model, ids, gcfg, attention_mask=mask)
    assert got.is_cuda and torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_decode_steps_take_the_kernel_or_raise():
    """On the card a model without ``use_flash_attention`` still decodes
    through B7 (its cache rounded up to the 8-row tile), and a key mask the
    kernel cannot read raises instead of taking the dense path."""
    _need_card()
    from fleetx_tpu_torch.models.gpt import generation as gen
    from fleetx_tpu_torch.models.gpt.convert import init_params
    from fleetx_tpu_torch.models.gpt.model import GPTForPretraining

    cfg = _tiny_cuda_cfg(use_flash_attention=False)
    model = GPTForPretraining(cfg, device="meta")
    model.load_state_dict(init_params(cfg, seed=0), assign=True)
    ids = torch.tensor(np.random.RandomState(3).randint(0, 61, (2, 7)))
    gcfg = gen.GenerationConfig(decode_strategy="greedy", max_length=6,
                                eos_token_id=-1)
    assert gen.right_size_decode_cache(model, 13) == 16
    before = dict(da.launches)
    gen.generate(model, ids, gcfg)
    assert _launched(before) == {"decode": 5 * cfg.num_layers}
    cache = gen.init_decode_cache(model, 2, cache_len=16)
    mask = torch.ones(2, 1, 1, 8, dtype=torch.bool, device="cuda")
    gen.decode_step(model, cache, ids.cuda(), torch.arange(7).cuda()[None])
    with pytest.raises(ValueError, match="key mask"):
        gen.decode_step(model, cache, ids[:, :1].cuda(),
                        torch.full((2, 1), 7).cuda(), mask)


def flash_case(d, *, b=2, s=192, h=3, seed=0, kv_lens=None, dtype=None):
    """q, k, v, dO [b, s, h, d] from a seed (q, k, v as strided views of
    one fused buffer, as the model's qkv projection hands them over), the
    forward's lse and delta; on the card."""
    rng = np.random.RandomState(seed)
    qkv = _torch(rng.randn(b, s, h, 3 * d).astype(np.float32), dtype).cuda()
    q, k, v = qkv.split(d, dim=-1)
    do = _torch(rng.randn(b, s, h, d).astype(np.float32), dtype).cuda()
    lens = None if kv_lens is None else torch.tensor(
        kv_lens, dtype=torch.int32, device="cuda")
    return q, k, v, do, lens


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal,kv_lens,rate", [
    (True, None, 0.0), (False, None, 0.0), (True, [0, 130], 0.1),
    (False, [64, 191], 0.1)], ids=["causal", "full", "causal-kvlens-drop",
                                    "full-kvlens-drop"])
def test_flash_kernels_match_plain_versions(head_dim, dtype, causal,
                                            kv_lens, rate):
    """B1, B2 and B3 each against its plain version on the same inputs; a
    zero kv_len row (fully masked) must come out as zeros."""
    from fleetx_tpu_torch.ops import flash_attention as fa

    _need_card()
    q, k, v, do, lens = flash_case(head_dim, kv_lens=kv_lens, dtype=dtype)
    kw = dict(causal=causal, kv_lens=lens, dropout_rate=rate,
              seed=-123456789)
    before = dict(fa.launches)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
    atol, rtol = fa.FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).reshape(
        -1, q.shape[1]).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    want_dq = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    want_dk, want_dv = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
        assert got.float().abs().mean() > 1e-3  # not trivially zero
    assert {n: fa.launches[n] - before[n] for n in fa.NAMES} == {
        n: 1 for n in fa.NAMES}
    if kv_lens is not None and kv_lens[0] == 0:
        assert not out[0].any() and not dk[0].any() and not dv[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("mp_rank", [0, 1])
def test_flash_kernels_on_a_heads_shard_match_plain_versions(head_dim, dtype,
                                                             mp_rank):
    """B1, B2 and B3 on mp rank ``mp_rank``'s 3 heads of 6 (strided views
    of a fused-qkv shard), causal at dropout 0.1 with the global-head meta
    (0, mp_rank·3, 3, 6, 0, 0), against their plain versions given the
    same meta; the identity meta draws other dropout bits."""
    from fleetx_tpu_torch.ops import flash_attention as fa

    _need_card()
    q, k, v, do, _ = flash_case(head_dim, dtype=dtype, seed=mp_rank)
    meta = (0, 3 * mp_rank, 3, 6, 0, 0)
    kw = dict(causal=True, dropout_rate=0.1, seed=-7, meta=meta)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).reshape(
        -1, q.shape[1]).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
    want_dq = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    want_dk, want_dv = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)
    atol, rtol = fa.FLASH_TOL[dtype]
    for got, want in ((out, want_out), (dq, want_dq), (dk, want_dk),
                      (dv, want_dv)):
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    own = fa.flash_fwd(q, k, v, **dict(kw, meta=None))[0]
    assert (own.float() - want_out.float()).abs().max() > 10 * atol


# (s, causal, kv_lens, meta) of the bf16 TMA + wgmma kernels' cases: s 192
# and 1088 leave a last 128-row block half past the end; kv_lens ending
# mid-tile (and 0: every row of a batch masked, every key past it); B11
# pairs with global offsets on, below and above the diagonal (above it,
# the early rows see no key at all, and the late keys no query); a heads
# shard of strided views (3 heads of 6 cut out of a wider fused buffer, mp
# rank 1's global-head meta)
WG_CASES = {
    "s192-causal": (192, True, None, None),
    "s1088-causal": (1088, True, None, None),
    "s1088-full-kvlens-midtile": (1088, False, [1000, 613], None),
    "s192-causal-kvlens-0": (192, True, [0, 150], None),
    "pair-diagonal": (256, True, None, (0, 0, 3, 3, 512, 512)),
    "pair-below-diagonal": (256, True, None, (1, 0, 3, 9, 640, 128)),
    "pair-above-diagonal": (320, True, None, (0, 3, 3, 6, 128, 224)),
    "heads-shard-view": (1088, True, None, (0, 3, 3, 6, 0, 0)),
}


def _rows(x, b, h):
    """[b, s, h, d] -> [b*h, s, d] (the lse rows' order)."""
    return x.transpose(1, 2).reshape(b * h, x.shape[1], -1)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("case", sorted(WG_CASES))
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_wgmma_kernels_match_plain_versions(kernel, head_dim, case, rate):
    """B1, B2 and B3 at bf16, d 64 and 128 (the TMA + wgmma kernels)
    against their plain versions within FLASH_TOL, each launched twice on
    the same inputs with the same bits both times (no atomics). The
    backward takes the forward kernel's lse and delta, as phase 6 feeds
    both sides. Rows that see no key come out as zeros with lse = -1e30
    (and zero dq); keys that no query sees, zero dk and dv."""
    from fleetx_tpu_torch.ops import flash_attention as fa

    _need_card()
    s, causal, kv_lens, meta = WG_CASES[case]
    bf16 = torch.bfloat16
    if case == "heads-shard-view":
        rng = np.random.RandomState(3)
        wide = _torch(rng.randn(2, s, 6, 3 * head_dim).astype(np.float32),
                      bf16).cuda()
        q, k, v = wide[:, :, 3:].split(head_dim, dim=-1)
        do = _torch(rng.randn(2, s, 3, head_dim).astype(np.float32),
                    bf16).cuda()
        lens = None
    else:
        q, k, v, do, lens = flash_case(head_dim, s=s, kv_lens=kv_lens,
                                       dtype=bf16, seed=s)
    b, _, h, _ = q.shape
    kw = dict(causal=causal, kv_lens=lens, dropout_rate=rate, seed=-99,
              meta=meta)
    atol, rtol = fa.FLASH_TOL[bf16]
    want_out, want_lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
    dead = want_lse <= -1e29  # rows that see no key
    if kv_lens is not None and kv_lens[0] == 0 or case == "pair-above-diagonal":
        assert dead.any()
    if kernel == "flash_fwd":
        run = lambda: fa.flash_fwd(q, k, v, **kw)  # noqa: E731
    else:
        out, lse = fa.flash_fwd(q, k, v, **kw)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).reshape(
            b * h, s).contiguous()
        args = (q, k, v, do, lse, delta)
        run = lambda: getattr(fa, kernel)(*args, **kw)  # noqa: E731
    before = dict(fa.launches)
    got, again = (x if isinstance(x, tuple) else (x,) for x in (run(), run()))
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in fa.NAMES} == {
        n: 2 * (n == kernel) for n in fa.NAMES}
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    if kernel == "flash_fwd":
        out, lse = got
        torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
        assert out.float().abs().mean() > 1e-3
        assert torch.equal(lse[dead], want_lse[dead])
        assert not _rows(out, b, h)[dead].any()
        return
    if kernel == "flash_bwd_dq":
        want = (fa.flash_bwd_dq_ref(*args, **kw),)
        assert not _rows(got[0], b, h)[dead].any()
    else:
        want = fa.flash_bwd_dkv_ref(*args, **kw)
        # keys that no query sees: past kv_len, or (causal) past the last
        # query's global position
        pos = torch.arange(s, device="cuda")
        lens_k = (torch.full((b,), s, device="cuda") if lens is None
                  else (lens.long() - (meta or (0,) * 6)[5]).clamp(0, s))
        unseen = pos[None, :] >= lens_k[:, None]  # [b, s]
        if causal:
            q_off, k_off = (meta or (0,) * 6)[4:]
            unseen = unseen | (pos[None, :] + k_off > s - 1 + q_off)
        if kv_lens is not None and kv_lens[0] == 0:
            assert unseen[0].all()
        for x in got:
            assert not x[unseen].any()
    for x, y in zip(got, want):
        torch.testing.assert_close(x.float(), y.float(), atol=atol,
                                   rtol=rtol)
        assert x.float().abs().mean() > 1e-3  # not trivially zero


@pytest.mark.cuda
def test_wgmma_kernels_refuse_views_off_16_bytes():
    """The TMA loads need a 16-byte aligned base and strides: a view two
    bytes off, or a fused buffer whose rows are not a multiple of 16 bytes,
    as any operand of B1, B2 or B3 (dO too), raises before any launch (no
    other kernel takes it instead)."""
    from fleetx_tpu_torch.ops import flash_attention as fa

    _need_card()
    b, s, h, d = 1, 128, 2, 64
    flat = torch.randn(b * s * h * d + 8, device="cuda").to(torch.bfloat16)
    off = flat[1:1 + b * s * h * d].view(b, s, h, d)
    ok = torch.randn(b, s, h, d, device="cuda").to(torch.bfloat16)
    ragged = torch.randn(b, s, h, 3 * d + 4, device="cuda").to(
        torch.bfloat16)[..., :d]
    lse = torch.zeros(b * h, s, device="cuda")
    before = dict(fa.launches)
    for q, k, v in ((off, ok, ok), (ok, ok, off), (ragged, ok, ok)):
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_fwd(q, k, v, causal=True)
    for bad in (off, ragged):
        for i in range(4):  # q, k, v, dO
            args = [ok, ok, ok, ok, lse, lse]
            args[i] = bad
            for fn in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
                with pytest.raises(ValueError, match="16-byte"):
                    fn(*args, causal=True)
    assert fa.launches == before


@pytest.mark.cuda
def test_flash_dropout_mask_on_the_card_equals_the_cpu_hash():
    """The int32 hash run by torch on the card gives the CPU's bits."""
    from fleetx_tpu_torch.ops.flash_attention import dropout_keep_scale

    _need_card()
    grid = (torch.arange(5, dtype=torch.int32)[:, None, None],
            torch.arange(0, 4096, 7, dtype=torch.int32)[None, :, None],
            torch.arange(0, 300, 3, dtype=torch.int32)[None, None, :])
    for seed in (0, -1, 2**31 - 1, -2**31, 12345):
        cpu = dropout_keep_scale(seed, *grid, 0.1)
        gpu = dropout_keep_scale(seed, *(t.cuda() for t in grid), 0.1)
        assert torch.equal(cpu, gpu.cpu())


@pytest.mark.cuda
def test_cuda_trainer_step_launches_each_flash_kernel_per_layer(tmp_path):
    """A tiny bf16 GPT trains two steps on the card through the real
    entry points; every layer launches B1, B2 and B3 once per step, the
    losses are finite and the weights move."""
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.ops import flash_attention as fa
    from fleetx_tpu_torch.utils.config import get_config

    _need_card()
    rng = np.random.RandomState(0)
    docs = [rng.randint(0, 120, size=rng.randint(50, 200)).astype(np.int32)
            for _ in range(50)]
    prefix = str(tmp_path / "tiny")
    np.save(prefix + "_ids.npy", np.concatenate(docs))
    np.savez(prefix + "_idx.npz", lens=np.array([len(d) for d in docs],
                                                np.int32))
    root = __file__.rsplit("/tests/", 1)[0]
    cfg = get_config(f"{root}/configs/tiny/pretrain_gpt_tiny_cpu.yaml",
                     overrides=[f"Data.Train.dataset.input_dir={prefix}",
                                "Model.use_flash_attention=True",
                                "Engine.mix_precision.use_pure_fp16=True",
                                "Engine.max_steps=2",
                                "Optimizer.lr.warmup_steps=0"], nranks=1)
    module = build_module(cfg)
    trainer = Trainer(cfg, module)
    assert trainer.device.type == "cuda"
    trainer.init_state()
    before = {n: p.detach().clone()
              for n, p in module.nets.named_parameters()}
    for name in fa.NAMES:
        fa.launches[name] = 0
    trainer.fit(build_dataloader(cfg, "Train"))
    layers = module.gpt_config.num_layers
    assert module.gpt_config.dtype == torch.bfloat16
    assert fa.launches == {n: 2 * layers for n in fa.NAMES}
    assert all(np.isfinite(float(h["loss"])) for h in trainer.history)
    moved = [n for n, p in module.nets.named_parameters()
             if not torch.equal(p, before[n])]
    assert "gpt.layers.0.attn.qkv_proj.weight" in moved


@pytest.mark.cuda
def test_cuda_moe_trainer_step_launches_each_flash_kernel_per_layer(
        tmp_path):
    """A tiny bf16 MoE GPT (``MoEModule``, 4 experts, gshard top 2,
    dropout 0.1) trains two steps on the card through the real entry
    points: every layer launches B1, B2 and B3 once per step, the losses
    and balance losses are finite, and the experts move."""
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.ops import flash_attention as fa
    from fleetx_tpu_torch.utils.config import get_config

    _need_card()
    rng = np.random.RandomState(0)
    docs = [rng.randint(0, 120, size=rng.randint(50, 200)).astype(np.int32)
            for _ in range(50)]
    prefix = str(tmp_path / "tiny")
    np.save(prefix + "_ids.npy", np.concatenate(docs))
    np.savez(prefix + "_idx.npz", lens=np.array([len(d) for d in docs],
                                                np.int32))
    root = __file__.rsplit("/tests/", 1)[0]
    cfg = get_config(f"{root}/configs/tiny/pretrain_gpt_tiny_cpu.yaml",
                     overrides=[f"Data.Train.dataset.input_dir={prefix}",
                                "Model.use_flash_attention=True",
                                "Model.module=MoEModule",
                                "Model.num_experts=4", "Model.gate=gshard",
                                "Engine.mix_precision.use_pure_fp16=True",
                                "Engine.max_steps=2",
                                "Optimizer.lr.warmup_steps=0"], nranks=1)
    module = build_module(cfg)
    trainer = Trainer(cfg, module)
    trainer.init_state()
    before = {n: p.detach().clone()
              for n, p in module.nets.named_parameters()}
    for name in fa.NAMES:
        fa.launches[name] = 0
    trainer.fit(build_dataloader(cfg, "Train"))
    layers = module.gpt_config.num_layers
    assert module.gpt_config.expert_mode
    assert fa.launches == {n: 2 * layers for n in fa.NAMES}
    assert all(np.isfinite(float(h["loss"])) and
               np.isfinite(float(h["balance_loss"]))
               for h in trainer.history)
    moved = [n for n, p in module.nets.named_parameters()
             if not torch.equal(p, before[n])]
    assert {"gpt.layers.0.moe_mlp.w_up", "gpt.layers.0.moe_mlp.gate.weight",
            "gpt.layers.0.attn.qkv_proj.weight"} <= set(moved)


def _ce_close(got, want, dtype, kind, readings=None):
    """``ce_gaps`` within CE_TOL; bf16 grads by ``grads_gaps``, aware of
    dl's rounding flips through ``readings`` of the kernel's own dl."""
    from fleetx_tpu_torch.ops import ce_loss as ce

    if dtype == torch.bfloat16 and kind == "grads":
        gaps = ce.grads_gaps(got, want, readings)
    else:
        gaps = ce.ce_gaps(got, want, dtype, kind)
    assert gaps["ok"], (kind, gaps)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,v", [(64, 384), (520, 1216)],
                         ids=["one-tile", "ragged-tiles"])
def test_ce_kernels_match_plain_versions(hidden, dtype, n, v):
    """B4, B5 and B6 each against its plain version (labels -1 and V give
    loss == lse); 520 tokens and 1216 = 9.5 x 128 columns leave ragged
    tiles in every kernel."""
    from fleetx_tpu_torch.ops import ce_loss as ce

    _need_card()
    h, w, labels = ce_case(n, hidden, v, dtype=dtype)
    before = dict(ce.launches)
    loss, lse = _twice_ce_fwd(h, w, labels)
    want_loss, want_lse = ce.fused_ce_fwd_ref(h, w, labels)
    _ce_close(loss, want_loss, dtype, "stats")
    _ce_close(lse, want_lse, dtype, "stats")
    assert torch.equal(loss[[0, 3]], lse[[0, 3]])
    gen = torch.Generator(device="cuda").manual_seed(n + hidden)
    g = torch.rand(n, device="cuda", generator=gen) + 0.5
    dh = ce.fused_ce_dh(h, w, labels, g, -g, lse)
    dw = ce.fused_ce_dw(h, w, labels, g, -g, lse)
    torch.cuda.synchronize()
    assert dh.dtype == dw.dtype == dtype

    def readings(wrt):
        return lambda: ce.kernel_readings(h, w, labels, g, -g, lse, wrt)

    _ce_close(dh, ce.fused_ce_dh_ref(h, w, labels, g, -g, lse), dtype,
              "grads", readings("h"))
    _ce_close(dw, ce.fused_ce_dw_ref(h, w, labels, g, -g, lse), dtype,
              "grads", readings("w"))
    assert dh.float().abs().mean() > 1e-4 and dw.float().abs().mean() > 1e-6
    assert {n_: ce.launches[n_] - before[n_] for n_ in ce.NAMES} == {
        "ce_fwd": 2, "ce_dh": 1, "ce_dw": 1}


def _twice_ce_fwd(h, w, labels):
    """B4's (loss, lse), after a second launch on the same inputs has
    given the same bits."""
    from fleetx_tpu_torch.ops import ce_loss as ce

    loss, lse = ce.fused_ce_fwd(h, w, labels)
    again = ce.fused_ce_fwd(h, w, labels)
    torch.cuda.synchronize()
    assert torch.equal(loss, again[0]) and torch.equal(lse, again[1])
    return loss, lse


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [64, 128, 2048])
@pytest.mark.parametrize("v", [1216, 25152, 50304])
@pytest.mark.parametrize("n", [64, 520, 8200])
def test_ce_bf16_forward_on_the_wgmma_mainloop(n, v, hidden):
    """The bf16 B4 (``ce_stats_kernel``, then ``ce_combine_kernel``)
    against its plain version within CE_TOL["stats"], launched twice with
    equal bits: 64, 520 and 8200 tokens leave ragged 128-row tiles; V
    1216, 25152 and 50304 leave last vocab tiles of 192, 64 and 128
    columns; labels -1, 0, V - 1 and V (loss == lse where none matches)."""
    from fleetx_tpu_torch.ops import ce_loss as ce

    _need_card()
    h, w, labels = ce_case(n, hidden, v, dtype=torch.bfloat16)
    before = ce.launches["ce_fwd"]
    loss, lse = _twice_ce_fwd(h, w, labels)
    assert ce.launches["ce_fwd"] == before + 2
    want_loss, want_lse = ce.fused_ce_fwd_ref(h, w, labels)
    _ce_close(loss, want_loss, torch.bfloat16, "stats")
    _ce_close(lse, want_lse, torch.bfloat16, "stats")
    assert torch.equal(loss[[0, 3]], lse[[0, 3]])
    assert (loss[1:3] != lse[1:3]).all()


@pytest.mark.cuda
def test_vp_stats_forward_on_a_vocab_shard():
    """B12's forward (``vp_stats``: B4 on mp rank 1's shard of 25152
    columns of a 50304 vocab, labels over the whole vocab, so about half
    lie off the shard and give no label logit) against its plain version
    within CE_TOL["stats"], launched twice with equal bits, one
    ``vp_ce_fwd`` launch counted each time."""
    from fleetx_tpu_torch.ops import ce_loss as ce

    _need_card()
    v_loc = 25152
    h, w, labels = ce_case(520, 128, 2 * v_loc, dtype=torch.bfloat16, seed=3)
    shard = w[v_loc:].contiguous()
    l_loc = ce.local_labels(labels, v_loc, 1)
    off = (l_loc < 0).float().mean().item()
    assert 0.3 < off < 0.7
    before = dict(ce.vp_launches)
    got = ce.vp_stats(h, shard, l_loc)
    again = ce.vp_stats(h, shard, l_loc)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert ce.vp_launches["vp_ce_fwd"] == before["vp_ce_fwd"] + 2
    want = ce.vp_stats_ref(h, shard, l_loc.to(torch.int32))
    for g, w_ in zip(got, want):
        _ce_close(g, w_, torch.bfloat16, "stats")
    assert torch.equal(got[1][l_loc < 0], torch.zeros_like(
        got[1][l_loc < 0]))


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,v", [(520, 128, 1216), (2056, 2048, 2112),
                                   (264, 4096, 1216)],
                         ids=["ragged-tiles", "ragged-chunks", "hidden-4096"])
def test_ce_bf16_backward_kernels_against_an_fp64_product(n, e, v):
    """The bf16 B5 and B6 against fp64 products (``fp64_checks``). The
    kernel's own dl (read from its scratch) lies within one bf16 step of
    the exact dl, and its output within CE_TOL's bound of the fp64 product
    of that dl on every element. Against the fp64 product of dl rounded to
    nearest, as the plain version rounds it, the kernel lies no farther
    than the plain version's error plus CE_TOL's bound, except in output
    rows where its dl rounded the other way: a one-step flip of dl at a
    large p moves a whole row of dh (or dW) by the step times |W| (or
    |h|), which at small values can pass atol. For the same reason the
    strict ``ce_gaps`` against the plain version fails on about half of
    the cotangent draws at E 2048, the first design's kernels alike
    (``tools/ce_backward_check.py``); the check against it is the
    flip-aware ``grads_gaps`` (``vs_plain``). 1216 and 2112 vocab
    rows and 520 tokens leave ragged 128- and 256-wide tiles; at E 2048
    the kernels walk chunks of 2048 rows, so 2056 tokens (dh) and 2112
    vocab rows (dW) leave a ragged last chunk of 8 and 64 rows; at E 4096
    (GPT-6.7B's) chunks of 1024 rows, so 1216 vocab rows leave one of
    192."""
    from fleetx_tpu_torch.ops import ce_loss as ce

    _need_card()
    bf16 = torch.bfloat16
    h, w, labels = ce_case(n, e, v, dtype=bf16, seed=11)
    limit = 2048 if e <= 2048 else 1024  # the chunk the plan picks at E
    for wrt, rows in (("h", n), ("w", v)):
        chunk, _ = ce._plan_chunk(n, v, e, wrt)
        assert -(-rows // chunk) == (2 if rows > limit else 1)
    _, lse = ce.fused_ce_fwd(h, w, labels)
    gen = torch.Generator(device="cuda").manual_seed(11)
    a = torch.rand(n, device="cuda", generator=gen) + 0.5
    b = -(torch.rand(n, device="cuda", generator=gen) + 0.5)
    for wrt, shape in (("h", (n, e)), ("w", (v, e))):
        got = ce.fp64_checks(h, w, labels, a, b, lse, wrt)
        assert got["got"].dtype == bf16 and got["got"].shape == shape
        assert got["got"].float().abs().mean() > 1e-6
        assert got["same_at_one_chunk"], wrt
        assert got["dl_steps"] <= 1.0, (wrt, got["dl_steps"])
        assert got["product_ratio"] <= 1.0, (wrt, got["product_ratio"])
        assert got["beyond_outside_flips"] == 0, (wrt, got["beyond"])
        assert got["whole_gap"] <= 1.0, (wrt, got["whole_gap"])
        assert got["vs_plain"]["ok"], (wrt, got["vs_plain"])


@pytest.mark.cuda
def test_ce_bf16_backward_refuses_rows_off_16_bytes():
    """The bf16 B5 and B6 load rows by TMA, which needs 16-byte row
    strides: a vocab (dh's scratch rows) or token count (dW's) that 8 does
    not divide is refused before any launch."""
    from fleetx_tpu_torch.ops import ce_loss as ce

    _need_card()
    h, w, labels = ce_case(64, 64, 388, dtype=torch.bfloat16)
    _, lse = ce.fused_ce_fwd(h, w, labels)
    g = torch.ones(64, device="cuda")
    before = dict(ce.launches)
    with pytest.raises(ValueError, match="16-byte"):
        ce.fused_ce_dh(h, w, labels, g, -g, lse)
    h, w, labels = ce_case(60, 64, 384, dtype=torch.bfloat16)
    _, lse = ce.fused_ce_fwd(h, w, labels)
    g = torch.ones(60, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        ce.fused_ce_dw(h, w, labels, g, -g, lse)
    assert ce.launches["ce_dh"] == before["ce_dh"]
    assert ce.launches["ce_dw"] == before["ce_dw"]


@pytest.mark.cuda
def test_ce_wrappers_reject_what_the_kernels_do_not_take():
    from fleetx_tpu_torch.ops import ce_loss as ce

    _need_card()
    h, w, labels = ce_case(64, 64, 384, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        ce.fused_ce_fwd(h[:, :40].contiguous(), w[:, :40].contiguous(),
                        labels)
    with pytest.raises(ValueError, match="contiguous"):
        ce.fused_ce_fwd(h.t().contiguous().t(), w, labels)
    with pytest.raises(ValueError, match="is on"):
        ce.fused_ce_fwd(h, w.cpu(), labels)
    # the fp32 kernels' shared accumulator bounds the hidden size (the
    # bf16 GEMMs take any multiple of 16: GPT-6.7B's 4096)
    big = torch.zeros(64, 2576, dtype=torch.float32, device="cuda")
    with pytest.raises(ValueError, match="up to"):
        ce.fused_ce_fwd(big, torch.zeros(384, 2576, dtype=torch.float32,
                                         device="cuda"), labels)


def _tiny_train_cfg(tmp_path, *extra):
    """The tiny config in bf16 with flash attention over a 400-document
    corpus in ``tmp_path`` (written once: a live loader maps its files)."""
    from fleetx_tpu_torch.utils.config import get_config

    prefix = str(tmp_path / "tiny")
    if not (tmp_path / "tiny_ids.npy").exists():
        rng = np.random.RandomState(0)
        docs = [rng.randint(0, 120, size=rng.randint(50, 200)).astype(
            np.int32) for _ in range(400)]
        np.save(prefix + "_ids.npy", np.concatenate(docs))
        np.savez(prefix + "_idx.npz", lens=np.array([len(d) for d in docs],
                                                    np.int32))
    root = __file__.rsplit("/tests/", 1)[0]
    return get_config(f"{root}/configs/tiny/pretrain_gpt_tiny_cpu.yaml",
                      overrides=[f"Data.Train.dataset.input_dir={prefix}",
                                 f"Data.Eval.dataset.input_dir={prefix}",
                                 "Model.use_flash_attention=True",
                                 "Engine.mix_precision.use_pure_fp16=True",
                                 "Optimizer.lr.warmup_steps=0", *extra],
                      nranks=1)


def _zero_launches():
    from fleetx_tpu_torch.ops import ce_loss as ce
    from fleetx_tpu_torch.ops import flash_attention as fa

    for mod in (ce, fa):
        for name in mod.NAMES:
            mod.launches[name] = 0


def _all_launches():
    from fleetx_tpu_torch.ops import ce_loss as ce
    from fleetx_tpu_torch.ops import flash_attention as fa

    return {**fa.launches, **ce.launches}


@pytest.mark.cuda
def test_cuda_trainer_fused_ce_recompute_and_eval_launch_counts(tmp_path):
    """A tiny bf16 GPT with fused_ce and full recompute trains 2 steps and
    evaluates once (2 batches) on the card: B4, B5, B6 once per step, B1
    twice per layer per step (forward and recompute), B2, B3 once; each
    eval batch B4 and B1 once per layer and no backward kernel."""
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module

    _need_card()
    cfg = _tiny_train_cfg(tmp_path, "Model.fused_ce=True",
                          "Model.use_recompute=True", "Engine.max_steps=2",
                          "Engine.eval_freq=2", "Engine.eval_iters=2")
    module = build_module(cfg)
    trainer = Trainer(cfg, module)
    trainer.init_state()
    _zero_launches()
    trainer.fit(build_dataloader(cfg, "Train"),
                build_dataloader(cfg, "Eval"))
    layers = module.gpt_config.num_layers
    assert _all_launches() == {
        "ce_fwd": 2 + 2, "ce_dh": 2, "ce_dw": 2,
        "flash_fwd": layers * (2 * 2 + 2), "flash_bwd_dq": 2 * layers,
        "flash_bwd_dkv": 2 * layers}
    assert all(np.isfinite(float(h["loss"])) for h in trainer.history)
    _zero_launches()
    loss = trainer.evaluate(build_dataloader(cfg, "Eval"))
    assert np.isfinite(loss)
    assert _all_launches() == {
        "ce_fwd": 2, "ce_dh": 0, "ce_dw": 0, "flash_fwd": 2 * layers,
        "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


@pytest.mark.cuda
def test_cuda_fused_ce_never_takes_the_logits_path(tmp_path):
    """On the card fused_ce with an unaligned vocab, or a batch whose token
    count 8 does not divide, raises instead of taking the logits path."""
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module

    _need_card()
    cfg = _tiny_train_cfg(tmp_path, "Model.fused_ce=True",
                          "Model.vocab_size=1000")
    module = build_module(cfg)
    trainer = Trainer(cfg, module)
    trainer.init_state()
    batch = trainer._to_device(next(iter(build_dataloader(cfg, "Train"))))
    with pytest.raises(ValueError, match="lane-aligned"):
        module.loss_fn(batch, None, train=False)
    cfg = _tiny_train_cfg(tmp_path, "Model.fused_ce=True")
    module = build_module(cfg)
    trainer = Trainer(cfg, module)
    trainer.init_state()
    odd = {k: v[:1, :7] for k, v in batch.items()}
    with pytest.raises(ValueError, match="8 does not divide"):
        module.loss_fn(odd, None, train=False)


# --------------------------------------------- ring-CP pair entries (B11)

# (causal, meta [b0, h0, h_local, h_total, q_off, k_off], kv_len)
BLOCK_CASES = {"diagonal": (True, (1, 2, 3, 9, 256, 256), 512),
               "below-diagonal": (True, (0, 0, 3, 3, 320, 64), 512),
               "off-diagonal-kvcut": (False, (2, 0, 3, 6, 384, 128), 300)}


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_block_entries_match_plain_versions(head_dim, dtype, case, rate):
    """B11: block_fwd_lse, block_dq and block_dkv on the card against the
    plain B1-B3 with the same global meta (offsets, b0/h0, a global kv_len
    below the end), each launching its kernel once."""
    from fleetx_tpu_torch.ops import flash_attention as fa

    _need_card()
    causal, meta, kv_len = BLOCK_CASES[case]
    q, k, v, do, _ = flash_case(head_dim, s=128, dtype=dtype)
    kw = dict(causal=causal, dropout_rate=rate, kv_len=kv_len)
    before = {**fa.launches, **fa.block_launches}
    out, lse = fa.block_fwd_lse(q, k, v, -42, meta, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dq = fa.block_dq(q, k, v, do, lse, delta, -42, meta, **kw)
    dk, dv = fa.block_dkv(q, k, v, do, lse, delta, -42, meta, **kw)
    torch.cuda.synchronize()
    b, s, h, _ = q.shape
    pkw = dict(causal=causal, dropout_rate=rate, seed=-42, meta=meta,
               kv_lens=torch.full((b,), kv_len, dtype=torch.int32,
                                  device="cuda"))
    want_out, want_lse = fa.flash_attention_fwd_ref(q, k, v, **pkw)
    rows = (lse.transpose(1, 2).reshape(b * h, s).contiguous(),
            delta.transpose(1, 2).reshape(b * h, s).contiguous())
    want_dq = fa.flash_bwd_dq_ref(q, k, v, do, *rows, **pkw)
    want_dk, want_dv = fa.flash_bwd_dkv_ref(q, k, v, do, *rows, **pkw)
    atol, rtol = fa.FLASH_TOL[dtype]
    for got, want in ((out, want_out), (dq, want_dq), (dk, want_dk),
                      (dv, want_dv)):
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
    torch.testing.assert_close(lse, want_lse.view(b, h, s).transpose(1, 2),
                               atol=1e-4, rtol=1e-5)
    after = {**fa.launches, **fa.block_launches}
    assert {n: after[n] - before[n] for n in after} == dict.fromkeys(after, 1)


@pytest.mark.cuda
def test_block_entries_refuse_blocks_off_the_tile_on_the_card():
    from fleetx_tpu_torch.ops import flash_attention as fa

    _need_card()
    q = torch.zeros(1, 96, 2, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="64-row tile"):
        fa.block_fwd_lse(q, q, q, 0, fa.identity_meta(2), causal=True,
                         dropout_rate=0.0, kv_len=96)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_ring_on_the_card_over_gloo_equals_single_process_kernels(dtype):
    """cp 2 ring, its 2 ranks processes that share the card over gloo (CUDA
    blocks staged through pinned host memory), at dropout 0.1: output and
    dq, dk, dv equal the single-process kernels' (merges in fp32: twice
    the kernel limit); each rank launches B1-B3 3 + 2(cp - 1) times."""
    from fleetx_tpu_torch.ops.flash_attention import FLASH_TOL, flash_attention
    from test_torch_cp_ranks import ring

    _need_card()
    rng = np.random.RandomState(3)
    q, k, v, do = (rng.randn(2, 512, 2, 64).astype(np.float32)
                   for _ in range(4))
    *got, launches = ring(q, k, v, do, dp=1, cp=2, rate=0.1, seed=99,
                          device="cuda", dtype=dtype)
    qt, kt, vt = (_torch(x, dtype).cuda().requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, dropout_rate=0.1, seed=99)
    out.backward(_torch(do, dtype).cuda())
    atol, rtol = FLASH_TOL[dtype]
    for g, w in zip(got, (out, qt.grad, kt.grad, vt.grad)):
        torch.testing.assert_close(torch.from_numpy(g), w.detach().float()
                                   .cpu(), atol=2 * atol, rtol=2 * rtol)
    assert launches == [dict.fromkeys(launches[0], 5)] * 2


@pytest.mark.cuda
def test_cuda_cp_trainer_on_two_ranks_sharing_the_card(tmp_path):
    """Two train steps of the tiny bf16 GPT at cp 2 on 2 ranks sharing the
    card over gloo, through the real entry points: equal losses and
    parameters on both ranks, and every layer's ring launching B1-B3
    (3 + 2(cp - 1) pairs) per step."""
    from test_torch_cp_ranks import train_program
    from fleetx_tpu_torch.parallel.launch import spawn

    _need_card()
    rng = np.random.RandomState(0)
    docs = [rng.randint(0, 120, size=rng.randint(50, 200)).astype(np.int32)
            for _ in range(60)]
    prefix = str(tmp_path / "tiny")
    np.save(prefix + "_ids.npy", np.concatenate(docs))
    np.savez(prefix + "_idx.npz", lens=np.array([len(d) for d in docs],
                                                np.int32))
    root = __file__.rsplit("/tests/", 1)[0]
    over = [f"Data.Train.dataset.input_dir={prefix}",
            "Data.Train.dataset.max_seq_len=256",
            "Model.max_position_embeddings=256",
            "Model.use_flash_attention=True",
            "Engine.mix_precision.use_pure_fp16=True",
            "Global.local_batch_size=2", "Global.micro_batch_size=2",
            "Distributed.cp_degree=2", "Optimizer.lr.warmup_steps=0"]
    runs = spawn(train_program, 2,
                 (f"{root}/configs/tiny/pretrain_gpt_tiny_cpu.yaml", over, 2,
                  None, "cuda"), timeout=300)
    assert runs[0]["losses"] == runs[1]["losses"]
    assert runs[0]["checksum"] == runs[1]["checksum"]
    assert all(np.isfinite(runs[0]["losses"]))
    layers = 2
    for r in runs:
        assert r["launches"] == {
            "flash_fwd": 2 * layers * 5, "flash_bwd_dq": 2 * layers * 5,
            "flash_bwd_dkv": 2 * layers * 5, "block_fwd_lse": 2 * layers * 5,
            "block_dq": 2 * layers * 5, "block_dkv": 2 * layers * 5}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_ce_backward_kernels_take_independent_a_and_b(dtype):
    """B5 and B6 against their plain versions for dl = a·softmax + b·onehot
    with a and b independent (B12's cotangents, a = g·exp(lse_loc − lse),
    b = −g), at a ragged vocab (1216 = 9.5 x 128 columns) and with labels
    off the vocab (-1 and V: no one-hot term)."""
    from fleetx_tpu_torch.ops import ce_loss as ce

    _need_card()
    n = 520
    h, w, labels = ce_case(n, 128, 1216, dtype=dtype, seed=7)
    _, lse = ce.fused_ce_fwd(h, w, labels)
    gen = torch.Generator(device="cuda").manual_seed(7)
    a = torch.rand(n, device="cuda", generator=gen) * 0.8 + 0.1
    b = -(torch.rand(n, device="cuda", generator=gen) + 0.5)
    for got, want in ((ce.fused_ce_dh(h, w, labels, a, b, lse),
                       ce.fused_ce_dh_ref(h, w, labels, a, b, lse)),
                      (ce.fused_ce_dw(h, w, labels, a, b, lse),
                       ce.fused_ce_dw_ref(h, w, labels, a, b, lse))):
        torch.cuda.synchronize()
        _ce_close(got, want, dtype, "grads")
        # b = -a would be another function: the gate tells them apart
        assert not ce.ce_gaps(got, ce._grad_plain(
            h, w, labels, a, -a, lse,
            wrt="h" if got.shape == h.shape else "w"), dtype, "grads")["ok"]


@pytest.mark.cuda
def test_b12_on_ranks_sharing_the_card_matches_its_plain_version():
    """B12 at mp 2 on 2 ranks sharing the card over gloo, bf16, against its
    plain version on the same ranks: each rank's partial dh and dW shard
    within CE_TOL, the loss within the stats limit, the summed dh within
    the grads limit relative to the partials' magnitudes and its own (it
    rounds once more than they do); one launch of
    each B12 entry per rank, none for the plain version."""
    from fleetx_tpu_torch.ops import ce_loss as ce
    from test_torch_mp_ranks import spawn_on_card, vp_ce_program

    _need_card()
    rng = np.random.RandomState(8)
    n, e, v = 520, 128, 2 * 1216
    h = rng.randn(n, e).astype(np.float32)
    w = (rng.randn(v, e) * 3 / np.sqrt(e)).astype(np.float32)
    labels = rng.randint(0, v, n).astype(np.int32)
    labels[:3] = [-1, 0, v - 1]
    g = rng.rand(n).astype(np.float32)
    args = (h, w, labels, g, 2, "cuda", torch.bfloat16)
    got = spawn_on_card(vp_ce_program, 2, *args)
    want = spawn_on_card(vp_ce_program, 2, *args, True)
    bf16 = torch.bfloat16
    scale = (sum(torch.from_numpy(r[3]).abs() for r in want)
             + torch.from_numpy(want[0][1]).abs())  # see ce.ce_gaps
    for k, w_ in zip(got, want):
        t = [torch.from_numpy(x) for x in k[:4]]
        r = [torch.from_numpy(x) for x in w_[:4]]
        assert ce.ce_gaps(t[0], r[0], bf16, "stats")["ok"]
        assert ce.ce_gaps(t[1], r[1], bf16, "grads", scale=scale)["ok"]
        assert ce.ce_gaps(t[2], r[2], bf16, "grads")["ok"]
        assert ce.ce_gaps(t[3], r[3], bf16, "grads")["ok"]
        assert k[4] == dict.fromkeys(ce.VP_NAMES, 1)
        assert w_[4] == dict.fromkeys(ce.VP_NAMES, 0)
    np.testing.assert_array_equal(got[0][0], got[1][0])


@pytest.mark.cuda
def test_cuda_mp2_trainer_on_two_ranks_sharing_the_card(tmp_path):
    """Two train steps of the tiny bf16 GPT at mp 2 with fused_ce and full
    recompute on 2 ranks sharing the card over gloo: equal losses and
    replicated parameters on both ranks; per rank B12 (and under it B4-B6)
    once per step and B1 twice per layer per step, B2 and B3 once: no
    plain version and no logits path."""
    from test_torch_mp_ranks import mp_train_program, spawn_on_card

    _need_card()
    cfg = _tiny_train_cfg(tmp_path)  # writes the corpus
    prefix = str(tmp_path / "tiny")
    root = __file__.rsplit("/tests/", 1)[0]
    over = [f"Data.Train.dataset.input_dir={prefix}",
            "Model.use_flash_attention=True", "Model.fused_ce=True",
            "Model.use_recompute=True",
            "Engine.mix_precision.use_pure_fp16=True",
            "Global.local_batch_size=2", "Global.micro_batch_size=2",
            "Distributed.mp_degree=2", "Optimizer.lr.warmup_steps=0"]
    runs = spawn_on_card(mp_train_program, 2,
                         f"{root}/configs/tiny/pretrain_gpt_tiny_cpu.yaml",
                         over, 2, None, "cuda")
    assert runs[0]["losses"] == runs[1]["losses"]
    assert runs[0]["replicated"] == runs[1]["replicated"]
    assert all(np.isfinite(runs[0]["losses"]))
    layers = cfg.Model.num_layers
    for r in runs:
        assert r["launches"] == {
            "flash_fwd": 2 * 2 * layers, "flash_bwd_dq": 2 * layers,
            "flash_bwd_dkv": 2 * layers, "ce_fwd": 2, "ce_dh": 2, "ce_dw": 2,
            "vp_ce_fwd": 2, "vp_ce_dh": 2, "vp_ce_dw": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("snapshot", ["sync", "async"])
def test_cuda_trainer_saves_loads_and_continues_bit_for_bit(tmp_path,
                                                           monkeypatch,
                                                           snapshot):
    """The tiny bf16 GPT with fused_ce and full recompute at dropout 0.1
    on the card: a run saving at steps 2 and 4 (synchronously, or as host
    snapshots), then a fresh trainer that loads step 2 and continues: the
    same losses for steps 3 and 4, and the same parameters, fused AdamW
    state (step counts included) and generator at step 4, bit for bit."""
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module
    from test_torch_ckpt_ranks import assert_states_equal, trainer_state

    _need_card()
    monkeypatch.setenv("FLEETX_CKPT_ASYNC_SNAPSHOT",
                       "1" if snapshot == "async" else "0")
    cfg = _tiny_train_cfg(tmp_path, "Model.fused_ce=True",
                          "Model.use_recompute=True", "Engine.max_steps=4",
                          "Engine.save_load.save_steps=2",
                          f"Engine.save_load.output_dir={tmp_path}/out")
    runs = []
    for load in (None, 2):
        trainer = Trainer(cfg, build_module(cfg))
        trainer.init_state()
        loader = build_dataloader(cfg, "Train")
        if load is not None:
            assert trainer.load(step=load) and trainer.step == 2
            loader.batch_sampler.consumed_samples = trainer.consumed_samples
        trainer.fit(loader)
        assert trainer.optimizer.defaults["fused"]
        runs.append(([float(h["loss"]) for h in trainer.history],
                     trainer_state(trainer)))
        del trainer
    assert runs[1][0] == runs[0][0][2:]
    assert_states_equal(runs[0][1], runs[1][1])


@pytest.mark.cuda
def test_cuda_sentry_skip_leaves_fused_adamw_state_bit_equal(tmp_path):
    """On the card a NaN batch (``loss_mask`` NaN through B4-B6) is
    skipped: parameters, the fused AdamW moments and step counts, the
    step and the generator stay bit for bit where the last applied step
    left them, and the next good step applies."""
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module
    from test_torch_ckpt_ranks import assert_states_equal, trainer_state

    _need_card()
    cfg = _tiny_train_cfg(tmp_path, "Model.fused_ce=True",
                          f"Engine.save_load.output_dir={tmp_path}/out")
    trainer = Trainer(cfg, build_module(cfg))
    trainer.init_state()
    loader = iter(build_dataloader(cfg, "Train"))
    good, bad = next(loader), next(loader)
    trainer.train_step(trainer._to_device(good))
    before = trainer_state(trainer)
    bad = dict(bad, loss_mask=np.full_like(bad["loss_mask"], np.nan))
    out = trainer.train_step(trainer._to_device(bad))
    assert out["skipped"] and trainer.step == 1
    assert_states_equal(before, trainer_state(trainer))
    out = trainer.train_step(trainer._to_device(good))
    assert not out["skipped"] and trainer.step == 2
    assert np.isfinite(float(out["loss"]))


@pytest.mark.cuda
def test_pp_transport_on_ranks_sharing_the_card():
    """The stages' transport between 2 ranks sharing the card (gloo, CUDA
    tensors staged through pinned host memory): three tensors each way,
    sent back to back, arrive whole, in order and on the card."""
    from test_torch_mp_ranks import spawn_on_card
    from test_torch_pp_ranks import transport_program

    _need_card()
    (sent0, got0, on0), (sent1, got1, on1) = spawn_on_card(
        transport_program, 2, "cuda")
    assert got1 == sent0 and got0 == sent1 and on0 and on1


@pytest.mark.cuda
def test_cuda_pp2_trainer_resumes_bit_for_bit(tmp_path):
    """The tiny bf16 GPT cut to 4 layers at pp 2 (2 ranks sharing the card
    over gloo), full recompute, dropout 0.1, 2 microbatches: a run of 2
    steps saving per-stage files at each, then fresh processes resuming
    step 1 and taking step 2: the same loss and every parameter, fused
    AdamW tensor and the generator bit for bit on both ranks; the tied
    embedding's copies equal; per rank B1 twice and B2, B3 once per layer
    of its stage per microbatch per step."""
    from test_torch_mp_ranks import spawn_on_card
    from test_torch_pp_ranks import pp_fit_program

    _need_card()
    _tiny_train_cfg(tmp_path)  # writes the corpus
    root = __file__.rsplit("/tests/", 1)[0]
    config = f"{root}/configs/tiny/pretrain_gpt_tiny_cpu.yaml"
    over = [f"Data.Train.dataset.input_dir={tmp_path}/tiny",
            "Model.use_flash_attention=True", "Model.use_recompute=True",
            "Engine.mix_precision.use_pure_fp16=True", "Model.num_layers=4",
            "Global.local_batch_size=4", "Global.micro_batch_size=2",
            "Distributed.pp_degree=2", "Optimizer.lr.warmup_steps=0",
            "Engine.max_steps=2", "Engine.save_load.save_steps=1"]
    whole, part = tmp_path / "whole", tmp_path / "part"
    a = spawn_on_card(pp_fit_program, 2, config,
                      over + [f"Engine.save_load.output_dir={whole}"], None,
                      "cuda")
    import shutil

    shutil.copytree(whole / "checkpoints" / "1", part / "checkpoints" / "1")
    b = spawn_on_card(pp_fit_program, 2, config,
                      over + [f"Engine.save_load.output_dir={part}"], 1,
                      "cuda")
    for x, y in zip(a, b):
        assert y["losses"] == x["losses"][1:]
        assert y["digests"] == x["digests"]
        assert all(np.isfinite(x["losses"]))
        # 2 layers a stage, 2 microbatches, 2 steps (A) and 1 (B)
        assert x["launches"] == {"flash_fwd": 16, "flash_bwd_dq": 8,
                                 "flash_bwd_dkv": 8}
        assert y["launches"] == {"flash_fwd": 8, "flash_bwd_dq": 4,
                                 "flash_bwd_dkv": 4}
    assert a[0]["losses"] == a[1]["losses"]
    assert (a[0]["digests"]["gpt.word_embeddings"]
            == a[1]["digests"]["gpt.word_embeddings"])


def _zero_overrides(tmp_path, *extra):
    """The tiny fp32 config with flash attention at sharding 2 (stage 2)
    on 2 ranks, 2 microbatches, over ``_tiny_train_cfg``'s corpus."""
    _tiny_train_cfg(tmp_path)  # writes the corpus
    return [f"Data.Train.dataset.input_dir={tmp_path}/tiny",
            "Model.use_flash_attention=True", "Optimizer.lr.warmup_steps=0",
            "Model.hidden_dropout_prob=0.1",
            "Model.attention_probs_dropout_prob=0.1",
            "Distributed.sharding.sharding_degree=2",
            "Distributed.sharding.sharding_stage=2",
            "Global.local_batch_size=2", "Global.micro_batch_size=1",
            *extra]


@pytest.mark.cuda
def test_cuda_zero_trainer_on_two_ranks_matches_the_replicated_update(
        tmp_path):
    """The tiny fp32 GPT at sharding 2 on 2 ranks sharing the card (gloo,
    the update shard's collectives through pinned host buffers), three
    steps with the update shard on and off: the same losses, parameters
    and whole AdamW moments within 2e-6, both ranks bit-equal, the AdamW
    state per rank at most 0.55 of the replicated run's."""
    from test_torch_mp_ranks import spawn_on_card
    from test_torch_zero_ranks import (
        assert_close,
        assert_replicas_equal,
        zero_fit_program,
    )

    _need_card()
    root = __file__.rsplit("/tests/", 1)[0]
    config = f"{root}/configs/tiny/pretrain_gpt_tiny_cpu.yaml"
    over = _zero_overrides(tmp_path,
                           f"Engine.save_load.output_dir={tmp_path}/out")
    on = spawn_on_card(zero_fit_program, 2, config, over, 3, None, "1",
                       None, None, "cuda")
    off = spawn_on_card(zero_fit_program, 2, config, over, 3, None, "0",
                        None, None, "cuda")
    assert [r["zero"] for r in on] == [True, True]
    assert not any(r["zero"] for r in off)
    for runs in (on, off):
        assert_replicas_equal(runs)
    np.testing.assert_allclose(on[0]["losses"], off[0]["losses"], rtol=0,
                               atol=1e-6)
    assert_close(on[0], off[0])
    assert on[0]["opt_bytes"] <= 0.55 * off[0]["opt_bytes"]


@pytest.mark.cuda
def test_cuda_zero_checkpoint_reshards_onto_one_rank(tmp_path):
    """Two steps at sharding 2 on 2 ranks sharing the card save step 2
    (the AdamW slices gathered to the writer); the step reloaded on the
    same mesh and at one rank in this process: parameters, whole moments
    and generator bit for bit equal to each other and to the state at the
    save, the step and consumed samples restored."""
    from test_torch_ckpt_ranks import assert_states_equal
    from test_torch_mp_ranks import spawn_on_card
    from test_torch_reshard_ranks import restore_program, save_program

    _need_card()
    root = __file__.rsplit("/tests/", 1)[0]
    config = f"{root}/configs/tiny/pretrain_gpt_tiny_cpu.yaml"
    over = _zero_overrides(tmp_path)
    out = str(tmp_path / "out")
    saved = spawn_on_card(save_program, 2, config, over, out, "cuda")
    same = spawn_on_card(restore_program, 2, config, over, out, "cuda")
    single = [o for o in over if not o.startswith(
        ("Distributed.", "Global.local_batch_size", "Global.micro_batch"))]
    one = restore_program(config, single + ["Global.local_batch_size=4",
                                            "Global.micro_batch_size=2"],
                          out, "cuda")
    assert saved[0]["zero"] and same[0]["zero"] and not one["zero"]
    for r in same + [one]:
        assert (r["step"], r["consumed"]) == (2, 8)
        assert_states_equal(r["state"], saved[0]["state"])


@pytest.mark.cuda
def test_cuda_mp2_sp_trainer_matches_sp_off(tmp_path):
    """Two train steps of the tiny bf16 GPT at mp 2 with fused_ce and
    ``core_attn`` recompute on 2 ranks sharing the card, with and without
    Megatron sequence parallelism: the first loss equal (only the
    gradients' summation order differs between the layouts), both losses
    within 1e-3 relative, equal losses and replicated parameters on both
    ranks of each run, the same launches (B1 twice per layer per step)."""
    from test_torch_mp_ranks import mp_train_program, spawn_on_card

    _need_card()
    cfg = _tiny_train_cfg(tmp_path)  # writes the corpus
    prefix = str(tmp_path / "tiny")
    root = __file__.rsplit("/tests/", 1)[0]
    runs = {}
    for sp in (True, False):
        over = [f"Data.Train.dataset.input_dir={prefix}",
                "Model.use_flash_attention=True", "Model.fused_ce=True",
                "Model.use_recompute=True",
                "Model.recompute_granularity=core_attn",
                f"Model.sequence_parallel={sp}",
                "Engine.mix_precision.use_pure_fp16=True",
                "Global.local_batch_size=2", "Global.micro_batch_size=2",
                "Distributed.mp_degree=2", "Optimizer.lr.warmup_steps=0"]
        runs[sp] = spawn_on_card(
            mp_train_program, 2,
            f"{root}/configs/tiny/pretrain_gpt_tiny_cpu.yaml", over, 2, None,
            "cuda")
        assert runs[sp][0]["losses"] == runs[sp][1]["losses"]
        assert runs[sp][0]["replicated"] == runs[sp][1]["replicated"]
        assert all(np.isfinite(runs[sp][0]["losses"]))
    on, off = runs[True][0], runs[False][0]
    assert on["losses"][0] == off["losses"][0]
    np.testing.assert_allclose(on["losses"], off["losses"], rtol=1e-3)
    layers = cfg.Model.num_layers
    assert on["launches"] == off["launches"] == {
        "flash_fwd": 2 * 2 * layers, "flash_bwd_dq": 2 * layers,
        "flash_bwd_dkv": 2 * layers, "ce_fwd": 2, "ce_dh": 2, "ce_dw": 2,
        "vp_ce_fwd": 2, "vp_ce_dh": 2, "vp_ce_dw": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("granularity,extra", [
    ("full", None), ("full_attn", None), ("core_attn", None),
    ("full", ("ffn_gelu",)), ("core_attn", ("qkv_out", "mlp_out"))],
    ids=["full", "full_attn", "core_attn", "full+ffn_gelu",
         "core_attn+qkv_out+mlp_out"])
def test_cuda_save_sets_equal_no_recompute(granularity, extra):
    """The tiny bf16 GPT on the card at dropout 0.1 through the kernels:
    each save-set's loss and every gradient bit-equal to the run without
    recompute (the same kernels on the same inputs with the same seeds);
    B1 launched once per layer without recompute and twice with (its lse
    is not kept, so it reruns under every save-set)."""
    import dataclasses

    from fleetx_tpu_torch.models.gpt.convert import init_params
    from fleetx_tpu_torch.ops import flash_attention as fa

    _need_card()
    base = gpt_model.GPTConfig(
        vocab_size=512, hidden_size=256, num_layers=2,
        num_attention_heads=2, max_position_embeddings=256,
        dtype=torch.bfloat16)
    params = init_params(base, seed=3, device="cuda")
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 512, (2, 256), generator=gen).cuda()
    pos = torch.arange(256, device="cuda")[None].expand(2, 256)

    def run(cfg):
        model = gpt_model.GPTForPretraining(cfg, device="meta")
        model.load_state_dict({n: t.clone() for n, t in params.items()},
                              assign=True)
        before = fa.launches["flash_fwd"]
        logits = model(ids, pos, deterministic=False,
                       generator=torch.Generator().manual_seed(1))
        loss = gpt_model.pretraining_loss(logits, ids, torch.ones_like(ids))
        loss.backward()
        torch.cuda.synchronize()
        return (loss.detach(), {n: p.grad for n, p in
                                model.named_parameters()},
                fa.launches["flash_fwd"] - before)

    ref_loss, ref, ref_b1 = run(base)
    loss, grads, b1 = run(dataclasses.replace(
        base, use_recompute=True, recompute_granularity=granularity,
        recompute_extra_saves=extra))
    assert (ref_b1, b1) == (base.num_layers, 2 * base.num_layers)
    assert torch.equal(loss, ref_loss)
    for n, g in ref.items():
        assert torch.equal(grads[n], g), n


@pytest.mark.cuda
def test_b12_kernels_at_hidden_12288():
    """B4-B6 as B12 runs them on a vocab shard at GPT-175B's hidden 12288
    (labels off the shard at -1, independent a and b), bf16, against their
    plain versions within CE_TOL (the grads aware of dl's rounding
    flips), each launched twice with equal bits; B4's lse no further from
    an fp64 product than cuBLAS's bf16 tensor-core GEMM's. Over a
    reduction of 12288 a single tensor-core accumulator drifts beyond
    CE_TOL of the plain version's IEEE sums (the stats at 1.17 times the
    limit here, before the mainloop summed its accumulator per 3072)."""
    from fleetx_tpu_torch.ops import ce_loss as ce

    _need_card()
    n, e, v_loc = 512, 12288, 2 * 1280
    h, w, labels = ce_case(n, e, 2 * v_loc, dtype=torch.bfloat16, seed=9)
    l_loc = ce.local_labels(labels, v_loc, 0)
    shard = w[:v_loc].contiguous()
    loss, lse = ce.fused_ce_fwd(h, shard, l_loc)
    again = ce.fused_ce_fwd(h, shard, l_loc)
    torch.cuda.synchronize()
    assert torch.equal(loss, again[0]) and torch.equal(lse, again[1])
    want_loss, want_lse = ce.fused_ce_fwd_ref(h, shard, l_loc)
    _ce_close(loss, want_loss, torch.bfloat16, "stats")
    _ce_close(lse, want_lse, torch.bfloat16, "stats")
    lse64 = torch.logsumexp(h.double() @ shard.double().t(), -1)
    lse_tc = torch.logsumexp(torch.mm(h, shard.t(), out_dtype=torch.float32)
                             .double(), -1)
    assert (lse.double() - lse64).abs().max() <= (lse_tc - lse64).abs().max()
    gen = torch.Generator(device="cuda").manual_seed(9)
    a = torch.rand(n, device="cuda", generator=gen) * 0.8 + 0.1
    b = -(torch.rand(n, device="cuda", generator=gen) + 0.5)
    for wrt, fn, ref in (("h", ce.fused_ce_dh, ce.fused_ce_dh_ref),
                         ("w", ce.fused_ce_dw, ce.fused_ce_dw_ref)):
        got = _twice(fn, h, shard, l_loc, a, b, lse)
        want = ref(h, shard, l_loc, a, b, lse)
        _ce_close(got, want, torch.bfloat16, "grads",
                  lambda: ce.kernel_readings(h, shard, l_loc, a, b, lse, wrt))


def _tier_waves(seed=5):
    """Three prompts over one 24-token prefix, then three unrelated ones
    that push them out of a 10-page pool, then the first three again."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, 61, 24)
    first = [np.concatenate([prefix, rng.randint(0, 61, n)])
             for n in (3, 6, 9)]
    return [first, [rng.randint(0, 61, n) for n in (30, 27, 33)], first]


@pytest.mark.cuda
def test_cuda_host_tier_revival_equals_never_evicted(tmp_path):
    """A tiny fp32 paged engine with a host tier over a disk tier: the
    first wave's prefix pages spill, the third wave revives them through
    the batched copies, and every stream equals that of an engine whose
    pool never evicts; each decode tick launches B8 once per layer."""
    _need_card()
    cfg = _tiny_cuda_cfg()
    waves = _tier_waves()
    want = [_serve_ticks(_tiny_engine(cfg, cache_len=48), w, 6)[0]
            for w in waves]
    engine = _tiny_engine(cfg, cache_len=48, num_pages=10,
                          host_cache_bytes=2 * 8192,
                          disk_cache_dir=str(tmp_path),
                          disk_cache_bytes=1 << 20)
    before = dict(da.launches)
    got, ticks = [], 0
    for w in waves:
        out, n = _serve_ticks(engine, w, 6)
        got.append(out)
        ticks += n
    assert got == want
    snap = engine.metrics.snapshot()
    assert snap["host_spilled_pages"] > 0
    assert snap["host_revived_pages"] + snap["disk_cache_hits"] > 0
    assert _launched(before) == {"paged_decode": ticks * cfg.num_layers}


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8"], ids=["b8", "b10"])
def test_cuda_shipped_admission_decodes_through_b8_and_b10(kv):
    """A prefill-role engine ships each prompt's pages as bytes to a
    decode-role engine on the card; the streams equal one colocated
    engine's and the decode engine's ticks launch B8 (B10 at int8) once
    per layer."""
    _need_card()
    cfg = _tiny_cuda_cfg()
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, 61, n) for n in (5, 17, 40)]
    want, _ = _serve_ticks(_tiny_engine(cfg, kv_dtype=kv), prompts)
    pre = _tiny_engine(cfg, kv_dtype=kv, role="prefill")
    dec = _tiny_engine(cfg, kv_dtype=kv, role="decode")
    rids = [pre.submit(p, max_length=12) for p in prompts]
    handed = {}
    while len(handed) < len(prompts):  # parked requests hold their lanes
        pre.step()
        for rid in pre.prefilled_ready():
            blobs = pre.export_kv(rid)
            handed[rid] = dec.submit(prompts[rids.index(rid)], max_length=12,
                                     history=pre.take_result(rid).tokens,
                                     kv_payloads=blobs)
    before = dict(da.launches)
    ticks = 0
    while dec.scheduler.queue_depth or dec.cache_manager.active_count:
        ticks += dec.step()["decoded"] > 0
    out = dec.drain()
    assert [out[handed[r]].tokens.tolist() for r in rids] == want
    name = "paged_decode_q8" if kv else "paged_decode"
    assert _launched(before) == {name: ticks * cfg.num_layers}
    assert dec.metrics.kv_pages_revived_remote == sum(
        -(-len(p) // 8) for p in prompts)


@pytest.mark.cuda
def test_cuda_tick_fault_recovers_on_fresh_pools():
    """A decode-tick fault on the card: recovery builds new pool tensors
    (other ``data_ptr``s while the old ones are held, which it leaves as
    they were), replays through B8, and the streams equal the fault-free
    engine's."""
    _need_card()
    from fleetx_tpu_torch.resilience.faults import faults

    cfg = _tiny_cuda_cfg()
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 61, n) for n in (5, 17, 40)]
    want, _ = _serve_ticks(_tiny_engine(cfg), prompts)
    engine = _tiny_engine(cfg)
    old = {k: v for k, v in engine.cache_manager.cache.items()
           if torch.is_tensor(v)}  # held, as an abandoned call holds them
    seen = {}
    build = engine._new_cache_manager

    def rebuild():
        seen.update({k: v.clone() for k, v in old.items()})
        return build()

    engine._new_cache_manager = rebuild
    faults.configure(tick_raise="4")
    try:
        got, _ = _serve_ticks(engine, prompts)
    finally:
        faults.reset()
    assert got == want
    assert engine.metrics.engine_recoveries == 1
    assert all(engine.cache_manager.cache[k].data_ptr() != v.data_ptr()
               for k, v in old.items())
    assert all(torch.equal(old[k], v) for k, v in seen.items())


@pytest.mark.cuda
def test_cuda_recovery_needs_one_pool_of_memory():
    """With no abandoned call holding it, recovery releases the old pool
    before it allocates the new one: the card's peak over the faulted tick
    stays under one more pool (82 MB here, far above the tiny model's
    activations), and the streams equal the fault-free engine's."""
    _need_card()
    from fleetx_tpu_torch.resilience.faults import faults

    cfg = _tiny_cuda_cfg()
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 61, n) for n in (5, 17, 40)]
    want, _ = _serve_ticks(_tiny_engine(cfg), prompts)
    engine = _tiny_engine(cfg, num_pages=20001)
    pool = engine.cache_manager.cache_nbytes()
    assert pool > 80e6
    for p in prompts:
        engine.submit(p, max_length=12)
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    faults.configure(tick_raise=str(engine._fault_ticks))
    try:
        assert engine.step()["recovered"]
    finally:
        faults.reset()
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < pool / 2
    out = engine.drain()
    assert [out[i].tokens.tolist() for i in sorted(out)] == want


@pytest.mark.cuda
def test_cuda_mp2_paged_engine_rank_b8_is_the_single_card_head_slice():
    """An mp 2 paged engine on 2 ranks sharing the card (gloo): each
    rank's first B8 output (layer 0, its heads) equals the single-card
    engine's slice of those heads, both ranks' streams equal the single
    card's, and each rank launches B8 once per layer of each tick."""
    from test_torch_mesh_ranks import mesh_cuda_program, serve_on_card
    from test_torch_mp_ranks import spawn_on_card

    from fleetx_tpu_torch.models.gpt.convert import init_params

    _need_card()
    cfg = dataclasses.replace(_tiny_cuda_cfg(), num_attention_heads=4)
    params = init_params(cfg, seed=0)
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, 61, n).tolist() for n in (5, 17, 30)]
    want = serve_on_card(params, cfg, prompts, 12)
    kw = {f: getattr(cfg, f) for f in ("vocab_size", "hidden_size",
                                       "num_layers", "num_attention_heads",
                                       "ffn_hidden_size",
                                       "max_position_embeddings", "dtype")}
    ranks = spawn_on_card(mesh_cuda_program, 2,
                          {k: v.cpu().numpy() for k, v in params.items()},
                          kw, prompts)
    for r, got in enumerate(ranks):
        assert got["tokens"] == want["tokens"]
        np.testing.assert_allclose(got["first"],
                                   want["first"][:, :, 2 * r:2 * r + 2],
                                   rtol=0, atol=1e-5)
        assert got["launches"] == got["ticks"] * cfg.num_layers


@pytest.mark.cuda
def test_cuda_int8_dense_matches_its_plain_dequant():
    """An int8-weight ``Dense`` on the card in bf16: bit-equal to
    ``F.linear`` of the plain dequant (fp32 values times scales, then
    bf16), and within one bf16 rounding of the fp32 product of the same
    bf16 operands on the host."""
    from fleetx_tpu_torch.ops.quant import quantize_int8
    from fleetx_tpu_torch.parallel.tensor_parallel import Dense

    _need_card()
    rng = np.random.RandomState(9)
    w = torch.from_numpy(rng.randn(384, 256).astype(np.float32) * 0.02)
    (q,), s = quantize_int8([w], (3 * 32, 1))  # a fused qkv's 3·hd channels
    dense = Dense(256, 384, torch.bfloat16, device="cuda", scale_rows=96)
    dense.weight_q8.copy_(q)
    dense.weight_scale.copy_(s)
    dense.bias.data.zero_()
    x = torch.from_numpy(rng.randn(8, 256).astype(np.float32)).cuda()
    with torch.no_grad():
        got = dense(x)
    plain = (q.float().view(-1, 96, 256) * s).view(384, 256)
    want = torch.nn.functional.linear(x.bfloat16(),
                                      plain.cuda().bfloat16(),
                                      torch.zeros(384, device="cuda",
                                                  dtype=torch.bfloat16))
    assert torch.equal(got, want)
    # the fp32 product of the same bf16 operands: the card rounds it once
    host = x.cpu().bfloat16().float() @ plain.bfloat16().float().t()
    np.testing.assert_allclose(got.float().cpu().numpy(), host.numpy(),
                               rtol=8e-3, atol=1e-5)


@pytest.mark.cuda
def test_cuda_router_failover_gives_the_single_engine_streams():
    """A ``ServingRouter`` over two tiny paged engines on the card, with
    one replica declared dead at router tick 3 (mid-stream): every
    request finishes once, each stream (greedy and seeded sampling, the
    callback transcript too) equals one engine's of the same lanes, and
    each decode forward launched B8 once per layer."""
    from fleetx_tpu_torch.resilience.faults import faults
    from fleetx_tpu_torch.serving import ServingRouter

    _need_card()
    cfg = _tiny_cuda_cfg()
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 61, n).tolist() for n in (5, 17, 30, 9)]
    kws = [{}, dict(decode_strategy="sampling", top_k=8, seed=3), {},
           dict(decode_strategy="sampling", top_p=0.9, seed=4)]
    one = _tiny_engine(cfg)
    rids = [one.submit(p, max_length=12, **kw) for p, kw in zip(prompts, kws)]
    ref = one.drain()
    want = [ref[r].tokens.tolist() for r in rids]
    engines = [_tiny_engine(cfg) for _ in range(2)]
    forwards = [0]
    for engine in engines:
        forward = engine.executor.forward

        def counted(cache, ids, *args, _forward=forward, **kw):
            forwards[0] += ids.shape[1] == 1
            return _forward(cache, ids, *args, **kw)

        engine.executor.forward = counted
    streams = {}
    before = dict(da.launches)
    faults.configure(replica_kill="1:3")
    try:
        router = ServingRouter(engines, probe_every=1)
        rids = [router.submit(p, max_length=12, on_token=lambda r, t, f:
                              streams.setdefault(r, []).append(t), **kw)
                for p, kw in zip(prompts, kws)]
        res = router.drain(max_ticks=400)
    finally:
        faults.reset()
    torch.cuda.synchronize()
    assert router.replica_states[1] == "dead"
    assert router.metrics.snapshot()["migrated"] >= 1
    assert [res[r].tokens.tolist() for r in rids] == want
    assert [streams[r] for r in rids] == want
    assert _launched(before) == {"paged_decode": forwards[0] * cfg.num_layers}


# (s, kv_lens) of the encoders' B1 mode: non-causal, per-row key lengths.
# ERNIE's 512-position bucket with rows past, on and below a 64-key tile
# border, one key and a filler row (0); ViT-B/16's 197 tokens padded to
# the tile (256)
ENCODER_CASES = {"ernie": (512, [512, 300, 129, 65, 64, 17, 1, 0]),
                 "vit": (256, [197, 197])}


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_flash_forward_non_causal_ragged_kv_lens(case, dtype, head_dim):
    """B1 non-causal with ragged ``kv_lens`` (q, k, v strided views of one
    fused buffer) against its plain version within FLASH_TOL, launched
    twice with the same bits; the filler row of length 0 comes out as
    zeros with lse -1e30, no NaN anywhere; one key fewer breaks the
    limit."""
    from fleetx_tpu_torch.ops import flash_attention as fa

    _need_card()
    s, lens = ENCODER_CASES[case]
    q, k, v, _, kv = flash_case(head_dim, b=len(lens), s=s, h=2,
                                kv_lens=lens, dtype=dtype, seed=s)
    kw = dict(causal=False, kv_lens=kv)
    before = dict(fa.launches)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    again, _ = fa.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches["flash_fwd"] - before["flash_fwd"] == 2
    assert torch.equal(out, again)
    want, want_lse = fa.flash_attention_fwd_ref(q, k, v, **kw)
    atol, rtol = fa.FLASH_TOL[dtype]
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    if 0 in lens:
        row = lens.index(0)
        assert not out[row].any()
        assert (lse.view(len(lens), -1, s)[row] <= -1e29).all()
    off = fa.flash_fwd(q, k, v, causal=False, kv_lens=(kv - 1).clamp_min(0))[0]
    err = ((off.float() - want.float()).abs()
           / (atol + rtol * want.float().abs())).max().item()
    assert err > 1.0, err


def _encoder_engines(kind, device):
    """A tiny ERNIE or ViT engine (fp32, head dim 16) on ``device``, its
    weights drawn on the CPU at std 0.3 (argmax far from ties)."""
    from fleetx_tpu_torch.models.ernie import convert as ec
    from fleetx_tpu_torch.models.ernie.model import (
        ErnieConfig,
        ErnieForPretraining,
    )
    from fleetx_tpu_torch.models.vision import convert as vc
    from fleetx_tpu_torch.models.vision.vit import ViT, ViTConfig
    from fleetx_tpu_torch.serving import EmbeddingEngine, ErnieScoringEngine

    if kind == "ernie":
        cfg = ErnieConfig(vocab_size=97, hidden_size=64, num_layers=2,
                          num_attention_heads=4, max_position_embeddings=128,
                          dtype=torch.float32)
        params, model, cls = (ec.init_params(cfg, seed=1, device="cpu"),
                              ErnieForPretraining(cfg, device="meta"),
                              ErnieScoringEngine)
    else:
        cfg = ViTConfig(image_size=32, patch_size=8, hidden_size=64,
                        num_layers=2, num_attention_heads=4, num_classes=0,
                        dtype=torch.float32)
        params, model, cls = (vc.init_params(cfg, seed=1, device="cpu"),
                              ViT(cfg, device="meta"), EmbeddingEngine)
    params = {n: t if n.endswith(("scale", "bias")) else t * 15.0
              for n, t in params.items()}
    return cls(model, params, device=device, slots=4), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ernie", "vit"])
def test_cuda_encoder_engines_run_b1_per_layer(kind):
    """An ``ErnieScoringEngine`` (fill-in-blank and scoring, prompts of 3 to
    100 tokens: buckets of 4, 64 and 128 with filler rows) and an
    ``EmbeddingEngine`` on the card: each batched forward launches B1 once
    per layer, the ERNIE ids equal the CPU engine's and the ViT vectors
    agree with it within 1e-4."""
    from fleetx_tpu_torch.ops import flash_attention as fa
    from fleetx_tpu_torch.serving import decode_floats, encode_floats

    _need_card()
    eng, cfg = _encoder_engines(kind, "cuda")
    cpu, _ = _encoder_engines(kind, "cpu")
    rng = np.random.RandomState(2)
    if kind == "ernie":
        prompts = []
        for n, masks in ((3, 1), (50, 2), (100, 0), (17, 3), (64, 0)):
            p = rng.randint(4, 97, n).astype(np.int32)
            p[rng.choice(n, masks, replace=False)] = 3
            prompts.append(p)
    else:
        prompts = [encode_floats(rng.rand(32, 32, 3).astype(np.float32))
                   for _ in range(5)]
    before = fa.launches["flash_fwd"]
    ticks = 0
    rids = [eng.submit(p) for p in prompts]
    while len(eng.scheduler):
        ticks += eng.step()["forwards"]
    res = eng.drain()
    torch.cuda.synchronize()
    assert fa.launches["flash_fwd"] - before == ticks * cfg.num_layers
    crids = [cpu.submit(p) for p in prompts]
    cres = cpu.drain()
    for r, c in zip(rids, crids):
        assert res[r].finish_reason == "complete"
        if kind == "ernie":
            assert res[r].tokens.tolist() == cres[c].tokens.tolist()
        else:
            np.testing.assert_allclose(decode_floats(res[r].tokens),
                                       decode_floats(cres[c].tokens),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_flash_backward_non_causal_ragged_kv_lens(case, dtype, rate):
    """B2 and B3 in the encoders' training mode (non-causal, ragged
    ``kv_lens`` with rows of length 0, mid-tile and full, head dim 64,
    dropout 0 and 0.1) against their plain versions within FLASH_TOL, each
    launched twice with the same bits; the length-0 row's dQ and every
    key past a row's length (its dK, dV) come out zero; another dropout
    seed breaks the limit."""
    from fleetx_tpu_torch.ops import flash_attention as fa

    _need_card()
    s, lens = ENCODER_CASES[case]
    q, k, v, do, kv = flash_case(64, b=len(lens), s=s, h=2, kv_lens=lens,
                                 dtype=dtype, seed=s + 1)
    kw = dict(causal=False, kv_lens=kv, dropout_rate=rate, seed=-98765)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).reshape(
        -1, s).contiguous()
    before = dict(fa.launches)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq2 = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in fa.NAMES} == {
        "flash_fwd": 0, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    assert all(torch.equal(a, b) for a, b in ((dq, dq2), (dk, dk2),
                                              (dv, dv2)))
    want_dq = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    want_dk, want_dv = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)
    atol, rtol = fa.FLASH_TOL[dtype]
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
    for row, n in enumerate(lens):
        assert not dk[row, n:].any() and not dv[row, n:].any()
        if n == 0:
            assert not dq[row].any()
    if rate:
        fdq = fa.flash_bwd_dq(q, k, v, do, lse, delta,
                              **dict(kw, seed=kw["seed"] + 1))
        err = ((fdq.float() - want_dq.float()).abs()
               / (atol + rtol * want_dq.float().abs())).max().item()
        assert err > 1.0, err


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ernie", "vit"])
def test_cuda_encoder_trainer_steps_launch_b1_b3_per_layer(tmp_path,
                                                           family):
    """A tiny bf16 ERNIE (``ErnieModule`` on ``ErnieDataset``, key lengths
    from the right padding, dropout 0.1) and a tiny bf16 ViT
    (``GeneralClsModule`` on ``SyntheticClsDataset``, 2 micro-batches a
    step, drop path, mixup, dropout 0.1) train two steps on the card
    through the real entry points: every layer launches B1, B2 and B3 once
    per micro-batch, the losses are finite and the weights move."""
    from fleetx_tpu_torch.core.engine import Trainer
    from fleetx_tpu_torch.data import build_dataloader
    from fleetx_tpu_torch.models import build_module
    from fleetx_tpu_torch.ops import flash_attention as fa
    from fleetx_tpu_torch.utils.config import get_config
    from torch_encoder_configs import ernie_yaml, vit_yaml, write_ernie_corpus

    _need_card()
    if family == "ernie":
        write_ernie_corpus(str(tmp_path / "er"))
        path = ernie_yaml(tmp_path / "c.yaml", str(tmp_path / "er"),
                          str(tmp_path / "out"))
        over = ["Model.hidden_dropout_prob=0.1",
                "Model.attention_probs_dropout_prob=0.1"]
        micro = 1
    else:
        path = vit_yaml(tmp_path / "c.yaml", str(tmp_path / "out"))
        over = ["Model.drop_rate=0.1", "Model.attn_drop_rate=0.1",
                "Model.drop_path_rate=0.1", "Model.mixup_alpha=0.8",
                "Global.micro_batch_size=4"]
        micro = 2
    cfg = get_config(path, overrides=over + [
        "Engine.mix_precision.use_pure_fp16=True", "Engine.max_steps=2"],
        nranks=1)
    module = build_module(cfg)
    trainer = Trainer(cfg, module)
    trainer.init_state()
    before = {n: p.detach().clone()
              for n, p in module.nets.named_parameters()}
    for name in fa.NAMES:
        fa.launches[name] = 0
    trainer.fit(build_dataloader(cfg, "Train"))
    torch.cuda.synchronize()
    layers = cfg.Model.num_layers
    assert trainer.step == 2
    assert fa.launches == {n: 2 * micro * layers for n in fa.NAMES}
    assert all(np.isfinite(float(h["loss"])) for h in trainer.history)
    moved = {n for n, p in module.nets.named_parameters()
             if not torch.equal(p, before[n])}
    assert len(moved) > len(before) // 2
