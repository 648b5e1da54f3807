"""Inputs and a timer shared by ``chip_smoke.py`` and the card tools.

The kernel phases of ``chip_smoke.py`` and ``attention_kernel_check.py``
build the same cases from these functions, so that the tool, run over
another checkout's kernels with ``--root``, times them on the phases'
own data: the decode pools and caches of phases 3, 9 and 10 (GPT-345M
decode shapes), the flash attention operands of phase 6 (GPT-345M and
GPT-1.3B training shapes), phase 15's context-parallel ring pairs, and
:func:`cuda_ms`, the device timer every phase uses. Everything is made on
the card (``DEVICE``) from a seed. Imports nothing of the kernels.
"""

from __future__ import annotations

import math

import torch

from fleetx_tpu_torch.ops.quant import quantize_kv

__all__ = ["DEVICE", "L2_BYTES", "GEN_PROMPT_LENS", "FLASH_MP_META",
           "CP_DEGREE", "CP_SEQ", "CP_BLOCK", "CP_SEED", "CP_PAIRS",
           "cuda_ms", "rotation_copies", "decode_case", "decode_bound",
           "flash_inputs", "flash_delta", "sdpa_times", "contiguous_cases",
           "contiguous_case"]

DEVICE = "cuda"  # where the cases are made: the card
L2_BYTES = 50 * 2 ** 20  # H100 SXM L2, NVIDIA data sheet
# phase 10's prompts, left-padded to 312 tokens: the decode cache
# right-sizes to 312 + 200 = 512 positions (B7 tiles at 256)
GEN_PROMPT_LENS = (24, 64, 112, 160, 200, 248, 288, 312)
# phase 20's attention on mp rank 1 of 2: heads 8-15 of GPT-1.3B's 16
# (b0, h0, h_local, h_total, q_off, k_off)
FLASH_MP_META = (0, 8, 8, 16, 0, 0)
# phase 15's context-parallel drive: cp 2 at seq 16384, so its ring pairs
# are [1, 4096, 16, 128] bf16
CP_DEGREE, CP_SEQ = 2, 16384
CP_BLOCK = CP_SEQ // (2 * CP_DEGREE)
CP_SEED = -24680  # the pair and ring phases' dropout seed
# (causal, meta) of phase 15's two pairs: rank 0's late block (id 3) on
# the diagonal, and against rank 0's early kv block (id 0)
CP_PAIRS = {"diagonal": (True, (0, 0, 16, 16, 3 * CP_BLOCK, 3 * CP_BLOCK)),
            "off-diagonal": (False, (0, 0, 16, 16, 3 * CP_BLOCK, 0))}


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events). A
    device-side sleep queued first lets the host enqueue every call before
    the first one runs, so a call shorter than its own Python launch
    overhead is timed back to back on the device, not at the host's pace
    (the sleep covers up to 1 ms of host time per call: an autograd
    backward call takes ~0.5 ms on the host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(iters * 2e6))  # ~1 ms per call at <= 2 GHz
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def rotation_copies(live_bytes: int) -> int:
    """How many copies of a case's K/V a timed loop rotates over so that
    they hold at least twice the L2's bytes: each launch then reads its
    live K/V from HBM, as a model's layers do."""
    return max(2, math.ceil(2 * L2_BYTES / live_bytes))


def decode_case(dtype, *, b=8, h=16, d=64, page_size=16, n_logical=64,
                copies=8, seed=0):
    """GPT-345M decode shapes: 8 rows of 16 heads of 64 over a pool of
    1 + 8*64 pages. Windows drawn from 1..1024 with page-boundary ends,
    starts > 0 and rows 0/1 sharing their first 4 physical pages; the trash
    page and every slot outside a window hold large finite values. The
    pool is replicated ``copies`` times (like a model's layers) so timed
    launches read it cold from HBM, not from the 50 MB L2."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    num_pages = 1 + b * n_logical
    cap = n_logical * page_size
    ends = torch.randint(1, cap + 1, (b,), generator=g)
    ends[1], ends[2], ends[3] = cap, 1, 37 * page_size   # boundaries, end=1
    starts = torch.zeros(b, dtype=torch.int64)
    starts[4] = 5
    starts[5] = torch.randint(0, int(ends[5]), (1,), generator=g)[0]
    ends[0] = max(int(ends[0]), 5 * page_size)           # spans the shared pages
    tables = torch.zeros(b, n_logical, dtype=torch.int32)
    for r in range(b):
        live = range(int(starts[r]) // page_size,
                     (int(ends[r]) - 1) // page_size + 1)
        for j in live:
            tables[r, j] = 1 + r * n_logical + j
    tables[1, :4] = tables[0, :4]                         # shared prefix pages
    q = torch.randn(b, 1, h, d, generator=g).to(dtype)
    pools = []
    for _ in range(copies):
        k = torch.randn(num_pages, page_size, h, d, generator=g)
        v = torch.randn(num_pages, page_size, h, d, generator=g)
        for t in (k, v):
            t[0] = 3.0e4  # trash page: large finite garbage
        pools.append((k.to(dtype), v.to(dtype)))
    # slots of a row's boundary pages that lie outside its window: garbage
    for r in range(b):
        for lo_hi in ((0, int(starts[r])), (int(ends[r]), cap)):
            for p in range(*lo_hi):
                page = int(tables[r, p // page_size])
                if page and not (r == 0 and p < 4 * page_size):
                    for k, v in pools:
                        k[page, p % page_size] = 1.0e4
                        v[page, p % page_size] = -1.0e4
    dev = torch.device(DEVICE)
    return {"q": q.to(dev), "tables": tables.to(dev),
            "starts": starts.to(torch.int32).to(dev),
            "ends": ends.to(torch.int32).to(dev),
            "pools": [(k.to(dev), v.to(dev)) for k, v in pools],
            "page_size": page_size}


def decode_bound(case, dtype, quant: bool = False) -> tuple:
    """(bytes, flops) the function must move and do on this case's data:
    each live K/V vector read once (shared pages once; at int8 d bytes and
    its fp32 scale), q read and out written once, the live table entries
    and window bounds read once."""
    q, tables, ps = case["q"], case["tables"].cpu(), case["page_size"]
    b, _, h, d = q.shape
    item = torch.tensor([], dtype=dtype).element_size()
    vector = d + 4 if quant else d * item  # bytes of one cached K or V
    live = set()
    live_pos = 0
    for r in range(b):
        s, e = int(case["starts"][r]), int(case["ends"][r])
        live_pos += e - s
        for p in range(s, e):
            live.add((int(tables[r, p // ps]), p % ps))
    pages = {pg for pg, _ in live}
    nbytes = (len(live) * h * vector * 2 + 2 * b * h * d * item
              + 4 * len(pages) + 8 * b)
    flops = live_pos * h * 4 * d  # q·k and p·v, 2 flops per multiply-add
    return nbytes, flops


def flash_inputs(dtype, *, b=8, s=1024, h=16, d=64, copies=3, seed=0):
    """GPT-345M (d 64) or GPT-1.3B (d 128) training shapes. Each of
    ``copies`` sets holds q, k, v as strided views of one fused
    [b, s, h, 3d] buffer (as the qkv projection hands them to the kernels)
    and dO; timed launches rotate over the sets so their operands (4 x 16.8
    MB in bf16 at d 64) come cold from HBM."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    sets = []
    for _ in range(copies):
        qkv = torch.randn(b, s, h, 3 * d, generator=g, device=DEVICE)
        q, k, v = qkv.to(dtype).split(d, dim=-1)
        do = torch.randn(b, s, h, d, generator=g, device=DEVICE).to(dtype)
        sets.append((q, k, v, do))
    return sets


def flash_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The backward's delta = rowsum(dO∘O), fp32 [b*h, s], from [b, s, h, d]
    dO and the forward's out (as the autograd backward computes it)."""
    b, s, h, _ = out.shape
    return (do.float() * out.float()).sum(-1).transpose(1, 2).reshape(
        b * h, s).contiguous()


def sdpa_times(sets, causal: bool, iters: int = 30) -> dict:
    """PyTorch's fused attention on the sets' q, k, v and dO, a yardstick
    the port never calls: ``scaled_dot_product_attention`` forward, and its
    backward (dQ, dK and dV in one call), at dropout 0, in PyTorch's
    [b, h, s, d] layout; ms under ``"forward"`` and ``"backward"``."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd, bwd = [], []
    for q, k, v, do in sets:
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        out = sdpa(qt, kt, vt, is_causal=causal)
        fwd.append((qt.detach(), kt.detach(), vt.detach()))
        bwd.append((out, (qt, kt, vt), do.transpose(1, 2).contiguous()))
    it = iter(range(1 << 30))

    def forward():
        with torch.no_grad():
            sdpa(*fwd[next(it) % len(fwd)], is_causal=causal)

    def backward():
        out, inputs, dot = bwd[next(it) % len(bwd)]
        torch.autograd.grad(out, inputs, dot, retain_graph=True)

    return {"forward": cuda_ms(forward, iters=iters, warmup=3),
            "backward": cuda_ms(backward, iters=iters, warmup=3)}


def contiguous_cases() -> list:
    """(label, cache_len, starts, ends) of phase 9's contiguous caches:
    phase 10's decode cache halfway through the decode (its left pads, one
    end for every row, as ``generate()`` passes it); a 712-position cache
    (512-token pad + 200, ``fit_decode_blocks`` tile 8) and a 1024-position
    one (tile 256), with left pads, ``end=1`` and ends on tile borders."""
    width = max(GEN_PROMPT_LENS)
    pads = [width - n for n in GEN_PROMPT_LENS]
    return [
        ("generate", 512, pads, [width + 100] * 8),
        ("block_k 8", 712, [0, 0, 5, 200, 17, 1, 96, 40],
         [712, 1, 320, 616, 480, 704, 592, 240]),
        ("block_k 256", 1024, [0, 3, 100, 0, 0, 300, 7, 64],
         [1024, 256, 512, 768, 1, 900, 1000, 1024]),
    ]


def contiguous_case(dtype, cache_len, starts, ends, *, quant, h=16, d=64,
                    seed=0) -> dict:
    """Contiguous decode caches [8, cache_len, 16, 64] on the card: K/V in
    ``dtype`` or int8 with fp32 scales (``quantize_kv``), large finite
    values at every slot outside a row's window, as many caches (like a
    model's layers) as :func:`rotation_copies` of their live bytes, so
    timed launches read them cold from HBM."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    b = len(starts)
    starts_t = torch.tensor(starts, dtype=torch.int32, device=dev)
    ends_t = torch.tensor(ends, dtype=torch.int32, device=dev)
    pos = torch.arange(cache_len, device=dev)
    dead = ((pos[None] < starts_t[:, None].long())
            | (pos[None] >= ends_t[:, None].long()))  # [b, cache_len]
    q = torch.randn(b, 1, h, d, generator=g, device=dev).to(dtype)
    item = torch.tensor([], dtype=dtype).element_size()
    vector = d + 4 if quant else d * item  # bytes of one cached K or V
    copies = rotation_copies(int((~dead).sum()) * h * vector * 2)
    caches = []
    for _ in range(copies):
        kv = []
        for garbage in (1.0e4, -1.0e4):
            x = torch.randn(b, cache_len, h, d, generator=g, device=dev)
            x[dead] = garbage
            kv.append(quantize_kv(x) if quant else (x.to(dtype), None))
        (k, ks), (v, vs) = kv
        caches.append({"k": k, "v": v, "k_scale": ks, "v_scale": vs})
    return {"q": q, "starts": starts_t, "ends": ends_t, "caches": caches,
            "dead": dead}
