"""The attention kernels of the training and decode paths on the card, timed
so that two trees can be held against each other in one call.

    python fleetx_tpu_torch/tools/attention_kernel_check.py [--root DIR] \
        [--out FILE]

- B1, B2 and B3 (``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``) at
  ``chip_smoke.py`` phase 6's shapes (b 8, s 1024, h 16, causal, bf16,
  dropout 0.1): GPT-345M (d 64), GPT-1.3B (d 128) and an mp 2 rank of
  GPT-1.3B (8 heads of 16 as strided views of a fused-qkv shard, the
  rank's global-head meta), the backward on the forward's lse and delta;
- B11's entries (``block_fwd_lse``, ``block_dq``, ``block_dkv``) on phase
  15's pairs (b 1, h 16, d 128, s_blk 4096, bf16, dropout 0.1): the full
  pair across blocks and the diagonal one;
- SDPA's backward (dQ, dK and dV in one call, dropout 0) beside each of
  those shapes and pairs (causal on phase 6's shapes and the diagonal
  pair, no mask on the full pair): the yardstick of B2 + B3;
- B7 and B9 on phase 10's decode cache (phase 9's "generate" case), B8 on
  phase 3's pools and B10 on them quantized, bf16;
- B1 at phase 6's d 64 and d 128 shapes again, causal and not, at dropout
  0 and 0.1, beside SDPA's causal forward: what the softmax's masks and
  keep mask cost the kernel.

Each time is the mean of CUDA events over launches that rotate over copies
of the inputs (past the 50 MB L2 where the path reads them cold), behind
a device-sleep backlog (``kernel_cases.cuda_ms``). Each case also gives the
SHA-256 of its output on the first copy, so that two trees can be shown
to compute the same bits.

``--root`` imports ``fleetx_tpu_torch`` from another checkout, such as an
earlier commit unpacked by ``git archive``; the inputs and the timer come
from this checkout's ``kernel_cases.py`` (``chip_smoke.py``'s cases), so
both trees see the same data.
Run it in the order parent, change, change, parent within one call. Prints
the card's name and power limit, then one JSON object. Needs a GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cases():
    """This checkout's ``kernel_cases`` module, loaded from its file: the
    package on the path may be another tree's (``--root``)."""
    spec = importlib.util.spec_from_file_location(
        "kernel_cases", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "kernel_cases.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().view(torch.uint8)
                          .cpu().numpy().tobytes()).hexdigest()[:16]


def _rotating(fn, n: int):
    it = iter(range(1 << 30))
    return lambda: fn(next(it) % n)


def _timed(kc, run, n: int, iters: int) -> dict:
    """ms of ``run`` rotated over ``n`` input sets, and the digest of its
    output on the first (a tuple's parts concatenated)."""
    first = run(0)
    if isinstance(first, tuple):
        first = torch.cat([t.reshape(-1) for t in first])
    return {"ms": kc.cuda_ms(_rotating(run, n), iters=iters, warmup=3),
            "digest": _digest(first)}


def flash_times(kc, fa) -> dict:
    """B1, B2 and B3 at phase 6's three shapes, B11's entries on phase 15's
    two pairs, and SDPA's backward beside each: ms (and, for the port's
    kernels, output digest) by case."""
    out = {}
    bf16 = torch.bfloat16
    for label, d, h, meta in (("d64", 64, 16, None), ("d128", 128, 16, None),
                              ("mp", 128, kc.FLASH_MP_META[2],
                               kc.FLASH_MP_META)):
        sets = kc.flash_inputs(bf16, d=d, h=h)
        kw = dict(causal=True, dropout_rate=0.1, seed=-1234567, meta=meta)
        staged = []
        for q, k, v, do in sets:
            o, lse = fa.flash_fwd(q, k, v, **kw)
            staged.append((q, k, v, do, lse, kc.flash_delta(do, o)))
        runs = {"b1": lambda i: fa.flash_fwd(*sets[i][:3], **kw)[0],
                "b2": lambda i: fa.flash_bwd_dq(*staged[i], **kw),
                "b3": lambda i: fa.flash_bwd_dkv(*staged[i], **kw)}
        for name, run in runs.items():
            out[f"{name}_{label}"] = _timed(kc, run, len(sets), 30)
        out[f"sdpa_bwd_{label}"] = kc.sdpa_times(sets, True)["backward"]
        del sets, staged
    sets = kc.flash_inputs(bf16, b=1, s=kc.CP_BLOCK, h=16, d=128, copies=2,
                           seed=15)
    for label, pair in (("full", "off-diagonal"), ("diagonal", "diagonal")):
        causal, meta = kc.CP_PAIRS[pair]
        kw = dict(causal=causal, dropout_rate=0.1, kv_len=kc.CP_SEQ)
        staged = []
        for q, k, v, do in sets:
            o, lse = fa.block_fwd_lse(q, k, v, kc.CP_SEED, meta, **kw)
            staged.append((q, k, v, do, lse, (do.float() * o.float()).sum(-1)))
        runs = {
            "b11_fwd": lambda i: fa.block_fwd_lse(
                *sets[i][:3], kc.CP_SEED, meta, **kw)[0],
            "b11_dq": lambda i: fa.block_dq(*staged[i], kc.CP_SEED, meta,
                                            **kw),
            "b11_dkv": lambda i: fa.block_dkv(*staged[i], kc.CP_SEED, meta,
                                              **kw)}
        for name, run in runs.items():
            out[f"{name}_{label}"] = _timed(kc, run, len(sets), 20)
        out[f"sdpa_bwd_{label}"] = kc.sdpa_times(sets, causal,
                                                 iters=20)["backward"]
        del staged
    del sets
    torch.cuda.empty_cache()
    return out


def variant_times(kc, fa) -> dict:
    """B1 at d 64 and 128 (b 8, s 1024, h 16, bf16), causal and not, at
    dropout 0 and 0.1, and SDPA's causal forward on the same inputs."""
    out = {}
    for d in (64, 128):
        sets = kc.flash_inputs(torch.bfloat16, d=d, h=16)
        for causal in (True, False):
            for rate in (0.0, 0.1):
                def run(i, causal=causal, rate=rate):
                    return fa.flash_fwd(*sets[i][:3], causal=causal,
                                        dropout_rate=rate, seed=5)[0]
                out[f"b1_d{d}_{'causal' if causal else 'full'}_p{rate}"] = \
                    kc.cuda_ms(_rotating(run, len(sets)), iters=30, warmup=3)
        qt = [tuple(x.transpose(1, 2).contiguous() for x in st[:3])
              for st in sets]

        def sdpa(i):
            return torch.nn.functional.scaled_dot_product_attention(
                *qt[i], is_causal=True)

        out[f"sdpa_d{d}_causal"] = kc.cuda_ms(_rotating(sdpa, len(qt)),
                                              iters=30, warmup=3)
        del sets, qt
    torch.cuda.empty_cache()
    return out


def decode_times(kc, da) -> dict:
    """B7 and B9 on phase 10's cache, B8 on phase 3's pools, B10 on them
    quantized (bf16): ms and output digest by kernel."""
    from fleetx_tpu_torch.ops.quant import quantize_kv

    bf16 = torch.bfloat16
    out = {}
    label, cache_len, starts, ends = kc.contiguous_cases()[0]
    for name, quant in (("decode", False), ("decode_q8", True)):
        case = kc.contiguous_case(bf16, cache_len, starts, ends, quant=quant)
        q, caches = case["q"], case["caches"]
        kw = dict(end=case["ends"], starts=case["starts"])

        def run(i, q=q, caches=caches, kw=kw):
            c = caches[i]
            return da.decode_attention(q, c["k"], c["v"], k_scale=c["k_scale"],
                                       v_scale=c["v_scale"], **kw)

        out[name] = {"case": label, "ms": kc.cuda_ms(
            _rotating(run, len(caches)), iters=200), "digest": _digest(run(0))}
        del case, caches
    case = kc.decode_case(bf16)
    q, pools = case["q"], case["pools"]
    kw = dict(tables=case["tables"], end=case["ends"], starts=case["starts"])
    nbytes, _ = kc.decode_bound(case, bf16, quant=True)
    quantized = [(quantize_kv(k.float()), quantize_kv(v.float()))
                 for k, v in pools]
    quantized = [quantized[i % len(quantized)]
                 for i in range(max(kc.rotation_copies(nbytes),
                                    len(quantized)))]

    def run_b8(i):
        k, v = pools[i]
        return da.paged_decode_attention(q, k, v, **kw)

    def run_b10(i):
        (k, ks), (v, vs) = quantized[i]
        return da.paged_decode_attention(q, k, v, k_scale=ks, v_scale=vs,
                                         **kw)

    for name, run, n in (("paged_decode", run_b8, len(pools)),
                         ("paged_decode_q8", run_b10, len(quantized))):
        out[name] = {"case": "phase 3 pools",
                     "ms": kc.cuda_ms(_rotating(run, n), iters=200),
                     "digest": _digest(run(0))}
    del case, pools, quantized
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose fleetx_tpu_torch is timed (default: "
                         "this one)")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # the kernels' package from --root; the inputs and the timer from this
    # checkout
    sys.path.insert(0, os.path.abspath(args.root))
    from fleetx_tpu_torch.ops import decode_attention as da
    from fleetx_tpu_torch.ops import flash_attention as fa

    kc = _cases()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"root": args.root, "module": fa.__file__, "card": card,
              "flash": flash_times(kc, fa), "decode": decode_times(kc, da),
              "variants_ms": variant_times(kc, fa)}
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
