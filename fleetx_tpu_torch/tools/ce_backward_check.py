"""The fused-CE kernels on the card, beyond what ``chip_smoke.py``
checks: the backward kernels B5 (``ce_dh``) and B6 (``ce_dw``) over many
draws of the cotangent, and the times of all three with B12's forward.

    python fleetx_tpu_torch/tools/ce_backward_check.py [--root DIR] \
        [--seeds 50] [--skip-sweep] [--accumulation] [--out FILE]

- The sweep: the bf16 cases of the CE card tests in
  ``tests/test_torch_cuda.py`` (their shapes and data), each with
  ``--seeds`` draws of the cotangent besides the test's own. Every draw
  goes through ``ce_loss.fp64_checks``: B5 and B6 against their plain
  versions under ``CE_TOL``, aware of dl's rounding flips
  (``ce_loss.grads_gaps``), and against fp64 products of their own dl.
  It needs a tree whose ``ce_loss`` has ``fp64_checks``.
- The times: B4 (``ce_fwd``), B5 and B6 at the GPT-1.3B head (n 8192,
  E 2048, V 50304, bf16) and at ``chip_smoke.py``'s fp32 case (n 1024,
  E 256, V 8192), and B12's forward (B4 on mp rank 0's vocab shard of
  25152, labels over the whole vocab, about half off the shard), CUDA
  events over 10 calls after 2; with the SHA-256 of each forward's
  (loss, lse), so that two trees can be shown to compute the same bits.

- The accumulation (``--accumulation``): B4's lse at 2048 tokens over a
  vocab shard of 25600, E 2048 and 12288, W ~ N(0, 0.02²) and N(0,
  0.05²), as its largest ratio to ``CE_TOL``'s stats bound from the lse
  of an fp64 product, beside the plain version's and cuBLAS's bf16
  tensor-core GEMM's (fp32 output); and the share of B5's and B6's bf16
  outputs that move from their plain versions (``grads_gaps``), whose
  limit is ``CE_TOL``'s 10%.

``--root`` imports ``fleetx_tpu_torch`` from another checkout, such as an
earlier commit unpacked by ``git archive``, so that one call can hold two
versions on the same card. Prints the card's name and power limit, then
one JSON object. Needs a GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

# (n, E, V, data seed, the test's cotangent seed, how the test draws it):
# "g" draws g and takes (a, b) = (g, -g), as test_ce_kernels_match_plain_
# versions; "ab" draws a and b apart, as test_ce_bf16_backward_kernels_
# against_an_fp64_product
SWEEP_CASES = {
    "one-tile-64": (64, 64, 384, 0, 128, "g"),
    "one-tile-128": (64, 128, 384, 0, 192, "g"),
    "ragged-tiles-64": (520, 64, 1216, 0, 584, "g"),
    "ragged-tiles-128": (520, 128, 1216, 0, 648, "g"),
    "fp64-ragged-tiles": (520, 128, 1216, 11, 11, "ab"),
    "fp64-ragged-chunks": (2056, 2048, 2112, 11, 11, "ab"),
}
TIME_CASES = {"bf16": (8192, 2048, 50304, torch.bfloat16),
              "fp32": (1024, 256, 8192, torch.float32)}


def ce_case(n, e, v, *, dtype, seed=0):
    """h [n, E], W [V, E] (scaled so that the softmax is not flat), labels
    with -1, both vocab ends and one past the end, on the card."""
    rng = np.random.RandomState(seed)
    h = torch.from_numpy(rng.randn(n, e).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.randn(v, e) * 3 / np.sqrt(e)).astype(
        np.float32)).to(dtype)
    labels = rng.randint(0, v, n).astype(np.int32)
    labels[:4] = [-1, 0, v - 1, v]
    return h.cuda(), w.cuda(), torch.from_numpy(labels).cuda()


def cotangents(n, seed, how):
    """(a, b) for the backward, drawn from a seeded generator on the card
    as the card tests draw them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.rand(n, device="cuda", generator=gen) + 0.5
    if how == "g":
        return a, -a
    return a, -(torch.rand(n, device="cuda", generator=gen) + 0.5)


def sweep(seeds: int) -> dict:
    """Per case and output (dh, dW): the draws whose check against the
    plain version fails (``vs_plain`` of ``ce_loss.fp64_checks``: CE_TOL,
    aware of dl's rounding flips), the worst and the test draw's strict
    tol ratio, and the worst of the other fp64 readings."""
    from fleetx_tpu_torch.ops import ce_loss as ce

    if not hasattr(ce, "fp64_checks"):
        raise SystemExit(f"{ce.__file__} has no fp64_checks: time it with "
                         "--skip-sweep")
    out = {}
    for case, (n, e, v, data_seed, test_seed, how) in SWEEP_CASES.items():
        h, w, labels = ce_case(n, e, v, dtype=torch.bfloat16, seed=data_seed)
        _, lse = ce.fused_ce_fwd(h, w, labels)
        draws = sorted(set(range(seeds)) | {test_seed})
        for wrt, name in (("h", "dh"), ("w", "dW")):
            row = {"draws": len(draws), "failed": [], "worst_tol_ratio": 0.0}
            for seed in draws:
                a, b = cotangents(n, seed, how)
                got = ce.fp64_checks(h, w, labels, a, b, lse, wrt)
                gap = got.pop("vs_plain")
                del got["got"]
                for k, x in got.items():
                    if k == "same_at_one_chunk":
                        row[k] = row.get(k, True) and x
                    else:
                        row[f"max_{k}"] = max(row.get(f"max_{k}", 0), x)
                if not gap["ok"]:
                    row["failed"].append(seed)
                row["worst_tol_ratio"] = max(row["worst_tol_ratio"],
                                             gap["tol_ratio"])
                row["strict_failures"] = row.get("strict_failures", 0) + (
                    gap["beyond"] > 0)
                row["max_accepted"] = max(row.get("max_accepted", 0),
                                          gap["accepted"])
                row["max_moved_share"] = max(row.get("max_moved_share", 0),
                                             gap["moved_share"])
                if seed == test_seed:
                    row["test_draw"] = {"seed": seed, **gap}
            out[f"{case}/{name}"] = row
    return out


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events, a
    device-side sleep queued first so that the host enqueues every call
    before the first one runs)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(iters * 2e6))
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def _digest(*tensors) -> str:
    sha = hashlib.sha256()
    for t in tensors:
        sha.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return sha.hexdigest()[:16]


def times() -> dict:
    """ms of B4, B5 and B6 per case of TIME_CASES, and of B12's forward at
    the 1.3B head's mp 2 shard; each forward's output digest."""
    from fleetx_tpu_torch.ops import ce_loss as ce

    out = {}
    for case, (n, e, v, dtype) in TIME_CASES.items():
        h, w, labels = ce_case(n, e, v, dtype=dtype, seed=7)
        a, b = cotangents(n, 7, "g")
        loss, lse = ce.fused_ce_fwd(h, w, labels)
        out[case] = {
            "ce_fwd": cuda_ms(lambda: ce.fused_ce_fwd(h, w, labels)),
            "ce_fwd_digest": _digest(loss, lse),
            "ce_dh": cuda_ms(lambda: ce.fused_ce_dh(h, w, labels, a, b, lse)),
            "ce_dw": cuda_ms(lambda: ce.fused_ce_dw(h, w, labels, a, b, lse))}
        if case == "bf16":
            v_loc = v // 2
            shard = w[:v_loc].contiguous()
            l_loc = ce.local_labels(labels, v_loc, 0)
            loss, lse = ce.fused_ce_fwd(h, shard, l_loc)
            out["bf16_shard"] = {
                "vp_ce_fwd": cuda_ms(lambda: ce.fused_ce_fwd(h, shard, l_loc)),
                "vp_ce_fwd_digest": _digest(loss, lse)}
            del shard, l_loc
        del h, w, labels, a, b, loss, lse
        torch.cuda.empty_cache()
    return out


def accumulation() -> dict:
    """The ``--accumulation`` readings by case ("E <hidden> W <std>")."""
    from fleetx_tpu_torch.ops import ce_loss as ce

    n, v = 2048, 25600
    atol, rtol, _ = ce.CE_TOL[torch.bfloat16]["stats"]
    out = {}
    for e in (2048, 12288):
        for w_std in (0.02, 0.05):
            g = torch.Generator(device="cuda").manual_seed(0)
            h = torch.randn(n, e, generator=g, device="cuda").bfloat16()
            w = (torch.randn(v, e, generator=g, device="cuda")
                 * w_std).bfloat16()
            labels = torch.randint(0, v, (n,), generator=g, device="cuda",
                                   dtype=torch.int32)
            mask = (torch.rand(n, generator=g, device="cuda") > 0.2).float()
            a = mask / mask.sum()
            _, lse = ce.fused_ce_fwd(h, w, labels)
            _, lse_plain = ce.fused_ce_fwd_ref(h, w, labels)
            lse64 = torch.logsumexp(h.double() @ w.double().t(), -1)
            lse_tc = torch.logsumexp(torch.mm(
                h, w.t(), out_dtype=torch.float32).double(), -1)
            bound = atol * lse64.abs().max() + rtol * lse64.abs()
            case = {f"lse_{k}": round(((x.double() - lse64).abs()
                                       / bound).max().item(), 4)
                    for k, x in (("kernel", lse), ("plain", lse_plain),
                                 ("library", lse_tc))}
            for wrt, fn, ref in (("h", ce.fused_ce_dh, ce.fused_ce_dh_ref),
                                 ("w", ce.fused_ce_dw, ce.fused_ce_dw_ref)):
                gaps = ce.grads_gaps(
                    fn(h, w, labels, a, -a, lse),
                    ref(h, w, labels, a, -a, lse),
                    lambda wrt=wrt: ce.kernel_readings(h, w, labels, a, -a,
                                                       lse, wrt))
                case["moved_" + ("dh" if wrt == "h" else "dW")] = round(
                    gaps["moved_share"], 4)
            out[f"E {e} W {w_std}"] = case
            del h, w, lse64, lse_tc
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="checkout whose fleetx_tpu_torch is held (default: this one)")
    ap.add_argument("--seeds", type=int, default=50)
    ap.add_argument("--skip-sweep", action="store_true")
    ap.add_argument("--accumulation", action="store_true")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from fleetx_tpu_torch.ops import ce_loss as ce

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"root": args.root, "module": ce.__file__, "card": card,
              "times_ms": times()}
    if not args.skip_sweep:
        result["sweep"] = sweep(args.seeds)
    if args.accumulation:
        result["accumulation"] = accumulation()
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
