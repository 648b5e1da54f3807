"""The serving path's decode ticks on the card, so that two trees can be
held against each other in one call.

    python fleetx_tpu_torch/tools/serving_check.py [--root DIR] [--out FILE]
        [--chunk N] [--spec K]

Runs ``chip_smoke.py`` phase 4 (8 requests through a ``ServingEngine`` at
GPT-345M width with bf16 KV pools: B8) and phase 11 (the same requests at
int8 KV: B10) from the ``chip_smoke.py`` of ``--root`` (default: this
checkout), over that tree's kernels, with the phases' own checks (launches
equal decode ticks x layers, the shared prefix reused, no page leaked).
``--root`` may be an earlier commit unpacked by ``git archive``. Run it in
the order parent, change, change, parent within one call: serving ticks
are host-bound, so TPOT moves with the host's pace between calls. Prints
the card's name and power limit, the phases' own lines, then one JSON
object with each phase's fields (tokens/s, TTFT and TPOT p50, ticks).
``--chunk N`` serves both phases with chunked prefill of N tokens
(``prefill_chunk``), ``--spec K`` with speculative decoding (the n-gram
proposer, k = K); the tree under ``--root`` must have the feature. Needs a
GPU.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose chip_smoke.py and kernels run "
                         "(default: this one)")
    ap.add_argument("--out", help="also write the JSON object here")
    ap.add_argument("--chunk", type=int, default=0,
                    help="prefill_chunk of both engines (0: off)")
    ap.add_argument("--spec", type=int, default=0,
                    help="speculative decoding with k = SPEC (0: off)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    # the root's chip_smoke puts its own checkout first on the path, so
    # that it drives that tree's package
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    fields = {}
    log = cs.log

    def kept(phase, **kw):
        if "tpot_ms_p50" in kw:
            fields[phase] = kw
        log(phase, **kw)

    cs.log = kept
    switches = {}
    if args.chunk:
        switches["prefill_chunk"] = args.chunk
    if args.spec:
        switches.update(spec=True, spec_k=args.spec)
    if switches:
        cs.build_engine = functools.partial(cs.build_engine, **switches)
    cs._build.build(cs.da.KERNEL)
    engine, cfg = cs.build_engine()
    served = cs.phase_serving(engine, cfg)
    del engine
    torch.cuda.empty_cache()
    cs.phase_int8_serving(served["kv_cache_bytes"])
    line = json.dumps({"root": root, "module": cs.da.__file__, "card": card,
                       "switches": switches, "phases": fields}, default=str)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
