"""Profiler summary views of the port's ``Trainer``.

Port of the JAX package's ``utils/profiler_summary.py``: the same four
views, chosen by ``Profiler.summary`` with a ``detailed`` override, from
what PyTorch exposes:

- overview: wall-time statistics of the profiled steps (the Trainer's
  ticks);
- model: the bytes of the parameters and of the optimizer state, and the
  model FLOPs per step from the formula the port's MFU uses (the port has
  no XLA cost analysis to ask);
- kernel: top ops by total self time, parsed from the Chrome trace that
  ``torch.profiler`` wrote under ``{log_dir}/plugins/profile/<run>/``
  (the JAX package's layout), by JAX's leaf-op and self-time rules: keep
  the device tracks when there are any, drop the step and module wrapper
  lines, and take each event's duration minus its direct children's;
- mem: ``torch.cuda.memory_stats`` of the trainer's card.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from fleetx_tpu_torch.utils.log import logger

__all__ = ["kernel_table", "print_summary", "trace_path"]

_DEFAULT_VIEWS = ("overview", "model", "kernel", "mem")
_ALL_VIEWS = ("overview", "model", "kernel", "mem")
# event categories of work on the card in a torch.profiler trace
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _selected_views(profiler_cfg: Dict) -> List[str]:
    if profiler_cfg.get("detailed"):
        return list(_ALL_VIEWS)
    chosen = profiler_cfg.get("summary") or {}
    return [v for v in _ALL_VIEWS if chosen.get(v, v in _DEFAULT_VIEWS)]


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} PiB"


def _rule(title: str) -> str:
    pad = max(4, 72 - len(title) - 2)
    return f"--- {title} {'-' * pad}"


def trace_path(log_dir: str, run: str, rank: int) -> str:
    """Where a profiling window's trace goes: JAX's
    ``{log_dir}/plugins/profile/<run>/<host>.trace.json.gz``, one file per
    rank."""
    return os.path.join(log_dir, "plugins", "profile", run,
                        f"rank{rank}.trace.json.gz")


def _overview(step_times: List[float]):
    logger.info(_rule("profiler overview"))
    if not step_times:
        logger.info("no step timings collected in the profiled window")
        return
    t = np.asarray(step_times)
    logger.info(
        "steps profiled: %d | step time mean %.2f ms, min %.2f ms, "
        "max %.2f ms, p50 %.2f ms",
        t.size, t.mean() * 1e3, t.min() * 1e3, t.max() * 1e3,
        float(np.percentile(t, 50)) * 1e3,
    )


def _model(trainer):
    logger.info(_rule("model view"))
    params = list(trainer.module.nets.parameters())
    p_bytes = sum(p.numel() * p.element_size() for p in params)
    logger.info("params: %.1fM (%s on this rank) | opt state: %s",
                trainer.n_params / 1e6, _fmt_bytes(p_bytes),
                _fmt_bytes(trainer.opt_state_device_bytes()))
    flops = trainer.flops_per_step()
    if flops is not None:
        logger.info("model flops (per step, the MFU formula): %.2f GFLOP; "
                    "no XLA cost analysis in the port", flops / 1e9)


def kernel_table(trace_file: str) -> List[Tuple[str, float, int]]:
    """``[(op, total self time in us, calls)]`` of the trace in
    ``trace_file``, largest first (the kernel view's ranking)."""
    opener = gzip.open if trace_file.endswith(".gz") else open
    with opener(trace_file, "rt") as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])
    # pid -> process name: keep the device tracks and drop the python host
    # threads, which would otherwise double-count everything
    proc_names = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            proc_names[ev.get("pid")] = (ev.get("args") or {}).get("name", "")
    device_pids = {
        pid for pid, name in proc_names.items()
        if any(s in name for s in ("TPU", "GPU", "/device:", "XLA Op"))
    }
    device_pids |= {ev.get("pid") for ev in events
                    if ev.get("ph") == "X" and ev.get("cat") in _DEVICE_CATS}
    # a leaf-op line, where the trace has one: wrapper lines (modules,
    # steps) span whole steps and would double-count everything beneath
    thread_names = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            thread_names[(ev.get("pid"), ev.get("tid"))] = (
                (ev.get("args") or {}).get("name", ""))
    op_tracks = {key for key, name in thread_names.items()
                 if name == "XLA Ops"}
    wrapper_tracks = {key for key, name in thread_names.items()
                      if name in ("Steps", "XLA Modules", "Framework Ops")}
    per_track = defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        if device_pids and ev.get("pid") not in device_pids:
            continue
        key = (ev.get("pid"), ev.get("tid"))
        if op_tracks:
            if key not in op_tracks:
                continue
        elif key in wrapper_tracks:
            continue
        per_track[key].append(ev)
    # self time: on one track events nest; sweep in start order with a
    # stack of open intervals, each event's self time its duration minus
    # its direct children's
    totals = defaultdict(float)
    counts = defaultdict(int)
    for track in per_track.values():
        track.sort(key=lambda e: (e["ts"], -e["dur"]))
        open_nodes = []  # [name, end_ts, child_total, dur]

        def _close(node):
            totals[node[0]] += max(0.0, node[3] - node[2])
            counts[node[0]] += 1

        for ev in track:
            ts, dur = ev["ts"], ev["dur"]
            while open_nodes and ts >= open_nodes[-1][1] - 1e-9:
                _close(open_nodes.pop())
            if open_nodes:
                open_nodes[-1][2] += dur
            open_nodes.append([ev["name"], ts + dur, 0.0, dur])
        while open_nodes:
            _close(open_nodes.pop())
    return [(name, dur, counts[name]) for name, dur in
            sorted(totals.items(), key=lambda kv: -kv[1])]


def _kernel(log_dir: str, top_k: int = 15,
            trace_file: Optional[str] = None):
    logger.info(_rule("kernel view (top ops by self time)"))
    if trace_file is None:
        traces = sorted(
            glob.glob(os.path.join(log_dir, "plugins", "profile", "*",
                                   "*.trace.json.gz")),
            key=os.path.getmtime)
        if not traces:
            logger.info("no trace found under %s", log_dir)
            return
        trace_file = traces[-1]
    try:
        table = kernel_table(trace_file)
    except Exception as e:
        logger.info("trace unreadable (%s): %s", trace_file, e)
        return
    if not table:
        logger.info("trace had no complete device events")
        return
    grand = sum(dur for _, dur, _ in table)
    logger.info("%-48s %10s %8s %7s", "op", "total(us)", "calls", "%")
    for name, dur, calls in table[:top_k]:
        shown = name if len(name) <= 48 else name[:45] + "..."
        logger.info("%-48s %10.0f %8d %6.1f%%", shown, dur, calls,
                    100.0 * dur / grand)


def _mem(device):
    logger.info(_rule("memory view"))
    import torch

    if getattr(device, "type", None) != "cuda":
        logger.info("device memory stats not exposed on this platform")
        return
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    logger.info("%s: in use %s | peak %s | reserved %s | limit %s",
                torch.cuda.get_device_name(device),
                _fmt_bytes(stats.get("allocated_bytes.all.current", 0)),
                _fmt_bytes(stats.get("allocated_bytes.all.peak", 0)),
                _fmt_bytes(stats.get("reserved_bytes.all.current", 0)),
                _fmt_bytes(total))


def print_summary(trainer, profiler_cfg: Dict, log_dir: str,
                  step_times: Optional[List[float]] = None,
                  trace_file: Optional[str] = None):
    """Print the configured summary views after a profiling window
    closes (``trace_file``: this rank's trace; the newest under
    ``log_dir`` when None)."""
    views = _selected_views(profiler_cfg)
    if "overview" in views:
        _overview(step_times or [])
    if "model" in views:
        _model(trainer)
    if "kernel" in views:
        _kernel(log_dir, trace_file=trace_file)
    if "mem" in views:
        _mem(trainer.device)
    logger.info("full timeline: %s (chrome://tracing or Perfetto)",
                trace_file or log_dir)
