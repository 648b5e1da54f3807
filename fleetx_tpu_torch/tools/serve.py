"""Fleet launcher: N replica processes behind one router + API process.

Port of the JAX package's ``tools/serve.py``, the deployable shape of the
serving stack:

    python -m fleetx_tpu_torch.tools.serve --demo --replicas 2 --port 8000

spawns one REPLICA subprocess per ``--replicas`` (a fresh interpreter,
never a fork of a process that has touched CUDA): each builds its own
engine on ``cuda:{index % device_count}`` (``--device cpu`` puts it on the
CPU), serves it over the
:mod:`~fleetx_tpu_torch.serving.api.replica_server` RPC on an ephemeral
port, and hands that port back through a port file. The FRONT DOOR runs
in this process: a :class:`~fleetx_tpu_torch.serving.router.ServingRouter`
over :class:`~fleetx_tpu_torch.serving.api.replica_client.ReplicaClient`
proxies, fronted by the OpenAI-compatible
:class:`~fleetx_tpu_torch.serving.api.server.ApiServer`. A replica process
dying mid-stream is absorbed by the router's zero-token-loss migration.

SIGTERM (or Ctrl-C) runs the graceful drain fan-out: router admission
stops, every replica gets ``request_shutdown`` over RPC (in-flight
requests finish, ``finish_reason="shutdown"`` at the grace deadline),
replica processes get SIGTERM and are reaped, and the launcher exits 0.

``--demo`` serves a deterministic tiny GPT (weights drawn on the CPU from
a seed, so every replica holds the same bits; token-id text codec:
prompts like ``"12 7 3"``). Without ``--device cpu`` the replicas need
CUDA: on a machine without it the launcher exits non-zero with the device
resolver's error. ``--autoscale`` closes the fleet-sizing loop with a
``FleetAutoscaler`` that spawns replica processes through
:func:`spawn_replica` and drains them back out.

Env knobs: ``FLEETX_SERVE_REPLICAS``, ``FLEETX_API_PORT``,
``FLEETX_API_HOST``, ``FLEETX_SERVE_GRACE_S``.

Internal: ``--replica-worker`` is the subprocess entry point (not for
operators); :func:`run_replica_worker` takes an engine builder, so another
program can serve its own engine through the same worker code.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PORT_WAIT_S = 120.0
DEMO_STD = 0.3  # the demo weights' std (init_params draws at 0.02)


def _replica_device(device_index: int, device: Optional[str] = None):
    """The device replica ``device_index`` serves on: ``device`` when it
    names one (``"cpu"``, ``"cuda:1"``), else ``cuda:{index % count}``.
    Raises without CUDA unless the CPU is asked for."""
    import torch

    from fleetx_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", device_index % torch.cuda.device_count())
    return dev


def demo_model(device_index: int = 0, seed: int = 0,
               device: Optional[str] = None):
    """The deterministic tiny GPT: ``(model, params, gen_cfg, device)``,
    vocab 61, hidden 32, one layer, fp32, greedy with 8 new tokens; its
    weights drawn on the CPU from ``seed`` (``init_params``, the kernels
    and embeddings scaled to std DEMO_STD so that greedy streams do not
    collapse to one token) and moved to the replica's device
    (:func:`_replica_device`), so every replica holds the same bits."""
    import torch

    from fleetx_tpu_torch.models.gpt.convert import init_params
    from fleetx_tpu_torch.models.gpt.generation import GenerationConfig
    from fleetx_tpu_torch.models.gpt.model import GPTConfig, GPTForPretraining

    dev = _replica_device(device_index, device)
    cfg = GPTConfig(
        vocab_size=61, hidden_size=32, num_layers=1,
        num_attention_heads=2, ffn_hidden_size=64,
        max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, dtype=torch.float32)
    gen_cfg = GenerationConfig(decode_strategy="greedy",
                               eos_token_id=10**6, pad_token_id=60,
                               max_length=8)
    params = {k: (v if k.endswith((".scale", ".bias"))
                  else v * (DEMO_STD / 0.02)).to(dev)
              for k, v in init_params(cfg, seed=seed, device="cpu").items()}
    return GPTForPretraining(cfg, device="meta"), params, gen_cfg, dev


def _build_demo_engine(device_index: int, seed: int = 0,
                       device: Optional[str] = None):
    """The demo engine over :func:`demo_model`: 4 lanes of 32 positions,
    pages of 8."""
    from fleetx_tpu_torch.serving import ServingEngine

    model, params, gen_cfg, dev = demo_model(device_index, seed, device)
    return ServingEngine(model, params, device=dev, slots=4, cache_len=32,
                         gen_cfg=gen_cfg, prefill_bucket=4, paged=True,
                         page_size=8)


def write_port_file(path: str, port: int) -> None:
    """Publish ``port`` atomically (a reader never sees a partial file)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(port))
    os.replace(tmp, path)


def run_replica_worker(args, build: Optional[Callable] = None,
                       on_drained: Optional[Callable] = None) -> int:
    """Subprocess entry: build the engine (``build(device_index,
    device)``, default the demo engine), serve it over the replica RPC,
    publish the port, and on SIGTERM stop admitting, drain what is in
    flight, call ``on_drained(engine)`` and exit 0."""
    from fleetx_tpu_torch.serving.api.replica_server import ReplicaServer
    from fleetx_tpu_torch.utils.log import logger

    stopping: List[int] = []

    def on_term(signum, frame):
        stopping.append(signum)

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    build = build or _build_demo_engine
    engine = build(args.device_index, device=args.device)
    server = ReplicaServer(engine, port=args.rpc_port).start()
    write_port_file(args.port_file, server.port)
    logger.info("serve: replica %d ready on %s (%s)", args.device_index,
                server.url, engine.device)
    while not stopping:
        time.sleep(0.05)
    # graceful: stop admitting, finish what is in flight, then exit 0 (the
    # router usually drove request_shutdown over RPC already; it is
    # idempotent). Under the server's lock: RPCs may still arrive.
    with server.locked() as eng:
        eng.request_shutdown(args.grace_s)
        eng.drain(max_ticks=2000)
        if on_drained is not None:
            on_drained(eng)
    server.stop()
    return 0


def _worker_argv(index: int, port_file: str, grace_s: float,
                 device: Optional[str]) -> List[str]:
    argv = [sys.executable, "-m", "fleetx_tpu_torch.tools.serve",
            "--replica-worker", "--device-index", str(index),
            "--port-file", port_file, "--grace-s", str(grace_s)]
    return argv + (["--device", device] if device else [])


def wait_for_port(proc: subprocess.Popen, port_file: str, index: int,
                  deadline: float) -> str:
    """The URL replica ``index`` publishes in ``port_file``; raises when
    the process exits first or ``deadline`` (monotonic) passes (a replica
    that cannot bind or import is a launch failure, not a hang)."""
    while not os.path.exists(port_file):
        if proc.poll() is not None:
            raise RuntimeError(f"replica {index} exited rc={proc.returncode}"
                               " before publishing its port")
        if time.monotonic() > deadline:
            raise RuntimeError(f"replica {index} never published its port")
        time.sleep(0.05)
    with open(port_file) as f:
        return f"http://127.0.0.1:{int(f.read().strip())}"


def _spawn_replicas(n: int, grace_s: float, tmpdir: str,
                    device: Optional[str] = None):
    """Launch the replica subprocesses together; returns (procs, urls)
    once every port file has appeared (raises after PORT_WAIT_S)."""
    procs, port_files = [], []
    for i in range(n):
        pf = os.path.join(tmpdir, f"replica_{i}.port")
        port_files.append(pf)
        procs.append(subprocess.Popen(_worker_argv(i, pf, grace_s, device),
                                      cwd=ROOT))
    deadline = time.monotonic() + PORT_WAIT_S
    urls = [wait_for_port(p, pf, i, deadline)
            for i, (p, pf) in enumerate(zip(procs, port_files))]
    return procs, urls


def spawn_replica(tmpdir: str, index: int, grace_s: float = 30.0,
                  connect_wait_s: float = 30.0,
                  device: Optional[str] = None):
    """Launch ONE more replica subprocess and hand back a connected
    ``ReplicaClient`` with its process: the autoscaler's ``spawn_fn``
    seam. Same worker entry and port-file handshake as the launch-time
    fleet. Raises on launch failure."""
    from fleetx_tpu_torch.serving.api.replica_client import ReplicaClient

    pf = os.path.join(tmpdir, f"replica_{index}.port")
    if os.path.exists(pf):
        os.remove(pf)  # a reused index must not read a stale port
    proc = subprocess.Popen(_worker_argv(index, pf, grace_s, device),
                            cwd=ROOT)
    try:
        url = wait_for_port(proc, pf, index,
                            time.monotonic() + PORT_WAIT_S)
    except RuntimeError:
        proc.kill()
        proc.wait()
        raise
    return ReplicaClient(url, connect_wait_s=connect_wait_s), proc


def stop_replicas(procs, grace_s: float) -> List[Optional[int]]:
    """SIGTERM every live replica process, wait for each (SIGKILL after
    ``grace_s`` + 30 s), and return their exit codes."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=grace_s + 30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)
    return [p.returncode for p in procs]


def run_fleet(args) -> int:
    """Parent entry: replicas → router over RPC → API, then serve until
    SIGTERM and drain the whole fleet."""
    from fleetx_tpu_torch.serving.api.replica_client import ReplicaClient
    from fleetx_tpu_torch.serving.api.server import ApiServer
    from fleetx_tpu_torch.serving.router import ServingRouter
    from fleetx_tpu_torch.utils.log import logger

    replicas = args.replicas or int(
        os.environ.get("FLEETX_SERVE_REPLICAS", "2"))
    grace_s = (args.grace_s if args.grace_s is not None
               else float(os.environ.get("FLEETX_SERVE_GRACE_S", "30")))
    port = (args.port if args.port is not None
            else int(os.environ.get("FLEETX_API_PORT", "8000")))
    host = args.host or os.environ.get("FLEETX_API_HOST", "127.0.0.1")

    stopping: List[int] = []

    def on_term(signum, frame):
        stopping.append(signum)

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    with tempfile.TemporaryDirectory(prefix="fleetx_serve_") as tmpdir:
        procs: list = []
        api = None
        try:
            spawned, urls = _spawn_replicas(replicas, grace_s, tmpdir,
                                            args.device)
            procs.extend(spawned)
            clients = [ReplicaClient(u, connect_wait_s=30) for u in urls]
            router = ServingRouter(clients)
            scaler = None
            if args.autoscale:
                from fleetx_tpu_torch.serving.autoscaler import (
                    FleetAutoscaler,
                )

                next_index = [replicas]

                def spawn():
                    try:
                        client, proc = spawn_replica(
                            tmpdir, next_index[0], grace_s,
                            device=args.device)
                    except Exception as e:  # noqa: BLE001 — skip this round
                        logger.error("serve: scale-up spawn failed: %s", e)
                        return None
                    procs.append(proc)
                    next_index[0] += 1
                    return client

                scaler = FleetAutoscaler(router, spawn,
                                         min_replicas=replicas,
                                         grace_s=grace_s)
            api = ApiServer(router, port=port, host=host,
                            model_id=args.model_id).start()
            if args.api_port_file:
                write_port_file(args.api_port_file, api.port)
            logger.info(
                "serve: fleet of %d replicas up — OpenAI API at %s/v1 "
                "(model id %r)", replicas, api.url, args.model_id)
            while not stopping:
                if all(p.poll() is not None for p in procs):
                    logger.error("serve: every replica process exited; "
                                 "shutting the front door down")
                    break
                if scaler is not None:
                    with api._lock:  # the driver thread ticks the router
                        scaler.step()
                time.sleep(0.1)
            logger.info("serve: draining fleet (grace %.0fs)", grace_s)
            with api._lock:  # no driver tick interleaves the drain
                router.shutdown(grace_s)  # request_shutdown fan-out
        finally:
            if api is not None:
                api.stop()
            codes = stop_replicas(procs, grace_s)
            logger.info("serve: replica exit codes %s", codes)
    logger.info("serve: fleet drained; bye")
    return 0


def main(argv=None) -> int:
    """CLI entry point."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--demo", action="store_true",
                    help="serve the deterministic tiny demo GPT")
    ap.add_argument("--replicas", type=int, default=None,
                    help="replica process count "
                         "(default $FLEETX_SERVE_REPLICAS or 2)")
    ap.add_argument("--port", type=int, default=None,
                    help="API port (default $FLEETX_API_PORT or 8000; "
                         "0 = ephemeral)")
    ap.add_argument("--host", default=None,
                    help="API bind host (default $FLEETX_API_HOST or "
                         "127.0.0.1)")
    ap.add_argument("--model-id", default="fleetx-demo",
                    help="model id served at /v1/models")
    ap.add_argument("--grace-s", type=float, default=None,
                    help="drain grace (default $FLEETX_SERVE_GRACE_S or 30)")
    ap.add_argument("--device", default=None,
                    help="the replicas' device: 'cpu' for the plain PyTorch "
                         "path; default CUDA (cuda:{index %% count})")
    ap.add_argument("--autoscale", action="store_true",
                    help="close the fleet-sizing loop: a FleetAutoscaler "
                         "watches replica health and spawns/drains replica "
                         "processes (FLEETX_AUTOSCALE_* knobs)")
    ap.add_argument("--api-port-file", default=None,
                    help="write the bound API port here once serving "
                         "(handshake for tests/scripts)")
    # internal subprocess plumbing
    ap.add_argument("--replica-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--device-index", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rpc-port", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port-file", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.replica_worker:
        return run_replica_worker(args)
    if not args.demo:
        ap.error("only --demo is wired up so far: real checkpoints plug "
                 "in by replacing _build_demo_engine")
    from fleetx_tpu_torch.utils.device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 1
    return run_fleet(args)


if __name__ == "__main__":
    sys.exit(main())
