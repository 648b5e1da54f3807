"""Run a function as the ranks of one process group on this host.

``python -m torch.distributed.run`` is the launcher of a training run; this
is the one of a program that drives ranks from inside Python (a test, a
smoke script): :func:`spawn` starts ``nprocs`` fresh interpreters, each
joins the group through :func:`~fleetx_tpu_torch.parallel.env.init_dist_env`
(rendezvous on a free localhost port), runs ``fn(*args)`` and hands its
result back. A rank may return early (a rank that leaves an elastic
shrink) while the others go on. A rank that raises, dies or outlives
``timeout`` stops every rank, and the call raises. No rank outlives the
call; :data:`last_exitcodes` holds the ranks' exit codes of the last
call.

A fresh interpreter spends most of its start importing torch and the
port. :func:`use_forkserver` makes later calls fork their ranks from one
server process that imported those modules once; each rank still gets
the caller's environment as it is at the call (a preloaded module read
its own when the server started). :func:`stop_forkserver` ends the
server.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_lib
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

__all__ = ["spawn", "free_port", "last_exitcodes", "stop_forkserver",
           "use_forkserver"]

last_exitcodes: List[Optional[int]] = []  # of the last spawn, by rank
_START = {"method": "spawn"}  # how spawn starts its ranks


def use_forkserver(preload: Sequence[str]) -> None:
    """Start the ranks of later calls by forking them from a server
    process that imports ``preload`` (module names) once, instead of a
    fresh interpreter each. Nothing may have initialised CUDA in those
    modules' import."""
    multiprocessing.set_forkserver_preload(list(preload))
    _START["method"] = "forkserver"


def stop_forkserver() -> None:
    """End the fork server, if one runs (ranks go back to fresh
    interpreters)."""
    from multiprocessing import forkserver

    if _START["method"] == "forkserver":
        forkserver._forkserver._stop()
    _START["method"] = "spawn"


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_main(fn, args, rank, nprocs, port, device, threads, results,
               env):
    os.environ.clear()
    os.environ.update(env)  # the caller's, as at the call
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch

    from fleetx_tpu_torch.parallel.env import destroy_dist_env, init_dist_env

    if threads:
        torch.set_num_threads(threads)
    try:
        try:
            init_dist_env(device)
        except Exception as exc:  # noqa: BLE001 - classified, then re-raised
            if "EADDRINUSE" not in str(exc):
                raise
            # another process took the port after free_port chose it: the
            # parent starts the ranks again on another (nothing ran yet)
            results.put((rank, None, traceback.format_exc()))
            return
        results.put((rank, True, fn(*args)))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        destroy_dist_env()


class _PortTaken(RuntimeError):
    """The rendezvous port was taken before rank 0 could listen on it."""


def spawn(fn: Callable, nprocs: int, args: Sequence = (), *,
          device: Optional[str] = None, timeout: float = 600.0,
          threads: int = 0) -> List[Any]:
    """``[fn(*args) of rank 0, ..., of rank nprocs - 1]``, each run in its
    own process as a rank of one group of ``nprocs``. ``fn`` must be a
    module-level function of an importable module, and its result
    picklable; ``device`` is where the ranks compute (as for
    ``init_dist_env``: CUDA unless named); ``threads`` > 0 caps each
    rank's intra-op threads. When another process takes the rendezvous
    port before the group forms, the ranks start again on another, at
    most twice."""
    for attempt in range(3):
        try:
            return _spawn_once(fn, nprocs, args, device, timeout, threads)
        except _PortTaken:
            if attempt == 2:
                raise


def _spawn_once(fn, nprocs, args, device, timeout, threads) -> List[Any]:
    ctx = multiprocessing.get_context(_START["method"])
    results = ctx.Queue()
    port = free_port()
    env = dict(os.environ)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, tuple(args), rank, nprocs, port, device,
                               threads, results, env))
             for rank in range(nprocs)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < nprocs:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks of {fn.__name__} "
                                       f"did not finish in {timeout} s")
                continue
            if ok is None:
                raise _PortTaken(value)
            if not ok:
                raise RuntimeError(f"rank {rank} of {fn.__name__} "
                                   f"failed:\n{value}")
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30.0 if len(got) == nprocs else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        last_exitcodes[:] = [p.exitcode for p in procs]
    return [got[r] for r in range(nprocs)]
