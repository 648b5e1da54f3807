"""The process group and the seeds of a multi-process run.

Port of the JAX package's ``parallel/env.py`` (:30-103). A launcher such as
``python -m torch.distributed.run`` describes the run in the environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``); :func:`init_dist_env` joins that group.
Each rank computes on card ``LOCAL_RANK % device_count``. The backend
follows from the cards, never from a config: NCCL when every local rank
has a card of its own, gloo when ranks share a card (NCCL cannot put two
ranks on one card) or compute on the CPU. A single process is a no-op.
:func:`shrink_dist_env` re-forms the group at a smaller size on one host,
for the elastic supervisor (``resilience/elastic.py``).
"""

from __future__ import annotations

import os
import random
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from fleetx_tpu_torch.utils.device import resolve_device
from fleetx_tpu_torch.utils.log import logger

__all__ = ["init_dist_env", "set_seed", "get_rank", "get_world_size",
           "ranks_per_card", "destroy_dist_env", "shrink_dist_env"]

_RANKS_PER_CARD = 1


def get_rank() -> int:
    """This process's rank in the world (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    """The number of ranks (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def ranks_per_card() -> int:
    """How many local ranks share one card (1 when each has its own)."""
    return _RANKS_PER_CARD


def init_dist_env(device: Optional[Union[str, torch.device]] = None,
                  store: Optional[dist.Store] = None) -> Optional[str]:
    """Join the process group the launcher's environment describes and
    return its backend; None (and nothing done) for a single process or a
    group that is already up. ``device`` is where the ranks compute: CUDA
    unless the caller names another (raises without CUDA, as every entry
    point does); a CUDA rank takes card ``LOCAL_RANK % device_count``.
    The ranks meet at ``tcp://MASTER_ADDR:MASTER_PORT`` unless a ``store``
    is given."""
    global _RANKS_PER_CARD
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return None
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % cards)
        _RANKS_PER_CARD = -(-local_world // cards)
        if _RANKS_PER_CARD == 1:
            backend = "nccl"
    if store is None:
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = os.environ["MASTER_PORT"]
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                                rank=rank, world_size=world)
    else:
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
    if rank == 0:
        logger.info("distributed: %d ranks over %s on %s (%d rank(s) per "
                    "card)", world, backend, dev.type, _RANKS_PER_CARD)
    return backend


def destroy_dist_env() -> None:
    """Leave the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def shrink_dist_env(world: int,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> bool:
    """Re-form the process group with its first ``world`` ranks, on this
    host. Every rank of the current group calls it: rank 0 picks a free
    port and sends it to the others over the old group, every rank
    leaves the old group (and the current mesh is dropped), and the ranks
    below ``world`` join a new one of that size (``init_dist_env`` on
    ``device``) through a store that rank 0 serves on the new port. False
    on a rank that is outside the new world: it holds no group when this
    returns.

    The store is made here rather than by a ``tcp://`` rendezvous: under
    ``python -m torch.distributed.run`` (``TORCHELASTIC_USE_AGENT_STORE=
    True``) that rendezvous makes every rank a client of the launcher's
    store, and the launcher does not listen on the new port."""
    from fleetx_tpu_torch.parallel.launch import free_port
    from fleetx_tpu_torch.parallel.mesh import set_mesh

    rank = get_rank()
    port = [free_port() if rank == 0 else None]
    dist.broadcast_object_list(port, src=0)
    destroy_dist_env()
    set_mesh(None)
    if rank >= world:
        return False
    os.environ.update(WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                      MASTER_PORT=str(port[0]))
    addr = os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
    if world > 1:
        init_dist_env(device, dist.TCPStore(addr, port[0], world,
                                            is_master=rank == 0))
    return True


def set_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's generators with ``seed`` on every
    rank alike: the ranks then draw the same weights and dropout seeds, as
    the JAX package's one root key gives every device the same stream."""
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
