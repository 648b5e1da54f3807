"""The layout of the ranks: data parallelism × context parallelism.

Port of the JAX package's ``parallel/mesh.py`` (:50-117) for the two axes
the port runs, ``dp`` and ``cp``. The world is laid out as the JAX mesh
lays out its devices, ``(pp, dp, fsdp, cp, mp)`` with the later axes
fastest: with pp, fsdp and mp at 1, rank = dp_rank · cp + cp_rank, so the
ranks of one cp group are adjacent. Each rank belongs to one cp group (the
ring of ranks that share a batch and split its sequence) and one dp group
(the ranks that hold the same sequence slice of different batches).
Tensor, pipeline, sharded-data (fsdp/ZeRO) and expert parallelism above 1
raise ``NotImplementedError`` (ROADMAP A6).

One mesh is current per process (:func:`get_mesh`); the data loader, the
module and the trainer read it. :func:`mesh_from_config` builds it from a
config's ``Distributed`` section once and hands the same one back while the
degrees and the process group stay the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist

__all__ = ["Mesh", "build_mesh", "mesh_from_config", "get_mesh",
           "set_mesh", "get_data_world"]


class Mesh:
    """The (dp, cp) layout of the world as seen from ``rank``."""

    def __init__(self, dp: int = 1, cp: int = 1, rank: int = 0,
                 cp_group=None, dp_group=None):
        self.dp, self.cp, self.rank = int(dp), int(cp), int(rank)
        self.cp_group, self.dp_group = cp_group, dp_group

    @property
    def world(self) -> int:
        return self.dp * self.cp

    @property
    def cp_rank(self) -> int:
        return self.rank % self.cp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.cp

    @property
    def cp_ranks(self) -> Tuple[int, ...]:
        """Global ranks of this rank's cp group, in ring order."""
        base = self.dp_rank * self.cp
        return tuple(range(base, base + self.cp))

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, cp={self.cp}, rank={self.rank}, "
                f"dp_rank={self.dp_rank}, cp_rank={self.cp_rank})")


_MESH: Optional[Mesh] = None
_MESH_KEY = None


def get_mesh() -> Mesh:
    """The current mesh (a single rank's when none was built)."""
    return _MESH if _MESH is not None else Mesh()


def _key(dp: int, cp: int):
    """What a current mesh must match to be handed back: its degrees and
    the process group it was built over."""
    up = dist.is_available() and dist.is_initialized()
    return dp, cp, id(dist.group.WORLD) if up else None


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Make ``mesh`` current (None: back to a single rank's)."""
    global _MESH, _MESH_KEY
    _MESH = mesh
    _MESH_KEY = None if mesh is None else _key(mesh.dp, mesh.cp)


def build_mesh(dp: int = 1, cp: int = 1) -> Mesh:
    """The (dp, cp) mesh over the initialised world (a single process when
    there is none), with a new cp and dp process group for this rank.
    Every rank must call it, in the same order as every other collective:
    each group is created on all ranks."""
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    if dp * cp != world:
        raise ValueError(f"dp {dp} x cp {cp} = {dp * cp} ranks, but the "
                         f"world has {world}")
    if world == 1:
        return Mesh()
    rank = dist.get_rank()
    cp_group = dp_group = None
    for d in range(dp):  # cp groups: adjacent ranks
        group = dist.new_group(list(range(d * cp, (d + 1) * cp)))
        if d == rank // cp:
            cp_group = group
    for c in range(cp):  # dp groups: one rank of each cp group
        group = dist.new_group(list(range(c, world, cp)))
        if c == rank % cp:
            dp_group = group
    return Mesh(dp, cp, rank, cp_group, dp_group)


_UNPORTED_DEGREES = ("mp_degree", "pp_degree", "ep_degree")


def mesh_from_config(cfg) -> Mesh:
    """The current mesh for ``cfg``'s ``Distributed`` section: built (and
    made current) on the first call, the same object while the degrees and
    the world stay the same. ``mp_degree``, ``pp_degree``, ``ep_degree``
    or ``sharding.sharding_degree`` above 1 raise ``NotImplementedError``
    (ROADMAP A6)."""
    d = cfg.get("Distributed") or {}
    for key in _UNPORTED_DEGREES:
        if (d.get(key) or 1) > 1:
            raise NotImplementedError(f"Distributed.{key}={d.get(key)} is "
                                      "not ported yet (ROADMAP A6)")
    sharding = (d.get("sharding") or {}).get("sharding_degree") or 1
    if sharding > 1:
        raise NotImplementedError(f"Distributed.sharding.sharding_degree="
                                  f"{sharding} is not ported yet (ROADMAP "
                                  "A6)")
    dp, cp = d.get("dp_degree") or 1, d.get("cp_degree") or 1
    if _MESH is None or _key(dp, cp) != _MESH_KEY:
        set_mesh(build_mesh(dp, cp))
    return _MESH


def get_data_world(mesh: Mesh) -> int:
    """The number of distinct data shards (dp; fsdp is not ported)."""
    return mesh.dp
