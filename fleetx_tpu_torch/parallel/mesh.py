"""The layout of the ranks: data × context × tensor parallelism.

Port of the JAX package's ``parallel/mesh.py`` (:50-117) for the three
axes the port runs, ``dp``, ``cp`` and ``mp``. The world is laid out as
the JAX mesh lays out its devices, ``(pp, dp, fsdp, cp, mp)`` with the
later axes fastest (:104): with pp and fsdp at 1, rank = (dp_rank · cp +
cp_rank) · mp + mp_rank, so the ranks of one mp group are adjacent and a
cp ring strides by mp. Each rank belongs to

- one mp group (the ranks that split the heads, the MLP and the vocab of
  one replica and hold the same tokens),
- one cp group (the ring of ranks with the same dp and mp rank that split
  a batch's sequence), and
- one data group (dp × cp: the ranks with the same mp rank, which hold
  different tokens; losses, mask counts and gradients are summed over it).

Pipeline, sharded-data (fsdp/ZeRO) and expert parallelism above 1 raise
``NotImplementedError`` naming the ROADMAP Queue A item that ports them
("Pipeline parallelism", "fsdp / ZeRO and elastic resume", "Other
families and the rest of the toolkit").

One mesh is current per process (:func:`get_mesh`); the data loader, the
module, the model's parallel layers and the trainer read it.
:func:`mesh_from_config` builds it from a config's ``Distributed`` section
once and hands the same one back while the degrees and the process group
stay the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist

__all__ = ["Mesh", "build_mesh", "mesh_from_config", "get_mesh",
           "set_mesh", "get_data_world"]


class Mesh:
    """The (dp, cp, mp) layout of the world as seen from ``rank``. A group
    is None where its axis holds this rank alone."""

    def __init__(self, dp: int = 1, cp: int = 1, rank: int = 0,
                 cp_group=None, *, mp: int = 1, mp_group=None,
                 data_group=None):
        self.dp, self.cp, self.mp, self.rank = (int(dp), int(cp), int(mp),
                                                int(rank))
        self.cp_group, self.mp_group = cp_group, mp_group
        self.data_group = data_group

    @property
    def world(self) -> int:
        return self.dp * self.cp * self.mp

    @property
    def mp_rank(self) -> int:
        return self.rank % self.mp

    @property
    def cp_rank(self) -> int:
        return (self.rank // self.mp) % self.cp

    @property
    def dp_rank(self) -> int:
        return self.rank // (self.cp * self.mp)

    @property
    def cp_ranks(self) -> Tuple[int, ...]:
        """Global ranks of this rank's cp group, in ring order."""
        base = self.dp_rank * self.cp * self.mp + self.mp_rank
        return tuple(base + i * self.mp for i in range(self.cp))

    @property
    def data_world(self) -> int:
        """How many ranks hold different tokens (dp × cp)."""
        return self.dp * self.cp

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, cp={self.cp}, mp={self.mp}, "
                f"rank={self.rank}, dp_rank={self.dp_rank}, "
                f"cp_rank={self.cp_rank}, mp_rank={self.mp_rank})")


_MESH: Optional[Mesh] = None
_MESH_KEY = None


def get_mesh() -> Mesh:
    """The current mesh (a single rank's when none was built)."""
    return _MESH if _MESH is not None else Mesh()


def _key(dp: int, cp: int, mp: int):
    """What a current mesh must match to be handed back: its degrees and
    the process group it was built over."""
    up = dist.is_available() and dist.is_initialized()
    return dp, cp, mp, id(dist.group.WORLD) if up else None


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Make ``mesh`` current (None: back to a single rank's)."""
    global _MESH, _MESH_KEY
    _MESH = mesh
    _MESH_KEY = None if mesh is None else _key(mesh.dp, mesh.cp, mesh.mp)


def build_mesh(dp: int = 1, cp: int = 1, mp: int = 1) -> Mesh:
    """The (dp, cp, mp) mesh over the initialised world (a single process
    when there is none), with this rank's mp, cp and data process
    groups (None for an axis of one rank). Every rank must call it, in the
    same order as every other collective: each group is created on all
    ranks."""
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    if dp * cp * mp != world:
        raise ValueError(f"dp {dp} x cp {cp} x mp {mp} = {dp * cp * mp} "
                         f"ranks, but the world has {world}")
    if world == 1:
        return Mesh()
    rank = dist.get_rank()
    def groups(members):
        """Create one group per member list on every rank; this rank's."""
        mine = None
        for ranks in members:
            group = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if rank in ranks:
                mine = group
        return mine

    index = [(d, c, m) for d in range(dp) for c in range(cp)
             for m in range(mp)]  # rank order: mp fastest

    def members(key):
        out = {}
        for r, coords in enumerate(index):
            out.setdefault(key(*coords), []).append(r)
        return list(out.values())

    mp_group = groups(members(lambda d, c, m: (d, c)))
    cp_group = groups(members(lambda d, c, m: (d, m)))
    data_group = groups(members(lambda d, c, m: m))
    return Mesh(dp, cp, rank, cp_group, mp=mp, mp_group=mp_group,
                data_group=data_group)


# the degrees the port refuses above 1, and the title of the ROADMAP
# Queue A item that ports each
_UNPORTED_DEGREES = {
    "pp_degree": "Pipeline parallelism",
    "ep_degree": "Other families and the rest of the toolkit",
    "sharding.sharding_degree": "fsdp / ZeRO and elastic resume",
}


def mesh_from_config(cfg) -> Mesh:
    """The current mesh for ``cfg``'s ``Distributed`` section: built (and
    made current) on the first call, the same object while the degrees and
    the world stay the same. ``pp_degree``, ``ep_degree`` or
    ``sharding.sharding_degree`` above 1 raise ``NotImplementedError``
    naming the ROADMAP item that ports it."""
    d = cfg.get("Distributed") or {}
    for key, item in _UNPORTED_DEGREES.items():
        parent, _, leaf = key.rpartition(".")
        section = (d.get(parent) or {}) if parent else d
        value = section.get(leaf) or 1
        if value > 1:
            raise NotImplementedError(f"Distributed.{key}={value} is not "
                                      f"ported yet (ROADMAP Queue A, "
                                      f"\"{item}\")")
    dp, cp = d.get("dp_degree") or 1, d.get("cp_degree") or 1
    mp = d.get("mp_degree") or 1
    if _MESH is None or _key(dp, cp, mp) != _MESH_KEY:
        set_mesh(build_mesh(dp, cp, mp))
    return _MESH


def get_data_world(mesh: Mesh) -> int:
    """The number of distinct data shards (dp; fsdp is not ported)."""
    return mesh.dp
