"""The layout of the ranks: pipeline × data × context × tensor parallelism.

Port of the JAX package's ``parallel/mesh.py`` (:50-117) for the four
axes the port runs, ``pp``, ``dp``, ``cp`` and ``mp``. The world is laid
out as the JAX mesh lays out its devices, ``(pp, dp, fsdp, cp, mp)`` with
the later axes fastest (:84-104): with fsdp at 1, rank = ((pp_rank · dp +
dp_rank) · cp + cp_rank) · mp + mp_rank, so the ranks of one mp group are
adjacent, a cp ring strides by mp and a pipeline strides by dp · cp · mp.
Each rank belongs to

- one mp group (the ranks of one stage that split the heads, the MLP and
  the vocab of one replica and hold the same tokens),
- one cp group (the ring of ranks with the same pp, dp and mp rank that
  split a batch's sequence),
- one data group (dp × cp of one stage: the ranks with the same pp and mp
  rank, which hold different tokens; losses, mask counts and gradients
  are summed over it),
- one pp group (the stages of one (dp, cp, mp) coordinate, in stage
  order: activations pass along it), and, at pp > 1, one embedding group
  (the first and the last stage of that coordinate, which hold the two
  copies of the tied word embedding).

Sharded-data (fsdp/ZeRO) and expert parallelism above 1 raise
``NotImplementedError`` naming the ROADMAP Queue A item that ports them
("fsdp / ZeRO and elastic resume", "Other families and the rest of the
toolkit"), and so does pp together with cp ("Pipeline parallelism").

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
    """The (pp, dp, cp, mp) layout of the world as seen from ``rank``. A
    group is None where its axis holds this rank alone."""

    def __init__(self, dp: int = 1, cp: int = 1, rank: int = 0,
                 cp_group=None, *, mp: int = 1, mp_group=None,
                 data_group=None, pp: int = 1, pp_group=None,
                 embed_group=None):
        self.dp, self.cp, self.mp, self.rank = (int(dp), int(cp), int(mp),
                                                int(rank))
        self.pp = int(pp)
        self.cp_group, self.mp_group = cp_group, mp_group
        self.data_group, self.pp_group = data_group, pp_group
        self.embed_group = embed_group

    @property
    def world(self) -> int:
        return self.pp * self.dp * self.cp * self.mp

    @property
    def mp_rank(self) -> int:
        return self.rank % self.mp

    @property
    def cp_rank(self) -> int:
        return (self.rank // self.mp) % self.cp

    @property
    def dp_rank(self) -> int:
        return (self.rank // (self.cp * self.mp)) % self.dp

    @property
    def pp_rank(self) -> int:
        return self.rank // (self.dp * self.cp * self.mp)

    @property
    def is_first_stage(self) -> bool:
        return self.pp_rank == 0

    @property
    def is_last_stage(self) -> bool:
        return self.pp_rank == self.pp - 1

    @property
    def cp_ranks(self) -> Tuple[int, ...]:
        """Global ranks of this rank's cp group, in ring order."""
        base = ((self.pp_rank * self.dp + self.dp_rank) * self.cp
                * self.mp + self.mp_rank)
        return tuple(base + i * self.mp for i in range(self.cp))

    @property
    def pp_ranks(self) -> Tuple[int, ...]:
        """Global ranks of this rank's pipeline, in stage order."""
        stride = self.dp * self.cp * self.mp
        return tuple(self.rank % stride + p * stride for p in range(self.pp))

    @property
    def data_world(self) -> int:
        """How many ranks of one stage hold different tokens (dp × cp)."""
        return self.dp * self.cp

    def __repr__(self) -> str:
        return (f"Mesh(pp={self.pp}, dp={self.dp}, cp={self.cp}, "
                f"mp={self.mp}, rank={self.rank}, pp_rank={self.pp_rank}, "
                f"dp_rank={self.dp_rank}, cp_rank={self.cp_rank}, "
                f"mp_rank={self.mp_rank})")


_MESH: Optional[Mesh] = None
_MESH_KEY = None


def get_mesh() -> Mesh:
    """The current mesh (a single rank's when none was built)."""
    return _MESH if _MESH is not None else Mesh()


def _key(dp: int, cp: int, mp: int, pp: int = 1):
    """What a current mesh must match to be handed back: its degrees and
    the process group it was built over."""
    up = dist.is_available() and dist.is_initialized()
    return dp, cp, mp, pp, id(dist.group.WORLD) if up else None


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Make ``mesh`` current (None: back to a single rank's)."""
    global _MESH, _MESH_KEY
    _MESH = mesh
    _MESH_KEY = None if mesh is None else _key(mesh.dp, mesh.cp, mesh.mp,
                                               mesh.pp)


def build_mesh(dp: int = 1, cp: int = 1, mp: int = 1, pp: int = 1) -> Mesh:
    """The (pp, dp, cp, mp) mesh over the initialised world (a single
    process when there is none), with this rank's mp, cp, data, pp and
    embedding process groups (None for an axis of one rank). Every rank
    must call it, in the same order as every other collective: each group
    is created on all ranks."""
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    if pp * dp * cp * mp != world:
        raise ValueError(f"pp {pp} x dp {dp} x cp {cp} x mp {mp} = "
                         f"{pp * dp * cp * mp} ranks, but the world has "
                         f"{world}")
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

    index = [(p, d, c, m) for p in range(pp) for d in range(dp)
             for c in range(cp) for m in range(mp)]  # rank order: mp fastest

    def members(key, keep=lambda p: True):
        out = {}
        for r, coords in enumerate(index):
            if keep(coords[0]):
                out.setdefault(key(*coords), []).append(r)
        return list(out.values())

    mp_group = groups(members(lambda p, d, c, m: (p, d, c)))
    cp_group = groups(members(lambda p, d, c, m: (p, d, m)))
    data_group = groups(members(lambda p, d, c, m: (p, m)))
    pp_group = groups(members(lambda p, d, c, m: (d, c, m)))
    # the tied word embedding's copies: the first and the last stage of
    # one (dp, cp, mp) coordinate (the reference's SharedLayerDesc)
    embed_group = groups(members(lambda p, d, c, m: (d, c, m),
                                 keep=lambda p: p in (0, pp - 1)))
    return Mesh(dp, cp, rank, cp_group, mp=mp, mp_group=mp_group,
                data_group=data_group, pp=pp, pp_group=pp_group,
                embed_group=embed_group)


# the degrees the port refuses above 1, and the title of the ROADMAP
# Queue A item that ports each
_UNPORTED_DEGREES = {
    "ep_degree": "Other families and the rest of the toolkit",
    "sharding.sharding_degree": "fsdp / ZeRO and elastic resume",
}


def mesh_from_config(cfg) -> Mesh:
    """The current mesh for ``cfg``'s ``Distributed`` section: built (and
    made current) on the first call, the same object while the degrees and
    the world stay the same. ``ep_degree`` or ``sharding.sharding_degree``
    above 1 raise ``NotImplementedError`` naming the ROADMAP item that
    ports it, and so does ``pp_degree`` together with ``cp_degree`` above
    1 ("Pipeline parallelism": pp × cp is not ported)."""
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
    mp, pp = d.get("mp_degree") or 1, d.get("pp_degree") or 1
    if pp > 1 and cp > 1:
        raise NotImplementedError(f"Distributed.pp_degree={pp} with "
                                  f"cp_degree={cp} is not ported yet "
                                  "(ROADMAP Queue A, \"Pipeline "
                                  "parallelism\": pp x cp)")
    if _MESH is None or _key(dp, cp, mp, pp) != _MESH_KEY:
        set_mesh(build_mesh(dp, cp, mp, pp))
    return _MESH


def get_data_world(mesh: Mesh) -> int:
    """The number of distinct data shards (dp; fsdp is not ported). Every
    stage of a pipeline reads its replica's batch: the first stage needs
    the tokens, the last the labels and the loss mask."""
    return mesh.dp
