"""The layout of the ranks: pipeline × data × sharded-data × context ×
tensor parallelism.

Port of the JAX package's ``parallel/mesh.py`` (:50-117). The world is
laid out as the JAX mesh lays out its devices, ``(pp, dp, fsdp, cp, mp)``
with the later axes fastest (:84-104): rank = (((pp_rank · dp + dp_rank)
· fsdp + fsdp_rank) · cp + cp_rank) · mp + mp_rank, so the ranks of one
mp group are adjacent, a cp ring strides by mp and a pipeline strides by
dp · fsdp · cp · mp. Each rank belongs to

- one mp group (the ranks of one stage that split the heads, the MLP and
  the vocab of one replica and hold the same tokens),
- one cp group (the ring of ranks with the same pp, dp, fsdp and mp rank
  that split a batch's sequence),
- one data group (dp × fsdp × cp of one stage: the ranks with the same
  pp and mp rank, which hold different tokens; losses and mask counts are
  summed over it, and so are the gradients),
- one zero group (dp × fsdp of one (pp, cp, mp) position, the axes
  ``("dp", "fsdp")`` of JAX's ``zero_update_spec``: the ranks over which
  the ZeRO weight-update shard splits the gradients, the AdamW update
  and its state, ``parallel/sharding.py``),
- one pp group (the stages of one (dp, fsdp, cp, mp) coordinate, in stage
  order: activations pass along it), and, at pp > 1, one embedding group
  (the first and the last stage of that coordinate, which hold the two
  copies of the tied word embedding).

The batch is split over dp × fsdp (:func:`get_data_world`, JAX
:113-114): a rank's rows are those of its data rank ``dp_rank · fsdp +
fsdp_rank``. ``Distributed.sharding`` at stages 1 and 2 shards the
optimizer state over fsdp (with the weight-update shard on, over dp
too); the parameters stay whole on every rank. Stage 3 (the parameters
sharded too), ``sharding_offload`` (the moments in host memory, which the
JAX package itself refuses off a TPU, core/engine.py:428-435) and pp
together with cp raise ``NotImplementedError`` naming the ROADMAP Queue
A item that ports them ("ZeRO stage 3 (parameter sharding)", "ZeRO
sharding offload", "Pipeline parallelism"). ``Distributed.ep_degree`` is
not read, as in JAX: an MoE model's experts split over the data ranks
(``parallel/moe.py``), as JAX shards its "expert" axis over ``("dp",
"fsdp")``.

One mesh is current per process (:func:`get_mesh`); the data loader, the
module, the model's parallel layers and the trainer read it.
:func:`mesh_from_config` builds it from a config's ``Distributed`` section
once and hands the same one back while the degrees and the process group
stay the same.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch.distributed as dist

__all__ = ["Mesh", "MeshConfig", "build_mesh", "mesh_from_config",
           "get_mesh", "set_mesh", "use_mesh", "get_data_world"]


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The parallel degrees of a ``Distributed`` section (copy of the JAX
    package's ``MeshConfig``, parallel/mesh.py:50-80)."""
    dp: int = 1
    fsdp: int = 1
    mp: int = 1
    pp: int = 1
    cp: int = 1
    sharding_stage: int = 1
    sharding_offload: bool = False

    @property
    def nranks(self) -> int:
        return self.dp * self.fsdp * self.mp * self.pp * self.cp

    @classmethod
    def from_dist_config(cls, dist_cfg) -> "MeshConfig":
        """Build from a normalized ``Distributed`` config section."""
        sharding = dist_cfg.get("sharding") or {}
        return cls(
            dp=dist_cfg.get("dp_degree") or 1,
            fsdp=sharding.get("sharding_degree") or 1,
            mp=dist_cfg.get("mp_degree") or 1,
            pp=dist_cfg.get("pp_degree") or 1,
            cp=dist_cfg.get("cp_degree") or 1,
            sharding_stage=sharding.get("sharding_stage") or 1,
            sharding_offload=bool(sharding.get("sharding_offload")),
        )


class Mesh:
    """The (pp, dp, fsdp, cp, mp) layout of the world as seen from
    ``rank``. A group is None where its axes hold this rank alone."""

    def __init__(self, dp: int = 1, cp: int = 1, rank: int = 0,
                 cp_group=None, *, mp: int = 1, mp_group=None,
                 data_group=None, pp: int = 1, pp_group=None,
                 embed_group=None, fsdp: int = 1, zero_group=None):
        self.dp, self.cp, self.mp, self.rank = (int(dp), int(cp), int(mp),
                                                int(rank))
        self.pp, self.fsdp = int(pp), int(fsdp)
        self.cp_group, self.mp_group = cp_group, mp_group
        self.data_group, self.pp_group = data_group, pp_group
        self.embed_group, self.zero_group = embed_group, zero_group

    @property
    def world(self) -> int:
        return self.pp * self.dp * self.fsdp * self.cp * self.mp

    @property
    def mp_rank(self) -> int:
        return self.rank % self.mp

    @property
    def cp_rank(self) -> int:
        return (self.rank // self.mp) % self.cp

    @property
    def fsdp_rank(self) -> int:
        return (self.rank // (self.cp * self.mp)) % self.fsdp

    @property
    def dp_rank(self) -> int:
        return (self.rank // (self.fsdp * self.cp * self.mp)) % self.dp

    @property
    def pp_rank(self) -> int:
        return self.rank // (self.dp * self.fsdp * self.cp * self.mp)

    @property
    def is_first_stage(self) -> bool:
        return self.pp_rank == 0

    @property
    def is_last_stage(self) -> bool:
        return self.pp_rank == self.pp - 1

    @property
    def cp_ranks(self) -> Tuple[int, ...]:
        """Global ranks of this rank's cp group, in ring order."""
        base = self.rank - self.cp_rank * self.mp
        return tuple(base + i * self.mp for i in range(self.cp))

    @property
    def pp_ranks(self) -> Tuple[int, ...]:
        """Global ranks of this rank's pipeline, in stage order."""
        stride = self.dp * self.fsdp * self.cp * self.mp
        return tuple(self.rank % stride + p * stride for p in range(self.pp))

    @property
    def data_world(self) -> int:
        """How many ranks of one stage hold different tokens (dp × fsdp ×
        cp)."""
        return self.dp * self.fsdp * self.cp

    @property
    def data_rank(self) -> int:
        """This rank's share of the batch's rows, of :func:`get_data_world`
        (JAX's batch dim over ``("dp", "fsdp")``)."""
        return self.dp_rank * self.fsdp + self.fsdp_rank

    @property
    def zero_world(self) -> int:
        """The size of the zero group (dp × fsdp)."""
        return self.dp * self.fsdp

    @property
    def zero_ranks(self) -> Tuple[int, ...]:
        """Global ranks of this rank's zero group, by data rank."""
        stride = self.cp * self.mp
        base = (self.pp_rank * self.zero_world * stride
                + self.rank % stride)
        return tuple(base + j * stride for j in range(self.zero_world))

    def config(self) -> MeshConfig:
        """The degrees of this mesh (the elastic planner's input)."""
        return MeshConfig(dp=self.dp, fsdp=self.fsdp, mp=self.mp, pp=self.pp,
                          cp=self.cp)

    def __repr__(self) -> str:
        return (f"Mesh(pp={self.pp}, dp={self.dp}, fsdp={self.fsdp}, "
                f"cp={self.cp}, mp={self.mp}, rank={self.rank}, "
                f"pp_rank={self.pp_rank}, dp_rank={self.dp_rank}, "
                f"fsdp_rank={self.fsdp_rank}, cp_rank={self.cp_rank}, "
                f"mp_rank={self.mp_rank})")


_MESH: Optional[Mesh] = None
_MESH_KEY = None


def get_mesh() -> Mesh:
    """The current mesh (a single rank's when none was built)."""
    return _MESH if _MESH is not None else Mesh()


def _key(mc: MeshConfig):
    """What a current mesh must match to be handed back: its degrees and
    the process group it was built over."""
    up = dist.is_available() and dist.is_initialized()
    return (mc.dp, mc.cp, mc.mp, mc.pp, mc.fsdp,
            id(dist.group.WORLD) if up else None)


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Make ``mesh`` current (None: back to a single rank's)."""
    global _MESH, _MESH_KEY
    _MESH = mesh
    _MESH_KEY = None if mesh is None else _key(mesh.config())


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """``mesh`` current for the block, the one before it current again
    after (a serving engine's device calls run under its own mesh)."""
    global _MESH, _MESH_KEY
    before = (_MESH, _MESH_KEY)
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        _MESH, _MESH_KEY = before


def build_mesh(dp: int = 1, cp: int = 1, mp: int = 1, pp: int = 1,
               fsdp: int = 1) -> Mesh:
    """The (pp, dp, fsdp, cp, mp) mesh over the initialised world (a
    single process when there is none), with this rank's mp, cp, data,
    zero, pp and embedding process groups (None for axes of one rank).
    Every rank must call it, in the same order as every other collective:
    each group is created on all ranks."""
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    if pp * dp * fsdp * cp * mp != world:
        raise ValueError(f"pp {pp} x dp {dp} x fsdp {fsdp} x cp {cp} x mp "
                         f"{mp} = {pp * dp * fsdp * cp * mp} ranks, but the "
                         f"world has {world}")
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

    index = [(p, d, f, c, m) for p in range(pp) for d in range(dp)
             for f in range(fsdp) for c in range(cp)
             for m in range(mp)]  # rank order: mp fastest

    def members(key, keep=lambda p: True):
        out = {}
        for r, coords in enumerate(index):
            if keep(coords[0]):
                out.setdefault(key(*coords), []).append(r)
        return list(out.values())

    mp_group = groups(members(lambda p, d, f, c, m: (p, d, f, c)))
    cp_group = groups(members(lambda p, d, f, c, m: (p, d, f, m)))
    data_group = groups(members(lambda p, d, f, c, m: (p, m)))
    # at cp 1 the zero group is the data group
    zero_group = (data_group if cp == 1 else
                  groups(members(lambda p, d, f, c, m: (p, c, m))))
    pp_group = groups(members(lambda p, d, f, c, m: (d, f, c, m)))
    # the tied word embedding's copies: the first and the last stage of
    # one (dp, fsdp, cp, mp) coordinate (the reference's SharedLayerDesc)
    embed_group = groups(members(lambda p, d, f, c, m: (d, f, c, m),
                                 keep=lambda p: p in (0, pp - 1)))
    return Mesh(dp, cp, rank, cp_group, mp=mp, mp_group=mp_group,
                data_group=data_group, pp=pp, pp_group=pp_group,
                embed_group=embed_group, fsdp=fsdp, zero_group=zero_group)


def mesh_from_config(cfg) -> Mesh:
    """The current mesh for ``cfg``'s ``Distributed`` section: built (and
    made current) on the first call, the same object while the degrees and
    the world stay the same. ``sharding_stage`` 3 at a
    ``sharding_degree`` above 1, ``sharding_offload`` and
    ``pp_degree`` together with ``cp_degree`` above 1 raise
    ``NotImplementedError`` naming the ROADMAP item that ports them."""
    d = cfg.get("Distributed") or {}
    mc = MeshConfig.from_dist_config(d)
    if mc.sharding_stage == 3 and mc.fsdp > 1:
        raise NotImplementedError(
            f"Distributed.sharding.sharding_stage=3 (sharding_degree "
            f"{mc.fsdp}) is not ported yet (ROADMAP Queue A, \"ZeRO stage 3 "
            "(parameter sharding)\"); stages 1 and 2 are")
    if mc.sharding_offload:
        raise NotImplementedError(
            "Distributed.sharding.sharding_offload=True is not ported yet "
            "(ROADMAP Queue A, \"ZeRO sharding offload\"; the JAX package "
            "lowers it on a TPU only)")
    if mc.pp > 1 and mc.cp > 1:
        raise NotImplementedError(f"Distributed.pp_degree={mc.pp} with "
                                  f"cp_degree={mc.cp} is not ported yet "
                                  "(ROADMAP Queue A, \"Pipeline "
                                  "parallelism\": pp x cp)")
    if _MESH is None or _key(mc) != _MESH_KEY:
        set_mesh(build_mesh(mc.dp, mc.cp, mc.mp, mc.pp, mc.fsdp))
    return _MESH


def get_data_world(mesh: Mesh) -> int:
    """The number of distinct data shards, dp × fsdp (JAX :113-114).
    Every stage of a pipeline reads its replica's batch: the first stage
    needs the tokens, the last the labels and the loss mask."""
    return mesh.dp * mesh.fsdp
