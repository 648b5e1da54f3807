"""The load-time contract of elastic training.

Port of :func:`validate_restore_mesh` and :class:`ElasticMeshMismatch`
from the JAX package's ``resilience/elastic.py`` (:54-96). A checkpoint
records the mesh it was written under (``meta["mesh"]``); a load onto
another mesh may change dp (each data replica holds the same parameters,
so a rank reads the file of its own stage and mp rank), never mp, pp or
cp, whose extents are baked into the saved shards and stages. A refused load is a
configuration error, not corruption: ``Trainer.load`` re-raises it and
quarantines nothing.

The supervisor that shrinks the mesh after a host loss (JAX
``plan_shrunken_mesh``, ``run_elastic``, ``apply_mesh_to_config``) waits
for ROADMAP Queue A "fsdp / ZeRO and elastic resume".
"""

from __future__ import annotations

from typing import Optional

from fleetx_tpu_torch.utils.log import logger

__all__ = ["ElasticMeshMismatch", "validate_restore_mesh"]

# axes whose extent is baked into the saved arrays (vocab and head shards
# ~ mp, layer placement ~ pp, sequence split ~ cp): a checkpoint cannot
# move across a change in any of these, only across dp/fsdp
_FIXED_AXES = ("mp", "pp", "cp")


class ElasticMeshMismatch(RuntimeError):
    """A checkpoint cannot be restored onto this mesh: an axis whose
    extent is baked into the saved arrays differs. A configuration error,
    not checkpoint corruption."""


def validate_restore_mesh(saved: dict, mesh, step: Optional[int] = None
                          ) -> None:
    """Check a checkpoint's recorded mesh ``saved`` (``{"dp", "fsdp",
    "mp", "pp", "cp"}``) against the restoring ``mesh`` (any object with
    those attributes; the port's ``Mesh`` has no fsdp axis and counts it
    as 1). mp/pp/cp must agree, or :class:`ElasticMeshMismatch` is
    raised; a dp/fsdp change is logged."""
    def now(ax):
        return int(getattr(mesh, ax, 1))

    bad = {}
    for ax in _FIXED_AXES:
        was = int(saved.get(ax) or 1)
        if was != now(ax):
            bad[ax] = (was, now(ax))
    if bad:
        detail = ", ".join(f"{ax} {was}->{cur}"
                           for ax, (was, cur) in bad.items())
        raise ElasticMeshMismatch(
            f"checkpoint{'' if step is None else f' step {step}'} was written "
            f"under an incompatible mesh: {detail} (mp/pp/cp extents are "
            "baked into array shapes; only dp/fsdp may change on restore)")
    was_dp = int(saved.get("dp") or 1)
    was_fsdp = int(saved.get("fsdp") or 1)
    if (was_dp, was_fsdp) != (now("dp"), now("fsdp")):
        logger.info("elastic reshard-on-load: checkpoint mesh dp%d x fsdp%d "
                    "-> dp%d x fsdp%d", was_dp, was_fsdp, now("dp"),
                    now("fsdp"))
