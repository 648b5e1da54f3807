"""Elastic training: survive a host loss by shrinking the mesh and
resuming through reshard-on-load.

Port of the JAX package's ``resilience/elastic.py`` (:54-213):

- :func:`validate_restore_mesh` and :class:`ElasticMeshMismatch`, the
  load-time contract. A checkpoint records the mesh it was written under
  (``meta["mesh"]``); a load onto another mesh may change dp and fsdp
  (the state files hold whole tensors, and each rank takes its own
  slices of the AdamW state, ``core/engine.py``), never mp, pp or cp,
  whose extents are baked into the saved shards and stages. A refused
  load is a configuration error, not corruption: ``Trainer.load``
  re-raises it and quarantines nothing.
- :func:`plan_shrunken_mesh`: which axis gives up ranks after a loss, dp
  first, then fsdp; mp, pp and cp never shrink.
- :func:`apply_mesh_to_config`: the config rewritten for the smaller
  mesh with the global batch and the accumulation factor held fixed.
- :func:`run_elastic`, the supervisor ``tools/train.py`` runs ``fit``
  under. JAX shrinks its mesh inside one process; in the port every rank
  is a process, so on :class:`~fleetx_tpu_torch.resilience.faults.
  HostLossFault` every rank takes the emergency checkpoint together, the
  ranks outside the smaller world leave, and the others re-form the
  process group at the new size (``parallel/env.shrink_dist_env``),
  rebuild the mesh and the trainer, resume through reshard-on-load and
  go on from the first sample the run had not consumed, so every batch is
  consumed exactly once across the shrink.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from fleetx_tpu_torch.resilience.faults import HostLossFault
from fleetx_tpu_torch.utils.log import logger

__all__ = ["ElasticMeshMismatch", "apply_mesh_to_config",
           "plan_shrunken_mesh", "run_elastic", "validate_restore_mesh"]

# axes whose extent is baked into the saved arrays (vocab and head shards
# ~ mp, layer placement ~ pp, sequence split ~ cp): a checkpoint cannot
# move across a change in any of these, only across dp/fsdp
_FIXED_AXES = ("mp", "pp", "cp")


class ElasticMeshMismatch(RuntimeError):
    """A checkpoint cannot be restored onto this mesh (or the mesh cannot
    shrink): an axis whose extent is baked into the saved arrays differs.
    A configuration error, not checkpoint corruption."""


def validate_restore_mesh(saved: dict, mesh, step: Optional[int] = None
                          ) -> None:
    """Check a checkpoint's recorded mesh ``saved`` (``{"dp", "fsdp",
    "mp", "pp", "cp"}``) against the restoring ``mesh`` (any object with
    those attributes; 1 where one is missing). mp/pp/cp must agree, or
    :class:`ElasticMeshMismatch` is raised; a dp/fsdp change is logged."""
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
                    "-> dp%d x fsdp%d (ZeRO update layouts re-derived for "
                    "the new mesh)", was_dp, was_fsdp, now("dp"),
                    now("fsdp"))


def plan_shrunken_mesh(mesh_cfg, factor: int = 2):
    """The mesh (a ``MeshConfig``) to resume on after losing ``1 -
    1/factor`` of the ranks: dp capacity first (pure replication), then
    fsdp. mp/pp/cp never change (their extents are baked into the
    checkpoint), so a mesh with no data-parallel capacity to give up
    raises :class:`ElasticMeshMismatch`."""
    if mesh_cfg.dp > 1 and mesh_cfg.dp % factor == 0:
        return dataclasses.replace(mesh_cfg, dp=mesh_cfg.dp // factor)
    if mesh_cfg.fsdp > 1 and mesh_cfg.fsdp % factor == 0:
        return dataclasses.replace(mesh_cfg, fsdp=mesh_cfg.fsdp // factor)
    raise ElasticMeshMismatch(
        f"mesh dp{mesh_cfg.dp} x fsdp{mesh_cfg.fsdp} x mp{mesh_cfg.mp} x "
        f"pp{mesh_cfg.pp} x cp{mesh_cfg.cp} has no data-parallel capacity "
        f"to give up (cannot shrink by {factor}; mp/pp/cp extents are fixed "
        "by the checkpoint contract)")


def apply_mesh_to_config(cfg, new_mesh) -> None:
    """Rewrite ``cfg`` in place for a shrunken mesh, holding the
    optimization trajectory fixed: ``Global.global_batch_size`` and the
    accumulation factor ``local / micro`` are kept by scaling
    ``local_batch_size`` and ``micro_batch_size`` up by the lost
    data-parallel capacity. Raises :class:`ElasticMeshMismatch` when the
    global batch does not divide over the new mesh."""
    dist = cfg.Distributed
    old_world = ((dist.dp_degree or 1)
                 * ((dist.sharding or {}).get("sharding_degree") or 1))
    new_world = new_mesh.dp * new_mesh.fsdp
    glb = cfg.Global
    gbs = glb.global_batch_size
    if gbs % new_world:
        raise ElasticMeshMismatch(
            f"global_batch_size {gbs} does not divide over the shrunken "
            f"data-parallel world {new_world} (dp{new_mesh.dp} x "
            f"fsdp{new_mesh.fsdp})")
    accum = glb.local_batch_size // glb.micro_batch_size
    dist.dp_degree = new_mesh.dp
    dist.sharding.sharding_degree = new_mesh.fsdp
    glb.local_batch_size = gbs // new_world
    if glb.local_batch_size % accum:
        raise ElasticMeshMismatch(
            f"local_batch_size {glb.local_batch_size} on the shrunken mesh "
            f"does not preserve the gradient-accumulation factor {accum}")
    glb.micro_batch_size = glb.local_batch_size // accum
    logger.info(
        "elastic config rewrite: dp world %d -> %d, local_batch %d, "
        "micro_batch %d (global_batch %d held fixed)",
        old_world, new_world, glb.local_batch_size, glb.micro_batch_size, gbs)


def _retarget(loader, mesh) -> None:
    """Point a loader built for the old mesh at this rank's rows of the
    new one (its batch sampler's data rank and count)."""
    from fleetx_tpu_torch.parallel.mesh import get_data_world

    sampler = getattr(loader, "batch_sampler", None)
    if sampler is not None and hasattr(sampler, "process_index"):
        sampler.process_index = mesh.data_rank
        sampler.process_count = get_data_world(mesh)


def run_elastic(cfg, trainer, train_data, valid_data=None, *,
                build_trainer: Optional[Callable] = None,
                make_loader: Optional[Callable] = None,
                max_shrinks: int = 4):
    """Run ``trainer.fit`` under the elastic supervisor (JAX :153-213).

    On :class:`HostLossFault` (the injected stand-in for a host dropping
    out), every rank: takes the emergency checkpoint (``_guarded_save``, a
    collective; a failure is absorbed and the resume falls back to the
    last periodic checkpoint) and waits for it; plans a smaller mesh and
    rewrites ``cfg``; leaves if its rank is outside the new world
    (returning None); otherwise re-forms the process group at the new size
    on a rendezvous rank 0 picked, rebuilds the trainer
    (``build_trainer(cfg)``; default ``Trainer(cfg, build_module(cfg))``
    on the old trainer's device), resumes through ``init_state`` (reshard-
    on-load), rebuilds the train data with ``make_loader(cfg, consumed)``
    (without it ``train_data`` is pointed at this rank's new rows) and
    sets its sampler's ``consumed_samples``. Returns the trainer that
    finished ``fit``; with no fault plan this is ``trainer.fit()``."""
    from fleetx_tpu_torch.parallel.env import shrink_dist_env
    from fleetx_tpu_torch.parallel.mesh import mesh_from_config

    shrinks = 0
    while True:
        try:
            trainer.fit(train_data, valid_data)
            return trainer
        except HostLossFault as e:
            shrinks += 1
            step = trainer.step
            if shrinks > max_shrinks:
                logger.error("host loss at step %d but shrink budget "
                             "(%d) exhausted; giving up", step, max_shrinks)
                raise
            logger.warning("host loss at step %d (%s); attempting elastic "
                           "shrink %d/%d", step, e, shrinks, max_shrinks)
            trainer._guarded_save(trainer._cur_epoch)
            trainer.wait_for_checkpoints()
            old_mesh = trainer.mesh.config()
            new_mesh = plan_shrunken_mesh(old_mesh)
            logger.warning("elastic shrink at step %d: dp%d x fsdp%d -> "
                           "dp%d x fsdp%d", step, old_mesh.dp, old_mesh.fsdp,
                           new_mesh.dp, new_mesh.fsdp)
            apply_mesh_to_config(cfg, new_mesh)
            device = trainer.device
            if not shrink_dist_env(new_mesh.nranks, device):
                logger.info("this rank left the run after the shrink at "
                            "step %d", step)
                return None
            if build_trainer is not None:
                trainer = build_trainer(cfg)
            else:
                from fleetx_tpu_torch.core.engine import Trainer
                from fleetx_tpu_torch.models import build_module

                trainer = Trainer(cfg, build_module(cfg), device=device)
            # init_state's resumable branch restores the snapshot through
            # reshard-on-load (each rank its slices of the new mesh)
            trainer.init_state()
            mesh = mesh_from_config(cfg)
            if make_loader is not None:
                train_data = make_loader(cfg, trainer.consumed_samples)
            else:
                _retarget(train_data, mesh)
            if valid_data is not None:
                _retarget(valid_data, mesh)
            sampler = getattr(train_data, "batch_sampler", None)
            if sampler is not None and hasattr(sampler, "consumed_samples"):
                sampler.consumed_samples = trainer.consumed_samples
