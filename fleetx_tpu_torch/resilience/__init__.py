"""Resilience of the training path: deterministic fault injection
(``faults.py``) and elastic training (``elastic.py``: the load-time mesh
contract and the supervisor that shrinks the mesh after a host loss).
The production halves, the step sentry, checkpoint fallback and
preemption, live in ``core/engine.py``."""

from fleetx_tpu_torch.resilience.elastic import (
    ElasticMeshMismatch,
    apply_mesh_to_config,
    plan_shrunken_mesh,
    run_elastic,
    validate_restore_mesh,
)
from fleetx_tpu_torch.resilience.faults import FaultPlan, faults

__all__ = ["ElasticMeshMismatch", "FaultPlan", "apply_mesh_to_config",
           "faults", "plan_shrunken_mesh", "run_elastic",
           "validate_restore_mesh"]
