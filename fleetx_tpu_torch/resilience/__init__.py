"""Resilience of the training path: deterministic fault injection
(``faults.py``) and the load-time mesh contract (``elastic.py``). The
production halves, the step sentry, checkpoint fallback and preemption,
live in ``core/engine.py``."""

from fleetx_tpu_torch.resilience.elastic import (
    ElasticMeshMismatch,
    validate_restore_mesh,
)
from fleetx_tpu_torch.resilience.faults import FaultPlan, faults

__all__ = ["ElasticMeshMismatch", "FaultPlan", "faults",
           "validate_restore_mesh"]
