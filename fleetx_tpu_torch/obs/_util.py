"""Shared helpers for the obs modules (one definition, three users)."""

from __future__ import annotations

import os

__all__ = ["env_int", "json_safe"]


def env_int(name: str, default: int, minimum: int = 0) -> int:
    """``FLEETX_OBS_*`` capacity knob: int env var clamped to
    ``minimum``; malformed values fall back to ``default`` (a typo'd
    knob must degrade to defaults, never crash the workload)."""
    try:
        return max(int(os.environ.get(name, default)), minimum)
    except ValueError:
        return default


def json_safe(v):
    """Coerce one attr value to a JSON-serializable primitive
    (everything non-primitive stringifies)."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)
