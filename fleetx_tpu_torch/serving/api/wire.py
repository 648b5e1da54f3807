"""JSON wire codecs + HTTP transport for the cross-process replica RPC.

Port of the JAX package's ``serving/api/wire.py``. The router ⇄ replica
contract rides plain JSON over HTTP, so any side can be curl-debugged.
Two payload families need codecs beyond JSON primitives:

- **KV page blobs**: ``export_kv`` ships crc32-trailed
  ``HostPageStore.payload_to_bytes`` wire bytes; they cross HTTP
  base64-encoded, UNPARSED: the decode replica's ``submit`` is the one
  place that validates the checksum, as in process.
- **Results**: ``ServingResult`` flattens to a dict (arrays to lists) and
  rebuilds on the client, so the router's ``drain()`` hands back the same
  dataclass either way; the dict is the JAX package's, field for field.

A request's sampling stream crosses as its integer ``seed`` (a JSON int)
where the JAX RPC sends the words of a ``jax.random`` key.

Errors cross as ``{"error_kind": ..., "error": ...}`` bodies with a
4xx/5xx status; :func:`raise_for_kind` rebuilds the typed exception
(``QueueFull``, ``ShuttingDown``, ``ValueError``, ...) so the router's
except-clauses fire identically for a remote replica.

:func:`rpc_call` is the one transport function: POST/GET with a timeout,
the ``faults.on_rpc`` chaos seam in front, and every network failure
normalized to ``ConnectionError``.
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request
from typing import Dict, List, Optional

import numpy as np

from fleetx_tpu_torch.resilience.faults import faults

__all__ = [
    "b64_blobs_decode",
    "b64_blobs_encode",
    "kind_for_exception",
    "raise_for_kind",
    "result_from_wire",
    "result_to_wire",
    "rpc_call",
]


def b64_blobs_encode(blobs) -> Optional[List[str]]:
    """KV page wire blobs (bytes) to base64 strings (None passes
    through). The crc32 trailer travels inside the blob untouched."""
    if blobs is None:
        return None
    return [base64.b64encode(bytes(b)).decode("ascii") for b in blobs]


def b64_blobs_decode(items) -> Optional[List[bytes]]:
    """Base64 strings to the original wire blobs, still UNVALIDATED:
    ``submit(kv_payloads=...)`` owns the checksum check, so a corrupt
    ship fails exactly where the in-process path fails."""
    if items is None:
        return None
    return [base64.b64decode(s) for s in items]


def result_to_wire(res) -> Optional[Dict]:
    """``ServingResult`` to a JSON dict (None while in flight)."""
    if res is None:
        return None
    return {
        "id": int(res.id),
        "prompt": [int(t) for t in np.asarray(res.prompt).reshape(-1)],
        "tokens": [int(t) for t in np.asarray(res.tokens).reshape(-1)],
        "finish_reason": str(res.finish_reason),
        "ttft_s": float(res.ttft_s),
        "latency_s": float(res.latency_s),
    }


def result_from_wire(d: Optional[Dict]):
    """JSON dict to ``ServingResult`` (None passes through)."""
    if d is None:
        return None
    from fleetx_tpu_torch.serving.engine import ServingResult

    return ServingResult(
        id=int(d["id"]),
        prompt=np.asarray(d["prompt"], np.int32),
        tokens=np.asarray(d["tokens"], np.int32),
        finish_reason=str(d["finish_reason"]),
        ttft_s=float(d["ttft_s"]),
        latency_s=float(d["latency_s"]),
    )


def _kinds() -> Dict[str, type]:
    """error_kind strings to the exceptions the router's fallbacks key
    on (imported late: the engine pulls torch)."""
    from fleetx_tpu_torch.serving.engine import (
        QueueFull,
        RecoveryExhausted,
        ShuttingDown,
    )

    return {
        "queue_full": QueueFull,
        "shutting_down": ShuttingDown,
        "recovery_exhausted": RecoveryExhausted,
        "value_error": ValueError,
        "key_error": KeyError,
    }


def kind_for_exception(exc) -> str:
    """The wire ``error_kind`` for an exception the replica raised
    (unknown types cross as ``"internal"``; the client surfaces them as
    ``RuntimeError``, which the router treats as a sick replica)."""
    for kind, cls in _kinds().items():
        if isinstance(exc, cls):
            return kind
    return "internal"


def raise_for_kind(kind: str, message: str) -> None:
    """Re-raise the typed exception an ``error_kind`` body encodes, so the
    router's except-clauses (``QueueFull``: try another replica,
    ``ValueError``: drop shipped KV / exclude, ``RecoveryExhausted``: mark
    dead) behave identically across the process boundary."""
    raise _kinds().get(kind, RuntimeError)(message)


def rpc_call(url: str, payload: Optional[Dict] = None, *,
             timeout_s: float = 10.0, method: str = "rpc") -> Dict:
    """One RPC: POST ``payload`` as JSON (GET when None) to ``url`` and
    return the parsed JSON body. The ``faults.on_rpc`` chaos seam runs
    first. An ``error_kind`` body re-raises its typed exception whatever
    the status; transport failures (refused, reset, timeout) normalize to
    ``ConnectionError``. A non-200 JSON body WITHOUT ``error_kind`` is
    data: ``/healthz`` serves 503 with the draining/dead health dict, and
    the probe needs that body (draining is not dead)."""
    faults.on_rpc(method)
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            body = json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read() or b"{}")
        except (ValueError, OSError):
            raise ConnectionError(
                f"rpc {method} to {url}: HTTP {e.code} with no JSON body")
        if isinstance(body, dict) and "error_kind" in body:
            raise_for_kind(body["error_kind"], body.get("error", ""))
        return body
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise ConnectionError(
            f"rpc {method} to {url} failed: {type(e).__name__}: {e}")
    if isinstance(body, dict) and "error_kind" in body:
        raise_for_kind(body["error_kind"], body.get("error", ""))
    return body
