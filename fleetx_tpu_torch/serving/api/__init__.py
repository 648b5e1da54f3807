"""Deployable serving front door: OpenAI-compatible API + replica RPC.

Port of the JAX package's ``serving/api``: it puts the in-process serving
stack (``ServingEngine`` + ``ServingRouter``) on a port.

- :mod:`~fleetx_tpu_torch.serving.api.server`: ``ApiServer``, a
  stdlib-only OpenAI-compatible HTTP front door (``/v1/chat/completions``,
  ``/v1/completions``, ``/v1/models``) with SSE streaming driven off the
  engine/router ``on_token`` callbacks.
- :mod:`~fleetx_tpu_torch.serving.api.replica_server` /
  :mod:`~fleetx_tpu_torch.serving.api.replica_client`: the cross-process
  replica RPC: each replica process serves its engine over HTTP, the
  router process drives engine-shaped client proxies, and every network
  failure maps onto the router's dead-replica / zero-token-loss replay
  fallbacks.
- :mod:`~fleetx_tpu_torch.serving.api.wire`: the JSON codecs (KV page
  blobs, results, typed errors) both sides share.

``fleetx_tpu_torch/tools/serve.py`` composes these into a fleet: N replica
processes behind one router + API process.

Imports here stay lazy: the submodules pull torch and the engine, and the
launcher imports this package before deciding which role a process plays.
"""

__all__ = ["ApiServer", "ReplicaClient", "ReplicaServer"]


def __getattr__(name):
    """Lazy re-exports (keep ``import fleetx_tpu_torch.serving.api``
    cheap)."""
    if name == "ApiServer":
        from fleetx_tpu_torch.serving.api.server import ApiServer
        return ApiServer
    if name == "ReplicaClient":
        from fleetx_tpu_torch.serving.api.replica_client import ReplicaClient
        return ReplicaClient
    if name == "ReplicaServer":
        from fleetx_tpu_torch.serving.api.replica_server import ReplicaServer
        return ReplicaServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
