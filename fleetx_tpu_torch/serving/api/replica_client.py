"""Engine-shaped RPC proxy: drive a remote replica like a local engine.

Port of the JAX package's ``serving/api/replica_client.py``.
``ReplicaClient(url)`` presents the ``ServingEngine`` surface the
:class:`~fleetx_tpu_torch.serving.router.ServingRouter` consumes (the
attributes ``role``, ``paged``, ``page_size``, ``cache_len``, ``slots``,
``submit_limit`` and ``model.cfg``, scraped from ``/rpc/spec`` at
connect, and the methods forwarded over
:func:`~fleetx_tpu_torch.serving.api.wire.rpc_call`), so
``ServingRouter([ReplicaClient(u) for u in urls])`` works, fallbacks
included.

Every transport failure surfaces as the exception (or sentinel) the
router's resilience ladder already handles for an in-process replica:

==================  ======================  ==============================
method              on ``ConnectionError``  router behavior it triggers
==================  ======================  ==============================
``health``          propagates              probe reads it as ``dead`` →
                                            SUSPECT/backoff escalation
``step``            ``ReplicaKilled``       ``_mark_dead`` → zero-token-
                                            loss ``history=`` migration
``submit``          ``QueueFull``           exclude + retry the other
                                            replicas (the request waits)
``take_result``     returns ``None``        keep polling / migrate
``emitted_tokens``  returns ``None``        re-base from router's record
``prefilled_ready`` returns ``[]``          no handoffs this tick
``cancel``          returns ``False``       a dead replica IS cancelled
``request_shutdown``  swallowed             already down = drained
``declare_dead``    swallowed               already down = dead
``export_kv``       propagates              handoff aborts → replay
==================  ======================  ==============================

Typed replica-side errors (``error_kind`` bodies) re-raise as the real
exception classes through the wire module.

Streaming crosses the boundary inside ``/rpc/step`` responses: the server
buffers the tick's ``on_token`` events and the client replays them, in
emission order, into the callbacks registered at :meth:`submit`. A lost
step response delivers NO events, so the router migrates from exactly the
tokens it has seen and the user stream stays loss- and duplicate-free.
"""

from __future__ import annotations

import numbers
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

from fleetx_tpu_torch.resilience.faults import ReplicaKilled
from fleetx_tpu_torch.serving.api import wire

__all__ = ["ReplicaClient"]


class ReplicaClient:
    """An engine-shaped handle on one remote replica process."""

    def __init__(self, url: str, *, timeout_s: float = 10.0,
                 connect_wait_s: float = 0.0):
        self.url = url.rstrip("/")
        self.timeout_s = float(timeout_s)
        spec = self._fetch_spec(connect_wait_s)
        self.role = spec.get("role", "both")
        self.paged = bool(spec.get("paged"))
        self.page_size = spec.get("page_size") or 0
        self.cache_len = int(spec.get("cache_len", 0))
        self.slots = int(spec.get("slots", 1))
        self.eos_token_id = spec.get("eos_token_id")
        self.vocab_size = int(spec.get("vocab_size", 0))
        max_pos = int(spec.get("max_position_embeddings",
                               self.cache_len or 1))
        self.submit_limit = int(spec.get("submit_limit",
                                         min(self.cache_len, max_pos)))
        # the nested attribute path a router reads for request limits
        self.model = SimpleNamespace(cfg=SimpleNamespace(
            max_position_embeddings=max_pos, vocab_size=self.vocab_size))
        # on_token callbacks by ENGINE rid, fed by step-event replay
        self._cbs: Dict[int, object] = {}

    def _fetch_spec(self, wait_s: float) -> Dict:
        """Scrape ``/rpc/spec``, retrying for up to ``wait_s`` seconds (a
        launcher connects while replica processes are still binding)."""
        deadline = time.monotonic() + max(0.0, wait_s)
        while True:
            try:
                return wire.rpc_call(self.url + "/rpc/spec",
                                     timeout_s=self.timeout_s,
                                     method="spec")
            except ConnectionError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)

    def _rpc(self, name: str, payload: Dict) -> Dict:
        return wire.rpc_call(f"{self.url}/rpc/{name}", payload,
                             timeout_s=self.timeout_s, method=name)

    # --------------------------------------------- the engine surface

    def submit(self, prompt, *, on_token=None, seed=None, history=None,
               kv_payloads=None, **kw) -> int:
        """Forward ``submit`` with the wire codecs. An unreachable replica
        raises :class:`QueueFull`: the router excludes it and retries the
        others, so the request waits instead of erroring. Typed
        replica-side refusals cross as themselves."""
        payload = {
            "prompt": [int(t) for t in prompt],
            "seed": None if seed is None else int(seed),
            "history": (None if history is None
                        else [int(t) for t in history]),
            "kv_payloads": wire.b64_blobs_encode(kv_payloads),
            "kw": _json_kwargs(kw),
        }
        try:
            rid = int(self._rpc("submit", payload)["id"])
        except ConnectionError as e:
            from fleetx_tpu_torch.serving.engine import QueueFull

            raise QueueFull(f"replica {self.url} unreachable at submit "
                            f"({e})") from e
        if on_token is not None:
            self._cbs[rid] = on_token
        return rid

    def step(self) -> Dict:
        """One remote tick. Replays the tick's ``on_token`` events into the
        registered callbacks (emission order), then returns the summary.
        An unreachable replica raises
        :class:`~fleetx_tpu_torch.resilience.faults.ReplicaKilled`: the
        router's dead-replica migration path."""
        try:
            out = self._rpc("step", {})
        except ConnectionError as e:
            raise ReplicaKilled(
                f"replica {self.url} unreachable at step ({e})") from e
        for erid, tok, finished in out.get("events", ()):
            cb = self._cbs.get(erid)
            if cb is not None:
                cb(erid, tok, bool(finished))
                if finished:
                    self._cbs.pop(erid, None)
        return out.get("summary", {})

    def health(self) -> Dict:
        """The replica's ``/healthz`` body. An unreachable replica RAISES:
        the router's probe reads a raising health as ``dead``."""
        return wire.rpc_call(self.url + "/healthz",
                             timeout_s=self.timeout_s, method="health")

    def take_result(self, request_id: int):
        """The finished ``ServingResult``, or ``None`` while in flight, and
        ``None`` when unreachable."""
        try:
            out = self._rpc("take_result", {"id": int(request_id)})
        except ConnectionError:
            return None
        res = wire.result_from_wire(out.get("result"))
        if res is not None:
            self._cbs.pop(int(request_id), None)
        return res

    def emitted_tokens(self, request_id: int) -> Optional[List[int]]:
        """Tokens the replica emitted for a live request (``None`` when
        unknown or unreachable)."""
        try:
            return self._rpc("emitted_tokens",
                             {"id": int(request_id)}).get("tokens")
        except ConnectionError:
            return None

    def prefilled_ready(self) -> List[int]:
        """Parked prefill-complete request ids (``[]`` when unreachable)."""
        try:
            return list(self._rpc("prefilled_ready", {}).get("ids", []))
        except ConnectionError:
            return []

    def export_kv(self, request_id: int) -> List[bytes]:
        """The crc32-trailed KV page wire blobs of a parked prefill.
        Raises ``KeyError`` (not parked) and ``ConnectionError``
        (unreachable): both abort this handoff and leave the router's
        replay fallback in charge."""
        out = self._rpc("export_kv", {"id": int(request_id)})
        return wire.b64_blobs_decode(out["payloads"]) or []

    def cancel(self, request_id: int) -> bool:
        """Cancel remotely; ``False`` when unreachable. Drops the local
        callback first, so no late event replays for an abandoned
        request."""
        self._cbs.pop(int(request_id), None)
        try:
            return bool(self._rpc("cancel",
                                  {"id": int(request_id)})["cancelled"])
        except ConnectionError:
            return False

    def request_shutdown(self, grace_s: Optional[float] = None) -> None:
        """Flip the remote engine to draining; swallowed when
        unreachable."""
        try:
            self._rpc("request_shutdown", {"grace_s": grace_s})
        except ConnectionError:
            pass

    def declare_dead(self) -> None:
        """Tell the remote engine it has been failed out; swallowed when
        unreachable."""
        try:
            self._rpc("declare_dead", {})
        except ConnectionError:
            pass


def _json_kwargs(kw: Dict) -> Dict:
    """Per-request override kwargs as JSON scalars (numpy ints and floats
    must not poison the wire, nor a float32 temperature turn int)."""
    out = {}
    for k, v in kw.items():
        if isinstance(v, numbers.Integral) and not isinstance(v, bool):
            out[k] = int(v)
        elif isinstance(v, numbers.Real) and not isinstance(v, bool):
            out[k] = float(v)
        else:
            out[k] = v
    return out
