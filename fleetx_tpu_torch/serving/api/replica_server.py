"""HTTP RPC server wrapping one ``ServingEngine`` for a remote router.

Port of the JAX package's ``serving/api/replica_server.py``. One replica
process runs one engine behind this server; the router's
:class:`~fleetx_tpu_torch.serving.api.replica_client.ReplicaClient` in the
front-door process drives it through the engine surface the in-process
router consumes:

====================  =====================================================
``GET  /healthz``     The engine's drain-aware ``health()`` dict (200 when
                      ``ok``, else 503 with the same body).
``GET  /rpc/spec``    Construction-time facts the client exposes as
                      attributes: ``role``, ``paged``, ``page_size``,
                      ``cache_len``, ``max_position_embeddings``,
                      ``submit_limit``, ``slots``, and the model's
                      ``vocab_size`` and ``eos_token_id``.
``POST /rpc/submit``  ``submit(...)`` with history, the request's ``seed``
                      and base64 kv_payloads (wire.py); typed errors cross
                      as ``error_kind`` bodies.
``POST /rpc/step``    One engine tick; returns the summary PLUS the
                      ``on_token`` events the tick emitted, in order (the
                      client replays them into the router's callbacks).
``POST /rpc/*``       ``take_result`` / ``cancel`` / ``emitted_tokens`` /
                      ``prefilled_ready`` / ``export_kv`` /
                      ``request_shutdown`` / ``declare_dead``.
====================  =====================================================

The engine is single-threaded by design; ``ThreadingHTTPServer`` handlers
serialize every engine touch through one lock, so concurrent RPCs (or a
health scrape mid-tick) cannot interleave engine state. Torch's current
CUDA device is per thread: every engine call enters the engine's device
on the handler thread that makes it. The engine's own watchdog thread
(``tick_timeout_s``) runs inside ``step`` under the same lock.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Tuple

import torch

from fleetx_tpu_torch.obs.httpd import HttpDaemon, JsonHandler
from fleetx_tpu_torch.serving.api import wire
from fleetx_tpu_torch.utils.log import logger

__all__ = ["ReplicaServer"]

_ERROR_CODES = {"queue_full": 429, "shutting_down": 503, "value_error": 400,
                "key_error": 404, "recovery_exhausted": 500}


class _ReplicaHandler(JsonHandler):
    """Routes ``/healthz`` + ``/rpc/*`` onto the wrapped engine."""

    server_version = "fleetx-replica/1"

    def _ctx(self) -> "ReplicaServer":
        return self.server.context["replica"]

    def do_GET(self) -> None:  # noqa: N802 — http.server contract
        """Read-only routes: health scrape + replica spec."""
        path = self.path.split("?", 1)[0].rstrip("/")
        ctx = self._ctx()
        if path == "/healthz":
            body = ctx.health()
            self._send_json(200 if body.get("state") == "ok" else 503, body)
        elif path == "/rpc/spec":
            self._send_json(200, ctx.spec())
        else:
            self._send_json(404, {"error": f"unknown path {self.path!r}",
                                  "error_kind": "not_found"})

    def do_POST(self) -> None:  # noqa: N802 — http.server contract
        """Mutating RPC routes (everything that touches engine state)."""
        path = self.path.split("?", 1)[0].rstrip("/")
        ctx = self._ctx()
        try:
            payload = self._read_json()
        except ValueError as e:
            self._send_json(400, {"error": str(e),
                                  "error_kind": "value_error"})
            return
        method = ctx.rpc_methods.get(path)
        if method is None:
            self._send_json(404, {"error": f"unknown rpc {self.path!r}",
                                  "error_kind": "not_found"})
            return
        try:
            self._send_json(200, method(payload))
        except Exception as e:  # noqa: BLE001 — typed over the wire
            kind = wire.kind_for_exception(e)
            if kind == "internal":
                logger.exception("replica rpc %s failed", path)
            self._send_json(_ERROR_CODES.get(kind, 500),
                            {"error": f"{type(e).__name__}: {e}",
                             "error_kind": kind})


class ReplicaServer(HttpDaemon):
    """The per-replica RPC server: one engine, one lock, one port.

    ``ReplicaServer(engine).start()`` and hand ``url`` to the router
    process; ``stop()`` (or process death) makes every client RPC fail as
    ``ConnectionError``, which the router maps to its probe-escalate →
    dead → migrate ladder."""

    def __init__(self, engine, port: int = 0, host: str = "127.0.0.1"):
        super().__init__(_ReplicaHandler, port=port, host=host,
                         context={"replica": self},
                         thread_name="fleetx-replica-rpc")
        self.engine = engine
        self._lock = threading.Lock()
        # on_token events buffered between /rpc/step responses, in
        # emission order: [(engine_rid, token, finished), ...]
        self._events: List[Tuple[int, int, bool]] = []
        self.rpc_methods = {
            "/rpc/submit": self._rpc_submit,
            "/rpc/step": self._rpc_step,
            "/rpc/take_result": self._rpc_take_result,
            "/rpc/cancel": self._rpc_cancel,
            "/rpc/emitted_tokens": self._rpc_emitted_tokens,
            "/rpc/prefilled_ready": self._rpc_prefilled_ready,
            "/rpc/export_kv": self._rpc_export_kv,
            "/rpc/request_shutdown": self._rpc_request_shutdown,
            "/rpc/declare_dead": self._rpc_declare_dead,
        }

    @contextlib.contextmanager
    def locked(self):
        """The one lock, and the engine's CUDA device current on this
        handler thread."""
        device = getattr(self.engine, "device", None)
        on_cuda = isinstance(device, torch.device) and device.type == "cuda"
        with self._lock, (torch.cuda.device(device) if on_cuda
                          else contextlib.nullcontext()):
            yield self.engine

    # ------------------------------------------------------------- routes

    def health(self) -> Dict:
        """The engine's ``health()`` dict (the ``/healthz`` contract)."""
        with self.locked() as eng:
            return eng.health()

    def spec(self) -> Dict:
        """Replica construction facts the client exposes as attributes."""
        eng = self.engine
        return {
            "role": eng.role,
            "paged": bool(eng.paged),
            "page_size": int(eng.page_size) if eng.paged else None,
            "cache_len": int(eng.cache_len),
            "max_position_embeddings":
                int(eng.model.cfg.max_position_embeddings),
            "submit_limit": int(eng.submit_limit),
            "vocab_size": int(eng.model.cfg.vocab_size),
            "eos_token_id": (None if eng.gen_cfg.eos_token_id is None
                             else int(eng.gen_cfg.eos_token_id)),
            "slots": int(eng.slots),
        }

    def _on_token(self, rid: int, tok: int, finished: bool) -> None:
        """Engine ``on_token`` sink: buffer for the next step response
        (callbacks fire inside the engine tick, under the lock)."""
        self._events.append((int(rid), int(tok), bool(finished)))

    def _rpc_submit(self, p: Dict) -> Dict:
        """``submit`` with the wire codecs; returns the engine rid."""
        kw = dict(p.get("kw") or {})
        with self.locked() as eng:
            rid = eng.submit(
                p["prompt"], on_token=self._on_token, seed=p.get("seed"),
                history=p.get("history"),
                kv_payloads=wire.b64_blobs_decode(p.get("kv_payloads")),
                **kw)
        return {"id": int(rid)}

    def _rpc_step(self, p: Dict) -> Dict:
        """One tick; the response carries the tick's summary and every
        ``on_token`` event it emitted, in order."""
        with self.locked() as eng:
            self._events = []
            summary = eng.step()
            events, self._events = self._events, []
        return {"summary": _json_summary(summary), "events": events}

    def _rpc_take_result(self, p: Dict) -> Dict:
        with self.locked() as eng:
            res = eng.take_result(int(p["id"]))
        return {"result": wire.result_to_wire(res)}

    def _rpc_cancel(self, p: Dict) -> Dict:
        with self.locked() as eng:
            return {"cancelled": bool(eng.cancel(int(p["id"])))}

    def _rpc_emitted_tokens(self, p: Dict) -> Dict:
        with self.locked() as eng:
            toks = eng.emitted_tokens(int(p["id"]))
        return {"tokens": None if toks is None else [int(t) for t in toks]}

    def _rpc_prefilled_ready(self, p: Dict) -> Dict:
        with self.locked() as eng:
            return {"ids": [int(r) for r in eng.prefilled_ready()]}

    def _rpc_export_kv(self, p: Dict) -> Dict:
        with self.locked() as eng:
            blobs = eng.export_kv(int(p["id"]))
        return {"payloads": wire.b64_blobs_encode(blobs)}

    def _rpc_request_shutdown(self, p: Dict) -> Dict:
        grace = p.get("grace_s")
        with self.locked() as eng:
            eng.request_shutdown(None if grace is None else float(grace))
        return {"ok": True}

    def _rpc_declare_dead(self, p: Dict) -> Dict:
        with self.locked() as eng:
            eng.declare_dead()
        return {"ok": True}


def _json_summary(summary: Dict) -> Dict:
    """Engine step summaries hold ints, lists and bools; coerce them so a
    numpy scalar can never break the wire."""
    out = {}
    for k, v in summary.items():
        if isinstance(v, (list, tuple)):
            out[k] = [int(x) for x in v]
        elif isinstance(v, bool) or v is None:
            out[k] = v
        else:
            try:
                out[k] = int(v)
            except (TypeError, ValueError):
                out[k] = str(v)
    return out
