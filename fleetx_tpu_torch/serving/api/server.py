"""OpenAI-compatible HTTP front door over a ServingEngine or Router.

Port of the JAX package's ``serving/api/server.py``: the same routes, JSON
bodies, SSE framing, 4xx table and ``fleetx_api_*`` metric families.
``ApiServer(target).start()`` puts the serving stack on a port any stock
OpenAI client or curl can talk to:

- ``POST /v1/chat/completions``: chat shape; ``stream: true`` serves
  Server-Sent Events (one ``chat.completion.chunk`` per decoded token,
  closed by ``data: [DONE]``), ``stream: false`` aggregates.
- ``POST /v1/completions``: the text-completion shape, same streaming
  contract (``text_completion`` chunks).
- ``POST /v1/embeddings``: float vectors in (one flattened image, or an
  array of them), float vectors out, through the fleet's float-out family
  (an ``EmbeddingEngine`` group; named by ``model`` when there are
  several); 404 ``model_not_found`` when the fleet serves none.
- ``GET /v1/models``: the served model listing: the configured
  ``model_id``, and with a router target one entry per model family of
  its replica groups (replica indices and capability flags as extension
  fields).
- ``GET /healthz``: the engine's ``health()`` dict, or the router
  aggregate.

``target`` is anything with the ``submit / step / take_result / cancel``
surface: a ``ServingEngine``, a ``ServingRouter`` over in-process engines,
or a router over ``ReplicaClient`` proxies (the ``tools/serve.py`` fleet).
A background DRIVER thread ticks the target while requests are in flight;
every target touch (submit, step, take_result, cancel) serializes through
one lock, because handler threads are many and the engine is
single-threaded by design.

Tokens in, tokens out: the default codec treats message/prompt text as
whitespace-separated token ids ("12 7 3") and decodes generated ids to
the same form (each SSE chunk also carries the raw id in a ``token``
extension field). Real ``encode``/``decode`` callables swap in a
tokenizer without touching the protocol layer.

Request validation happens BEFORE the engine sees anything: malformed
bodies, empty prompts, bad sampling params and unknown models return
structured 4xx JSON (OpenAI error shape). Engine-side refusals map onto
HTTP the way the router maps them onto fallbacks: ``QueueFull`` → 429,
``ShuttingDown`` → 503, ``ValueError`` → 400.

Sampling params map onto the engine's per-request overrides:
``temperature`` 0/unset → greedy, > 0 → sampling with ``top_p``/``top_k``;
``seed`` pins the request's sampling stream (same seed → the same tokens,
across replicas and migrations); ``max_tokens`` → ``max_length``;
``stop_token_id`` (extension) → ``eos_token_id``. The ``X-Fleetx-Tenant``
header (else the body's ``user``) names the tenant: a label on the metrics
and, with the QoS router, its dispatch lane.

``FLEETX_API_TIMEOUT_S`` bounds how long one request may stay in flight
before the front door cancels it (finish_reason ``timeout``).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from fleetx_tpu_torch.obs.events import emit as obs_emit
from fleetx_tpu_torch.obs.httpd import HttpDaemon, JsonHandler
from fleetx_tpu_torch.obs.registry import get_registry
from fleetx_tpu_torch.utils.log import logger

__all__ = ["ApiServer", "ApiError"]


class ApiError(Exception):
    """A request rejection with an HTTP status + OpenAI error body."""

    def __init__(self, code: int, message: str, kind: str =
                 "invalid_request_error"):
        super().__init__(message)
        self.code = code
        self.kind = kind

    def body(self) -> Dict:
        """The OpenAI-shaped error envelope."""
        return {"error": {"message": str(self), "type": self.kind,
                          "code": self.code}}


def _default_encode(text) -> List[int]:
    """The id codec: text is whitespace-separated token ids (a list of
    ints passes through). Raises :class:`ApiError` 400 on anything the
    codec can't read — the no-tokenizer front door serves token-id
    workloads."""
    if isinstance(text, (list, tuple)):
        try:
            return [int(t) for t in text]
        except (TypeError, ValueError):
            raise ApiError(400, "prompt list must contain token ids")
    if isinstance(text, str):
        try:
            return [int(t) for t in text.split()]
        except ValueError:
            raise ApiError(
                400, "no tokenizer configured: content must be "
                "whitespace-separated token ids (e.g. \"12 7 3\")")
    raise ApiError(400, f"prompt must be a string or token-id list, "
                        f"got {type(text).__name__}")


def _default_decode(tokens: List[int]) -> str:
    """Inverse of :func:`_default_encode`: ids → "12 7 3"."""
    return " ".join(str(int(t)) for t in tokens)


_FINISH_MAP = {"eos": "stop", "max_length": "length"}


class _ApiMetrics:
    """Process-global ``fleetx_api_*`` instruments (the JAX server's
    families); one set per process, shared across ApiServers."""

    _instance = None

    def __init__(self):
        reg = get_registry()
        self.requests = reg.counter(
            "fleetx_api_requests_total",
            "API requests accepted per route and tenant",
            ("route", "tenant"))
        self.errors = reg.counter(
            "fleetx_api_errors_total",
            "API error responses per HTTP status", ("code",))
        self.tokens = reg.counter(
            "fleetx_api_tokens_total",
            "Completion tokens delivered to API clients per tenant",
            ("tenant",))
        self.active = reg.gauge(
            "fleetx_api_active_requests",
            "API requests currently in flight (streaming or aggregating)")
        self.ttft = reg.histogram(
            "fleetx_api_ttft_seconds",
            "Submit-to-first-SSE-token latency at the API layer")

    @classmethod
    def get(cls) -> "_ApiMetrics":
        """The per-process singleton (registry families are themselves
        process-global; re-instantiating would just re-fetch them)."""
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance


class _ApiHandler(JsonHandler):
    """Routes the OpenAI surface onto the owning :class:`ApiServer`."""

    server_version = "fleetx-api/1"
    protocol_version = "HTTP/1.1"

    def _api(self) -> "ApiServer":
        return self.server.context["api"]

    def do_GET(self) -> None:  # noqa: N802 — http.server contract
        """Read-only routes: model listing + health."""
        path = self.path.split("?", 1)[0].rstrip("/")
        api = self._api()
        if path == "/v1/models":
            self._send_json(200, api.models_payload())
        elif path == "/healthz":
            body = api.health()
            self._send_json(200 if body.get("state") == "ok" else 503, body)
        else:
            self._send_json(404, ApiError(
                404, f"unknown path {self.path!r}").body())

    def do_POST(self) -> None:  # noqa: N802 — http.server contract
        """The two completion routes."""
        path = self.path.split("?", 1)[0].rstrip("/")
        api = self._api()
        chat = path == "/v1/chat/completions"
        embeddings = path == "/v1/embeddings"
        if not chat and not embeddings and path != "/v1/completions":
            self._send_json(404, ApiError(
                404, f"unknown path {self.path!r}").body())
            return
        try:
            body = self._read_json()
            if not isinstance(body, dict):
                raise ApiError(400, "request body must be a JSON object")
            if embeddings:
                api.handle_embeddings(self, body)
            else:
                api.handle_completion(self, body, chat=chat)
        except ApiError as e:
            api.metrics.errors.labels(code=str(e.code)).inc()
            self._send_json(e.code, e.body())
        except ValueError as e:
            # malformed JSON from _read_json, or an engine-side
            # validation the pre-checks didn't anticipate
            api.metrics.errors.labels(code="400").inc()
            self._send_json(400, ApiError(400, str(e)).body())
        except BrokenPipeError:
            pass  # client hung up mid-stream; the request was cancelled
        except Exception as e:  # noqa: BLE001 — 500 must stay JSON
            logger.exception("api: unhandled error on %s", path)
            api.metrics.errors.labels(code="500").inc()
            try:
                self._send_json(500, ApiError(
                    500, f"{type(e).__name__}: {e}", "server_error").body())
            except OSError:
                pass


class ApiServer(HttpDaemon):
    """The front door: OpenAI surface + driver thread over one target."""

    def __init__(self, target, *, port: int = 0, host: str = "127.0.0.1",
                 model_id: str = "fleetx",
                 encode: Optional[Callable] = None,
                 decode: Optional[Callable] = None,
                 request_timeout_s: Optional[float] = None):
        super().__init__(_ApiHandler, port=port, host=host,
                         context={"api": self},
                         thread_name="fleetx-api-http")
        self.target = target
        self.model_id = model_id
        self.encode = encode or _default_encode
        self.decode = decode or _default_decode
        self.request_timeout_s = (
            request_timeout_s if request_timeout_s is not None
            else float(os.environ.get("FLEETX_API_TIMEOUT_S", "120")))
        self.metrics = _ApiMetrics.get()
        self._lock = threading.Lock()       # serializes ALL target touches
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._driver: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._created = int(time.time())

    # ------------------------------------------------------------ driver

    def start(self) -> "ApiServer":
        """Start the HTTP listener and the engine driver thread."""
        if self._driver is None:
            self._stop.clear()
            self._driver = threading.Thread(
                target=self._drive, name="fleetx-api-driver", daemon=True)
            self._driver.start()
        super().start()
        return self

    def stop(self) -> None:
        """Stop the listener, then the driver."""
        super().stop()
        self._stop.set()
        if self._driver is not None:
            self._driver.join(timeout=10)
            self._driver = None

    def _drive(self) -> None:
        """Tick the target while requests are in flight; idle cheaply
        otherwise. A tick that raises marks the whole front door sick
        (503 /healthz) rather than silently wedging every stream."""
        self._driver_error = None
        while not self._stop.is_set():
            if self._inflight <= 0:
                time.sleep(0.005)
                continue
            try:
                with self._lock:
                    self.target.step()
            except Exception as e:  # noqa: BLE001 — surfaced via /healthz
                logger.exception("api: driver tick failed")
                self._driver_error = f"{type(e).__name__}: {e}"
                time.sleep(0.1)
            # hand the lock over: a released threading.Lock is re-taken
            # by this loop before a waiting handler thread runs, which
            # starves the handlers' take_result/submit between ticks
            time.sleep(0)

    # ------------------------------------------------------------ routes

    def _served_models(self) -> Dict[str, Dict]:
        """The router's per-family replica-group view, ``{}`` for plain
        engine targets (which serve exactly the configured model id)."""
        if hasattr(self.target, "models"):
            with self._lock:
                return self.target.models()
        return {}

    def models_payload(self) -> Dict:
        """The ``/v1/models`` listing: derived from the router's replica
        groups when the target has them (one entry per family, plus the
        configured ``model_id`` as an alias of the default group), else
        the single configured model."""
        served = self._served_models()
        data = [{"id": self.model_id, "object": "model",
                 "created": self._created, "owned_by": "fleetx"}]
        if served:
            default = getattr(self.target, "_default_model", None)
            data[0]["group"] = default
            for family in sorted(served):
                info = served[family]
                data.append({"id": family, "object": "model",
                             "created": self._created,
                             "owned_by": "fleetx",
                             "replicas": info["replicas"],
                             "live": info["live"],
                             "capabilities": info["capabilities"]})
        return {"object": "list", "data": data}

    def health(self) -> Dict:
        """The ``/healthz`` body: the engine's ``health()`` dict, or a
        router aggregate (ok while ANY replica is in rotation)."""
        if getattr(self, "_driver_error", None):
            return {"state": "dead", "error": self._driver_error}
        with self._lock:
            if hasattr(self.target, "health"):
                return self.target.health()
            states = list(self.target.replica_states)
            return {"state": ("ok" if any(s == "ok" for s in states)
                              else "dead"),
                    "replicas": states,
                    "queue_depth": self.target.queue_depth,
                    "in_flight": self.target.in_flight}

    # ------------------------------------------------- request handling

    def _parse(self, body: Dict, chat: bool) -> Tuple[List[int], Dict]:
        """Validate one completion request → (prompt ids, submit kwargs).

        Every rejection is a structured :class:`ApiError` (4xx) raised
        BEFORE the engine is touched — the engine never sees a request
        the validator wouldn't vouch for."""
        model = body.get("model")
        model_kw: Dict = {}
        if model is not None and model != self.model_id:
            served = self._served_models()
            if model in served:
                # family-addressed request on a heterogeneous fleet:
                # dispatch stays inside this model group
                model_kw["model"] = model
            else:
                raise ApiError(
                    404, f"model {model!r} not found (serving "
                    f"{sorted(served) or [self.model_id]})",
                    "model_not_found")
        if body.get("n", 1) != 1:
            raise ApiError(400, "n > 1 is not supported")
        if chat:
            msgs = body.get("messages")
            if not isinstance(msgs, list) or not msgs:
                raise ApiError(400,
                               "messages must be a non-empty array")
            ids: List[int] = []
            for m in msgs:
                if not isinstance(m, dict) or "content" not in m:
                    raise ApiError(400, "each message needs a content")
                ids.extend(self.encode(m["content"]))
        else:
            if "prompt" not in body:
                raise ApiError(400, "prompt is required")
            ids = self.encode(body["prompt"])
        if not ids:
            raise ApiError(400, "prompt is empty after encoding")

        kw: Dict = dict(model_kw)
        max_tokens = body.get("max_tokens", body.get(
            "max_completion_tokens"))
        if max_tokens is not None:
            if not isinstance(max_tokens, int) or max_tokens < 1:
                raise ApiError(400, "max_tokens must be a positive int")
            kw["max_length"] = max_tokens
        temp = body.get("temperature")
        if temp is not None:
            if not isinstance(temp, (int, float)) or temp < 0:
                raise ApiError(400, "temperature must be >= 0")
        top_p = body.get("top_p")
        if top_p is not None:
            if not isinstance(top_p, (int, float)) or not 0 < top_p <= 1:
                raise ApiError(400, "top_p must be in (0, 1]")
        top_k = body.get("top_k")
        if top_k is not None:
            if not isinstance(top_k, int) or top_k < 1:
                raise ApiError(400, "top_k must be a positive int")
        seed = body.get("seed")
        if seed is not None and not isinstance(seed, int):
            raise ApiError(400, "seed must be an int")
        if temp is not None and temp > 0:
            kw["decode_strategy"] = "sampling"
            kw["temperature"] = float(temp)
            if top_p is not None:
                kw["top_p"] = float(top_p)
            if top_k is not None:
                kw["top_k"] = int(top_k)
        elif temp is not None:
            kw["decode_strategy"] = "greedy"  # temperature 0 = greedy
        if seed is not None:
            kw["seed"] = seed
        stop_tok = body.get("stop_token_id")
        if stop_tok is not None:
            if not isinstance(stop_tok, int):
                raise ApiError(400, "stop_token_id must be an int")
            kw["eos_token_id"] = stop_tok
        stream = body.get("stream", False)
        if not isinstance(stream, bool):
            raise ApiError(400, "stream must be a boolean")
        return ids, kw

    def _tenant_of(self, handler: _ApiHandler, body: Dict) -> str:
        """The tenant identity from the auth/header seam: an
        ``X-Fleetx-Tenant`` header (what an authenticating reverse proxy
        stamps after validating the API key) wins; the OpenAI-compatible
        ``user`` body field is the fallback; anonymous traffic shares
        the ``"default"`` lane. The value feeds the per-tenant metric
        labels and — when the target is the QoS router — its dispatch
        lane, budgets, and rate limits."""
        t = handler.headers.get("X-Fleetx-Tenant") or body.get("user")
        if not isinstance(t, str):
            return "default"
        return t.strip()[:64] or "default"

    def _submit(self, ids: List[int], kw: Dict, sink) -> int:
        """Submit under the lock, mapping engine refusals onto HTTP."""
        from fleetx_tpu_torch.serving.engine import QueueFull, ShuttingDown

        try:
            with self._lock:
                return self.target.submit(ids, on_token=sink, **kw)
        except QueueFull as e:
            raise ApiError(429, str(e), "rate_limit_exceeded")
        except ShuttingDown as e:
            raise ApiError(503, str(e), "server_shutting_down")
        except ValueError as e:
            raise ApiError(400, str(e))

    def handle_completion(self, handler: _ApiHandler, body: Dict,
                          chat: bool) -> None:
        """One ``/v1/*completions`` request end to end (validate →
        submit → stream or aggregate → respond)."""
        ids, kw = self._parse(body, chat)
        tenant = self._tenant_of(handler, body)
        route = "chat" if chat else "completions"
        self.metrics.requests.labels(route=route, tenant=tenant).inc()
        if getattr(self.target, "supports_tenants", False):
            # the QoS router's per-tenant lane/budget seam; plain
            # engines never see the kwarg
            kw["tenant"] = tenant

        q: "queue.Queue" = queue.Queue()

        def sink(_rid: int, tok: int, finished: bool) -> None:
            q.put((int(tok), bool(finished)))

        with self._inflight_lock:
            self._inflight += 1
        self.metrics.active.inc()
        t0 = time.monotonic()
        try:
            rid = self._submit(ids, kw, sink)
            if body.get("stream", False):
                self._respond_stream(handler, q, rid, ids, chat, t0,
                                     tenant)
            else:
                self._respond_json(handler, q, rid, ids, chat, t0,
                                   tenant)
        finally:
            with self._inflight_lock:
                self._inflight -= 1
            self.metrics.active.inc(-1)

    def handle_embeddings(self, handler: _ApiHandler, body: Dict) -> None:
        """One ``/v1/embeddings`` request: float vectors in, float vectors
        out, through a KV-free embedding family's int32 wire
        (``serving/embedding_engine.py``). 404 when the fleet serves no
        such family or the named model is not one; 400 when it serves
        several and the request names none. Each input row is one request;
        a row that ends other than ``complete`` answers 503 (timeout,
        shutdown) or 500."""
        from fleetx_tpu_torch.serving.embedding_engine import (
            decode_floats,
            encode_floats,
        )

        served = self._served_models()
        float_out = sorted(
            fam for fam, info in served.items()
            if info["capabilities"]
            and info["capabilities"].get("emits") == "floats")
        model = body.get("model")
        if model is None:
            if len(float_out) != 1:
                raise ApiError(
                    404 if not float_out else 400,
                    f"no unambiguous embedding model served (float-out "
                    f"families: {float_out}); name one", "model_not_found")
            model = float_out[0]
        elif model not in float_out:
            raise ApiError(404, f"model {model!r} is not a served "
                                f"embedding family (have {float_out})",
                           "model_not_found")

        def numbers(row) -> bool:
            return isinstance(row, list) and bool(row) and all(
                isinstance(v, (int, float)) and not isinstance(v, bool)
                for v in row)

        inp = body.get("input")
        if numbers(inp):
            rows = [inp]
        elif isinstance(inp, list) and inp and all(numbers(r) for r in inp):
            rows = inp
        else:
            raise ApiError(
                400, "input must be a non-empty array of numbers (one "
                "flattened image/vector) or an array of such arrays")
        tenant = self._tenant_of(handler, body)
        self.metrics.requests.labels(route="embeddings",
                                     tenant=tenant).inc()
        with self._inflight_lock:
            self._inflight += len(rows)
        self.metrics.active.inc()
        t0 = time.monotonic()
        try:
            pending = []
            for row in rows:
                q: "queue.Queue" = queue.Queue()

                def sink(_rid, tok, finished, _q=q):
                    _q.put((int(tok), bool(finished)))

                ids = [int(t) for t in encode_floats(row)]
                pending.append(
                    (q, self._submit(ids, dict(model=model), sink)))
            data = []
            for index, (q, rid) in enumerate(pending):
                result = self._await_result(q, rid, t0, lambda _t: None,
                                            tenant)
                if result.finish_reason != "complete":
                    raise ApiError(
                        503 if result.finish_reason in ("shutdown",
                                                        "timeout")
                        else 500,
                        f"embedding request ended {result.finish_reason!r}",
                        "server_error")
                data.append({
                    "object": "embedding", "index": index,
                    "embedding": [float(v) for v in
                                  decode_floats(result.tokens)]})
            n_in = sum(len(r) for r in rows)
            handler._send_json(200, {
                "object": "list", "data": data, "model": model,
                "usage": {"prompt_tokens": n_in, "total_tokens": n_in}})
        finally:
            with self._inflight_lock:
                self._inflight -= len(rows)
            self.metrics.active.inc(-1)

    def _await_result(self, q: "queue.Queue", rid: int, t0: float,
                      on_token: Callable[[int], None],
                      tenant: str = "default"):
        """Pump the token queue until the request's result is ready.

        Tokens arrive via the queue (the driver thread ticks the target,
        callbacks fire inside the tick); terminal-without-token ends
        (timeout/cancel/shutdown) arrive only as a result appearing, so
        an idle queue polls ``take_result`` too. Returns the
        ``ServingResult``; the front-door deadline cancels the request
        and synthesizes a ``timeout`` result if the target loses it."""
        first = True
        deadline = t0 + self.request_timeout_s
        result = None
        tokens_c = self.metrics.tokens.labels(tenant=tenant)
        while result is None:
            try:
                tok, finished = q.get(timeout=0.05)
                if first:
                    self.metrics.ttft.observe(time.monotonic() - t0)
                    first = False
                tokens_c.inc()
                on_token(tok)
                if not finished:
                    continue
            except queue.Empty:
                pass
            with self._lock:
                result = self.target.take_result(rid)
            if result is None and time.monotonic() > deadline:
                with self._lock:
                    self.target.cancel(rid)
                    result = self.target.take_result(rid)
                obs_emit("api_request_timeout", request=rid,
                         timeout_s=self.request_timeout_s)
                if result is None:
                    from fleetx_tpu_torch.serving.engine import ServingResult

                    result = ServingResult(
                        id=rid, prompt=ids_to_np([]), tokens=ids_to_np([]),
                        finish_reason="timeout", ttft_s=0.0, latency_s=0.0)
                break
        # tokens emitted in the same tick that finished the request may
        # still sit in the queue — flush them before the final chunk
        while True:
            try:
                tok, _fin = q.get_nowait()
            except queue.Empty:
                break
            tokens_c.inc()
            on_token(tok)
        return result

    # ------------------------------------------------------- responders

    def _respond_json(self, handler, q, rid, ids, chat, t0,
                      tenant: str = "default") -> None:
        """Aggregate (non-stream) response."""
        toks: List[int] = []
        result = self._await_result(q, rid, t0, toks.append, tenant)
        text = self.decode([int(t) for t in result.tokens])
        finish = _FINISH_MAP.get(result.finish_reason,
                                 result.finish_reason)
        usage = {"prompt_tokens": len(ids),
                 "completion_tokens": len(result.tokens),
                 "total_tokens": len(ids) + len(result.tokens)}
        if chat:
            payload = {
                "id": f"chatcmpl-{rid}", "object": "chat.completion",
                "created": int(time.time()), "model": self.model_id,
                "choices": [{"index": 0,
                             "message": {"role": "assistant",
                                         "content": text},
                             "finish_reason": finish}],
                "usage": usage,
                "tokens": [int(t) for t in result.tokens]}
        else:
            payload = {
                "id": f"cmpl-{rid}", "object": "text_completion",
                "created": int(time.time()), "model": self.model_id,
                "choices": [{"index": 0, "text": text,
                             "finish_reason": finish}],
                "usage": usage,
                "tokens": [int(t) for t in result.tokens]}
        handler._send_json(200, payload)

    def _respond_stream(self, handler, q, rid, ids, chat, t0,
                        tenant: str = "default") -> None:
        """SSE streaming response: one chunk per decoded token (with the
        raw id in the ``token`` extension field), a final chunk carrying
        ``finish_reason``, then ``data: [DONE]``."""
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        handler.send_header("Connection", "close")
        handler.end_headers()
        obj = "chat.completion.chunk" if chat else "text_completion"
        oid = f"chatcmpl-{rid}" if chat else f"cmpl-{rid}"
        sent = [0]

        def write_event(payload: Dict) -> None:
            handler.wfile.write(
                b"data: " + json.dumps(payload).encode() + b"\n\n")
            handler.wfile.flush()

        def chunk(tok: Optional[int], finish: Optional[str]) -> Dict:
            text = ("" if tok is None
                    else (" " if sent[0] else "") + self.decode([tok]))
            choice: Dict = {"index": 0, "finish_reason": finish}
            if chat:
                choice["delta"] = ({} if tok is None
                                   else {"content": text})
            else:
                choice["text"] = text
            out = {"id": oid, "object": obj, "created": int(time.time()),
                   "model": self.model_id, "choices": [choice]}
            if tok is not None:
                out["token"] = int(tok)
                sent[0] += 1
            return out

        def on_token(tok: int) -> None:
            try:
                write_event(chunk(tok, None))
            except OSError:
                # client went away: cancel so the slot frees, then let
                # the pump finish via the result it produces
                with self._lock:
                    self.target.cancel(rid)
                raise BrokenPipeError("client disconnected mid-stream")

        result = self._await_result(q, rid, t0, on_token, tenant)
        finish = _FINISH_MAP.get(result.finish_reason,
                                 result.finish_reason)
        write_event(chunk(None, finish))
        handler.wfile.write(b"data: [DONE]\n\n")
        handler.wfile.flush()


def ids_to_np(ids: List[int]):
    """Token-id list → the int32 array shape ``ServingResult`` carries."""
    return np.asarray(ids, np.int32)
