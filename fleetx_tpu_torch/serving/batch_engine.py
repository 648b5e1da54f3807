"""KV-free dynamic-batching serving engine: the base of the encoder engines.

Port of the JAX package's ``BatchingEngine`` (serving/batch_engine.py:
84-457). An encoder model (ERNIE fill-in-blank or scoring, a ViT
embedding or class) answers a request in one forward and carries no state
between ticks, so its engine is request coalescing: each tick admits up
to ``slots`` queued requests, pads them into one batch (its row count a
power of two capped at ``slots``, :func:`_bucket`), runs one forward,
emits every output and retires every request. No cache, no lanes.

It keeps the operational contract of ``ServingEngine``
(``model_protocol.ENGINE_SURFACE``), so the router, the front door and the
chaos scenarios drive it unchanged:

- admission: the bounded queue (``FLEETX_SERVING_MAX_QUEUE``,
  :class:`QueueFull`), refusals while draining (:class:`ShuttingDown`),
  queue-TTL and deadline shedding to ``finish_reason="timeout"``;
- exactly one terminal result per request: ``complete`` on success,
  else ``timeout``, ``cancelled``, ``error`` or ``shutdown``;
- faults: the forward runs under ``faults.on_serving_tick``; a raising
  forward requeues its batch at the head in arrival order (nothing was
  emitted, so the retry repeats the result), strikes each request and
  retires one as ``error`` past ``max_recoveries`` strikes; the engine
  reads dead past ``max_recoveries`` faulted ticks in a row;
- the JAX engine's events (``drain_reject``, ``queue_reject``,
  ``request_timeout``, ``request_cancelled``, ``tick_fault``,
  ``engine_recovery``, ``shutdown``) and the ``fleetx_serving_*`` metrics
  with the batched-forward pair;
- migration: a request submitted again with ``history=`` (the router's
  copy of what the caller saw) re-runs, and only the outputs past the
  history reach the callback.

Outputs ride the int32 token channel: token ids (fill-in-blank), one class
or SOP id, or a float32 vector bit-cast to int32 (embeddings,
``embedding_engine.encode_floats``). Subclasses set ``capabilities`` and
implement :meth:`_validate` and :meth:`_run_batch`, and may price a
request for the router (:meth:`request_rows`); the model is a module
of the port whose weights ``params`` (a state dict) are loaded onto
``device`` (CUDA unless the caller names another).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from fleetx_tpu_torch.models.gpt.model import inference_params
from fleetx_tpu_torch.obs.events import emit as obs_emit
from fleetx_tpu_torch.obs.tracing import span
from fleetx_tpu_torch.resilience.faults import faults
from fleetx_tpu_torch.serving.engine import (
    QueueFull,
    ServingResult,
    ShuttingDown,
    _env_float,
    _env_int,
)
from fleetx_tpu_torch.serving.metrics import ServingMetrics
from fleetx_tpu_torch.serving.model_protocol import ModelCapabilities
from fleetx_tpu_torch.serving.scheduler import FIFOScheduler, Request
from fleetx_tpu_torch.utils.device import resolve_device
from fleetx_tpu_torch.utils.log import logger

__all__ = ["BatchingEngine"]


def _bucket(n: int, cap: int) -> int:
    """The next power of two >= ``n``, capped at ``cap``."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class BatchingEngine:
    """Dynamic batching over one encoder model (module docstring)."""

    #: set by subclasses: the served family's capabilities
    capabilities: ModelCapabilities

    def __init__(self, model, params: Dict[str, torch.Tensor], *,
                 device=None, slots: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 queue_ttl_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 grace_s: Optional[float] = None,
                 max_recoveries: Optional[int] = None,
                 metrics: Optional[ServingMetrics] = None):
        self.device = resolve_device(device)
        model.load_state_dict(inference_params(model, params, self.device),
                              assign=True)
        self.model = model.eval()
        self.slots = slots or _env_int("FLEETX_SERVING_SLOTS", 8)
        self.max_queue = (max_queue if max_queue is not None
                          else _env_int("FLEETX_SERVING_MAX_QUEUE", 0))
        self.queue_ttl_s = (queue_ttl_s if queue_ttl_s is not None
                            else _env_float("FLEETX_SERVING_QUEUE_TTL_S",
                                            0.0))
        self.deadline_s = (deadline_s if deadline_s is not None
                           else _env_float("FLEETX_SERVING_DEADLINE_S", 0.0))
        self.grace_s = (grace_s if grace_s is not None
                        else _env_float("FLEETX_SERVING_GRACE_S", 30.0))
        self.max_recoveries = max(1, max_recoveries
                                  if max_recoveries is not None
                                  else _env_int(
                                      "FLEETX_SERVING_MAX_RECOVERIES", 8))
        # the router's shape attributes: never paged, never phase-split,
        # and the "cache length" is the per-request input bound
        self.role = "both"
        self.paged = False
        self.page_size = 0
        self.model_family = self.capabilities.family
        self.cache_len = self.capabilities.max_input
        self.scheduler = FIFOScheduler()
        self.metrics = metrics or ServingMetrics(self.slots)
        self._results: Dict[int, ServingResult] = {}
        self._strikes: Dict[int, int] = {}
        self._next_id = 0
        self._ticks = 0
        self._fault_ticks = 0
        self._recovery_streak = 0
        self._shutting_down = False
        self._shutdown_deadline: Optional[float] = None
        self._dead = False
        self._now = time.perf_counter  # swappable clock (tests)

    # ---------------------------------------------------- subclass hooks

    def _validate(self, prompt: np.ndarray) -> None:
        """Raise ``ValueError`` when ``prompt`` is not servable here."""
        raise NotImplementedError

    def _run_batch(self, requests: List[Request]) -> List[List[int]]:
        """One batched forward: the wire-encoded outputs of each request,
        in order. It runs under the fault seam: raising requeues."""
        raise NotImplementedError

    def request_rows(self, prompt: np.ndarray) -> int:
        """The rows of work the forward runs for ``prompt`` (the router's
        DRR cost): its token count here."""
        return int(np.asarray(prompt).size)

    # ------------------------------------------------------------ submit

    def submit(self, prompt, *, on_token=None, seed: Optional[int] = None,
               queue_ttl_s: Optional[float] = None,
               deadline_s: Optional[float] = None, history=None,
               kv_payloads=None, max_length: Optional[int] = None,
               min_length: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               decode_strategy: Optional[str] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None) -> int:
        """Queue one request; returns its id. The signature is the
        engine surface's: the sampling knobs (and ``seed``) a router
        forwards are accepted and ignored, every forward here being
        deterministic. ``kv_payloads`` raises ``ValueError`` (no KV cache
        to revive into); ``history`` replays a migrated request."""
        del seed, max_length, min_length, eos_token_id, decode_strategy
        del temperature, top_k, top_p
        if self._shutting_down:
            self.metrics.record_drain_reject()
            obs_emit("drain_reject", engine=self.metrics.engine_label)
            raise ShuttingDown(
                "engine is draining toward shutdown; submit to another "
                "replica")
        if self.max_queue and self.scheduler.queue_depth >= self.max_queue:
            self._expire_queued(self._now())
        if self.max_queue and self.scheduler.queue_depth >= self.max_queue:
            self.metrics.record_reject()
            obs_emit("queue_reject", engine=self.metrics.engine_label,
                     queue_depth=self.scheduler.queue_depth)
            raise QueueFull(
                f"admission queue is full ({self.scheduler.queue_depth}/"
                f"{self.max_queue} waiting); retry later or raise "
                "FLEETX_SERVING_MAX_QUEUE")
        if kv_payloads is not None:
            raise ValueError(
                f"model family {self.model_family!r} has no KV cache to "
                "revive shipped pages into (capabilities.has_kv_cache="
                "False): this engine cannot take a disaggregated handoff")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        self._validate(prompt)
        rid = self._next_id
        self._next_id += 1
        req = Request(
            id=rid, prompt=prompt, max_new_tokens=1, min_new_tokens=0,
            eos_token_id=-1, greedy=True, temperature=1.0, top_k=0,
            top_p=1.0, generator=None, on_token=on_token,
            submit_time=self._now(),
            queue_ttl_s=float(queue_ttl_s if queue_ttl_s is not None
                              else self.queue_ttl_s),
            deadline_s=float(deadline_s if deadline_s is not None
                             else self.deadline_s))
        if history is not None:
            req.tokens.extend(int(t) for t in
                              np.asarray(history, np.int64).reshape(-1))
        self.scheduler.submit(req)
        self.metrics.record_submit()
        return rid

    # -------------------------------------------------------------- step

    @torch.no_grad()
    def step(self) -> Dict:
        """One tick: shed expired queued requests, run up to ``slots`` of
        the rest in one batched forward under the fault seam, emit and
        retire. Returns the summary ``ServingEngine.step`` returns
        (``retired``, ``timed_out``, ``queue_depth``, ...)."""
        t0 = self._now()
        self._ticks += 1
        timed_out = self._expire_queued(t0)
        retired: List[int] = []
        recovered = False
        if (self._shutting_down and self._shutdown_deadline is not None
                and t0 > self._shutdown_deadline):
            retired.extend(self._retire_all("shutdown"))
        batch: List[Request] = []
        while len(batch) < self.slots:
            req = self.scheduler.pop_next()
            if req is None:
                break
            batch.append(req)
        forwards = 0
        if batch:
            attempt = self._fault_ticks
            self._fault_ticks += 1
            try:
                with span("serving.batch_forward", engine_tick=self._ticks,
                          batch=len(batch)):
                    faults.on_serving_tick(attempt)
                    outputs = self._run_batch(batch)
            except Exception as e:  # noqa: BLE001 — requeue and retry
                recovered = True
                retired.extend(self._on_batch_fault(batch, e))
            else:
                forwards = 1
                self._recovery_streak = 0
                self.metrics.record_batched_forward(len(batch), self.slots)
                now = self._now()
                for req, out in zip(batch, outputs):
                    self._strikes.pop(req.id, None)
                    self._emit_and_finalize(req, out, now)
                    retired.append(req.id)
        self.metrics.observe_tick(self.scheduler.queue_depth, 0,
                                  self._now() - t0)
        return {"admitted": len(batch), "retired": retired,
                "timed_out": timed_out, "forwards": forwards,
                "recovered": recovered,
                "queue_depth": self.scheduler.queue_depth}

    def _emit_and_finalize(self, req: Request, out: List[int],
                           now: float) -> None:
        """Deliver one request's outputs and record its result: a migrated
        request's history is skipped on the callback but rides the
        result."""
        already = len(req.tokens)
        out = [int(t) for t in out]
        req.tokens = out
        req.admit_time = now
        self.metrics.record_admit(now - req.submit_time)
        cb_error = False
        for i, tok in enumerate(out[already:]):
            if req.first_token_time is None:
                req.first_token_time = self._now()
                self.metrics.record_first_token(
                    req.first_token_time - req.submit_time)
            if req.on_token is not None and not cb_error:
                try:
                    req.on_token(req.id, tok, already + i + 1 == len(out))
                except Exception:  # noqa: BLE001 — the caller's bug
                    cb_error = True
                    logger.exception(
                        "serving: on_token callback raised for request "
                        "%d; delivery stops, result still records", req.id)
        self.metrics.record_tokens(len(out) - already)
        self._finalize(req, "error" if cb_error else "complete", self._now())

    def _on_batch_fault(self, batch: List[Request], err: Exception
                        ) -> List[int]:
        """Requeue a faulted batch at the head in arrival order, strike its
        requests, retire those past ``max_recoveries`` strikes as
        ``error``; past ``max_recoveries`` faulted ticks in a row the
        engine reads dead."""
        obs_emit("tick_fault", engine=self.metrics.engine_label,
                 error=f"{type(err).__name__}: {err}", batch=len(batch))
        logger.warning(
            "serving: batched forward over %d request(s) raised (%s); "
            "requeueing at head", len(batch), err)
        now = self._now()
        dead = []
        for req in reversed(batch):
            self._strikes[req.id] = self._strikes.get(req.id, 0) + 1
            if self._strikes[req.id] > self.max_recoveries:
                self._strikes.pop(req.id, None)
                self._finalize(req, "error", now)
                dead.append(req.id)
            else:
                self.scheduler.requeue(req)
        self.metrics.record_recovery()
        self._recovery_streak += 1
        obs_emit("engine_recovery", engine=self.metrics.engine_label,
                 streak=self._recovery_streak)
        if self._recovery_streak > self.max_recoveries:
            self._dead = True
        return dead

    def _expire_queued(self, now: float) -> List[int]:
        out = []
        for req in self.scheduler.pop_expired(now):
            self._finalize(req, "timeout", now)
            obs_emit("request_timeout", request=req.id, where="queue")
            out.append(req.id)
        return out

    def _finalize(self, req: Request, reason: str, now: float) -> None:
        if req.id in self._results:
            return  # exactly one result: the first terminal reason wins
        req.phase = "finished"
        self._results[req.id] = ServingResult(
            id=req.id, prompt=req.prompt,
            tokens=np.asarray(req.tokens, np.int32), finish_reason=reason,
            ttft_s=(req.first_token_time or now) - req.submit_time,
            latency_s=now - req.submit_time)
        self.metrics.record_retire(now - req.submit_time, reason)

    # ------------------------------------------------- results, lifecycle

    def result(self, request_id: int) -> Optional[ServingResult]:
        """Finished result for ``request_id`` (None while in flight)."""
        return self._results.get(request_id)

    def take_result(self, request_id: int) -> Optional[ServingResult]:
        """Remove and return one finished result (None while queued)."""
        return self._results.pop(request_id, None)

    def cancel(self, request_id: int) -> bool:
        """Cancel a queued request (between ticks every unfinished request
        is queued): one ``cancelled`` result. False when the id is unknown
        or finished."""
        req = self.scheduler.remove(request_id)
        if req is None:
            return False
        self._finalize(req, "cancelled", self._now())
        obs_emit("request_cancelled", request=request_id,
                 engine=self.metrics.engine_label)
        return True

    def emitted_tokens(self, request_id: int) -> Optional[list]:
        """A queued request's migrated history (everything else is emitted
        at once when it retires); None for an unknown or finished id."""
        for r in self.scheduler.snapshot():
            if r.id == request_id:
                return list(r.tokens)
        return None

    def request_shutdown(self, grace_s: Optional[float] = None) -> None:
        """Start draining: submits are refused, queued requests run until
        the grace deadline, then the rest retire as ``shutdown``."""
        if self._shutting_down:
            return
        self._shutting_down = True
        grace = self.grace_s if grace_s is None else float(grace_s)
        self._shutdown_deadline = self._now() + max(grace, 0.0)
        obs_emit("shutdown", engine=self.metrics.engine_label,
                 active=0, queued=self.scheduler.queue_depth)

    def shutdown(self, grace_s: Optional[float] = None
                 ) -> Dict[int, ServingResult]:
        """Drain to completion: every submitted request gets a terminal
        result; returns and clears them."""
        self.request_shutdown(grace_s)
        while len(self.scheduler):
            self.step()
        out, self._results = self._results, {}
        return out

    def drain(self, max_ticks: Optional[int] = None
              ) -> Dict[int, ServingResult]:
        """Tick until the queue is empty (or ``max_ticks``), then return
        and clear every finished result."""
        n = 0
        while len(self.scheduler):
            self.step()
            n += 1
            if max_ticks is not None and n >= max_ticks:
                break
        out, self._results = self._results, {}
        return out

    def _retire_all(self, reason: str) -> List[int]:
        now = self._now()
        out = []
        for req in self.scheduler.drain_all():
            self._finalize(req, reason, now)
            out.append(req.id)
        return out

    def declare_dead(self) -> None:
        """Mark the engine dead without its shutdown (a supervisor's
        decision)."""
        self._dead = True

    # ------------------------------------------------------ health, shape

    def health(self) -> Dict:
        """The health report: ``state`` ok | draining | dead, the model
        family and its capabilities, and the queue."""
        state = ("dead" if self._dead
                 else "draining" if self._shutting_down else "ok")
        return {"state": state, "role": self.role,
                "model": self.model_family,
                "capabilities": self.capabilities.as_dict(),
                "queue_depth": self.scheduler.queue_depth,
                "queue_tokens": self.scheduler.queued_tokens(),
                "active": 0, "slots": self.slots}

    @property
    def submit_limit(self) -> int:
        """The smallest refused input size: one past the model's input
        bound (a request needs no decode room)."""
        return self.cache_len + 1
