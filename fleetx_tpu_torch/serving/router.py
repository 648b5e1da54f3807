"""ServingRouter: health-aware dispatch and zero-token-loss failover over N
serving replicas.

Port of the JAX package's ``serving/router.py``; host-only Python and
numpy. The router fronts N engines (in-process ``ServingEngine``s or
``api.replica_client.ReplicaClient`` proxies of replica processes) and
consumes only their submit/step/health/result surface.

**Dispatch.** Requests queue in PER-TENANT lanes (``submit(tenant=...)``,
threaded from the API's ``X-Fleetx-Tenant`` header) and dispatch by
deficit round robin over the lanes: each scheduling round grants every
backlogged lane a token quantum scaled by its :class:`TenantPolicy`
weight, and a lane spends its accumulated deficit on its own FIFO head
(cost = prompt tokens + decode budget), so a flooding tenant can at most
consume its weighted share. Lanes with a higher ``priority`` dispatch
strictly first, and a paid lane's deadline-at-risk request may PREEMPT a
lower-priority in-flight request through the same cancel +
``submit(history=...)`` machinery migration uses: the victim re-queues at
its OWN lane head with its delivered tokens as history, so preemption
never loses a token. ``dispatch="fifo"`` (``FLEETX_ROUTER_DISPATCH``)
restores the single-FIFO order. Admission is bounded per lane AND
fleet-wide (``FLEETX_ROUTER_MAX_QUEUE``): a tenant past its lane bound,
request rate, or token budget sheds with
:class:`~fleetx_tpu_torch.serving.engine.QueueFull` scoped to ITS lane.
Placement goes to the least-loaded in-rotation replica, scored by its
health report's ``queue_depth + active``. PREFIX AFFINITY pins the hash of
a prompt's longest full-page prefix to the replica whose trie first got
those pages, and falls back to least-loaded the moment that replica is
out of rotation or full.

**Health-based rotate-out.** Each replica is probed through its
``health()`` report (the ``/healthz`` body): ``draining`` rotates it out
of dispatch but keeps ticking it; ``dead`` or a raising probe makes it a
SUSPECT: rotated out, re-probed on a bounded exponential backoff
(``FLEETX_ROUTER_PROBE_BACKOFF`` ticks, doubling per consecutive
failure), and only after ``FLEETX_ROUTER_PROBE_MAX`` consecutive failures
marked DEAD.

**Zero-token-loss failover.** The router holds every request's prompt
and emitted-token history, fed from the engines' ``on_token`` callbacks
(the history is what the client has already seen). When a replica dies
(killed, probe escalation, or :class:`RecoveryExhausted` out of its
``step()``) its in-flight requests re-queue at their lane heads in
submission order and re-dispatch to a survivor with
``submit(history=...)``: the engine replays ``prompt + history[:-1]`` and
decoding continues from the last delivered token. Greedy streams are
byte-identical to a never-killed run. History tokens are never
re-emitted through ``on_token``.

**The sampling stream.** Each request is pinned to one integer ``seed``
(the caller's, else derived from ``base_seed`` and the router's request
id with ``numpy.random.SeedSequence``) which every dispatch re-sends with
the history; the engine's generator skips one draw per history token
(``engine.skip_draws``), so a migrated or preempted sampling stream
resumes at the exact position. (The JAX router pins a ``jax.random`` key
instead: the draws, and so sampled tokens, differ between the packages.)

**Phase-disaggregated routing.** Replicas advertise a ``role`` in the
same health report (``prefill`` / ``decode`` / ``both``). Fresh prompts
prefer PREFILL-role replicas, priced by their report's ``queue_tokens``;
each router tick then runs a HANDOFF phase: finished prefills export their
KV pages as checksummed wire blobs (``export_kv``), the request re-queues
at the head carrying them, and the next dispatch lands it on a decode
replica whose ``submit(kv_payloads=...)`` revives the pages. Every
failure in that chain falls back to the replay ladder above. With no
prefill replica in rotation the fleet degrades to colocated dispatch;
with no decode replica, prefill replicas serve as replay-decoders.

**Graceful degradation.** Queued requests past their ``queue_ttl_s`` /
``deadline_s`` are shed with ``finish_reason="timeout"``; dispatch
forwards the REMAINING deadline to the replica. A replica that turns
suspect triggers HEDGED re-dispatch (``FLEETX_ROUTER_HEDGE``): its
requests migrate to survivors at once, and if the suspect proves healthy
the router cancels the stale engine-side copies before ticking it again.
Every submitted request reaches EXACTLY ONE terminal
:class:`ServingResult` (``_finalize`` is idempotent). If every replica is
dead the router strands the rest loudly (``finish_reason="error"``,
``router_stranded`` event) rather than hanging its caller.

The router is synchronous and single-threaded like the engine: one
``step()`` probes, dispatches, ticks every live replica once, and
collects results. ``drain()`` loops to completion; ``shutdown()`` drains
every replica gracefully and finalizes the rest. Observability:
``fleetx_router_*`` metrics and the ``replica_out`` / ``replica_back`` /
``replica_dead`` / ``request_migrated`` events.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
import weakref
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from fleetx_tpu_torch.obs.events import emit as obs_emit
from fleetx_tpu_torch.obs.registry import get_registry
from fleetx_tpu_torch.obs.tracing import span
from fleetx_tpu_torch.resilience.faults import ReplicaKilled, faults
from fleetx_tpu_torch.serving.engine import (
    QueueFull,
    RecoveryExhausted,
    ServingResult,
    ShuttingDown,
    _env_float,
    _env_int,
)
from fleetx_tpu_torch.serving.metrics import _drop_series
from fleetx_tpu_torch.utils.log import logger

__all__ = ["ReplicaState", "RouterMetrics", "ServingRouter", "TenantPolicy"]

#: lane every request without an explicit tenant lands in — one default
#: lane makes DRR degenerate to the old single FIFO, so tenant-less
#: callers keep byte-identical dispatch order
DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Admission + scheduling policy for one tenant's router lane.

    ``weight`` scales the lane's deficit-round-robin quantum — its
    guaranteed share of dispatch tokens under contention. ``priority``
    orders strict dispatch tiers (higher dispatches first) and is what
    arms preemption. ``rate_rps`` / ``token_budget`` are per-second
    admission buckets (requests and cost tokens respectively; 0 = no
    limit) refilled continuously on the router clock; ``max_queue``
    bounds THIS tenant's lane (0 = unbounded). Every limit sheds with a
    lane-scoped :class:`QueueFull` — the tenant that exceeds its
    contract absorbs its own backpressure. ``preempt`` arms the
    deadline-at-risk preemption path (None = armed iff priority > 0)."""

    weight: float = 1.0
    priority: int = 0
    rate_rps: float = 0.0
    token_budget: float = 0.0
    max_queue: int = 0
    preempt: Optional[bool] = None

    @property
    def preempts(self) -> bool:
        """Whether this lane's deadline-at-risk requests may preempt."""
        return self.priority > 0 if self.preempt is None else self.preempt


@dataclasses.dataclass
class _TenantLane:
    """One tenant's FIFO queue + DRR deficit + admission-bucket state."""

    name: str
    policy: TenantPolicy
    queue: List["_RouterRequest"] = dataclasses.field(default_factory=list)
    deficit: float = 0.0
    # token buckets: level is "how much is available now", refilled
    # continuously from the policy rates on the router's swappable clock
    rate_level: float = 0.0
    budget_level: float = 0.0
    refilled: Optional[float] = None


class ReplicaState:
    """Replica lifecycle states (module docstring "rotate-out")."""

    OK = "ok"              # in rotation: receives dispatches, ticked
    SUSPECT = "suspect"    # probe failing: out of rotation, backoff re-probe
    DRAINING = "draining"  # finishing its own work: ticked, no dispatches
    DEAD = "dead"          # gone: never touched again, requests migrated


@dataclasses.dataclass
class _Replica:
    """One fronted engine + the router's view of it."""

    index: int
    engine: object
    state: str = ReplicaState.OK
    # phase role learned from the health report ("prefill"/"decode"/
    # "both"): prefill replicas get fresh prompts priced in queue
    # TOKENS and are polled for finished prefills to hand off
    role: str = "both"
    # model family served (the /healthz ``model`` key): dispatch filters
    # by it BEFORE load/affinity — a GPT prompt never lands on an ERNIE
    # replica, and fallback stays inside the family group
    model: str = "gpt"
    probe_failures: int = 0          # consecutive non-ok probes
    next_probe_tick: int = 0         # backoff schedule while suspect
    dispatched: Dict[int, int] = dataclasses.field(default_factory=dict)
    # engine rids hedged away while suspect; cancelled if/when it rejoins
    stale: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _RouterRequest:
    """One router-level request across dispatches/migrations."""

    rid: int
    prompt: np.ndarray
    model: str                    # family group this request dispatches to
    kw: Dict                      # engine submit kwargs (decode knobs)
    seed: int                     # SAME seed at every dispatch (RNG parity)
    on_token: Optional[object]
    submit_time: float
    queue_ttl_s: float
    deadline_s: float
    # when THIS queue residency began: reset at every (re-)enqueue, so
    # the queue TTL measures waiting — a migrated request that already
    # ran for minutes must not be shed the instant it re-queues
    # (deadline_s stays anchored to submit_time: total lifetime)
    queued_since: float = 0.0
    affinity_key: Optional[int] = None
    state: str = "queued"         # queued | dispatched | finished
    replica: Optional[int] = None
    engine_rid: Optional[int] = None
    dispatches: int = 0
    first_token_time: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    # disaggregated handoff: wire-format page blobs export_kv() shipped,
    # consumed by the next dispatch (cleared on success OR on a decode-
    # side ValueError — the replay fallback never re-sends bad blobs)
    kv_payloads: Optional[list] = None
    tenant: str = DEFAULT_TENANT
    preemptions: int = 0          # times evicted for a higher-priority lane


class RouterMetrics:
    """``fleetx_router_*`` registry instruments for one router, labeled
    ``router="<n>"``, the JAX router's families and labels. The same
    owned-series + weakref-finalize discipline as ``ServingMetrics``:
    cycling routers cannot grow ``/metrics`` forever."""

    _labels = itertools.count()

    def __init__(self, registry=None):
        reg = registry or get_registry()
        self.router_label = str(next(self._labels))
        lab = {"router": self.router_label}
        self._owned = owned = []

        def child(fam):
            owned.append((fam, dict(lab)))
            return fam.labels(**lab)

        def counter(name, help):
            return child(reg.counter(name, help, ("router",)))

        def gauge(name, help):
            return child(reg.gauge(name, help, ("router",)))

        def hist(name, help):
            return child(reg.histogram(name, help, ("router",)))

        self._g_replicas = gauge(
            "fleetx_router_replicas",
            "Replicas this router fronts (dead ones included)")
        self._g_in_rotation = gauge(
            "fleetx_router_replicas_in_rotation",
            "Replicas currently receiving dispatches (state ok)")
        self._g_queue_depth = gauge(
            "fleetx_router_queue_depth",
            "Requests waiting in the router-level queue")
        self._c_ticks = counter(
            "fleetx_router_ticks_total", "Router scheduler ticks executed")
        self._c_dispatched = counter(
            "fleetx_router_dispatched_total",
            "Dispatches to a replica (migrations re-count)")
        self._c_affinity = counter(
            "fleetx_router_affinity_hits_total",
            "Dispatches placed by prefix affinity (warm-trie pin)")
        self._c_migrated = counter(
            "fleetx_router_migrated_total",
            "In-flight requests migrated off a suspect/dead replica")
        self._c_deaths = counter(
            "fleetx_router_replica_deaths_total",
            "Replicas marked dead (probe escalation, kill, "
            "RecoveryExhausted)")
        self._c_probe_failures = counter(
            "fleetx_router_probe_failures_total",
            "Health probes that returned non-ok or raised")
        self._c_rejected = counter(
            "fleetx_router_rejected_total",
            "Submits refused by the bounded router queue")
        self._c_shed = counter(
            "fleetx_router_shed_total",
            "Queued requests shed by queue-TTL/deadline expiry")
        self._c_preempted = counter(
            "fleetx_router_preempted_total",
            "In-flight requests preempted for a higher-priority lane's "
            "deadline-at-risk request (zero-loss: victims re-queue with "
            "history)")
        self._finished_family = reg.counter(
            "fleetx_router_finished_total",
            "Requests that reached their one terminal result, by reason",
            ("router", "reason"))
        # per-tenant QoS families, labeled (router, tenant) — children
        # materialize lazily per tenant seen, owned for finalize-cleanup
        tl = ("router", "tenant")
        self._tenant_families = {
            "queue_depth": reg.gauge(
                "fleetx_router_tenant_queue_depth",
                "Requests waiting in this tenant's router lane", tl),
            "shed": reg.counter(
                "fleetx_router_tenant_shed_total",
                "This tenant's requests refused at admission (lane bound, "
                "rate, token budget) or shed from its lane by "
                "TTL/deadline", tl),
            "preempted": reg.counter(
                "fleetx_router_tenant_preempted_total",
                "This tenant's in-flight requests preempted by a "
                "higher-priority lane", tl),
            "dispatched": reg.counter(
                "fleetx_router_tenant_dispatched_total",
                "Dispatches of this tenant's requests (migrations "
                "re-count)", tl),
            "tokens": reg.counter(
                "fleetx_router_tenant_tokens_total",
                "Tokens delivered in this tenant's terminal results", tl),
            "goodput_share": reg.gauge(
                "fleetx_router_tenant_goodput_share",
                "This tenant's fraction of all tokens this router "
                "delivered", tl),
        }
        self._tenant_children: Dict[Tuple[str, str], object] = {}
        self._per_tenant: Dict[str, Dict[str, int]] = {}
        self._h_ttft = hist(
            "fleetx_router_ttft_seconds",
            "Router submit -> first token on the host (end-to-end across "
            "queueing, dispatch, and any migration)")
        self._h_latency = hist(
            "fleetx_router_request_latency_seconds",
            "Router submit -> terminal result latency")
        self._h_queue_depth = hist(
            "fleetx_router_queue_depth_per_tick",
            "Router queue depth sampled once per tick")
        self._reasons: Dict[str, object] = {}
        weakref.finalize(self, _drop_series, owned)

    def _tenant_child(self, key: str, tenant: str):
        """Memoized per-tenant child of one QoS family (owned for the
        weakref-finalize cleanup like every other child)."""
        child = self._tenant_children.get((key, tenant))
        if child is None:
            labels = {"router": self.router_label, "tenant": tenant}
            fam = self._tenant_families[key]
            self._owned.append((fam, labels))
            child = fam.labels(**labels)
            self._tenant_children[(key, tenant)] = child
        return child

    def _tenant_stats(self, tenant: str) -> Dict[str, int]:
        return self._per_tenant.setdefault(
            tenant, {"shed": 0, "preempted": 0, "dispatched": 0,
                     "tokens": 0})

    def record_reject(self, tenant: str = DEFAULT_TENANT) -> None:
        """A submit was refused at admission (queue bound/rate/budget)."""
        self._c_rejected.inc()
        self._tenant_stats(tenant)["shed"] += 1
        self._tenant_child("shed", tenant).inc()

    def record_shed(self, tenant: str = DEFAULT_TENANT) -> None:
        """A queued request was shed by TTL/deadline expiry."""
        self._c_shed.inc()
        self._tenant_stats(tenant)["shed"] += 1
        self._tenant_child("shed", tenant).inc()

    def record_probe_failure(self) -> None:
        """A health probe returned non-ok or raised."""
        self._c_probe_failures.inc()

    def record_dispatch(self, affinity: bool,
                        tenant: str = DEFAULT_TENANT) -> None:
        """One dispatch placed (``affinity`` = via the prefix pin)."""
        self._c_dispatched.inc()
        if affinity:
            self._c_affinity.inc()
        self._tenant_stats(tenant)["dispatched"] += 1
        self._tenant_child("dispatched", tenant).inc()

    def record_preempted(self, victim_tenant: str) -> None:
        """One in-flight request preempted for a higher-priority lane."""
        self._c_preempted.inc()
        self._tenant_stats(victim_tenant)["preempted"] += 1
        self._tenant_child("preempted", victim_tenant).inc()

    def observe_tenant_queue(self, tenant: str, depth: int) -> None:
        """Per-tick lane-depth gauge sample."""
        self._tenant_child("queue_depth", tenant).set(depth)

    def record_tenant_tokens(self, tenant: str, n_tokens: int) -> None:
        """Terminal result delivered ``n_tokens`` to ``tenant``; refresh
        every tenant's delivered-token share gauge."""
        st = self._tenant_stats(tenant)
        st["tokens"] += int(n_tokens)
        if n_tokens:
            self._tenant_child("tokens", tenant).inc(int(n_tokens))
        total = sum(s["tokens"] for s in self._per_tenant.values())
        if total:
            for t, s in self._per_tenant.items():
                self._tenant_child("goodput_share", t).set(
                    s["tokens"] / total)

    def record_migrated(self) -> None:
        """One in-flight request migrated off its replica."""
        self._c_migrated.inc()

    def record_replica_death(self) -> None:
        """One replica was marked dead."""
        self._c_deaths.inc()

    def record_finished(self, reason: str, latency_s: float) -> None:
        """One request reached its terminal result."""
        child = self._reasons.get(reason)
        if child is None:
            labels = {"router": self.router_label, "reason": reason}
            self._owned.append((self._finished_family, labels))
            child = self._reasons[reason] = self._finished_family.labels(
                **labels)
        child.inc()
        self._h_latency.observe(latency_s)

    def observe_ttft(self, ttft_s: float) -> None:
        """First token of a request reached the caller."""
        self._h_ttft.observe(ttft_s)

    def observe_tick(self, queue_depth: int, replicas: int,
                     in_rotation: int) -> None:
        """Per-tick gauge sample."""
        self._c_ticks.inc()
        self._g_queue_depth.set(queue_depth)
        self._g_replicas.set(replicas)
        self._g_in_rotation.set(in_rotation)
        self._h_queue_depth.observe(queue_depth)

    @property
    def finish_reasons(self) -> Dict[str, int]:
        """``{finish_reason: count}`` over terminal results."""
        return {r: int(c.value) for r, c in self._reasons.items()
                if int(c.value)}

    def snapshot(self) -> Dict:
        """Aggregate dict the benches/tests consume."""
        ticks = int(self._c_ticks.value)
        ttft_p50, ttft_p99 = self._h_ttft.quantiles((50, 99))
        lat_p50, lat_p99 = self._h_latency.quantiles((50, 99))
        return {
            "replicas": int(self._g_replicas.value),
            "replicas_in_rotation": int(self._g_in_rotation.value),
            "queue_depth": int(self._g_queue_depth.value),
            "queue_depth_mean": (self._h_queue_depth.sum / ticks
                                 if ticks else 0.0),
            "ticks": ticks,
            "dispatched": int(self._c_dispatched.value),
            "affinity_hits": int(self._c_affinity.value),
            "migrated": int(self._c_migrated.value),
            "replica_deaths": int(self._c_deaths.value),
            "probe_failures": int(self._c_probe_failures.value),
            "rejected": int(self._c_rejected.value),
            "shed": int(self._c_shed.value),
            "preempted": int(self._c_preempted.value),
            "per_tenant": {t: dict(s) for t, s in self._per_tenant.items()},
            "finished": sum(self.finish_reasons.values()),
            "finish_reasons": self.finish_reasons,
            "ttft_s_p50": ttft_p50,
            "ttft_s_p99": ttft_p99,
            "latency_s_p50": lat_p50,
            "latency_s_p99": lat_p99,
        }


class ServingRouter:
    """Fault-tolerant request router over N serving replicas (module
    docstring). ``replicas`` is a list of constructed ``ServingEngine``s
    — each replica's slots/pages/mesh are its own capacity, the router
    only consumes the submit/step/health/result surface."""

    _AFFINITY_CAP = 65536  # prefix pins kept (insertion-ordered, oldest out)
    _HOT_PREFIX_CAP = 32   # most-reused prefixes tracked for prewarming
    _MAX_DRR_ROUNDS = 4096  # converges far earlier; loud loop backstop

    #: capability flag the API server probes before threading
    #: ``submit(tenant=...)`` — plain engines don't take the kwarg
    supports_tenants = True

    def __init__(self, replicas, *, max_queue: Optional[int] = None,
                 queue_ttl_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 probe_every: Optional[int] = None,
                 probe_max_failures: Optional[int] = None,
                 probe_backoff_ticks: Optional[int] = None,
                 hedge: Optional[bool] = None,
                 affinity: Optional[bool] = None,
                 base_seed: int = 0,
                 metrics: Optional[RouterMetrics] = None,
                 tenants: Optional[Dict[str, TenantPolicy]] = None,
                 dispatch: Optional[str] = None,
                 preempt: Optional[bool] = None,
                 preempt_risk_frac: Optional[float] = None,
                 drr_quantum: Optional[int] = None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self._replicas = [_Replica(index=i, engine=e,
                                   role=getattr(e, "role", "both"),
                                   model=getattr(e, "model_family", "gpt"))
                          for i, e in enumerate(replicas)]
        self.max_queue = (max_queue if max_queue is not None
                          else _env_int("FLEETX_ROUTER_MAX_QUEUE", 0))
        self.queue_ttl_s = (queue_ttl_s if queue_ttl_s is not None
                            else _env_float("FLEETX_ROUTER_QUEUE_TTL_S", 0.0))
        self.deadline_s = (deadline_s if deadline_s is not None
                           else _env_float("FLEETX_ROUTER_DEADLINE_S", 0.0))
        # probing cadence: in-process probes are a method call, so the
        # default probes every tick; a cross-process router GETting
        # /healthz raises this to its scrape budget
        self.probe_every = max(1, probe_every if probe_every is not None
                               else _env_int("FLEETX_ROUTER_PROBE_EVERY", 1))
        self.probe_max_failures = max(
            1, probe_max_failures if probe_max_failures is not None
            else _env_int("FLEETX_ROUTER_PROBE_MAX", 3))
        self.probe_backoff_ticks = max(
            1, probe_backoff_ticks if probe_backoff_ticks is not None
            else _env_int("FLEETX_ROUTER_PROBE_BACKOFF", 2))
        self.hedge = (hedge if hedge is not None
                      else _env_int("FLEETX_ROUTER_HEDGE", 1) == 1)
        self.affinity = (affinity if affinity is not None
                         else _env_int("FLEETX_ROUTER_AFFINITY", 1) == 1)
        # affinity granularity: the page is the trie-sharing unit, so the
        # pinned prefix is the longest FULL-page run (0 disables when the
        # fleet is not paged — there is no warm trie to pin to)
        page_sizes = {e.page_size for e in replicas if e.paged}
        self._affinity_page = min(page_sizes) if page_sizes else 0
        self._affinity_map: Dict[int, int] = {}  # prefix hash -> replica
        # the tightest per-request capacity PER MODEL GROUP, so caller
        # mistakes (over-long prompts, unservable strategies) raise AT
        # SUBMIT like the engine's contract — not as a delayed
        # finish_reason="error" result out of the first dispatch.
        # ``submit_limit`` is the protocol seam (the smallest REJECTED
        # size); the getattr fallback keeps pre-protocol engine doubles
        # (tests, RPC proxies) working on the old cache/position formula
        self._limits: Dict[str, int] = {}
        for rep in self._replicas:
            e = rep.engine
            lim = getattr(e, "submit_limit", None)
            if lim is None:
                lim = min(e.cache_len,
                          e.model.cfg.max_position_embeddings)
            self._limits[rep.model] = min(
                self._limits.get(rep.model, lim), lim)
        # single-model callers never name a family: replica 0's group is
        # the default, which on a homogeneous fleet is the whole fleet
        self._default_model = self._replicas[0].model
        self._limit = self._limits[self._default_model]
        self.base_seed = int(base_seed)
        self.metrics = metrics or RouterMetrics()
        # ---- per-tenant QoS dispatch (module docstring "Dispatch") ----
        self.dispatch_mode = (
            dispatch if dispatch is not None
            else os.environ.get("FLEETX_ROUTER_DISPATCH", "drr"))
        if self.dispatch_mode not in ("drr", "fifo"):
            raise ValueError(
                f"dispatch mode {self.dispatch_mode!r} (want drr|fifo)")
        self.preempt_enabled = (
            preempt if preempt is not None
            else _env_int("FLEETX_ROUTER_PREEMPT", 1) == 1)
        self.preempt_risk_frac = max(0.0, (
            preempt_risk_frac if preempt_risk_frac is not None
            else _env_float("FLEETX_ROUTER_PREEMPT_RISK_FRAC", 0.5)))
        self.drr_quantum = max(1, (
            drr_quantum if drr_quantum is not None
            else _env_int("FLEETX_ROUTER_DRR_QUANTUM", 256)))
        self._tenant_policies: Dict[str, TenantPolicy] = dict(tenants or {})
        self._lanes: Dict[str, _TenantLane] = {}
        for name in self._tenant_policies:  # eager: stable DRR lane order
            self._lane(name)
        # most-reused full-page prefixes seen at submit — what a freshly
        # spawned replica prewarms from the shared page store
        self._hot_prefixes: Dict[int, list] = {}  # key -> [prefix, hits]
        self._requests: Dict[int, _RouterRequest] = {}
        self._results: Dict[int, ServingResult] = {}
        self._next_id = 0
        self._ticks = 0
        self._shutting_down = False
        self._now = time.perf_counter  # swappable clock (chaos tests)

    # ------------------------------------------------------------ submit

    def submit(self, prompt, *, max_length: Optional[int] = None,
               min_length: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               decode_strategy: Optional[str] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               seed: Optional[int] = None, on_token=None,
               queue_ttl_s: Optional[float] = None,
               deadline_s: Optional[float] = None,
               model: Optional[str] = None,
               tenant: Optional[str] = None) -> int:
        """Queue one request; returns its router-level id. The kwargs
        mirror ``ServingEngine.submit`` (they are forwarded verbatim at
        every dispatch); ``seed`` pins the request's sampling stream —
        the SAME seed re-sends at each migration, which is what makes
        sampling failover RNG-position-exact. ``model`` names the family
        group to dispatch into (default: replica 0's family, so
        single-model callers never change); an unserved family raises
        ValueError at submit, loudly. ``tenant`` names the QoS lane the
        request queues in (default: the shared ``"default"`` lane);
        admission enforces that lane's :class:`TenantPolicy` bounds.
        Raises :class:`QueueFull` at the fleet-wide
        ``FLEETX_ROUTER_MAX_QUEUE`` bound or any per-lane limit (the
        message names the lane) and :class:`ShuttingDown` after
        :meth:`shutdown` began."""
        if self._shutting_down:
            raise ShuttingDown(
                "router is shutting down; submit to another cluster")
        tenant = tenant if tenant else DEFAULT_TENANT
        if self.max_queue and self.queue_depth >= self.max_queue:
            self._shed_expired(self._now())  # dead entries don't hold slots
        if self.max_queue and self.queue_depth >= self.max_queue:
            self.metrics.record_reject(tenant)
            obs_emit("queue_reject", router=self.metrics.router_label,
                     queue_depth=self.queue_depth, tenant=tenant)
            raise QueueFull(
                f"router queue is full ({self.queue_depth}/{self.max_queue}"
                " waiting); retry later or raise FLEETX_ROUTER_MAX_QUEUE")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if decode_strategy is not None and decode_strategy not in (
                "greedy", "sampling"):
            raise ValueError(
                f"decode_strategy {decode_strategy!r} not servable by "
                "continuous batching (beam search needs one-shot "
                "generate())")
        if model is None:
            model = self._default_model
        if model not in self._limits:
            raise ValueError(
                f"model {model!r} is not served by this fleet (serving: "
                f"{sorted(self._limits)})")
        if prompt.size >= self._limits[model]:
            raise ValueError(
                f"prompt_len {prompt.size} is not servable by any "
                f"{model!r} replica (tightest per-request limit "
                f"{self._limits[model]})")
        lane = self._lane(tenant)
        self._admit_lane(lane, prompt, max_length)
        rid = self._next_id
        self._next_id += 1
        if seed is None:
            seed = int(np.random.SeedSequence(
                [self.base_seed, rid]).generate_state(1)[0])
        kw = {}
        for name, value in (("max_length", max_length),
                            ("min_length", min_length),
                            ("eos_token_id", eos_token_id),
                            ("decode_strategy", decode_strategy),
                            ("temperature", temperature),
                            ("top_k", top_k), ("top_p", top_p)):
            if value is not None:
                kw[name] = value
        now = self._now()
        req = _RouterRequest(
            rid=rid, prompt=prompt, model=model, kw=kw, seed=int(seed),
            on_token=on_token, submit_time=now, queued_since=now,
            queue_ttl_s=float(queue_ttl_s if queue_ttl_s is not None
                              else self.queue_ttl_s),
            deadline_s=float(deadline_s if deadline_s is not None
                             else self.deadline_s),
            affinity_key=self._affinity_key(prompt),
            tenant=tenant,
        )
        self._requests[rid] = req
        lane.queue.append(req)
        if req.affinity_key is not None:
            self._note_hot_prefix(req.affinity_key, prompt)
        return rid

    # --------------------------------------------- tenant lanes (QoS)

    def _lane(self, tenant: str) -> _TenantLane:
        """The tenant's lane, created on first sight with its configured
        :class:`TenantPolicy` (or the open default policy)."""
        lane = self._lanes.get(tenant)
        if lane is None:
            lane = self._lanes[tenant] = _TenantLane(
                name=tenant,
                policy=self._tenant_policies.get(tenant, TenantPolicy()))
        return lane

    def _cost(self, req: _RouterRequest) -> float:
        """DRR/budget cost of one request in TOKENS: prompt plus the
        decode budget it asked for (the same units prefill replicas are
        priced in — a flooding tenant pays for the work it books, not
        the requests it counts). The prompt counts the rows of work its
        family's engine runs for it where the engine says
        (``request_rows``: a KV-free engine, whose ViT prices an image at
        its 197 tokens, not its 150,528 wire ints), else its length. JAX
        prices every prompt by its length (router.py:735)."""
        return float(self._prompt_rows(req)) + float(
            req.kw.get("max_length", 0) or 0)

    def _prompt_rows(self, req: _RouterRequest) -> int:
        """The rows of work of ``req``'s prompt: ``request_rows`` of the
        first engine of its family that has it, else the prompt's
        length."""
        for rep in self._replicas:
            if rep.model == req.model:
                rows = getattr(rep.engine, "request_rows", None)
                if rows is not None:
                    return int(rows(req.prompt))
        return int(req.prompt.size)

    def _refill_buckets(self, lane: _TenantLane, now: float) -> None:
        """Continuous token-bucket refill on the router clock. Burst
        capacity is one second's worth of each rate — enough to absorb
        a bursty arrival at the contracted average."""
        pol = lane.policy
        if lane.refilled is None:
            lane.rate_level = max(pol.rate_rps, 1.0)
            lane.budget_level = pol.token_budget
        else:
            dt = max(0.0, now - lane.refilled)
            lane.rate_level = min(max(pol.rate_rps, 1.0),
                                  lane.rate_level + dt * pol.rate_rps)
            lane.budget_level = min(pol.token_budget,
                                    lane.budget_level
                                    + dt * pol.token_budget)
        lane.refilled = now

    def _admit_lane(self, lane: _TenantLane, prompt: np.ndarray,
                    max_length: Optional[int]) -> None:
        """Per-lane admission control: lane queue bound, request-rate
        bucket, token-budget bucket. Every refusal is a
        :class:`QueueFull` scoped to THIS lane — the tenant exceeding
        its contract sheds its own requests, never the fleet's."""
        pol = lane.policy
        why = None
        if pol.max_queue and len(lane.queue) >= pol.max_queue:
            why = (f"lane is full ({len(lane.queue)}/{pol.max_queue} "
                   "waiting)")
        else:
            now = self._now()
            self._refill_buckets(lane, now)
            cost = float(prompt.size) + float(max_length or 0)
            if pol.rate_rps and lane.rate_level < 1.0:
                why = f"request rate above {pol.rate_rps}/s"
            elif pol.token_budget and lane.budget_level < cost:
                why = (f"token budget exhausted (request costs "
                       f"{cost:.0f} tokens, {lane.budget_level:.0f} "
                       f"available at {pol.token_budget}/s)")
            else:
                if pol.rate_rps:
                    lane.rate_level -= 1.0
                if pol.token_budget:
                    lane.budget_level -= cost
        if why is not None:
            self.metrics.record_reject(lane.name)
            obs_emit("queue_reject", router=self.metrics.router_label,
                     tenant=lane.name, queue_depth=len(lane.queue))
            raise QueueFull(f"tenant {lane.name!r}: {why}; retry later "
                            "or raise this tenant's TenantPolicy limits")

    def _queued(self) -> List[_RouterRequest]:
        """Queued requests across every lane in global submission order
        (migrated/preempted re-queues sit at their lane heads and carry
        the oldest rids, so rid order IS the legacy single-FIFO order)."""
        out = [r for lane in self._lanes.values() for r in lane.queue]
        out.sort(key=lambda r: r.rid)
        return out

    def _prune_lanes(self) -> None:
        """Drop dispatched/finalized requests out of every lane queue."""
        for lane in self._lanes.values():
            if any(r.state != "queued" for r in lane.queue):
                lane.queue = [r for r in lane.queue if r.state == "queued"]

    def _requeue_head(self, reqs: List[_RouterRequest]) -> None:
        """Re-queue migrated/continued requests at their OWN lane heads
        in submission order (the lane-aware version of the old
        head-of-queue prepend)."""
        for req in sorted(reqs, key=lambda r: r.rid, reverse=True):
            self._lane(req.tenant).queue.insert(0, req)

    def _note_hot_prefix(self, key: int, prompt: np.ndarray) -> None:
        """Track the most-reused full-page prefixes (bounded): the warm
        set :meth:`hot_prefixes` hands the autoscaler for prewarming a
        fresh replica's trie from the shared page store."""
        ent = self._hot_prefixes.get(key)
        if ent is not None:
            ent[1] += 1
            return
        n = (prompt.size // self._affinity_page) * self._affinity_page
        self._hot_prefixes[key] = [np.ascontiguousarray(prompt[:n]), 1]
        while len(self._hot_prefixes) > self._HOT_PREFIX_CAP:
            coldest = min(self._hot_prefixes,
                          key=lambda k: self._hot_prefixes[k][1])
            del self._hot_prefixes[coldest]

    def hot_prefixes(self, k: int = 8) -> List[np.ndarray]:
        """The ``k`` most-reused full-page prompt prefixes this router
        has admitted — what a freshly spawned replica prewarms from the
        shared :class:`DiskPageStore` before taking traffic."""
        ents = sorted(self._hot_prefixes.values(), key=lambda e: -e[1])
        return [e[0] for e in ents[:k]]

    def _affinity_key(self, prompt: np.ndarray) -> Optional[int]:
        """Hash of the longest FULL-page prompt prefix (None when
        affinity is off, the fleet is unpaged, or no page fills): the
        page is the trie-sharing granularity, so this is exactly the
        prefix whose warm pages a previous session may have parked."""
        if not self.affinity or not self._affinity_page:
            return None
        n = (prompt.size // self._affinity_page) * self._affinity_page
        if n == 0:
            return None
        return zlib.crc32(np.ascontiguousarray(prompt[:n]).tobytes())

    # -------------------------------------------------------------- step

    def step(self) -> Dict:
        """One router tick: shed expired queued work, probe due replicas
        (rotate out / escalate / rejoin), dispatch the queue, tick every
        live replica once (collecting results and handling death), and
        strand the remainder loudly if the whole fleet is gone. Returns
        a summary dict."""
        self._ticks += 1
        now = self._now()
        shed = self._shed_expired(now)
        self._probe_due()
        handoff = self._handoff()
        dispatched = self._dispatch()
        finished, migrated = self._tick_replicas()
        stranded = self._strand_if_no_replicas()
        in_rotation = sum(r.state == ReplicaState.OK for r in self._replicas)
        self.metrics.observe_tick(self.queue_depth, len(self._replicas),
                                  in_rotation)
        for lane in self._lanes.values():
            self.metrics.observe_tenant_queue(lane.name, len(lane.queue))
        return {"dispatched": dispatched, "finished": finished,
                "migrated": migrated, "handoff": handoff,
                "shed": shed + stranded,
                "queue_depth": self.queue_depth,
                "in_rotation": in_rotation,
                "replica_states": [r.state for r in self._replicas]}

    def drain(self, max_ticks: Optional[int] = None
              ) -> Dict[int, ServingResult]:
        """Tick until every submitted request has its terminal result
        (or ``max_ticks``), then return-and-clear the finished results."""
        n = 0
        while any(r.state != "finished" for r in self._requests.values()):
            self.step()
            n += 1
            if max_ticks is not None and n >= max_ticks:
                break
        out, self._results = self._results, {}
        for rid in out:
            self._requests.pop(rid, None)
        return out

    def result(self, request_id: int) -> Optional[ServingResult]:
        """Finished result for ``request_id`` (None while in flight)."""
        return self._results.get(request_id)

    def take_result(self, request_id: int) -> Optional[ServingResult]:
        """Remove and return one finished result (None while in flight)."""
        res = self._results.pop(request_id, None)
        if res is not None:
            self._requests.pop(request_id, None)
        return res

    def cancel(self, request_id: int) -> bool:
        """Cancel a queued or dispatched request (exactly one terminal
        result with ``finish_reason="cancelled"``, partial tokens kept).
        False when unknown or already finished."""
        req = self._requests.get(request_id)
        if req is None or req.state == "finished":
            return False
        if req.state == "dispatched":
            rep = self._replicas[req.replica]
            rep.dispatched.pop(req.engine_rid, None)
            if rep.state not in (ReplicaState.DEAD,):
                try:
                    rep.engine.cancel(req.engine_rid)
                    rep.engine.take_result(req.engine_rid)  # drop the copy
                except Exception:  # noqa: BLE001 — a dying replica is fine
                    pass
        else:
            lane = self._lane(req.tenant)
            lane.queue = [r for r in lane.queue if r.rid != request_id]
        self._finalize(req, "cancelled")
        obs_emit("request_cancelled", request=request_id,
                 router=self.metrics.router_label)
        return True

    def shutdown(self, grace_s: Optional[float] = None
                 ) -> Dict[int, ServingResult]:
        """Graceful cluster drain: stop router admission, ask every live
        replica to drain (``request_shutdown``), tick until every request
        has its terminal result (replicas retire leftovers at their grace
        deadline), finalize still-queued requests as ``"shutdown"``, and
        return-and-clear all results."""
        self._shutting_down = True
        for rep in self._replicas:
            if rep.state != ReplicaState.DEAD:
                try:
                    rep.engine.request_shutdown(grace_s)
                except Exception:  # noqa: BLE001 — best-effort on a zombie
                    pass
        while any(r.state == "dispatched" for r in self._requests.values()):
            self.step()
        for req in self._queued():
            self._finalize(req, "shutdown")
        for lane in self._lanes.values():
            lane.queue = []
        out, self._results = self._results, {}
        for rid in out:
            self._requests.pop(rid, None)
        return out

    # --------------------------------------------------------- internals

    def _shed_expired(self, now: float) -> int:
        """Deadline-aware shedding of the ROUTER queue: queued requests
        past their queue-TTL or total deadline finalize as ``"timeout"``
        (migrated partials kept) instead of occupying queue slots they
        can no longer use."""
        shed = 0
        for lane in self._lanes.values():
            keep = []
            for req in lane.queue:
                waiting = now - req.queued_since   # THIS queue residency
                age = now - req.submit_time        # total lifetime
                if ((req.queue_ttl_s and waiting > req.queue_ttl_s)
                        or (req.deadline_s and age > req.deadline_s)):
                    self._finalize(req, "timeout")
                    obs_emit("request_timeout", request=req.rid,
                             where="router_queue", tenant=req.tenant)
                    self.metrics.record_shed(req.tenant)
                    shed += 1
                else:
                    keep.append(req)
            lane.queue = keep
        return shed

    def _probe(self, rep: _Replica) -> Dict:
        """One health probe: the flap injector may LIE, otherwise the
        replica's ``health()`` report (== its ``/healthz`` body); a
        raising probe reads as dead."""
        lie = faults.on_router_probe(rep.index)
        if lie is not None:
            return lie
        try:
            return rep.engine.health()
        except Exception as e:  # noqa: BLE001 — unreachable replica
            return {"state": "dead", "error": f"{type(e).__name__}: {e}"}

    def _probe_due(self) -> None:
        """Probe replicas whose schedule is due: healthy/draining ones on
        the ``probe_every`` cadence, suspects on their bounded-backoff
        schedule. State transitions per the module docstring."""
        for rep in self._replicas:
            if rep.state == ReplicaState.DEAD:
                continue
            if rep.state == ReplicaState.SUSPECT:
                if self._ticks < rep.next_probe_tick:
                    continue
            elif (self._ticks - 1) % self.probe_every:
                continue
            report = self._probe(rep)
            state = report.get("state", "dead")
            # roles and model families ride the health report so a
            # cross-process router learns placement phases AND grouping
            # from the same /healthz scrape
            rep.role = report.get("role", rep.role)
            rep.model = report.get("model", rep.model)
            if state == "ok":
                if rep.state == ReplicaState.SUSPECT:
                    self._rejoin(rep)
                rep.probe_failures = 0
            elif state == "draining":
                # the replica is finishing its own work: no dispatches,
                # keep ticking, never escalate to dead on this signal.
                # A SUSPECT turning draining must first cancel its
                # hedged-away stale copies — draining replicas ARE
                # ticked, and a stale copy decoding there would
                # double-deliver tokens the migrated copy owns
                if rep.state != ReplicaState.DRAINING:
                    self._cancel_stale(rep)
                    rep.state = ReplicaState.DRAINING
                    obs_emit("replica_out", replica=rep.index,
                             reason="draining")
                    logger.warning(
                        "router: replica %d rotated out (draining)",
                        rep.index)
            else:  # dead / unreachable
                rep.probe_failures += 1
                self.metrics.record_probe_failure()
                if rep.probe_failures >= self.probe_max_failures:
                    self._mark_dead(rep, f"probe escalation "
                                    f"({rep.probe_failures} failures)")
                    continue
                backoff = (self.probe_backoff_ticks
                           * (2 ** (rep.probe_failures - 1)))
                rep.next_probe_tick = self._ticks + min(backoff, 64)
                if rep.state == ReplicaState.OK:
                    rep.state = ReplicaState.SUSPECT
                    obs_emit("replica_out", replica=rep.index,
                             reason=state,
                             probe_failures=rep.probe_failures)
                    logger.warning(
                        "router: replica %d rotated out (probe says %r); "
                        "re-probing with backoff before declaring it dead",
                        rep.index, state)
                    if self.hedge:
                        # hedged re-dispatch: do not wait out the probe
                        # escalation — move its work to survivors now and
                        # cancel the stale copies if it ever rejoins
                        self._migrate_all(rep, why="hedge", stale=True)

    def _cancel_stale(self, rep: _Replica) -> None:
        """Cancel and drop the engine-side copies of requests hedged
        away while ``rep`` was suspect — exactly-one-stream: the
        migrated copy is the live one, so before this engine is ever
        ticked again (rejoin OR drain) its stale copies must die."""
        for erid in rep.stale:
            try:
                rep.engine.cancel(erid)
                rep.engine.take_result(erid)  # drop the cancelled copy
            except Exception:  # noqa: BLE001
                pass
        rep.stale = []

    def _rejoin(self, rep: _Replica) -> None:
        """A suspect proved healthy: cancel the engine-side copies of
        hedged-away requests (exactly-one-result: the migrated copy is
        the live one), then put the replica back in rotation."""
        self._cancel_stale(rep)
        rep.state = ReplicaState.OK
        rep.probe_failures = 0
        obs_emit("replica_back", replica=rep.index)
        logger.warning("router: replica %d back in rotation", rep.index)

    def _mark_dead(self, rep: _Replica, reason: str) -> None:
        """Point of no return for one replica: declare it dead, migrate
        everything it still held, drop its affinity pins."""
        if rep.state == ReplicaState.DEAD:
            return
        rep.state = ReplicaState.DEAD
        try:
            rep.engine.declare_dead()
        except Exception:  # noqa: BLE001 — the process may be gone
            pass
        self.metrics.record_replica_death()
        obs_emit("replica_dead", replica=rep.index, reason=reason)
        logger.error("router: replica %d is DEAD (%s); migrating %d "
                     "in-flight request(s)", rep.index, reason,
                     len(rep.dispatched))
        self._migrate_all(rep, why="replica_dead")
        self._affinity_map = {k: v for k, v in self._affinity_map.items()
                              if v != rep.index}

    def _migrate_all(self, rep: _Replica, *, why: str,
                     stale: bool = False) -> int:
        """Re-queue every request dispatched to ``rep`` at the router
        queue HEAD in submission order, each carrying its durable token
        history for the admit-with-history re-dispatch. ``stale`` tracks
        the engine-side rids for cancel-on-rejoin (hedging)."""
        moved = []
        for erid, rid in sorted(rep.dispatched.items(), key=lambda kv: kv[1]):
            req = self._requests[rid]
            if req.state != "dispatched":
                continue
            req.state = "queued"
            req.replica = None
            req.engine_rid = None
            req.queued_since = self._now()  # fresh TTL clock (re-queue)
            moved.append(req)
            if stale:
                rep.stale.append(erid)
            self.metrics.record_migrated()
            obs_emit("request_migrated", request=rid, replica=rep.index,
                     tokens=len(req.tokens), why=why)
        rep.dispatched = {}
        self._requeue_head(moved)
        return len(moved)

    def _handoff(self) -> int:
        """Disaggregated prefill→decode handoff: pull
        every finished prefill off the in-rotation PREFILL-role
        replicas, export its KV pages as wire blobs, and re-queue the
        request at the HEAD carrying the payloads — the next dispatch
        lands it on a decode replica that revives the pages instead of
        re-prefilling. Export failure of any kind (fault injector,
        replica error) falls back to the replay ladder: the first
        token is already in the durable router history, so the request
        re-queues WITHOUT payloads and replays on a survivor — slower,
        never wrong, zero tokens lost."""
        moved = []
        for rep in self._replicas:
            if (rep.role != "prefill"
                    or rep.state not in (ReplicaState.OK,
                                         ReplicaState.DRAINING)):
                continue
            for erid in rep.engine.prefilled_ready():
                rid = rep.dispatched.get(erid)
                if rid is None:
                    continue  # not ours (direct engine submit)
                req = self._requests[rid]
                try:
                    req.kv_payloads = rep.engine.export_kv(erid)
                except Exception as e:  # noqa: BLE001 — replay fallback
                    obs_emit("kv_ship_failed", request=rid,
                             replica=rep.index, where="export",
                             error=f"{type(e).__name__}: {e}")
                    logger.warning(
                        "router: KV export of request %d failed on "
                        "replica %d (%s); falling back to replay "
                        "re-prefill", rid, rep.index, e)
                    try:
                        rep.engine.cancel(erid)
                    except Exception:  # noqa: BLE001
                        pass
                # drop the engine-side stub result either way: export
                # finalizes the parked copy as "prefilled", cancel as
                # "cancelled" — the router copy is the live one now
                try:
                    rep.engine.take_result(erid)
                except Exception:  # noqa: BLE001 — replica may be gone
                    pass
                rep.dispatched.pop(erid, None)
                req.state = "queued"
                req.replica = None
                req.engine_rid = None
                req.queued_since = self._now()
                moved.append(req)
                obs_emit("request_handoff", request=rid,
                         replica=rep.index,
                         shipped=req.kv_payloads is not None)
        if moved:
            self._requeue_head(moved)
        return len(moved)

    def _load(self, rep: _Replica) -> float:
        """Dispatch load score: what the health report prices. Decode
        and colocated replicas score queued + active work (slot
        pressure); PREFILL-role replicas score queued prompt TOKENS —
        prefill cost scales with tokens, not request count, so two
        8-token prompts are cheaper than one 4096-token prompt even
        though they are "two requests". Units never mix: placement
        filters candidates to one role class before comparing. A
        raising ``health()`` between probes scores infinitely loaded —
        least preferred but never a router-wide crash; the next probe
        rotates the replica out properly."""
        try:
            h = rep.engine.health()
        except Exception:  # noqa: BLE001 — sickness is the probe's call
            return float("inf")
        if rep.role == "prefill":
            return int(h.get("queue_tokens", 0))
        return int(h.get("queue_depth", 0)) + int(h.get("active", 0))

    def _pick_replica(self, req: _RouterRequest, exclude, loads):
        """Placement: ``(replica, via_affinity)`` — prefix affinity
        first (the replica whose warm trie owns this prompt's full-page
        prefix), falling back to least-loaded when the owner is rotated
        out, excluded, or unknown; ``(None, False)`` when no replica is
        in rotation (the queue waits). ``loads`` is this tick's score
        memo (one ``health()`` read per replica per tick, bumped per
        dispatch — the in-process version of scoring from the cached
        probe scrape).

        Phase-aware placement: requests carrying token history or shipped KV
        need a replica that DECODES, so prefill-role replicas are only
        used for them as a last resort (no other candidate — they can
        replay-decode, just not divert-park an admit-with-history);
        fresh prompts prefer prefill-role replicas when any are in
        rotation, falling back to the full fleet when the prefill tier
        is gone or saturated — degraded but never stuck."""
        # model group FIRST: cross-family dispatch is never a fallback
        # (an ERNIE replica cannot degrade-serve a GPT prompt) — the
        # exclude/refusal loop above this stays group-local by design
        candidates = [r for r in self._replicas
                      if r.state == ReplicaState.OK
                      and r.model == req.model
                      and r.index not in exclude]
        if not candidates:
            return None, False
        needs_decode = bool(req.tokens) or req.kv_payloads is not None
        tier = [r for r in candidates
                if (r.role != "prefill") == needs_decode]
        if tier:
            candidates = tier
        if req.affinity_key is not None:
            owner = self._affinity_map.get(req.affinity_key)
            for r in candidates:
                if r.index == owner:
                    return r, True
        return min(candidates,
                   key=lambda r: (loads.get(r.index, 0), r.index)), False

    def _dispatch(self) -> int:
        """Dispatch the tenant lanes onto in-rotation replicas —
        deficit round robin by default, the legacy single FIFO under
        ``dispatch="fifo"`` (and byte-equivalently under DRR when only
        the default lane exists)."""
        loads = {r.index: self._load(r) for r in self._replicas
                 if r.state == ReplicaState.OK}
        if self.dispatch_mode == "fifo":
            dispatched = self._dispatch_fifo(loads)
        else:
            dispatched = self._dispatch_drr(loads)
        self._prune_lanes()
        return dispatched

    def _dispatch_fifo(self, loads) -> int:
        """Legacy order: one global FIFO over every lane by submission
        id; a stuck head blocks everything behind it (strict arrival
        fairness, no tenant isolation)."""
        dispatched = 0
        for req in self._queued():
            if self._dispatch_one(req, loads):
                dispatched += 1
            elif req.state == "queued":
                break  # preserve FIFO order past the first stuck head
        return dispatched

    def _dispatch_drr(self, loads) -> int:
        """Deficit round robin over the backlogged lanes, strict
        priority tiers first. Each round grants every still-active lane
        ``drr_quantum × weight`` deficit tokens; a lane serves its FIFO
        head while its deficit covers the head's cost (prompt + decode
        budget). A head that cannot place (every candidate full) blocks
        only ITS lane — the other tenants keep draining, which is the
        whole point. Rounds repeat until every lane is empty, blocked,
        or nothing moved."""
        dispatched = 0
        groups: Dict[int, List[_TenantLane]] = {}
        for lane in self._lanes.values():
            if lane.queue:
                groups.setdefault(lane.policy.priority, []).append(lane)
        for prio in sorted(groups, reverse=True):
            lanes = groups[prio]
            active = {lane.name for lane in lanes}
            for _ in range(self._MAX_DRR_ROUNDS):
                progress = False
                for lane in lanes:
                    if lane.name not in active:
                        continue
                    lane.deficit += self.drr_quantum * max(
                        lane.policy.weight, 1e-9)
                    while lane.queue:
                        head = lane.queue[0]
                        if head.state != "queued":  # cancelled elsewhere
                            lane.queue.pop(0)
                            progress = True
                            continue
                        cost = self._cost(head)
                        if cost > lane.deficit:
                            break  # next round adds another quantum
                        if self._dispatch_one(head, loads):
                            lane.deficit -= cost
                            lane.queue.pop(0)
                            dispatched += 1
                            progress = True
                        elif head.state == "queued":
                            # head can't place: lane waits, others go on
                            active.discard(lane.name)
                            break
                        else:  # finalized (timeout/error): drop, go on
                            lane.queue.pop(0)
                            progress = True
                    if not lane.queue:
                        active.discard(lane.name)
                        lane.deficit = 0.0  # empty lane banks nothing
                if not active or not progress:
                    break
        return dispatched

    def _try_preempt(self, req: _RouterRequest, exclude: set,
                     loads) -> bool:
        """Priority preemption (module docstring): a deadline-at-risk
        request of a preempting lane evicts the cheapest-to-replay
        in-flight request of a strictly lower-priority lane in its own
        model group. The victim is cancelled on its replica and
        re-queued at its OWN lane head carrying every delivered token as
        history — exactly the migration path, so zero tokens are lost
        and the exactly-one-result invariant is untouched. Returns True
        when a slot was freed (the caller retries placement)."""
        lane = self._lane(req.tenant)
        if not (self.preempt_enabled and lane.policy.preempts):
            return False
        if not req.deadline_s:
            return False  # no deadline -> never "at risk"
        age = self._now() - req.submit_time
        if age < self.preempt_risk_frac * req.deadline_s:
            return False
        victim = None
        for cand in self._requests.values():
            if cand.state != "dispatched" or cand.model != req.model:
                continue
            if self._lane(cand.tenant).policy.priority >= lane.policy.priority:
                continue
            if self._replicas[cand.replica].state != ReplicaState.OK:
                continue
            if victim is None or len(cand.tokens) < len(victim.tokens):
                victim = cand  # fewest emitted tokens = cheapest replay
        if victim is None:
            return False
        vrep = self._replicas[victim.replica]
        vrep.dispatched.pop(victim.engine_rid, None)
        try:
            vrep.engine.cancel(victim.engine_rid)
            res = vrep.engine.take_result(victim.engine_rid)
        except Exception:  # noqa: BLE001 — fall back to callback history
            res = None
        if res is not None:
            # engine host truth is the durable history (same re-base the
            # migration paths use); the callback stream already saw these
            victim.tokens = [int(t) for t in res.tokens]
        victim.state = "queued"
        victim.replica = None
        victim.engine_rid = None
        victim.queued_since = self._now()
        victim.preemptions += 1
        self._lane(victim.tenant).queue.insert(0, victim)
        if vrep.role != "prefill":
            loads[vrep.index] = max(0, loads.get(vrep.index, 1) - 1)
        exclude.discard(vrep.index)
        self.metrics.record_preempted(victim.tenant)
        self.metrics.record_migrated()
        obs_emit("request_preempted", request=victim.rid,
                 tenant=victim.tenant, by=req.rid,
                 by_tenant=req.tenant, replica=vrep.index,
                 tokens=len(victim.tokens))
        logger.info(
            "router: request %d (tenant %s) preempted off replica %d for "
            "deadline-at-risk request %d (tenant %s); %d tokens carried",
            victim.rid, victim.tenant, vrep.index, req.rid, req.tenant,
            len(victim.tokens))
        return True

    def _dispatch_one(self, req: _RouterRequest, loads) -> bool:
        """Try to place one request; True iff it was dispatched (a
        terminal finalize — dead fleet, bad deadline — returns False but
        leaves ``req.state`` finished, so the caller drops it)."""
        exclude = set()
        refused = None     # last ValueError across candidates
        only_refusals = True  # no candidate was merely full/draining
        while True:
            rep, via_affinity = self._pick_replica(req, exclude, loads)
            if rep is None and not only_refusals:
                # capacity, not validity, is the problem: a preempting
                # lane may evict lower-priority in-flight work to make
                # room (then retry this same placement loop once)
                if self._try_preempt(req, exclude, loads):
                    only_refusals = True
                    refused = None
                    continue
            if rep is None:
                if refused is not None and only_refusals and exclude:
                    # EVERY in-rotation replica judged the request
                    # inadmissible (not full — invalid): exactly one
                    # terminal result, loudly, as an error. If any
                    # candidate was merely full, the request WAITS —
                    # capacity may free up.
                    logger.error(
                        "router: request %d rejected by every replica "
                        "(%s); finalizing as error", req.rid, refused)
                    self._finalize(req, "error")
                return False
            kw = dict(req.kw)
            if req.deadline_s:
                remaining = req.deadline_s - (self._now() - req.submit_time)
                if remaining <= 0:
                    self._finalize(req, "timeout")
                    obs_emit("request_timeout", request=req.rid,
                             where="router_dispatch")
                    self.metrics.record_shed()
                    return False
                # forward the REMAINING budget so the global deadline
                # holds across queue time and migrations
                kw["deadline_s"] = remaining
            try:
                erid = rep.engine.submit(
                    req.prompt, on_token=self._make_cb(req),
                    seed=req.seed,
                    history=req.tokens if req.tokens else None,
                    kv_payloads=req.kv_payloads, **kw)
            except QueueFull:
                only_refusals = False
                exclude.add(rep.index)
                continue
            except ShuttingDown:
                rep.state = ReplicaState.DRAINING
                obs_emit("replica_out", replica=rep.index,
                         reason="draining")
                only_refusals = False
                exclude.add(rep.index)
                continue
            except ValueError as e:
                if req.kv_payloads is not None:
                    # the shipped pages failed decode-side validation
                    # (wire checksum, page-size mismatch): drop the
                    # blobs and retry THIS SAME candidate set as a
                    # plain replay — the replica is healthy, the
                    # payload was bad, and the history already covers
                    # the prefill
                    req.kv_payloads = None
                    obs_emit("kv_ship_failed", request=req.rid,
                             replica=rep.index, where="admit",
                             error=f"{type(e).__name__}: {e}")
                    logger.warning(
                        "router: replica %d rejected shipped KV for "
                        "request %d (%s); replaying without it",
                        rep.index, req.rid, e)
                    continue
                # THIS replica can't legally admit it (e.g. a smaller
                # survivor whose budget a migrated history exceeds on a
                # heterogeneous fleet) — try the others before giving up
                refused = e
                exclude.add(rep.index)
                continue
            req.kv_payloads = None
            req.state = "dispatched"
            req.replica = rep.index
            req.engine_rid = erid
            req.dispatches += 1
            # bump the memo in the replica's own load units: tokens
            # for a prefill target, requests otherwise (_load docstring)
            loads[rep.index] = loads.get(rep.index, 0) + (
                int(req.prompt.size) if rep.role == "prefill" else 1)
            rep.dispatched[erid] = req.rid
            if req.affinity_key is not None:
                self._affinity_map.setdefault(req.affinity_key, rep.index)
                # bounded pin table: the warm caches the pins point at
                # are themselves LRU, so dropping the OLDEST pin only
                # costs a likely-already-cold locality hint — never
                # correctness — and the router's memory stays constant
                # under millions of distinct prefixes
                while len(self._affinity_map) > self._AFFINITY_CAP:
                    self._affinity_map.pop(next(iter(self._affinity_map)))
            self.metrics.record_dispatch(via_affinity, req.tenant)
            return True

    def _make_cb(self, req: _RouterRequest):
        """Per-dispatch ``on_token`` wrapper: append to the router's
        durable history (the failover replay source), record TTFT, and
        forward to the user's callback under the ROUTER request id."""
        def cb(_engine_rid, tok, finished):
            req.tokens.append(int(tok))
            if req.first_token_time is None:
                req.first_token_time = self._now()
                self.metrics.observe_ttft(
                    req.first_token_time - req.submit_time)
            if req.on_token is not None:
                req.on_token(req.rid, int(tok), bool(finished))
        return cb

    def _tick_replicas(self):
        """Tick every live replica once: the kill injector and
        ``RecoveryExhausted`` feed the dead path; a recovered tick
        re-bases request histories from engine host truth; finished
        engine results finalize their router requests."""
        finished = migrated = 0
        for rep in self._replicas:
            if rep.state in (ReplicaState.DEAD, ReplicaState.SUSPECT):
                continue  # suspects are not ticked (partition semantics)
            try:
                faults.on_router_tick(rep.index, self._ticks)
                with span("router.tick_replica", replica=rep.index):
                    summary = rep.engine.step()
            except ReplicaKilled as e:
                migrated += len(rep.dispatched)
                self._mark_dead(rep, str(e))
                continue
            except RecoveryExhausted as e:
                migrated += len(rep.dispatched)
                self._mark_dead(rep, f"RecoveryExhausted: {e}")
                continue
            if summary.get("recovered"):
                # in-place recovery rolled host truth back: re-base the
                # durable histories on it (stream-offset re-sync)
                for erid, rid in rep.dispatched.items():
                    toks = rep.engine.emitted_tokens(erid)
                    if toks is not None:
                        self._requests[rid].tokens = list(toks)
            finished += self._collect(rep)
        return finished, migrated

    def _collect(self, rep: _Replica) -> int:
        """Pull finished engine results for this replica's dispatches and
        finalize them (exactly once — the dispatched-map entry is the
        single path from engine result to router result)."""
        done = 0
        continued = []
        for erid in list(rep.dispatched):
            res = rep.engine.take_result(erid)
            if res is None:
                continue
            rid = rep.dispatched.pop(erid)
            req = self._requests[rid]
            req.tokens = [int(t) for t in res.tokens]
            if (res.finish_reason == "shutdown" and not self._shutting_down
                    and any(r.state == ReplicaState.OK
                            for r in self._replicas)):
                # an externally-draining replica ran out of grace with
                # this request unfinished: its partial tokens are all
                # delivered, so CONTINUE it on a survivor instead of
                # surfacing a truncated result
                req.state = "queued"
                req.replica = None
                req.engine_rid = None
                req.queued_since = self._now()
                continued.append(req)
                self.metrics.record_migrated()
                obs_emit("request_migrated", request=rid,
                         replica=rep.index, tokens=len(req.tokens),
                         why="drain_expired")
                continue
            self._finalize(req, res.finish_reason)
            done += 1
        if continued:
            # head-of-lane re-queue in submission order — the same
            # fairness _migrate_all gives dead-replica migrations
            self._requeue_head(continued)
        return done

    def _strand_if_no_replicas(self) -> int:
        """Lost-fleet backstop — ``drain()`` must terminate, not hang:

        - every replica dead → everything left finalizes as ``"error"``
          with a ``router_stranded`` event (the operator lost the fleet);
        - every replica dead OR draining → nothing will ever accept a
          dispatch again, so QUEUED requests finalize as ``"shutdown"``
          (dispatched ones keep ticking — their draining replicas retire
          them under the engine grace window).

        A suspect replica blocks both: it may rejoin. On a
        heterogeneous fleet the judgment is PER MODEL GROUP — dispatch
        never crosses families, so a group with no live replicas has
        stranded its requests even while other families keep serving."""
        live = {ReplicaState.OK, ReplicaState.SUSPECT}
        by_model: Dict[str, set] = {}
        for r in self._replicas:
            by_model.setdefault(r.model, set()).add(r.state)
        dead_models, closed_models = set(), set()
        for m, states in by_model.items():
            if states & live:
                continue
            (dead_models if states == {ReplicaState.DEAD}
             else closed_models).add(m)
        if not dead_models and not closed_models:
            return 0
        stranded = 0
        for lane in self._lanes.values():
            keep: List[_RouterRequest] = []
            for req in lane.queue:
                # a family the fleet no longer reports counts as dead
                if req.model in dead_models or req.model not in by_model:
                    self._finalize(req, "error")
                    stranded += 1
                elif req.model in closed_models:
                    self._finalize(req, "shutdown")
                    stranded += 1
                else:
                    keep.append(req)
            lane.queue = keep
        errored = 0
        for req in self._requests.values():
            if (req.state == "dispatched"
                    and req.model in dead_models):  # died with the group
                self._finalize(req, "error")
                stranded += 1
                errored += 1
        if dead_models and (errored or stranded):
            obs_emit("router_stranded", requests=stranded,
                     models=sorted(dead_models),
                     router=self.metrics.router_label)
            logger.error(
                "router: every replica serving %s is dead; %d "
                "request(s) stranded", sorted(dead_models), stranded)
        return stranded

    def _finalize(self, req: _RouterRequest, reason: str) -> None:
        """Record THE terminal result for one request (idempotent — the
        exactly-one-result invariant's last line of defense)."""
        if req.state == "finished":
            return
        req.state = "finished"
        now = self._now()
        self._results[req.rid] = ServingResult(
            id=req.rid, prompt=req.prompt,
            tokens=np.asarray(req.tokens, np.int32),
            finish_reason=reason,
            ttft_s=(req.first_token_time or now) - req.submit_time,
            latency_s=now - req.submit_time,
        )
        self.metrics.record_finished(reason, now - req.submit_time)
        if req.tokens:
            self.metrics.record_tenant_tokens(req.tenant, len(req.tokens))

    # ------------------------------------------------------- fleet membership

    def add_replica(self, engine) -> int:
        """Join a new replica to the rotation (the autoscaler's scale-up
        seam). The engine enters as ``OK`` and is eligible for the very
        next dispatch; per-model submit limits and the affinity page
        granularity tighten to include it. Returns the replica index."""
        rep = _Replica(index=len(self._replicas), engine=engine,
                       role=getattr(engine, "role", "both"),
                       model=getattr(engine, "model_family", "gpt"))
        self._replicas.append(rep)
        lim = getattr(engine, "submit_limit", None)
        if lim is None:
            lim = min(engine.cache_len,
                      engine.model.cfg.max_position_embeddings)
        self._limits[rep.model] = min(
            self._limits.get(rep.model, lim), lim)
        if rep.model == self._default_model:
            self._limit = self._limits[self._default_model]
        if getattr(engine, "paged", False):
            ps = engine.page_size
            self._affinity_page = (min(self._affinity_page, ps)
                                   if self._affinity_page else ps)
        obs_emit("replica_added", replica=rep.index, model=rep.model,
                 role=rep.role, router=self.metrics.router_label)
        logger.info("router: replica %d joined (model=%s role=%s)",
                    rep.index, rep.model, rep.role)
        return rep.index

    def remove_replica(self, index: int) -> bool:
        """Retire a drained replica from the rotation (the autoscaler's
        scale-down seam). Refuses — returns False — while the replica is
        still ``OK`` or holds dispatched work: drain it first
        (``engine.request_shutdown``) so no request is stranded.
        Indices of the surviving replicas are unchanged."""
        if not 0 <= index < len(self._replicas):
            return False
        rep = self._replicas[index]
        if rep.state == ReplicaState.OK or rep.dispatched:
            return False
        rep.state = ReplicaState.DEAD
        self._affinity_map = {k: v for k, v in self._affinity_map.items()
                              if v != index}
        obs_emit("replica_removed", replica=index,
                 router=self.metrics.router_label)
        logger.info("router: replica %d removed from rotation", index)
        return True

    # ---------------------------------------------------------- introspection

    @property
    def replica_states(self) -> List[str]:
        """Per-replica lifecycle state, by index."""
        return [r.state for r in self._replicas]

    def models(self) -> Dict[str, Dict]:
        """Per-family replica-group view — what ``/v1/models`` serves:
        ``{family: {replicas, live, capabilities, limit}}``.
        ``capabilities`` comes from the first replica of the group that
        advertises any (None for pre-protocol engine doubles);
        ``limit`` is the group's smallest rejected input size."""
        out: Dict[str, Dict] = {}
        for rep in self._replicas:
            info = out.setdefault(rep.model, {
                "replicas": [], "live": 0, "capabilities": None,
                "limit": self._limits.get(rep.model, self._limit)})
            info["replicas"].append(rep.index)
            if rep.state in (ReplicaState.OK, ReplicaState.SUSPECT):
                info["live"] += 1
            if info["capabilities"] is None:
                caps = getattr(rep.engine, "capabilities", None)
                if caps is not None:
                    info["capabilities"] = caps.as_dict()
        return out

    @property
    def queue_depth(self) -> int:
        """Requests waiting across every tenant lane."""
        return sum(len(lane.queue) for lane in self._lanes.values())

    @property
    def in_flight(self) -> int:
        """Requests currently dispatched to a replica."""
        return sum(r.state == "dispatched" for r in self._requests.values())
