"""Trace-driven serving workloads and the SLO goodput scorer.

Port of the JAX package's ``serving/workload.py`` (host-only numpy; the
traces are bit-identical to JAX's for the same spec, and so are their
:func:`trace_hash` fingerprints).

Fixed-batch benches measure tokens/s; production traffic is Poisson
arrivals, multi-tenant prompt mixes, bursty shared prefixes, and users
who abandon slow requests. The number that matters under that load is
**SLO goodput**: the fraction of requests that finish normally AND meet
their latency deadlines (TTFT: submit to first token; TPOT: mean
inter-token gap). An overloaded system earns credit for degrading
gracefully (shedding late requests with ``timeout`` while the rest keep
meeting deadlines) and loses it for collapsing.

Three pieces, all host-only and engine-agnostic:

- :func:`generate_trace`: a SEEDED, fully deterministic request trace
  from a :class:`WorkloadSpec`: inter-arrivals drawn from the spec's
  named :class:`TraceDistribution` (``"poisson"``, exponential gaps, or
  ``"azure_llm"``, Weibull gaps with shape < 1 and lognormal-shaped
  lengths, the burst-and-lull pattern of the Azure LLM inference traces)
  at the base rate, multiplied during periodic burst windows; tenants
  drawn by weight (bursts pin to the shared-prefix-heaviest tenant);
  per-tenant prompt/decode length ranges, deadlines and abandonment
  patience. :func:`trace_hash` fingerprints the result.
- :func:`run_trace`: replay a trace against anything with the
  submit/step/cancel/take_result surface (``ServingEngine`` or
  ``ServingRouter``), submitting each request at its arrival time,
  cancelling abandoned ones, and recording per-request
  :class:`RequestOutcome` timings from the streaming callbacks.
- :func:`score_goodput`: outcomes to the goodput record: goodput
  fraction, TTFT/TPOT p50/p99, finish-reason mix, per-tenant goodput.

Determinism boundary: the TRACE is bit-deterministic from its seed (the
hash proves it); outcomes depend on wall-clock scheduling like any load
test.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from fleetx_tpu_torch.serving.engine import QueueFull, ShuttingDown

__all__ = [
    "DISTRIBUTIONS",
    "RequestOutcome",
    "TenantSpec",
    "TraceDistribution",
    "TraceRequest",
    "WorkloadSpec",
    "disagg_spec",
    "generate_trace",
    "run_trace",
    "score_goodput",
    "trace_hash",
]


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One traffic class: length mix, shared prefix, SLOs, patience.

    ``shared_prefix_len`` > 0 gives every request of this tenant the
    same leading tokens (a system prompt / template), generated once
    from the workload seed — the shape prefix caching and the router's
    affinity pin exist for. Deadlines are SCORING thresholds (0 = no
    SLO on that axis); ``abandon_s`` is behavioral — the driver cancels
    a request still unfinished that long after submission, the way a
    user closes the tab."""

    name: str
    weight: float = 1.0
    prompt_len: Tuple[int, int] = (8, 64)     # inclusive range, prefix incl.
    gen_len: Tuple[int, int] = (8, 64)        # max_new_tokens range
    shared_prefix_len: int = 0
    ttft_deadline_s: float = 0.0              # 0 = no TTFT SLO
    tpot_deadline_ms: float = 0.0             # 0 = no TPOT SLO
    abandon_s: float = 0.0                    # 0 = infinitely patient


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One seeded workload: arrival process + tenant mix.

    ``distribution`` names a :data:`DISTRIBUTIONS` entry shaping the
    inter-arrival gaps and the length draws — ``"poisson"`` (default,
    the original synthetic model) or ``"azure_llm"`` (heavy-tailed)."""

    seed: int = 0
    n_requests: int = 64
    arrival_rate: float = 8.0                 # requests/second (base)
    vocab: int = 50304                        # prompt tokens in [1, vocab)
    tenants: Tuple[TenantSpec, ...] = (TenantSpec("default"),)
    burst_every_s: float = 0.0                # 0 = no bursts
    burst_len_s: float = 1.0
    burst_factor: float = 4.0                 # arrival-rate multiplier
    distribution: str = "poisson"             # DISTRIBUTIONS key


class TraceDistribution:
    """The pluggable trace-shape seam: how long until the next arrival,
    and how long prompts/decodes are within each tenant's configured
    range. The base class IS the ``"poisson"`` preset — exponential
    inter-arrivals, uniform lengths — and its rng call pattern is
    frozen: :func:`generate_trace` draws through these exact methods in
    a fixed order, so a given (spec, seed) pair reproduces byte-exact
    traces forever (and JAX's traces: the hashes are compared)."""

    name = "poisson"

    def interarrival(self, rng, rate: float) -> float:
        """Seconds until the next arrival at ``rate`` req/s mean."""
        return float(rng.exponential(1.0 / rate))

    def prompt_len(self, rng, lo: int, hi: int) -> int:
        """Prompt length within the tenant's inclusive range."""
        return int(rng.integers(lo, hi + 1))

    def gen_len(self, rng, lo: int, hi: int) -> int:
        """max_new_tokens within the tenant's inclusive range."""
        return int(rng.integers(lo, hi + 1))


class _AzureLLMDistribution(TraceDistribution):
    """Heavy-tailed preset shaped like the Azure LLM inference traces
    (arXiv 2404.16283): Weibull inter-arrivals with shape < 1 — many
    near-simultaneous arrivals separated by long lulls, far burstier
    than Poisson at the same mean rate — and lognormal-body lengths
    (most requests short, a fat tail of near-range-max ones). The
    Weibull scale is normalized by Γ(1 + 1/k) so the MEAN rate still
    matches ``arrival_rate``: saturation math carries over between
    presets, only the variance (the hard part) changes."""

    name = "azure_llm"
    _SHAPE = 0.45      # Weibull k; < 1 = heavy tail
    _LOGNORM_SPAN = 8.0  # lognormal(0,1) value mapped to range max

    def interarrival(self, rng, rate: float) -> float:
        scale = (1.0 / rate) / math.gamma(1.0 + 1.0 / self._SHAPE)
        return float(rng.weibull(self._SHAPE) * scale)

    def _length(self, rng, lo: int, hi: int) -> int:
        frac = min(float(rng.lognormal(0.0, 1.0)) / self._LOGNORM_SPAN, 1.0)
        return lo + int(round(frac * (hi - lo)))

    def prompt_len(self, rng, lo: int, hi: int) -> int:
        return self._length(rng, lo, hi)

    def gen_len(self, rng, lo: int, hi: int) -> int:
        return self._length(rng, lo, hi)


#: Named trace shapes ``WorkloadSpec.distribution`` selects from.
DISTRIBUTIONS: Dict[str, TraceDistribution] = {
    d.name: d for d in (TraceDistribution(), _AzureLLMDistribution())
}


@dataclasses.dataclass
class TraceRequest:
    """One request of a generated trace (host data only)."""

    index: int
    arrival_s: float
    tenant: str
    prompt: np.ndarray                        # [prompt_len] int32
    max_new_tokens: int
    ttft_deadline_s: float
    tpot_deadline_ms: float
    abandon_s: float


def _in_burst(t: float, spec: WorkloadSpec) -> bool:
    if spec.burst_every_s <= 0:
        return False
    return (t % spec.burst_every_s) < spec.burst_len_s


def generate_trace(spec: WorkloadSpec) -> List[TraceRequest]:
    """Deterministic trace from ``spec.seed`` (module docstring): same
    spec, same bytes — :func:`trace_hash` is the receipt."""
    if spec.n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    if spec.arrival_rate <= 0:
        raise ValueError("arrival_rate must be > 0")
    if not spec.tenants:
        raise ValueError("need at least one tenant")
    if spec.distribution not in DISTRIBUTIONS:
        raise ValueError(
            f"unknown distribution {spec.distribution!r} "
            f"(have {sorted(DISTRIBUTIONS)})")
    dist = DISTRIBUTIONS[spec.distribution]
    rng = np.random.default_rng(spec.seed)
    # per-tenant shared prefixes drawn FIRST, so adding requests to a
    # spec never reshuffles the prefixes earlier requests share
    prefixes = {}
    for t in spec.tenants:
        if t.shared_prefix_len > 0:
            prefixes[t.name] = rng.integers(
                1, spec.vocab, t.shared_prefix_len, dtype=np.int32)
    weights = np.asarray([t.weight for t in spec.tenants], np.float64)
    weights = weights / weights.sum()
    # bursts pin to the shared-prefix-heaviest tenant: the template storm
    burst_tenant = max(
        range(len(spec.tenants)),
        key=lambda i: (spec.tenants[i].shared_prefix_len, -i))
    out: List[TraceRequest] = []
    t = 0.0
    for i in range(spec.n_requests):
        rate = spec.arrival_rate * (
            spec.burst_factor if _in_burst(t, spec) else 1.0)
        t += dist.interarrival(rng, rate)
        ti = (burst_tenant if _in_burst(t, spec)
              else int(rng.choice(len(spec.tenants), p=weights)))
        tenant = spec.tenants[ti]
        prefix = prefixes.get(tenant.name)
        lo, hi = tenant.prompt_len
        plen = dist.prompt_len(rng, lo, hi)
        if prefix is not None:
            plen = max(plen, len(prefix) + 1)  # at least one fresh token
            suffix = rng.integers(1, spec.vocab, plen - len(prefix),
                                  dtype=np.int32)
            prompt = np.concatenate([prefix, suffix])
        else:
            prompt = rng.integers(1, spec.vocab, plen, dtype=np.int32)
        glo, ghi = tenant.gen_len
        out.append(TraceRequest(
            index=i, arrival_s=t, tenant=tenant.name, prompt=prompt,
            max_new_tokens=dist.gen_len(rng, glo, ghi),
            ttft_deadline_s=tenant.ttft_deadline_s,
            tpot_deadline_ms=tenant.tpot_deadline_ms,
            abandon_s=tenant.abandon_s,
        ))
    return out


def disagg_spec(n_requests: int = 32, *,
                vocab: int = 50304,
                prompt_len: Tuple[int, int] = (96, 192),
                gen_len: Tuple[int, int] = (16, 64),
                seed: int = 7) -> WorkloadSpec:
    """The prefill-heavy mix phase disaggregation targets: long prompts,
    short decodes, the shape where an arriving prefill steals the most
    decode ticks from in-flight requests on a colocated replica, and
    where shipping KV to a dedicated decode replica pays for itself.
    One tenant, no bursts, no SLOs (a colocated and a disaggregated
    router replaying it are compared byte for byte)."""
    return WorkloadSpec(
        seed=seed, n_requests=n_requests, vocab=vocab,
        arrival_rate=1000.0,  # effectively simultaneous arrivals
        tenants=(TenantSpec("disagg", prompt_len=prompt_len,
                            gen_len=gen_len),))


def trace_hash(trace: List[TraceRequest]) -> str:
    """16-hex-digit fingerprint of a trace — the bench record's workload
    identity (arrivals at microsecond precision, prompts byte-exact,
    and the SLO/abandonment fields: two workloads differing only in
    their deadlines score DIFFERENT goodput, so they must not share a
    fingerprint a regression gate compares against)."""
    h = hashlib.sha256()
    for r in trace:
        h.update(np.int64(round(r.arrival_s * 1e6)).tobytes())
        h.update(r.tenant.encode())
        h.update(np.ascontiguousarray(r.prompt, np.int32).tobytes())
        h.update(np.int64(r.max_new_tokens).tobytes())
        h.update(np.asarray([r.ttft_deadline_s, r.tpot_deadline_ms,
                             r.abandon_s], np.float64).tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class RequestOutcome:
    """What one trace request actually experienced."""

    index: int
    tenant: str
    finish_reason: str            # engine reasons, plus "rejected"
    n_tokens: int = 0
    ttft_s: Optional[float] = None
    tpot_ms: Optional[float] = None   # mean inter-token gap (>= 2 tokens)
    ttft_deadline_s: float = 0.0
    tpot_deadline_ms: float = 0.0
    tokens: Optional[Tuple[int, ...]] = None  # run_trace(keep_tokens=True)

    @property
    def met_ttft(self) -> bool:
        """TTFT SLO met (vacuously when no deadline is set)."""
        return (not self.ttft_deadline_s
                or (self.ttft_s is not None
                    and self.ttft_s <= self.ttft_deadline_s))

    @property
    def met_tpot(self) -> bool:
        """TPOT SLO met (vacuously with no deadline or < 2 tokens)."""
        return (not self.tpot_deadline_ms or self.tpot_ms is None
                or self.tpot_ms <= self.tpot_deadline_ms)

    @property
    def good(self) -> bool:
        """Counts toward goodput: finished normally AND met every SLO.
        Shed/abandoned/errored requests are the degradation the scorer
        charges for — gracefully if the survivors stayed fast."""
        return (self.finish_reason in ("eos", "max_length")
                and self.met_ttft and self.met_tpot)


def run_trace(target, trace: List[TraceRequest], *,
              now=time.perf_counter, submit_kw: Optional[Dict] = None,
              max_wall_s: float = 300.0,
              keep_tokens: bool = False) -> List[RequestOutcome]:
    """Replay ``trace`` against ``target`` (engine or router: the
    submit/step/cancel/take_result surface) in real time: each request
    submits at its arrival offset, abandoning tenants cancel past their
    patience, and streaming callbacks time every token. Returns one
    :class:`RequestOutcome` per trace request (``"rejected"`` for
    admission-refused submits). ``max_wall_s`` is a loud runaway guard,
    not a scheduling knob.

    A target advertising ``supports_tenants`` (the QoS router, or an
    HTTP shim forwarding the tenant header) receives each request's
    trace tenant as ``submit(tenant=...)`` — the seam that lets one
    trace drive per-tenant dispatch and plain engines alike.
    ``keep_tokens=True`` records each outcome's full token stream
    (``RequestOutcome.tokens``) for byte-parity assertions."""
    submit_kw = dict(submit_kw or {})
    send_tenant = bool(getattr(target, "supports_tenants", False))
    pending = sorted(trace, key=lambda r: (r.arrival_s, r.index))
    live: Dict[int, Dict] = {}  # rid -> record
    outcomes: List[RequestOutcome] = []
    start = now()
    pi = 0
    while pi < len(pending) or live:
        t = now() - start
        if t > max_wall_s:
            raise TimeoutError(
                f"run_trace exceeded max_wall_s={max_wall_s} with "
                f"{len(pending) - pi} unsubmitted + {len(live)} live")
        while pi < len(pending) and pending[pi].arrival_s <= t:
            tr = pending[pi]
            pi += 1
            rec = {"trace": tr, "t_submit": now(), "times": []}

            def cb(_rid, _tok, _fin, rec=rec):
                rec["times"].append(now())

            kw = dict(submit_kw)
            if send_tenant:
                kw["tenant"] = tr.tenant
            try:
                rid = target.submit(tr.prompt,
                                    max_length=tr.max_new_tokens,
                                    on_token=cb, **kw)
            except (QueueFull, ShuttingDown):
                outcomes.append(RequestOutcome(
                    index=tr.index, tenant=tr.tenant,
                    finish_reason="rejected",
                    ttft_deadline_s=tr.ttft_deadline_s,
                    tpot_deadline_ms=tr.tpot_deadline_ms))
                continue
            live[rid] = rec
        # abandonment: the user closed the tab — actively cancel
        for rid, rec in list(live.items()):
            ab = rec["trace"].abandon_s
            if ab and now() - rec["t_submit"] > ab:
                target.cancel(rid)
        target.step()
        for rid in list(live):
            res = target.take_result(rid)
            if res is None:
                continue
            rec = live.pop(rid)
            tr, times = rec["trace"], rec["times"]
            tpot = None
            if len(times) >= 2:
                tpot = (times[-1] - times[0]) / (len(times) - 1) * 1e3
            outcomes.append(RequestOutcome(
                index=tr.index, tenant=tr.tenant,
                finish_reason=res.finish_reason,
                n_tokens=int(len(res.tokens)),
                ttft_s=(times[0] - rec["t_submit"]) if times else None,
                tpot_ms=tpot,
                ttft_deadline_s=tr.ttft_deadline_s,
                tpot_deadline_ms=tr.tpot_deadline_ms,
                tokens=(tuple(int(t) for t in res.tokens)
                        if keep_tokens else None)))
        if pi < len(pending) and not live:
            # idle gap before the next arrival: don't burn a core spinning
            gap = pending[pi].arrival_s - (now() - start)
            if gap > 0:
                time.sleep(min(gap, 0.002))
    outcomes.sort(key=lambda o: o.index)
    return outcomes


def _pct(values, q) -> Optional[float]:
    vals = [v for v in values if v is not None]
    if not vals:
        return None
    return float(np.percentile(np.asarray(vals, np.float64), q))


def score_goodput(outcomes: List[RequestOutcome]) -> Dict:
    """Outcomes → the SLO goodput record (module docstring). Goodput
    divides by ALL submitted requests — a shed or abandoned request is a
    user who got nothing, however graceful the shedding was; the
    ``finish_reasons`` mix shows whether degradation was controlled
    (timeouts/rejects) or chaotic (errors)."""
    n = len(outcomes)
    if n == 0:
        raise ValueError("no outcomes to score")
    reasons: Dict[str, int] = {}
    for o in outcomes:
        reasons[o.finish_reason] = reasons.get(o.finish_reason, 0) + 1
    good = sum(o.good for o in outcomes)
    tenants = sorted({o.tenant for o in outcomes})
    per_tenant = {
        t: round(sum(o.good for o in outcomes if o.tenant == t)
                 / max(sum(o.tenant == t for o in outcomes), 1), 4)
        for t in tenants
    }
    ttfts = [o.ttft_s for o in outcomes]
    tpots = [o.tpot_ms for o in outcomes]
    return {
        "requests": n,
        "goodput": round(good / n, 4),
        "good": good,
        "met_ttft_frac": round(sum(o.met_ttft for o in outcomes) / n, 4),
        "met_tpot_frac": round(sum(o.met_tpot for o in outcomes) / n, 4),
        "completed_frac": round(
            sum(o.finish_reason in ("eos", "max_length")
                for o in outcomes) / n, 4),
        "shed_frac": round(
            (reasons.get("timeout", 0) + reasons.get("rejected", 0)) / n, 4),
        "finish_reasons": reasons,
        "tokens_total": sum(o.n_tokens for o in outcomes),
        "ttft_ms_p50": _pct([t * 1e3 if t is not None else None
                             for t in ttfts], 50),
        "ttft_ms_p99": _pct([t * 1e3 if t is not None else None
                             for t in ttfts], 99),
        "tpot_ms_p50": _pct(tpots, 50),
        "tpot_ms_p99": _pct(tpots, 99),
        "goodput_per_tenant": per_tenant,
    }
