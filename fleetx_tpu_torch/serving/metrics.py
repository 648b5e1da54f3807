"""Serving metrics: the counters and latency samples the engine records.

A subset of the JAX package's ``ServingMetrics`` (serving/metrics.py):
request and token counters, admission rejects and timeouts, TTFT, request
latency, tick time, the prefix-cache counters, the page
gauges, the KV precision with its byte costs, the chunked-prefill counter
and prefill-stall samples, the queued prompt tokens, and the speculative
families (proposed, accepted, acceptance rate, tokens per request per
tick), the crash-safety counters (recoveries, poison retirements, drain
rejects), the host and disk page tiers (synced from their stores each
tick), the serving role and the KV-shipping counters, with
:meth:`snapshot` giving the same key names. The Prometheus registry,
histograms and exposition are not ported (ROADMAP Queue A, "Serving
features still missing"); samples are plain lists.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["ServingMetrics"]


def _ms_quantiles(samples: List[float], qs) -> List[Optional[float]]:
    if not samples:
        return [None] * len(qs)
    return [float(np.percentile(samples, q)) * 1e3 for q in qs]


class ServingMetrics:
    """Per-engine counters and samples (times in seconds, reported in
    milliseconds by :meth:`snapshot`)."""

    def __init__(self, slots: int = 0):
        self.slots = slots
        self.submitted = 0
        self.admitted = 0
        self.rejected = 0
        self.tokens_generated = 0
        self.ticks = 0
        self.prefix_queries = 0
        self.prefix_hits = 0
        self.prefill_tokens_saved = 0
        self.prompt_tokens = 0
        self.pages_in_use = 0
        self.pages_total = 0
        self.kv_dtype = "bf16"
        self.kv_bytes_per_token = 0
        self.kv_cache_bytes = 0
        self.prefill_chunks = 0
        self.prefill_queue_tokens = 0
        self.spec_proposed_tokens = 0
        self.spec_accepted_tokens = 0
        self.engine_recoveries = 0
        self.poison_retired = 0
        self.drain_rejects = 0
        self.role = "both"
        self.kv_pages_shipped = 0
        self.kv_bytes_shipped = 0
        self.kv_pages_revived_remote = 0
        self.host_spilled_pages = 0
        self.host_revived_pages = 0
        self.host_evicted_pages = 0
        self.host_cache_bytes = 0
        self.host_cache_pages = 0
        self._host_synced = (0, 0, 0)  # the store's counters at last sync
        self.disk_cache_bytes = 0
        self.disk_cache_hits = 0
        self.disk_cache_misses = 0
        self._disk_synced = (0, 0)
        self.finish_reasons: Dict[str, int] = {}
        self.ttft_s: List[float] = []
        self.prefill_stall_s: List[float] = []
        self.spec_tokens_per_tick: List[int] = []
        self.latency_s: List[float] = []
        self.tick_s: List[float] = []
        self._first_token_t: Optional[float] = None
        self._last_token_t: Optional[float] = None

    def record_submit(self) -> None:
        """A request entered the admission queue."""
        self.submitted += 1

    def record_admit(self) -> None:
        """A request won a decode lane."""
        self.admitted += 1

    def record_reject(self) -> None:
        """A submit was refused by admission control (queue full)."""
        self.rejected += 1

    def record_first_token(self, ttft_s: float) -> None:
        """First token of a request reached the host (end-to-end TTFT)."""
        self.ttft_s.append(ttft_s)

    def record_tokens(self, n: int) -> None:
        """``n`` tokens reached the host."""
        now = time.perf_counter()
        if self._first_token_t is None:
            self._first_token_t = now
        self._last_token_t = now
        self.tokens_generated += n

    def record_prefix(self, shared_tokens: int, prompt_tokens: int) -> None:
        """One paged admission: ``shared_tokens`` of the prompt came from
        the prefix cache or a page tier (their prefill was skipped)."""
        self.prefix_queries += 1
        self.prefix_hits += shared_tokens > 0
        self.prefill_tokens_saved += int(shared_tokens)
        self.prompt_tokens += int(prompt_tokens)

    def record_recovery(self) -> None:
        """The engine ran one replay recovery."""
        self.engine_recoveries += 1

    def record_poison(self) -> None:
        """A poison request was quarantined (bisection, a twice-failed
        prefill or its own failed replay) and retired ``error``."""
        self.poison_retired += 1

    def record_drain_reject(self) -> None:
        """A submit was refused because the engine is shutting down."""
        self.drain_rejects += 1

    def set_role(self, role: str) -> None:
        """The engine's serving role (prefill | decode | both)."""
        self.role = role

    def record_kv_shipped(self, pages: int, nbytes: int) -> None:
        """One ``export_kv``: ``pages`` page payloads of ``nbytes`` wire
        bytes left for a decode-role replica."""
        self.kv_pages_shipped += int(pages)
        self.kv_bytes_shipped += int(nbytes)

    def record_kv_revived_remote(self, pages: int) -> None:
        """One shipped admission wrote ``pages`` shipped pages into the
        pool (their prefill skipped)."""
        self.kv_pages_revived_remote += int(pages)

    def observe_host_tier(self, store) -> None:
        """Per-tick sync from a host page store: its bytes and entries,
        and the lifetime spill/revive/evict counts advanced by the store's
        deltas since the last sync."""
        self.host_cache_bytes = int(store.nbytes)
        self.host_cache_pages = len(store)
        now = (store.spilled_pages, store.revived_pages,
               store.evicted_pages)
        last = self._host_synced
        self.host_spilled_pages += max(now[0] - last[0], 0)
        self.host_revived_pages += max(now[1] - last[1], 0)
        self.host_evicted_pages += max(now[2] - last[2], 0)
        self._host_synced = now

    def observe_disk_tier(self, store) -> None:
        """Per-tick sync from a disk page store: the directory's bytes
        (every replica's files count, as of the store's last listing) and
        this store's hits and misses since the last sync."""
        self.disk_cache_bytes = int(store.cached_nbytes)
        now = (store.hits, store.misses)
        last = self._disk_synced
        self.disk_cache_hits += max(now[0] - last[0], 0)
        self.disk_cache_misses += max(now[1] - last[1], 0)
        self._disk_synced = now

    def record_retire(self, latency_s: float, reason: str) -> None:
        """A request finished (``reason``: eos | max_length | cache_full |
        timeout | cancelled | error | shutdown | prefilled)."""
        self.finish_reasons[reason] = self.finish_reasons.get(reason, 0) + 1
        self.latency_s.append(latency_s)

    def observe_tick(self, tick_s: float, pages_in_use: int,
                     pages_total: int) -> None:
        """One scheduler tick took ``tick_s``; page gauges after it."""
        self.ticks += 1
        self.tick_s.append(tick_s)
        self.pages_in_use = pages_in_use
        self.pages_total = pages_total

    def observe_prefill_stall(self, stall_s: float) -> None:
        """One tick spent ``stall_s`` seconds on prefill work (admissions
        or one chunk) before its decode."""
        self.prefill_stall_s.append(stall_s)

    def record_prefill_chunk(self, tokens: int) -> None:
        """One chunked-prefill call wrote ``tokens`` prompt tokens (the
        count is the signal; the chunk size is a constant)."""
        del tokens
        self.prefill_chunks += 1

    def observe_queue_tokens(self, tokens: int) -> None:
        """Per-tick sample of queued plus mid-chunk prompt tokens."""
        self.prefill_queue_tokens = int(tokens)

    def record_spec(self, proposed: int, accepted: int,
                    emitted_rows) -> None:
        """One speculative tick: ``proposed``/``accepted`` draft tokens over
        the batch; ``emitted_rows`` each request's emitted-token count."""
        self.spec_proposed_tokens += int(proposed)
        self.spec_accepted_tokens += int(accepted)
        self.spec_tokens_per_tick.extend(int(n) for n in emitted_rows)

    def set_quant_config(self, kv_dtype: str, kv_bytes_per_token: int,
                         kv_cache_bytes: int) -> None:
        """The engine's KV precision (``bf16`` | ``int8``), the K+V bytes
        one cached token costs over all layers, and the pools' bytes."""
        self.kv_dtype = kv_dtype
        self.kv_bytes_per_token = int(kv_bytes_per_token)
        self.kv_cache_bytes = int(kv_cache_bytes)

    @property
    def retired(self) -> int:
        """Requests retired, any finish_reason."""
        return sum(self.finish_reasons.values())

    @property
    def timeouts(self) -> int:
        """Requests retired by a queue TTL or deadline."""
        return self.finish_reasons.get("timeout", 0)

    @property
    def cancels(self) -> int:
        """Requests retired by ``cancel()``."""
        return self.finish_reasons.get("cancelled", 0)

    @property
    def spec_acceptance_rate(self) -> float:
        """Lifetime accepted / proposed draft tokens (0 before any)."""
        return (self.spec_accepted_tokens / self.spec_proposed_tokens
                if self.spec_proposed_tokens else 0.0)

    def snapshot(self) -> Dict:
        """Aggregate view under the JAX package's snapshot key names."""
        span = (self._last_token_t - self._first_token_t
                if self._first_token_t is not None else None)
        ttft_p50, ttft_p95 = _ms_quantiles(self.ttft_s, (50, 95))
        tick_p50, tick_p99 = _ms_quantiles(self.tick_s, (50, 99))
        stall_p50, stall_p99 = _ms_quantiles(self.prefill_stall_s, (50, 99))
        return {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "retired": self.retired,
            "rejected": self.rejected,
            "timeouts": self.timeouts,
            "cancels": self.cancels,
            "tokens_generated": self.tokens_generated,
            "ticks": self.ticks,
            "slots": self.slots,
            "ttft_ms_p50": ttft_p50,
            "ttft_ms_p95": ttft_p95,
            "latency_ms_mean": (float(np.mean(self.latency_s)) * 1e3
                                if self.latency_s else None),
            "decode_tokens_per_s": (self.tokens_generated / span
                                    if span else None),
            "finish_reasons": dict(self.finish_reasons),
            "prefix_queries": self.prefix_queries,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": (self.prefix_hits / self.prefix_queries
                                if self.prefix_queries else 0.0),
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "pages_in_use": self.pages_in_use,
            "pages_total": self.pages_total,
            "tick_ms_p50": tick_p50,
            "tick_ms_p99": tick_p99,
            "prefill_chunks": self.prefill_chunks,
            "prefill_stall_ms_p50": stall_p50,
            "prefill_stall_ms_p99": stall_p99,
            "prefill_stall_ms_max": (max(self.prefill_stall_s) * 1e3
                                     if self.prefill_stall_s else None),
            "prefill_queue_tokens": self.prefill_queue_tokens,
            "spec_proposed_tokens": self.spec_proposed_tokens,
            "spec_accepted_tokens": self.spec_accepted_tokens,
            "spec_acceptance_rate": self.spec_acceptance_rate,
            "spec_tokens_per_tick_mean": (
                float(np.mean(self.spec_tokens_per_tick))
                if self.spec_tokens_per_tick else None),
            "kv_dtype": self.kv_dtype,
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "kv_cache_bytes": self.kv_cache_bytes,
            "host_spilled_pages": self.host_spilled_pages,
            "host_revived_pages": self.host_revived_pages,
            "host_evicted_pages": self.host_evicted_pages,
            "host_cache_bytes": self.host_cache_bytes,
            "host_cache_pages": self.host_cache_pages,
            "role": self.role,
            "kv_pages_shipped": self.kv_pages_shipped,
            "kv_bytes_shipped": self.kv_bytes_shipped,
            "kv_pages_revived_remote": self.kv_pages_revived_remote,
            "disk_cache_bytes": self.disk_cache_bytes,
            "disk_cache_hits": self.disk_cache_hits,
            "disk_cache_misses": self.disk_cache_misses,
            "engine_recoveries": self.engine_recoveries,
            "poison_retired": self.poison_retired,
            "drain_rejects": self.drain_rejects,
        }
