"""Serving metrics: the counters, gauges and latency histograms the
engine records, on the observability registry.

Port of the JAX package's ``serving/metrics.py``. One
:class:`ServingMetrics` instance rides a ``ServingEngine``; the engine
feeds it lifecycle events (submit, admit, first token, retire) and one
sample per tick (queue depth, lanes, pages). Every number lives in an
``obs/registry.py`` instrument of a ``fleetx_serving_*`` family labeled
``engine="<n>"`` (the JAX names, types, help and labels), so ``GET
/metrics`` (``FLEETX_OBS_PORT``, ``obs/http.py``) exposes the same series
as Prometheus text; the class is a façade that names the metrics once and
keeps the ``snapshot()`` and attribute surface. Latency, TTFT and tick
distributions are bounded histogram reservoirs (``FLEETX_OBS_RESERVOIR``
samples): means stay exact (count/sum), percentiles describe the recent
window. An instance that is garbage-collected drops its series from the
registry (:func:`_drop_series`). ``log_snapshot()`` writes one line through
``utils/log.py`` (the engine's ``log_every`` cadence).

Under a mesh (mp serving) every byte gauge is per device, and
``mesh_devices``/``mesh`` (:meth:`set_mesh`) say what the decode tick
spans. TTFT is end to end: submit to the first token on the host.
"""

from __future__ import annotations

import itertools
import time
import weakref
from typing import Dict, Optional

from fleetx_tpu_torch.obs.registry import MetricsRegistry, get_registry

__all__ = ["ServingMetrics"]


def _drop_series(owned) -> None:
    """weakref.finalize target: remove every registry series a
    ServingMetrics instance owned (its ``engine=<n>`` label is unique,
    so a process that cycles engines would otherwise accumulate
    dead-engine series in /metrics forever)."""
    for family, labels in owned:
        family.remove(**labels)


def _ms(v: Optional[float]) -> Optional[float]:
    return None if v is None else v * 1e3


class ServingMetrics:
    """Counters + gauges for one serving engine (see module docstring)."""

    _labels = itertools.count()

    def __init__(self, slots: int = 0,
                 registry: Optional[MetricsRegistry] = None):
        reg = registry or get_registry()
        self.registry = reg
        self.engine_label = str(next(self._labels))
        lab = {"engine": self.engine_label}
        # (family, labels) of every series this instance creates; a
        # weakref finalizer removes them when the instance dies, so the
        # registry's memory stays bounded across engine restarts. A plain
        # list captured by closure — the finalizer must not pin self.
        self._owned = owned = []

        def child(fam):
            owned.append((fam, dict(lab)))
            return fam.labels(**lab)

        def counter(name, help):
            return child(reg.counter(name, help, ("engine",)))

        def gauge(name, help):
            return child(reg.gauge(name, help, ("engine",)))

        def hist(name, help):
            return child(reg.histogram(name, help, ("engine",)))

        self.slots = slots
        self._c_submitted = counter(
            "fleetx_serving_submitted_total",
            "Requests that entered the admission queue")
        self._c_admitted = counter(
            "fleetx_serving_admitted_total",
            "Requests that won a decode lane (prefill ran)")
        self._retired_family = reg.counter(
            "fleetx_serving_retired_total",
            "Requests retired, by finish_reason",
            ("engine", "reason"))
        self._c_rejected = counter(
            "fleetx_serving_rejected_total",
            "Submits refused by admission control (queue full)")
        self._c_drain_rejects = counter(
            "fleetx_serving_drain_rejects_total",
            "Submits refused because the engine was shutting down")
        self._c_tokens = counter(
            "fleetx_serving_tokens_total",
            "Decode tokens that reached the host")
        self._c_ticks = counter(
            "fleetx_serving_ticks_total",
            "Scheduler ticks executed")
        # crash-safety counters (docs/RESILIENCE.md serving-recovery):
        # recoveries = replay-recovery passes the engine ran, poison =
        # requests quarantined by bisection/replay
        self._c_recoveries = counter(
            "fleetx_serving_engine_recoveries_total",
            "Replay-recovery passes (device state rebuilt from host truth)")
        self._c_poison = counter(
            "fleetx_serving_poison_retired_total",
            "Requests quarantined as poison (bisection or replay failure)")
        # paged-cache counters (zero on the slot path so the snapshot
        # schema is stable across modes)
        self._c_prefix_queries = counter(
            "fleetx_serving_prefix_queries_total",
            "Paged admissions that consulted the prefix trie")
        self._c_prefix_hits = counter(
            "fleetx_serving_prefix_hits_total",
            "Paged admissions that reused shared prefix pages")
        self._c_prefill_saved = counter(
            "fleetx_serving_prefill_tokens_saved_total",
            "Prompt tokens whose prefill the prefix cache skipped")
        self._c_prompt_tokens = counter(
            "fleetx_serving_prompt_tokens_total",
            "Prompt tokens across admitted paged requests")
        # chunked-prefill + host-spill-tier story (docs/SERVING.md):
        # how long ticks stall on prefill work, how many chunks ran, and
        # what the two-level page cache moved between HBM and host DRAM
        self._c_prefill_chunks = counter(
            "fleetx_serving_prefill_chunks_total",
            "Chunked-prefill device calls executed (one per tick max)")
        self._c_host_spilled = counter(
            "fleetx_serving_host_spilled_pages_total",
            "Warm KV pages spilled to the host-DRAM tier on eviction")
        self._c_host_revived = counter(
            "fleetx_serving_host_revived_pages_total",
            "Spilled pages revived into device pages on a prefix match")
        self._c_host_evicted = counter(
            "fleetx_serving_host_evicted_pages_total",
            "Host-tier entries dropped under the byte budget (LRU)")
        self._host_synced = (0, 0, 0)  # last (spilled, revived, evicted)
        # disaggregated prefill/decode (docs/SERVING.md): the handoff
        # counters — pages/bytes a prefill-role replica exported, pages a
        # decode-role replica revived from a remote ship — plus the
        # shared disk tier's traffic and the per-phase load signals
        self._c_kv_shipped = counter(
            "fleetx_serving_kv_pages_shipped_total",
            "KV pages exported to a decode-role replica (export_kv)")
        self._c_kv_bytes_shipped = counter(
            "fleetx_serving_kv_bytes_shipped_total",
            "Wire-format bytes of exported KV page payloads")
        self._c_kv_revived_remote = counter(
            "fleetx_serving_kv_pages_revived_remote_total",
            "Shipped KV pages revived into this replica's pool "
            "(submit(kv_payloads=...), no re-prefill)")
        self._g_disk_bytes = gauge(
            "fleetx_serving_disk_cache_bytes",
            "Bytes of wire-format KV pages resident in the shared "
            "disk tier (FLEETX_SERVING_DISK_CACHE_DIR)")
        self._c_disk_hits = counter(
            "fleetx_serving_disk_cache_hits_total",
            "Disk-tier reads that revived a page (any replica wrote it)")
        self._c_disk_misses = counter(
            "fleetx_serving_disk_cache_misses_total",
            "Disk-tier probes that found no stored page")
        self._disk_synced = (0, 0)  # last (hits, misses)
        self._g_queue_tokens = gauge(
            "fleetx_serving_prefill_queue_tokens",
            "Prompt tokens queued or mid-chunked-prefill — the load "
            "signal the router prices a prefill-role replica by")
        # info-style role family: 1 at the engine's serving role, so one
        # scrape says which pool each replica belongs to
        self._role_family = reg.gauge(
            "fleetx_serving_role",
            "1 at the engine's serving role (prefill | decode | both)",
            ("engine", "role"))
        self.role = "both"
        # speculative decoding (docs/SERVING.md): proposer/verifier
        # throughput — acceptance rate prices the proposer, tokens-per-
        # tick is the decode multiplier the whole feature exists for
        self._c_spec_proposed = counter(
            "fleetx_serving_spec_proposed_tokens_total",
            "Draft tokens proposed to speculative verification")
        self._c_spec_accepted = counter(
            "fleetx_serving_spec_accepted_tokens_total",
            "Proposed draft tokens the target model accepted")
        self._g_spec_rate = gauge(
            "fleetx_serving_spec_acceptance_rate",
            "Lifetime accepted/proposed draft-token ratio")
        self._h_spec_tokens = hist(
            "fleetx_serving_spec_tokens_per_tick",
            "Tokens emitted per active request per speculative tick "
            "(accepted drafts + the correction/bonus token)")
        self._g_queue_depth = gauge(
            "fleetx_serving_queue_depth",
            "Requests currently waiting for a decode lane")
        self._g_active_slots = gauge(
            "fleetx_serving_active_slots",
            "Decode lanes currently occupied")
        self._g_slots = gauge(
            "fleetx_serving_slots",
            "Configured decode lanes of this engine")
        self._g_slots.set(slots)
        self._g_pages_in_use = gauge(
            "fleetx_serving_pages_in_use",
            "KV pages currently allocated (paged mode)")
        self._g_pages_total = gauge(
            "fleetx_serving_pages_total",
            "Usable KV pages in the shared pool (paged mode)")
        self._g_host_bytes = gauge(
            "fleetx_serving_host_cache_bytes",
            "Bytes of spilled KV pages resident in the host-DRAM tier")
        self._g_host_pages = gauge(
            "fleetx_serving_host_cache_pages",
            "Spilled KV pages resident in the host-DRAM tier")
        # mesh-sharded serving (docs/SERVING.md "Mesh-sharded serving"):
        # how many devices this engine's decode tick spans — the router
        # reads it to price a replica's capacity (1 = unmeshed)
        self._g_mesh_devices = gauge(
            "fleetx_serving_mesh_devices",
            "Devices the engine's jitted decode tick runs across "
            "(1 = single-device engine)")
        self._g_mesh_devices.set(1)
        self.mesh_desc = "-"
        # quantized-serving config (docs/QUANTIZATION.md): the info-style
        # family carries the active precision pair as labels — plus the
        # mesh shape, so one scrape says what precision runs on what
        # device slice; the bytes gauges make the HBM win scrapeable
        # next to tokens/s
        self._quant_family = reg.gauge(
            "fleetx_serving_quant_config",
            "1 at the engine's active (kv_dtype, weight_dtype, mesh) tuple",
            ("engine", "kv_dtype", "weight_dtype", "mesh"))
        self._g_kv_bytes = gauge(
            "fleetx_serving_kv_bytes_per_token",
            "KV-cache bytes one cached token costs across all layers "
            "(per-vector scales included at int8)")
        self._g_weight_bytes = gauge(
            "fleetx_serving_weight_bytes",
            "Bytes of servable params resident in HBM "
            "(int8 values + scales when weight-quantized)")
        self._g_kv_cache_bytes = gauge(
            "fleetx_serving_kv_cache_bytes",
            "Device bytes of the whole decode cache tree, measured from "
            "its actual leaves (values + scale leaves)")
        self.kv_dtype = "bf16"
        self.weight_dtype = "bf16"
        self._h_ttft = hist(
            "fleetx_serving_ttft_seconds",
            "Submit-to-first-token latency (end-to-end, host observed)")
        self._h_queue_wait = hist(
            "fleetx_serving_queue_wait_seconds",
            "Time spent waiting in the admission queue")
        self._h_latency = hist(
            "fleetx_serving_request_latency_seconds",
            "Submit-to-retire request latency")
        # per-tick wall-clock feeds the p50/p99 that make recovery/
        # quarantine cost visible next to steady-state ticks
        self._h_tick = hist(
            "fleetx_serving_tick_seconds",
            "Scheduler tick wall-clock")
        self._h_queue_depth = hist(
            "fleetx_serving_queue_depth_per_tick",
            "Queue depth sampled once per tick (mean/peak feed snapshot)")
        self._h_active = hist(
            "fleetx_serving_active_slots_per_tick",
            "Occupied lanes sampled once per tick")
        self._h_page_occ = hist(
            "fleetx_serving_page_occupancy",
            "Page-pool occupancy fraction sampled once per tick")
        self._h_pages_per_req = hist(
            "fleetx_serving_pages_per_request",
            "Fresh (non-shared) pages claimed per admitted paged request")
        # how long a tick's decode was stalled by prefill work — under
        # chunking this is bounded by ~one chunk-sized call (the claim
        # tools/bench_serving.py's chunked record prices)
        self._h_prefill_stall = hist(
            "fleetx_serving_prefill_stall_ms",
            "Milliseconds a tick spent on prefill work (admissions + "
            "chunks) before its batched decode ran")
        # dynamic-batching engines (serving/batch_engine.py): coalesced
        # forwards and how full each one ran — the KV-free analogue of
        # active-slot occupancy
        self._c_batched_forwards = counter(
            "fleetx_serving_batched_forwards_total",
            "Coalesced batched forwards run by a KV-free engine")
        self._h_batch_occ = hist(
            "fleetx_serving_batch_occupancy",
            "Fraction of the coalescing window filled per batched forward")
        self._reasons: Dict[str, object] = {}  # reason -> counter child
        self._first_token_t: Optional[float] = None
        self._last_token_t: Optional[float] = None
        weakref.finalize(self, _drop_series, owned)

    # ------------------------------------------------- lifecycle recording
    def record_submit(self) -> None:
        """A request entered the admission queue."""
        self._c_submitted.inc()

    def record_admit(self, queue_wait_s: float) -> None:
        """A request won a slot after waiting ``queue_wait_s``."""
        self._c_admitted.inc()
        self._h_queue_wait.observe(queue_wait_s)

    def record_first_token(self, ttft_s: float) -> None:
        """First token of a request reached the host (end-to-end TTFT)."""
        self._h_ttft.observe(ttft_s)

    def record_tokens(self, n: int) -> None:
        """``n`` decode tokens reached the host this tick."""
        now = time.perf_counter()
        if self._first_token_t is None:
            self._first_token_t = now
        self._last_token_t = now
        self._c_tokens.inc(n)

    def record_reject(self) -> None:
        """A submit was refused by admission control (queue full)."""
        self._c_rejected.inc()

    def record_recovery(self) -> None:
        """The engine ran one replay-recovery pass (device state rebuilt
        and every active request re-prefilled from its host history)."""
        self._c_recoveries.inc()

    def record_poison(self) -> None:
        """A poison request was quarantined (bisection or replay failure)
        and retired with ``finish_reason="error"``."""
        self._c_poison.inc()

    def record_drain_reject(self) -> None:
        """A submit was refused because the engine is shutting down."""
        self._c_drain_rejects.inc()

    def record_batched_forward(self, batch: int, capacity: int) -> None:
        """A KV-free engine ran one coalesced forward over ``batch``
        requests with room for ``capacity``."""
        self._c_batched_forwards.inc()
        self._h_batch_occ.observe(batch / max(capacity, 1))

    def record_prefix(self, shared_tokens: int, prompt_tokens: int,
                      pages: int) -> None:
        """One paged admission: ``shared_tokens`` of the prompt came from
        the prefix cache (their prefill was skipped), ``pages`` is the
        FRESH pages the request claimed (trie-shared pages excluded —
        they cost nothing, which is the point)."""
        self._c_prefix_queries.inc()
        if shared_tokens > 0:
            self._c_prefix_hits.inc()
        self._c_prefill_saved.inc(int(shared_tokens))
        self._c_prompt_tokens.inc(int(prompt_tokens))
        self._h_pages_per_req.observe(int(pages))

    def set_mesh(self, devices: int, desc: str = "-") -> None:
        """Publish the engine's mesh footprint: ``devices`` the decode
        tick spans (1 = unmeshed) and a short shape string (e.g.
        ``"mp2"``, ``"fsdp2xmp2"``; ``"-"`` unmeshed) that also labels
        the quant-config info gauge."""
        self.mesh_desc = desc
        self._g_mesh_devices.set(int(devices))

    def set_quant_config(self, kv_dtype: str, weight_dtype: str,
                         kv_bytes_per_token: int, weight_bytes: int,
                         kv_cache_bytes: int = 0) -> None:
        """Publish the engine's precision config: the (kv_dtype,
        weight_dtype, mesh) info labels plus the bytes-per-token /
        param-bytes / cache-tree gauges the HBM story is read from
        (docs/QUANTIZATION.md; bytes are PER DEVICE under a mesh —
        docs/SERVING.md "Mesh-sharded serving"). Call :meth:`set_mesh`
        first on a meshed engine so the label is current."""
        self.kv_dtype = kv_dtype
        self.weight_dtype = weight_dtype
        labels = {"engine": self.engine_label, "kv_dtype": kv_dtype,
                  "weight_dtype": weight_dtype, "mesh": self.mesh_desc}
        self._owned.append((self._quant_family, dict(labels)))
        self._quant_family.labels(**labels).set(1)
        self._g_kv_bytes.set(int(kv_bytes_per_token))
        self._g_weight_bytes.set(int(weight_bytes))
        self._g_kv_cache_bytes.set(int(kv_cache_bytes))

    def observe_prefill_stall(self, stall_s: float) -> None:
        """One tick spent ``stall_s`` seconds on prefill work (whole
        admissions or one chunk) before its decode call."""
        self._h_prefill_stall.observe(stall_s * 1e3)

    def record_prefill_chunk(self, tokens: int) -> None:
        """One chunked-prefill device call wrote ``tokens`` prompt
        tokens (the count rides the counter; per-chunk size is static)."""
        del tokens  # chunk size is a config constant; count is the signal
        self._c_prefill_chunks.inc()

    def observe_host_tier(self, store) -> None:
        """Per-tick sync from a :class:`HostPageStore`: gauges track its
        current bytes/entries, counters advance by the store's lifetime
        deltas since the last sync (registry counters only increment)."""
        self._g_host_bytes.set(store.nbytes)
        self._g_host_pages.set(len(store))
        now = (store.spilled_pages, store.revived_pages,
               store.evicted_pages)
        last = self._host_synced
        for child, delta in zip(
                (self._c_host_spilled, self._c_host_revived,
                 self._c_host_evicted),
                (now[0] - last[0], now[1] - last[1], now[2] - last[2])):
            if delta > 0:
                child.inc(delta)
        self._host_synced = now

    def set_role(self, role: str) -> None:
        """Publish the engine's serving role (``prefill`` | ``decode`` |
        ``both``) — the info-style label the router and a fleet scrape
        read replica specialization from."""
        self.role = role
        labels = {"engine": self.engine_label, "role": role}
        self._owned.append((self._role_family, dict(labels)))
        self._role_family.labels(**labels).set(1)

    def record_kv_shipped(self, pages: int, nbytes: int) -> None:
        """One successful ``export_kv``: ``pages`` page payloads,
        ``nbytes`` total wire-format bytes, left this replica for a
        decode-role peer."""
        self._c_kv_shipped.inc(int(pages))
        self._c_kv_bytes_shipped.inc(int(nbytes))

    def record_kv_revived_remote(self, pages: int) -> None:
        """One ``submit(kv_payloads=...)`` admission revived ``pages``
        shipped pages into this replica's pool (their prefill skipped —
        the whole point of the handoff)."""
        self._c_kv_revived_remote.inc(int(pages))

    def observe_queue_tokens(self, tokens: int) -> None:
        """Per-tick sample of queued + mid-chunk prompt tokens (the
        prefill-phase load signal)."""
        self._g_queue_tokens.set(int(tokens))

    def observe_disk_tier(self, store) -> None:
        """Per-tick sync from a :class:`DiskPageStore`: the bytes gauge
        tracks the shared directory's residency as of the store's last
        listing (every replica's writes included), hit/miss counters
        advance by this instance's lifetime deltas (registry counters only
        increment)."""
        self._g_disk_bytes.set(store.cached_nbytes)
        now = (store.hits, store.misses)
        last = self._disk_synced
        for child, delta in zip((self._c_disk_hits, self._c_disk_misses),
                                (now[0] - last[0], now[1] - last[1])):
            if delta > 0:
                child.inc(delta)
        self._disk_synced = now

    def record_spec(self, proposed: int, accepted: int,
                    emitted_rows) -> None:
        """One speculative tick: ``proposed``/``accepted`` draft tokens
        across the batch, ``emitted_rows`` the per-request emitted-token
        counts (each feeds the tokens-per-tick histogram)."""
        if proposed > 0:
            self._c_spec_proposed.inc(proposed)
        if accepted > 0:
            self._c_spec_accepted.inc(accepted)
        total = int(self._c_spec_proposed.value)
        self._g_spec_rate.set(
            int(self._c_spec_accepted.value) / total if total else 0.0)
        for n in emitted_rows:
            self._h_spec_tokens.observe(int(n))

    def observe_pages(self, pages_in_use: int, pages_total: int) -> None:
        """Per-tick page-pool gauge sample (paged mode only)."""
        self._g_pages_in_use.set(pages_in_use)
        self._g_pages_total.set(pages_total)
        self._h_page_occ.observe(
            pages_in_use / pages_total if pages_total else 0.0)

    def record_retire(self, latency_s: float, reason: str) -> None:
        """A request finished (``reason``: eos | max_length | cache_full |
        timeout | cancelled | error | shutdown | prefilled)."""
        child = self._reasons.get(reason)
        if child is None:
            labels = {"engine": self.engine_label, "reason": reason}
            self._owned.append((self._retired_family, labels))
            child = self._reasons[reason] = self._retired_family.labels(
                **labels)
        child.inc()
        self._h_latency.observe(latency_s)

    def observe_tick(self, queue_depth: int, active_slots: int,
                     tick_s: Optional[float] = None) -> None:
        """Per-tick gauge sample from the engine's scheduler loop;
        ``tick_s`` is the tick's wall-clock (feeds the p50/p99 that make
        recovery/quarantine cost visible next to steady-state ticks)."""
        self._c_ticks.inc()
        self._g_queue_depth.set(queue_depth)
        self._g_active_slots.set(active_slots)
        self._h_queue_depth.observe(queue_depth)
        self._h_active.observe(active_slots)
        if tick_s is not None:
            self._h_tick.observe(tick_s)

    # ------------------------------------------------- attribute surface
    # (historic int attributes, now views over the registry children —
    # one source of truth, no parallel state to drift)
    @property
    def submitted(self) -> int:
        """Requests submitted."""
        return int(self._c_submitted.value)

    @property
    def admitted(self) -> int:
        """Requests admitted into a decode lane."""
        return int(self._c_admitted.value)

    @property
    def retired(self) -> int:
        """Requests retired, any finish_reason."""
        return sum(int(c.value) for c in self._reasons.values())

    @property
    def rejected(self) -> int:
        """Submits rejected by the bounded queue."""
        return int(self._c_rejected.value)

    @property
    def tokens_generated(self) -> int:
        """Decode tokens that reached the host."""
        return int(self._c_tokens.value)

    @property
    def ticks(self) -> int:
        """Scheduler ticks executed."""
        return int(self._c_ticks.value)

    @property
    def finish_reasons(self) -> Dict[str, int]:
        """``{finish_reason: count}`` over this engine's retirements."""
        return {r: int(c.value) for r, c in self._reasons.items()
                if int(c.value)}

    @property
    def engine_recoveries(self) -> int:
        """Replay-recovery passes this engine ran."""
        return int(self._c_recoveries.value)

    @property
    def poison_retired(self) -> int:
        """Requests quarantined as poison."""
        return int(self._c_poison.value)

    @property
    def drain_rejects(self) -> int:
        """Submits refused during shutdown drain."""
        return int(self._c_drain_rejects.value)

    @property
    def timeouts(self) -> int:
        """Requests retired by queue-TTL or total-deadline expiry."""
        return self.finish_reasons.get("timeout", 0)

    @property
    def cancels(self) -> int:
        """Requests retired via ``cancel()``."""
        return self.finish_reasons.get("cancelled", 0)

    @property
    def callback_errors(self) -> int:
        """Requests retired because their ``on_token`` callback raised."""
        return self.finish_reasons.get("error", 0)

    @property
    def prefix_queries(self) -> int:
        """Paged admissions that consulted the prefix trie."""
        return int(self._c_prefix_queries.value)

    @property
    def prefix_hits(self) -> int:
        """Paged admissions that reused shared pages."""
        return int(self._c_prefix_hits.value)

    @property
    def prefill_tokens_saved(self) -> int:
        """Prompt tokens whose prefill the prefix cache skipped."""
        return int(self._c_prefill_saved.value)

    @property
    def prompt_tokens(self) -> int:
        """Prompt tokens across admitted paged requests."""
        return int(self._c_prompt_tokens.value)

    @property
    def prefill_chunks(self) -> int:
        """Chunked-prefill device calls executed."""
        return int(self._c_prefill_chunks.value)

    @property
    def host_spilled_pages(self) -> int:
        """Warm pages spilled to the host tier."""
        return int(self._c_host_spilled.value)

    @property
    def host_revived_pages(self) -> int:
        """Spilled pages revived on a prefix match."""
        return int(self._c_host_revived.value)

    @property
    def host_evicted_pages(self) -> int:
        """Host-tier entries dropped under the byte budget."""
        return int(self._c_host_evicted.value)

    @property
    def kv_pages_shipped(self) -> int:
        """KV pages exported to decode-role replicas."""
        return int(self._c_kv_shipped.value)

    @property
    def kv_bytes_shipped(self) -> int:
        """Wire-format bytes of exported KV page payloads."""
        return int(self._c_kv_bytes_shipped.value)

    @property
    def kv_pages_revived_remote(self) -> int:
        """Shipped pages revived into this replica's pool."""
        return int(self._c_kv_revived_remote.value)

    @property
    def disk_cache_hits(self) -> int:
        """Disk-tier reads that revived a page."""
        return int(self._c_disk_hits.value)

    @property
    def disk_cache_misses(self) -> int:
        """Disk-tier probes that found nothing."""
        return int(self._c_disk_misses.value)

    @property
    def spec_proposed_tokens(self) -> int:
        """Draft tokens proposed to speculative verification."""
        return int(self._c_spec_proposed.value)

    @property
    def spec_accepted_tokens(self) -> int:
        """Proposed draft tokens the target model accepted."""
        return int(self._c_spec_accepted.value)

    @property
    def queue_depth(self) -> int:
        """Last sampled queue depth."""
        return int(self._g_queue_depth.value)

    @property
    def active_slots(self) -> int:
        """Last sampled occupied-lane count."""
        return int(self._g_active_slots.value)

    @property
    def pages_in_use(self) -> int:
        """Last sampled allocated-page count (paged mode)."""
        return int(self._g_pages_in_use.value)

    @property
    def pages_total(self) -> int:
        """Last sampled usable-pool size (paged mode)."""
        return int(self._g_pages_total.value)

    # bounded-reservoir views (regression-tested: a 10k-retire loop must
    # hold these at the FLEETX_OBS_RESERVOIR cap, not 10k entries)
    @property
    def ttft_s(self):
        """TTFT reservoir (newest ``FLEETX_OBS_RESERVOIR`` samples)."""
        return self._h_ttft.reservoir

    @property
    def queue_wait_s(self):
        """Queue-wait reservoir."""
        return self._h_queue_wait.reservoir

    @property
    def latency_s(self):
        """Request-latency reservoir."""
        return self._h_latency.reservoir

    @property
    def tick_s(self):
        """Tick wall-clock reservoir."""
        return self._h_tick.reservoir

    @property
    def pages_per_request(self):
        """Fresh-pages-per-request reservoir."""
        return self._h_pages_per_req.reservoir

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict:
        """Aggregate view: counters, queue/occupancy stats, TTFT
        percentiles, decode tokens/s."""
        span = None
        if self._first_token_t is not None and self._last_token_t is not None:
            span = self._last_token_t - self._first_token_t
        ticks = self.ticks
        ttft_p50, ttft_p95 = self._h_ttft.quantiles((50, 95))
        tick_p50, tick_p99 = self._h_tick.quantiles((50, 99))
        stall_p50, stall_p99 = self._h_prefill_stall.quantiles((50, 99))
        return {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "retired": self.retired,
            "rejected": self.rejected,
            "timeouts": self.timeouts,
            "cancels": self.cancels,
            "callback_errors": self.callback_errors,
            "tokens_generated": self.tokens_generated,
            "ticks": ticks,
            "queue_depth": self.queue_depth,
            "queue_depth_mean": (self._h_queue_depth.sum / ticks
                                 if ticks else 0.0),
            "queue_depth_peak": int(self._h_queue_depth.max or 0),
            "active_slots": self.active_slots,
            "slots": self.slots,
            "slot_occupancy_mean": (self._h_active.sum / ticks / self.slots
                                    if ticks and self.slots else 0.0),
            "ttft_ms_mean": _ms(self._h_ttft.mean),
            "ttft_ms_p50": _ms(ttft_p50),
            "ttft_ms_p95": _ms(ttft_p95),
            "queue_wait_ms_mean": _ms(self._h_queue_wait.mean),
            "latency_ms_mean": _ms(self._h_latency.mean),
            "decode_tokens_per_s": (self.tokens_generated / span
                                    if span and span > 0 else None),
            "finish_reasons": self.finish_reasons,
            # paged-cache story: how much prefill the prefix trie saved
            # and how full the page pool ran (zeros on the slot path)
            "prefix_queries": self.prefix_queries,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": (self.prefix_hits / self.prefix_queries
                                if self.prefix_queries else 0.0),
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "prefill_tokens_saved_frac": (
                self.prefill_tokens_saved / self.prompt_tokens
                if self.prompt_tokens else 0.0),
            "pages_per_request_mean": self._h_pages_per_req.mean,
            "pages_in_use": self.pages_in_use,
            "pages_total": self.pages_total,
            # chunked-prefill + host-tier story (docs/SERVING.md): decode
            # stall bounded by one chunk, prefix hits sustained past the
            # device pool via the host-DRAM spill tier
            "prefill_chunks": self.prefill_chunks,
            "prefill_stall_ms_p50": stall_p50,
            "prefill_stall_ms_p99": stall_p99,
            "prefill_stall_ms_max": self._h_prefill_stall.max,
            "host_spilled_pages": self.host_spilled_pages,
            "host_revived_pages": self.host_revived_pages,
            "host_evicted_pages": self.host_evicted_pages,
            "host_cache_bytes": int(self._g_host_bytes.value),
            "host_cache_pages": int(self._g_host_pages.value),
            # disaggregation story (docs/SERVING.md "Disaggregated
            # prefill/decode"): what this replica shipped out / revived
            # in, its role in the fleet, the prefill-phase load signal,
            # and the shared disk tier's traffic
            "role": self.role,
            "kv_pages_shipped": self.kv_pages_shipped,
            "kv_bytes_shipped": self.kv_bytes_shipped,
            "kv_pages_revived_remote": self.kv_pages_revived_remote,
            "prefill_queue_tokens": int(self._g_queue_tokens.value),
            "disk_cache_bytes": int(self._g_disk_bytes.value),
            "disk_cache_hits": self.disk_cache_hits,
            "disk_cache_misses": self.disk_cache_misses,
            "page_occupancy_mean": (self._h_page_occ.mean or 0.0),
            "page_occupancy_peak": (self._h_page_occ.max or 0.0),
            # precision story (docs/QUANTIZATION.md): what the decode path
            # stores K/V and weights as, and what that costs in HBM
            "kv_dtype": self.kv_dtype,
            "weight_dtype": self.weight_dtype,
            "kv_bytes_per_token": int(self._g_kv_bytes.value),
            "weight_bytes": int(self._g_weight_bytes.value),
            "kv_cache_bytes": int(self._g_kv_cache_bytes.value),
            # mesh story (docs/SERVING.md "Mesh-sharded serving"): how
            # many devices the decode tick spans; the bytes gauges above
            # are PER DEVICE, so they shrink as the mesh grows
            "mesh_devices": int(self._g_mesh_devices.value),
            "mesh": self.mesh_desc,
            # speculative-decoding story (docs/SERVING.md): what the
            # proposer offered, what verification kept, and the
            # resulting decode multiplier (1.0 mean = nothing accepted)
            "spec_proposed_tokens": self.spec_proposed_tokens,
            "spec_accepted_tokens": self.spec_accepted_tokens,
            "spec_acceptance_rate": float(self._g_spec_rate.value),
            "spec_tokens_per_tick_mean": self._h_spec_tokens.mean,
            # crash-safety story: how often the engine recovered, what it
            # quarantined, what shutdown turned away, and what a tick costs
            "engine_recoveries": self.engine_recoveries,
            "poison_retired": self.poison_retired,
            "drain_rejects": self.drain_rejects,
            "tick_ms_p50": _ms(tick_p50),
            "tick_ms_p99": _ms(tick_p99),
        }

    def log_snapshot(self) -> None:
        """One structured log line through the framework logger."""
        from fleetx_tpu_torch.utils.log import logger

        s = self.snapshot()
        logger.info(
            "serving: queue=%d active=%d/%d retired=%d/%d rejected=%d "
            "timeouts=%d cancels=%d tokens=%d "
            "occupancy=%.2f tok/s=%s ttft_ms_p50=%s",
            s["queue_depth"], s["active_slots"], s["slots"], s["retired"],
            s["submitted"], s["rejected"], s["timeouts"], s["cancels"],
            s["tokens_generated"], s["slot_occupancy_mean"],
            ("%.1f" % s["decode_tokens_per_s"]
             if s["decode_tokens_per_s"] else "-"),
            ("%.1f" % s["ttft_ms_p50"] if s["ttft_ms_p50"] else "-"),
        )
