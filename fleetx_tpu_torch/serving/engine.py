"""ServingEngine: continuous-batching decode over the paged or the slot KV
cache.

Port of the JAX package's ``serving/engine.py``:

- **submit()** queues a request (FIFO) with per-request overrides for
  max/min length, EOS, temperature, top-k/top-p, a seeded sampling stream
  and the admission limits; a full bounded queue raises
  :class:`QueueFull`.
- **step()** is one scheduler tick: retire queued requests past their
  queue TTL or deadline, then prefill work — admissions (prefill-on-insert:
  the prompt runs one cached forward and its first token is sampled) or,
  while a long prompt is mid-chunked-prefill, exactly one chunk of it —
  then ONE batched decode forward over all lanes (or, with speculation on,
  a draft and one verify), then per-lane EOS / max-length / cache-full
  retirement and the active-deadline sweep.
- **drain()** ticks until queue and lanes are empty and returns the
  finished :class:`ServingResult` records; **cancel()** retires a queued
  or in-flight request at once.

Storage is PAGED by default (``paged=False`` or ``FLEETX_SERVING_PAGED=0``
gives the slot cache): K/V live in a shared ``[num_pages, page_size,
heads, head_dim]`` pool per layer, each request holds a block table of page
indices, and a refcounted prefix trie (``FLEETX_SERVING_PREFIX_CACHE``,
default on) lets requests sharing whole prompt pages reuse one prefill
(``cache_manager.py``). The slot cache gives each lane one contiguous row
of ``cache_len`` positions; a prompt is prefilled into a batch-1 cache and
copied into its row. A decode tick's attention runs in the decode kernels
(``ops/decode_attention.py``): B8 over the pages (B10 at ``kv_dtype``
``"int8"``), B7 over the slot rows (B9 at int8). Prefill, chunks and the
speculative verify take the dense masked path, as in the JAX engine.

Chunked prefill (``prefill_chunk`` / ``FLEETX_SERVING_PREFILL_CHUNK``,
default off): a prompt whose non-shared suffix exceeds the chunk enters the
``prefilling`` state and is written one chunk per tick, so that no tick
stalls the active streams' decode for more than about one chunk of prefill.
With a chunk size set a tick makes at most one prefill-shaped call (one
chunk, or one short admission), and FIFO order holds behind the prefilling
head. Paged chunks write straight into the lane's pages; slot chunks fill
a batch-1 working cache copied into the slot after the final chunk. The
final chunk samples the first token where the one-call path would, so
greedy streams are the unchunked engine's. Deadlines are checked between
chunks.

Speculative decoding (``spec`` / ``FLEETX_SERVING_SPEC=1``, ``spec_k`` /
``FLEETX_SERVING_SPEC_K``, default off): a proposer (``spec.py``: n-gram
prompt lookup, or a draft model under ``FLEETX_SERVING_SPEC_DRAFT=self`` or
``spec_proposer=``) guesses up to k tokens per active request, clamped
before proposing to the request's remaining budget and its pages; ONE
``k + 1``-token forward per tick scores them. Greedy acceptance keeps the
longest draft prefix equal to the target's argmax (with the per-position
``min_length`` EOS ban) plus the correction token, so greedy streams are
the plain engine's. Sampling rows run speculative rejection: per position
with a draft, one uniform u from the request's generator, the draft d kept
when u < p(d), else one categorical draw from the residual (p with d
removed); a position without a draft takes one categorical draw. That
preserves the target distribution; it cannot repeat the JAX engine's draws
(``jax.random`` keys). A tick where nothing was drafted is a plain tick.
On the paged path every lane's pending-token page is claimed first in the
plain tick's order, the draft windows after, and those are returned once
the verify is done, so ``cache_full`` decisions equal the plain engine's.

Admission limits: ``max_queue`` (``FLEETX_SERVING_MAX_QUEUE``, 0 =
unbounded), per-request ``queue_ttl_s`` (time waiting for a lane) and
``deadline_s`` (submit to finish), from ``FLEETX_SERVING_QUEUE_TTL_S`` /
``FLEETX_SERVING_DEADLINE_S`` by default; both retire with
``finish_reason="timeout"``. With no limits set every knob is inert.

Lane state lives on the host and rides each tick as small int tensors; the
caches are updated in place.

Page tiers (``host_cache_bytes`` / ``FLEETX_SERVING_HOST_CACHE_BYTES``,
``disk_cache_dir`` and ``disk_cache_bytes`` /
``FLEETX_SERVING_DISK_CACHE_DIR`` and ``_BYTES``; paged with the prefix
cache; default off): a warm prefix page
that LRU eviction would destroy spills to a bounded host store and/or a
directory of wire-format files that replicas share, and a later prompt
with the same prefix revives it into fresh pages instead of prefilling it
(``cache_manager.py``). Revived bytes are the spilled bytes, so greedy
streams equal those of a pool that never evicted. ``prewarm(prompt)``
pulls a persisted prefix into the device trie before traffic.

Roles (``role`` / ``FLEETX_SERVING_ROLE``: ``both``, the default,
``prefill`` or ``decode``): a prefill-role engine (paged only) runs
admission and prefill, emits the first token and PARKS the request
(``prefilled_ready()``); ``export_kv(id)`` reads the pages covering the
prompt and returns them as crc32-trailed wire-format blobs, retiring the
request ``"prefilled"``. A decode replica admits them with
``submit(prompt, history=[t0], kv_payloads=blobs)``: the pages are written
through the revive path (no prefill) and decoding continues from ``t0``,
its sampling stream advanced past ``t0``'s draw. A blob that fails its crc
or does not fit the pool raises ValueError at submit; the caller falls
back to replay (``submit(history=)``).

Crash safety:

- **Transactional ticks.** ``step()`` snapshots the host bookkeeping (the
  queue, the active, prefilling and parked maps, the results, each
  request's progress fields and a sampling request's generator state),
  re-committing after each admission; an exception rolls it back and runs
  :meth:`recover`, so no token, request or queue place is lost or
  doubled.
- **Replay recovery.** :meth:`recover` builds FRESH pool (or slot) tensors
  — never reusing the old ones, which an abandoned call may still write —
  and re-admits every active and parked request from host truth: its
  prompt through its admission's own prefill call(s), then its emitted
  tokens but the last through decode-shaped forwards (one per position,
  every replayed lane riding each; the decode kernels), which write the
  K/V the original decode ticks wrote, bit for bit. Mid-prefill requests
  requeue at the head. The page tiers survive (content-addressed). More
  than ``max_recoveries`` (``FLEETX_SERVING_MAX_RECOVERIES``, 8)
  consecutive recoveries without a productive tick raise
  :class:`RecoveryExhausted` and ``health()`` reads ``"dead"``.
- **Poison quarantine.** A decode tick that fails again right after a
  recovery bisects the active set with non-committing probe forwards (no
  sampling, no host state moved; a probe's K/V writes land only at each
  probed lane's next write position, which the next committed tick
  overwrites before reading it) and retires the request whose presence
  kills the batch ``error``; a prefill that fails twice retires its
  request directly.
- **Watchdog.** With ``tick_timeout_s`` (``FLEETX_SERVING_TICK_TIMEOUT_S``)
  > 0 each decode forward runs on a daemon worker thread (under
  ``no_grad`` there) with its operands bound on the calling thread; a
  forward past the budget banks ``hang_diagnostics`` and raises
  :class:`TickTimeout` into the rollback. The abandoned call can only
  write the old tensors it was bound to, and holds them until it returns.
- **Graceful shutdown.** :meth:`shutdown` (or SIGTERM through
  :meth:`install_sigterm_handler`) stops admission
  (:class:`ShuttingDown`), keeps ticking for ``grace_s``
  (``FLEETX_SERVING_GRACE_S``, 30) and then retires what is left
  ``"shutdown"`` with its partial tokens.
- **Admit-with-history.** ``submit(history=)`` admits a request another
  replica started through the same replay.

Only host-side and injected faults are recoverable in process: a real
CUDA error (an illegal address, a device-side assert) poisons the
process's CUDA context, so the engine marks itself dead and re-raises it
instead of replaying.

Int8 weights (``weight_dtype`` / ``FLEETX_SERVING_WEIGHT_DTYPE``, default
bf16, i.e. the model's compute dtype): the whole state dict is quantized
once at construction (``ops/quant.serving_weight_params``: per-channel
absmax int8, JAX's channels and bits), the device holds the int8 values
and fp32 scales, and each dense layer and embedding dequantizes its own
weight per call (fp32, then the compute dtype). A state dict that is
already quantized passes through; one served at bf16 raises.

Mesh serving (``mesh=``, a ``parallel/mesh.Mesh`` with an mp axis): the
port runs SPMD, one engine per mp rank of a process group (the ranks
``parallel/launch.spawn`` starts; gloo where ranks share a card), where
the JAX engine is one controller over a device mesh. Every rank is handed
the same whole state dict and the same ``submit``/``step`` calls; it
quantizes the whole model first (at int8 weights), then keeps its
column- or row-parallel shard (``convert.shard_params``), and holds its
``heads / mp`` heads of both cache layouts, int8 scales included, which
its decode kernels read. The row-parallel projections all-reduce their
partial sums (fp32 GEMM outputs, rounded once after the sum, so that a
rank's activations are the single device's up to fp32 summation order),
and every forward's logits are all-gathered over the mp
group before sampling, so each rank samples the same token from the same
bits with the same per-request generator, and the host bookkeeping
(scheduler, lanes, trie, snapshots, replay) stays identical on every rank;
every clock read is rank 0's, broadcast (limits, grace windows and
metrics stamps alike). Byte gauges and
``cache_nbytes()`` are per rank. What a mesh does not take: pp or cp
extents and heads that mp does not divide (ValueError), an fsdp extent
(the parameters would be sharded, ROADMAP Queue A "ZeRO stage 3
(parameter sharding)"), the page tiers, ``prewarm`` and the prefill or
decode roles at mp > 1 (Queue A "Page tiers and roles under a mesh"), and
the tick watchdog at mp > 1 (an abandoned call's collectives would pair
with the recovery's; Queue C "Gaps by design"). A dp extent replicates
the tick.

Observability: the metrics live on the ``obs`` registry (``metrics.py``);
``FLEETX_OBS_PORT`` makes the process scrapeable (``/metrics``,
``/healthz``, whose probe is this engine's ``health()``, held weakly),
and ``log_every`` / ``FLEETX_SERVING_LOG_EVERY`` writes
``metrics.log_snapshot()`` every that many ticks.

The router-facing surface (``model_protocol.ENGINE_SURFACE``):
``health()``, ``declare_dead()``, ``submit_limit``, ``emitted_tokens()``,
``take_result()`` and the one-shot ``generate_batch()``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import threading
import time
import traceback
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fleetx_tpu_torch.models.gpt.generation import (
    GenerationConfig,
    _top_p_cutoff_bisect,
)
from fleetx_tpu_torch.models.gpt.convert import shard_params
from fleetx_tpu_torch.models.gpt.model import (
    inference_params,
    refuse_moe_serving,
)
from fleetx_tpu_torch.obs import http as obs_http
from fleetx_tpu_torch.obs.events import emit as obs_emit
from fleetx_tpu_torch.ops.quant import (
    resolve_serving_dtype,
    serving_weight_params,
)
from fleetx_tpu_torch.resilience.faults import faults
from fleetx_tpu_torch.serving.cache_manager import (
    DiskPageStore,
    HostPageStore,
    PagedKVCacheManager,
    SlotKVCacheManager,
    TieredPageStore,
    scatter_slot,
)
from fleetx_tpu_torch.serving.metrics import ServingMetrics
from fleetx_tpu_torch.serving.model_protocol import GPTExecutor
from fleetx_tpu_torch.serving.scheduler import FIFOScheduler, Request
from fleetx_tpu_torch.serving.spec import build_proposer
from fleetx_tpu_torch.utils.device import resolve_device
from fleetx_tpu_torch.utils.log import logger

__all__ = ["QueueFull", "RecoveryExhausted", "ServingEngine",
           "ServingResult", "ShuttingDown", "TickTimeout", "filter_logits",
           "sample_tokens", "skip_draws"]

_NEG = -1e9
_MESH_TIERS = 'ROADMAP Queue A, "Page tiers and roles under a mesh"'


class QueueFull(RuntimeError):
    """Admission refused: the queue is at ``FLEETX_SERVING_MAX_QUEUE``. The
    explicit backpressure signal — callers shed load or retry later."""


class ShuttingDown(RuntimeError):
    """Admission refused: the engine is draining toward shutdown (a router
    sends the request to another replica)."""


class TickTimeout(RuntimeError):
    """A decode forward outlived ``FLEETX_SERVING_TICK_TIMEOUT_S``; raised
    into the transactional tick's rollback and recovery, with
    ``engine.hang_diagnostics`` banked."""


class RecoveryExhausted(RuntimeError):
    """More than ``FLEETX_SERVING_MAX_RECOVERIES`` consecutive recoveries
    without a productive tick: the fault is not request-shaped, so the
    engine declares itself dead (the caller restarts the process)."""


def _is_device_fault(exc: BaseException) -> bool:
    """A real CUDA error: it poisons the process's CUDA context, so no
    in-process replay can recover from it."""
    cls = getattr(torch, "AcceleratorError", None)
    if cls is not None and isinstance(exc, cls):
        return True
    msg = str(exc)
    return isinstance(exc, RuntimeError) and any(
        m in msg for m in ("CUDA error", "device-side assert",
                           "illegal memory access"))


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def filter_logits(logits, temperature, top_k, top_p, *, topk_cap: int):
    """THE per-row sampling filter: temperature scale, top-k through one
    ``topk(topk_cap)`` (the row's cutoff is its k-th value; ``top_k`` in
    ``[0, topk_cap]``, 0 = no filter), then the sort-free top-p threshold
    bisection with per-row targets. ``logits`` [n, vocab] fp32 with
    per-row knobs [n] → filtered logits (removed entries at ``-1e9``)."""
    vocab = logits.shape[-1]
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    cap = max(1, min(topk_cap, vocab))
    vals = torch.topk(scaled, cap, dim=-1).values  # [n, cap] descending
    kth = vals.gather(1, (top_k.long() - 1).clamp(0, cap - 1)[:, None])
    filtered = torch.where((top_k > 0)[:, None] & (scaled < kth), _NEG,
                           scaled)
    probs, thresh = _top_p_cutoff_bisect(filtered, top_p[:, None])
    return torch.where(probs >= thresh, filtered, _NEG)


def sample_tokens(logits, generators, greedy, temperature, top_k, top_p, *,
                  topk_cap: int):
    """Per-row sampler: each row applies ITS OWN strategy (greedy flag,
    temperature, top-k, top-p) and draws from its own ``torch.Generator``
    (``generators[i]``, unused and may be None for a greedy row). Greedy
    rows take the argmax of the unfiltered logits. Returns int32 [n]."""
    tok = torch.argmax(logits, dim=-1)
    if not bool(greedy.all()):
        probs = torch.softmax(filter_logits(logits, temperature, top_k,
                                            top_p, topk_cap=topk_cap), -1)
        for i in torch.nonzero(~greedy).flatten().tolist():
            tok[i] = torch.multinomial(probs[i], 1,
                                       generator=generators[i])[0]
    return tok.to(torch.int32)


def skip_draws(generator: torch.Generator, n: int, vocab: int) -> None:
    """Move ``generator`` past ``n`` tokens sampled by :func:`sample_tokens`:
    each is one ``torch.multinomial`` of one sample over an fp32 vocabulary
    row, which draws one exponential per entry whatever the row holds, so
    repeating it over a uniform row consumes the same stream. A request
    admitted with a history (or shipped KV) resumes its sampling there."""
    if n > 0:
        row = torch.ones(vocab, dtype=torch.float32, device=generator.device)
        for _ in range(n):
            torch.multinomial(row, 1, generator=generator)


@dataclasses.dataclass
class ServingResult:
    """Final outcome of one request: generated tokens + latency stats."""

    id: int
    prompt: np.ndarray
    tokens: np.ndarray  # generated tokens (EOS included when hit)
    # eos | max_length | cache_full | timeout | cancelled | error |
    # shutdown | prefilled ("error" covers raising callbacks and
    # quarantined poison requests)
    finish_reason: str
    ttft_s: float
    latency_s: float


class _Watchdog:
    """One daemon worker thread that runs a watched call; a call past its
    budget is abandoned — the worker finishes it (its results unread) and
    exits — and the next call starts a new worker."""

    def __init__(self, device: torch.device):
        self.device = device
        self.jobs: queue.SimpleQueue = queue.SimpleQueue()
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="fleetx-serving-watchdog")
        self.thread.start()

    def _loop(self) -> None:
        # autograd mode and the current CUDA device are per thread
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        with ctx, torch.no_grad():
            while True:
                job = self.jobs.get()
                if job is None:
                    return
                fn, box, done = job
                try:
                    box.append((True, fn()))
                except BaseException as exc:  # handed to the caller
                    box.append((False, exc))
                del fn, job  # an abandoned call's operands go here
                done.set()

    def run(self, fn, timeout: float):
        """``(True, result)``, re-raising what ``fn`` raised, or ``(False,
        None)`` when ``fn`` outlived ``timeout`` (this worker then retires
        after it)."""
        box, done = [], threading.Event()
        self.jobs.put((fn, box, done))
        if not done.wait(timeout):
            self.jobs.put(None)
            return False, None
        ok, value = box[0]
        if not ok:
            raise value
        return True, value


class ServingEngine:
    """Continuous-batching serving loop (module docstring).

    ``model`` gives the architecture and its ``cfg`` (a module on the
    ``meta`` device is enough); ``params`` is its state dict
    (``convert.init_params`` / ``convert.params_from_jax``). The engine
    builds its own decode-configured copy on ``device`` — CUDA unless the
    caller passes another; without CUDA it raises — with the dense
    weights stored at the compute dtype (the forward casts them there
    anyway, so results are unchanged), or at ``weight_dtype="int8"`` as
    int8 with per-channel scales. ``params`` is the whole model's state
    dict also under a ``mesh`` (module docstring), where each rank keeps
    its shard. Every keyword left at None takes its ``FLEETX_SERVING_*``
    variable, else the JAX engine's default."""

    def __init__(self, model, params: Dict[str, torch.Tensor], *,
                 device=None, slots: Optional[int] = None,
                 cache_len: Optional[int] = None,
                 gen_cfg: Optional[GenerationConfig] = None,
                 base_seed: int = 0, topk_cap: Optional[int] = None,
                 prefill_bucket: Optional[int] = None,
                 metrics: Optional[ServingMetrics] = None,
                 max_queue: Optional[int] = None,
                 queue_ttl_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 paged: Optional[bool] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 kv_dtype: Optional[str] = None,
                 prefill_chunk: Optional[int] = None,
                 spec: Optional[bool] = None,
                 spec_k: Optional[int] = None,
                 spec_proposer=None, role: Optional[str] = None,
                 host_cache_bytes: Optional[int] = None,
                 disk_cache_dir: Optional[str] = None,
                 disk_cache_bytes: Optional[int] = None,
                 max_recoveries: Optional[int] = None,
                 tick_timeout_s: Optional[float] = None,
                 grace_s: Optional[float] = None,
                 weight_dtype: Optional[str] = None,
                 log_every: Optional[int] = None, mesh=None):
        refuse_moe_serving(model.cfg)
        mp = self._check_mesh(mesh, model.cfg)
        self.mesh = mesh
        self.device = resolve_device(device)
        gen_cfg = gen_cfg or GenerationConfig(decode_strategy="greedy")
        if gen_cfg.repetition_penalty != 1.0:
            raise ValueError("continuous batching does not support "
                             "repetition_penalty")
        if gen_cfg.forced_eos_token_id is not None:
            raise ValueError("continuous batching does not support "
                             "forced_eos_token_id")
        self.gen_cfg = gen_cfg
        self.slots = slots or _env_int("FLEETX_SERVING_SLOTS", 8)
        self.paged = (paged if paged is not None
                      else _env_int("FLEETX_SERVING_PAGED", 1) == 1)
        self.page_size = page_size or _env_int("FLEETX_SERVING_PAGE_SIZE", 16)
        # "both" is the colocated engine; a prefill-role engine parks each
        # request after its first token for export_kv, a decode-role one
        # is a plain engine a router feeds shipped KV
        self.role = (role or os.environ.get("FLEETX_SERVING_ROLE", "")
                     or "both")
        if self.role not in ("prefill", "decode", "both"):
            raise ValueError(f"role must be 'prefill', 'decode' or 'both', "
                             f"got {self.role!r}")
        if self.role == "prefill" and not self.paged:
            raise ValueError(
                "role='prefill' requires the paged cache (paged=True): "
                "export_kv() ships whole pages through the block table")
        cache_len = (cache_len or _env_int("FLEETX_SERVING_CACHE_LEN", 0)
                     or model.cfg.max_position_embeddings)
        if self.paged:
            # per-request logical capacity rounds to whole pages
            cache_len += -cache_len % self.page_size
        elif model.cfg.use_flash_attention or self.device.type == "cuda":
            # the decode kernel's 8-row tile (JAX rounds under flash; on the
            # card every decode step takes the kernel); the extra rows are
            # never attended
            cache_len += -cache_len % 8
        self.cache_len = cache_len
        # KV precision: "bf16" keeps the model's compute dtype, "int8"
        # stores the cache as int8 with fp32 scales (decode through B9/B10)
        self.kv_dtype = resolve_serving_dtype(kv_dtype,
                                              "FLEETX_SERVING_KV_DTYPE")
        decode_kv = "int8" if self.kv_dtype == "int8" else None
        # weight precision: "int8" holds every dense kernel and embedding
        # as int8 with per-channel scales, dequantized per call
        self.weight_dtype = resolve_serving_dtype(
            weight_dtype, "FLEETX_SERVING_WEIGHT_DTYPE")
        layout = dict(
            mp_degree=mp, sequence_parallel=False, pp_degree=1,
            cp_degree=1, num_microbatches=1, virtual_pp_degree=1)
        if self.paged:
            # default pool = every lane's full capacity + the trash page
            self.num_pages = (num_pages or _env_int("FLEETX_SERVING_PAGES", 0)
                              or self.slots * (cache_len // self.page_size)
                              + 1)
            self.prefix_cache = (
                prefix_cache if prefix_cache is not None
                else _env_int("FLEETX_SERVING_PREFIX_CACHE", 1) == 1)
            cfg = dataclasses.replace(
                model.cfg, decode_cache_len=cache_len,
                decode_num_pages=self.num_pages,
                decode_page_size=self.page_size, decode_kv_dtype=decode_kv,
                **layout)
        else:
            self.num_pages = 0
            self.prefix_cache = False
            cfg = dataclasses.replace(
                model.cfg, decode_cache_len=cache_len, decode_num_pages=None,
                decode_page_size=None, decode_kv_dtype=decode_kv, **layout)
        # the row-parallel sums round once, as one GEMM's does
        self.model = type(model)(cfg, device="meta",
                                 int8=self.weight_dtype == "int8",
                                 fp32_partials=True)
        # the whole model quantized once (no-op at bf16), then this rank's
        # shard: a row-parallel kernel's absmax runs over its whole input
        params = serving_weight_params(params, self.weight_dtype,
                                       cfg.head_dim)
        if mp > 1:
            params = shard_params(params, cfg, mesh.mp_rank)
        self.model.load_state_dict(
            inference_params(self.model, params, self.device), assign=True)
        del params
        self.executor = GPTExecutor(self.model, mesh=mesh)
        self.capabilities = self.executor.capabilities
        self.model_family = self.capabilities.family
        self.topk_cap = topk_cap or _env_int("FLEETX_SERVING_TOPK_CAP", 64)
        self.prefill_bucket = (prefill_bucket
                               or _env_int("FLEETX_SERVING_PREFILL_BUCKET", 32))
        # chunked prefill: 0 = whole-prompt prefill-on-insert; > 0 bounds a
        # tick's prefill work to one chunk-sized call
        self.prefill_chunk = (prefill_chunk if prefill_chunk is not None
                              else _env_int("FLEETX_SERVING_PREFILL_CHUNK", 0))
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {self.prefill_chunk}")
        # admission limits, all off by default
        self.max_queue = (max_queue if max_queue is not None
                          else _env_int("FLEETX_SERVING_MAX_QUEUE", 0))
        self.queue_ttl_s = (queue_ttl_s if queue_ttl_s is not None
                            else _env_float("FLEETX_SERVING_QUEUE_TTL_S", 0.0))
        self.deadline_s = (deadline_s if deadline_s is not None
                           else _env_float("FLEETX_SERVING_DEADLINE_S", 0.0))
        # page tiers under the paged pool's prefix trie (module docstring)
        host_bytes = (host_cache_bytes if host_cache_bytes is not None
                      else _env_int("FLEETX_SERVING_HOST_CACHE_BYTES", 0))
        disk_dir = (disk_cache_dir if disk_cache_dir is not None
                    else os.environ.get("FLEETX_SERVING_DISK_CACHE_DIR", ""))
        disk_bytes = (disk_cache_bytes if disk_cache_bytes is not None
                      else _env_int("FLEETX_SERVING_DISK_CACHE_BYTES", 0))
        tiered = self.paged and self.prefix_cache
        self._dram_store = (HostPageStore(host_bytes)
                            if host_bytes > 0 and tiered else None)
        self._disk_store = (DiskPageStore(disk_dir, disk_bytes)
                            if disk_dir and disk_bytes > 0 and tiered
                            else None)
        self._host_store = (
            TieredPageStore(self._dram_store, self._disk_store)
            if self._dram_store is not None and self._disk_store is not None
            else self._dram_store if self._dram_store is not None
            else self._disk_store)
        # crash safety (module docstring)
        self.max_recoveries = (
            max_recoveries if max_recoveries is not None
            else _env_int("FLEETX_SERVING_MAX_RECOVERIES", 8))
        self.tick_timeout_s = (
            tick_timeout_s if tick_timeout_s is not None
            else _env_float("FLEETX_SERVING_TICK_TIMEOUT_S", 0.0))
        self.grace_s = (grace_s if grace_s is not None
                        else _env_float("FLEETX_SERVING_GRACE_S", 30.0))
        self.log_every = (log_every if log_every is not None
                          else _env_int("FLEETX_SERVING_LOG_EVERY", 0))
        if mp > 1:
            self._check_mesh_features()
            # every rank reads rank 0's clock, so that limits and grace
            # windows decide alike on every rank and the stamps agree
            self._now = self._mesh_clock
        else:
            self._now = time.perf_counter
        self._recoveries_consecutive = 0
        self._tick_strikes = 0              # consecutive failed decode ticks
        self._prefill_strikes: Dict[int, int] = {}  # request id -> failures
        self._fault_ctx = None              # ("prefill", id) during prefill
        self._fault_ticks = 0               # attempted decode device calls
        self._fault_prefills = 0            # attempted prefills
        self._fault_ships = 0               # attempted KV exports
        self._watchdog: Optional[_Watchdog] = None
        self.probes = 0                     # probes of the last bisection
        self.abandoned: List[threading.Thread] = []  # timed-out workers
        self.hang_diagnostics = None
        self._shutting_down = False
        self._dead = False
        self._shutdown_deadline = None
        self._shutdown_event_pending = False
        self._prev_sigterm = None
        self._ticks = 0
        self.cache_manager = self._new_cache_manager()
        self._tables_dev = None       # device copy of the block tables,
        self._tables_version = -1     # refreshed when the pool's moves
        self.scheduler = FIFOScheduler()
        self.metrics = metrics or ServingMetrics(self.slots)
        self.metrics.set_role(self.role)
        self.publish_quant_metrics()
        self.base_seed = int(base_seed)
        self._next_id = 0
        self._active: Dict[int, Request] = {}  # slot -> request
        # chunked prefill: slot -> the request mid-prefill there (at most
        # one: the FIFO head)
        self._prefilling: Dict[int, Request] = {}
        # prefill role: slot -> request parked after its first token, lane
        # and pages held, until export_kv()
        self._prefilled: Dict[int, Request] = {}
        self._results: Dict[int, ServingResult] = {}
        # speculative decoding, off by default; an explicit proposer
        # implies it, and contradicting it is a configuration error
        self.spec = (spec if spec is not None
                     else True if spec_proposer is not None
                     else _env_int("FLEETX_SERVING_SPEC", 0) == 1)
        if spec_proposer is not None and not self.spec:
            raise ValueError(
                "spec_proposer was given but speculation is explicitly "
                "disabled (spec=False); drop one or the other")
        self.spec_k = (spec_k if spec_k is not None
                       else _env_int("FLEETX_SERVING_SPEC_K", 4))
        self._proposer = None
        if self.spec:
            if not self.capabilities.supports_spec:
                raise ValueError(
                    f"model family {self.capabilities.family!r} does not "
                    "support speculative decoding")
            if self.spec_k < 1:
                raise ValueError(
                    f"spec_k must be >= 1 when speculation is on, got "
                    f"{self.spec_k} (FLEETX_SERVING_SPEC_K)")
            self._proposer = spec_proposer or build_proposer(
                os.environ.get("FLEETX_SERVING_SPEC_DRAFT", ""), self.model,
                self.model.state_dict(), prefill_bucket=self.prefill_bucket,
                device=self.device)
            self._proposer.bind(self.slots, self.cache_len)
            obs_emit("spec_enabled", k=self.spec_k,
                     proposer=self._proposer.name)
        # observability: FLEETX_OBS_PORT makes the process scrapeable, and
        # /healthz reads health() (held weakly: the probe never keeps a
        # dead engine alive)
        obs_http.maybe_start_from_env()
        self._health_name = f"serving_engine_{self.metrics.engine_label}"
        ref = weakref.ref(self)

        def _healthy():
            eng = ref()
            return True if eng is None else eng.health()

        obs_http.register_health(self._health_name, _healthy)
        weakref.finalize(self, obs_http.unregister_health, self._health_name)

    @staticmethod
    def _check_mesh(mesh, cfg) -> int:
        """The mp extent of a serving ``mesh`` (1 without one), after the
        JAX engine's checks: pp or cp extents and heads that mp does not
        divide raise ValueError, a dp extent replicates the tick (with a
        warning); an fsdp extent raises, the parameters' shard being ZeRO
        stage 3's."""
        if mesh is None:
            return 1
        if mesh.pp > 1 or mesh.cp > 1:
            raise ValueError(
                f"serving mesh {mesh} has pp/cp extents; the decode tick "
                "runs the full layer stack per rank — use a (dp, mp) mesh")
        if cfg.num_attention_heads % mesh.mp:
            raise ValueError(
                f"num_attention_heads {cfg.num_attention_heads} does not "
                f"divide over mp={mesh.mp}; the kv cache shards over heads")
        if mesh.fsdp > 1:
            raise NotImplementedError(
                f"serving over an fsdp extent ({mesh}) shards the "
                "parameters, which is not ported yet (ROADMAP Queue A, "
                "\"ZeRO stage 3 (parameter sharding)\")")
        if mesh.dp > 1:
            logger.warning(
                "serving: mesh has dp=%d — the decode tick is REPLICATED "
                "over the dp axis (no throughput gain); prefer %d "
                "independent engine replicas behind a router", mesh.dp,
                mesh.dp)
        return mesh.mp

    def _check_mesh_features(self) -> None:
        """At mp > 1: the page tiers and the roles raise (their wire
        format holds whole pages, a rank holds a head slice), and so does
        the tick watchdog (an abandoned call's collectives would pair with
        the recovery's on the same group)."""
        what = ("the host page tier" if self._dram_store is not None
                else "the disk page tier" if self._disk_store is not None
                else f"role={self.role!r}" if self.role != "both"
                else None)
        if what is not None:
            self._refuse_under_mesh(what)
        if self.tick_timeout_s > 0:
            raise NotImplementedError(
                f"tick_timeout_s={self.tick_timeout_s} under an mp "
                f"{self.mesh.mp} mesh: an abandoned call's collectives "
                "would pair with the recovery's on the same group (ROADMAP "
                "Queue C, \"Gaps by design\": the watchdog under a mesh)")

    def _refuse_under_mesh(self, what: str) -> None:
        if self.mesh is not None and self.mesh.mp > 1:
            raise NotImplementedError(
                f"{what} under an mp {self.mesh.mp} mesh is not ported yet "
                f"({_MESH_TIERS})")

    def _mesh_clock(self) -> float:
        """``time.perf_counter()`` of the mp group's first rank, broadcast
        over the group at every read (every rank reads the clock at the same
        points): limits, grace windows and metrics stamps read one clock on
        every rank."""
        group = self.mesh.mp_group
        dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
        t = torch.tensor([time.perf_counter()], dtype=torch.float64,
                         device=dev)
        dist.broadcast(t, src=self.mesh.rank - self.mesh.mp_rank,
                       group=group)
        return float(t[0])

    def _new_cache_manager(self):
        """Fresh device storage (construction and :meth:`recover`): new
        pool or slot tensors, the page tiers threaded through."""
        if self.paged:
            return PagedKVCacheManager(
                self.model, self.slots, self.cache_len, self.num_pages,
                self.page_size, prefix_cache=self.prefix_cache,
                device=self.device, host_store=self._host_store)
        return SlotKVCacheManager(self.model, self.slots, self.cache_len,
                                  device=self.device)

    def publish_quant_metrics(self) -> None:
        """Push the precision and mesh config and the byte gauges into
        ``metrics`` (JAX ``_publish_quant_metrics``): the K+V bytes one
        cached token costs over all layers (one fp32 scale per head vector
        at int8), the weights' bytes and the cache's, all per rank under a
        mesh. Call again after swapping ``engine.metrics``."""
        cfg = self.model.cfg
        quant = self.kv_dtype == "int8"
        item = 1 if quant else torch.empty(0, dtype=cfg.dtype).element_size()
        heads = cfg.num_attention_heads // cfg.mp_degree  # on this rank
        per_token = cfg.num_layers * heads * 2 * (
            cfg.head_dim * item + (4 if quant else 0))
        if self.mesh is None:
            self.metrics.set_mesh(1, "-")
        else:
            m = self.mesh
            desc = "x".join(f"{k}{v}" for k, v in (
                ("pp", m.pp), ("dp", m.dp), ("fsdp", m.fsdp), ("cp", m.cp),
                ("mp", m.mp)) if v > 1) or "1"
            self.metrics.set_mesh(m.world, desc)
        self.metrics.set_quant_config(
            self.kv_dtype, self.weight_dtype, per_token, self.weight_nbytes(),
            kv_cache_bytes=self.cache_manager.cache_nbytes())

    def weight_nbytes(self) -> int:
        """Bytes of the served weights on this rank: every tensor of the
        model's state dict (int8 values and fp32 scales at int8 weights;
        this rank's shards under a mesh)."""
        return sum(t.numel() * t.element_size()
                   for t in self.model.state_dict().values())

    # ------------------------------------------------------------ lifecycle

    def submit(self, prompt, *, max_length: Optional[int] = None,
               min_length: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               decode_strategy: Optional[str] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               seed: Optional[int] = None, on_token=None,
               queue_ttl_s: Optional[float] = None,
               deadline_s: Optional[float] = None, history=None,
               kv_payloads=None) -> int:
        """Queue one request; returns its id. Kwargs override the engine's
        ``gen_cfg`` per request; ``seed`` pins this request's sampling
        stream (default: derived from the engine's ``base_seed`` and the
        request id); ``on_token`` streams ``(request_id, token,
        finished)`` per decoded token; ``queue_ttl_s``/``deadline_s``
        override the engine's limits (0 disables). Raises
        :class:`QueueFull` when the bounded queue is full and
        :class:`ShuttingDown` once a shutdown was requested.

        ``history``: tokens this request already emitted on another replica
        (admit-with-history). It admits through the replay seam — prompt
        and ``history[:-1]`` rebuilt, its sampling stream moved past
        ``len(history)`` draws of the same ``seed`` — and decodes on from
        ``history[-1]``; history counts against ``max_length`` and rides
        the result, but ``on_token`` fires only for new tokens. A history
        that is already terminal raises ValueError.

        ``kv_payloads``: the page blobs a prefill-role replica's
        :meth:`export_kv` shipped for this prompt, with ``history=[t0]``.
        They are decoded and checked here (crc32, leaves, shapes and
        dtypes against this pool): a bad ship raises ValueError before the
        request queues. Admission writes them into fresh pages, no
        prefill."""
        if self._shutting_down:
            self.metrics.record_drain_reject()
            obs_emit("drain_reject", engine=self.metrics.engine_label)
            raise ShuttingDown(
                "engine is draining toward shutdown; submit to another "
                "replica (in-flight requests finish under the grace window)")
        if self.max_queue and self.scheduler.queue_depth >= self.max_queue:
            # dead entries must not hold live ones out
            self._expire_queued(self._now())
        if self.max_queue and self.scheduler.queue_depth >= self.max_queue:
            self.metrics.record_reject()
            obs_emit("queue_reject", engine=self.metrics.engine_label,
                     queue_depth=self.scheduler.queue_depth)
            raise QueueFull(
                f"admission queue is full ({self.scheduler.queue_depth}/"
                f"{self.max_queue} waiting, {self.cache_manager.active_count}"
                f"/{self.slots} slots busy); retry later or raise "
                "FLEETX_SERVING_MAX_QUEUE")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        g = self.gen_cfg
        strategy = decode_strategy or g.decode_strategy
        if strategy not in ("greedy", "sampling"):
            raise ValueError(
                f"decode_strategy {strategy!r} not servable by continuous "
                "batching")
        limit = min(self.cache_len, self.model.cfg.max_position_embeddings)
        if prompt.size >= limit:
            raise ValueError(
                f"prompt_len {prompt.size} leaves no decode room "
                f"(cache/position limit {limit})")
        max_new = int(max_length if max_length is not None else g.max_length)
        if prompt.size + max_new > limit:
            clamped = limit - prompt.size
            logger.warning(
                "serving: request %d max_length %d clamped to %d "
                "(prompt %d + limit %d)", self._next_id, max_new, clamped,
                prompt.size, limit)
            max_new = clamped
        min_new = min(int(min_length if min_length is not None
                          else g.min_length), max_new)
        eos = int(eos_token_id if eos_token_id is not None
                  else (g.eos_token_id if g.eos_token_id is not None else -1))
        vocab = self.model.cfg.vocab_size
        tk = int(top_k if top_k is not None else g.top_k)
        if tk <= 0 or tk >= vocab:
            tk = 0  # no filter
        elif tk > self.topk_cap:
            logger.warning(
                "serving: request %d top_k %d clamped to topk_cap %d "
                "(FLEETX_SERVING_TOPK_CAP)", self._next_id, tk, self.topk_cap)
            tk = self.topk_cap
        hist = ([] if history is None
                else [int(t) for t in np.asarray(history,
                                                 np.int64).reshape(-1)])
        if hist:
            if eos >= 0 and hist[-1] == eos:
                raise ValueError(
                    f"history of {len(hist)} tokens already ends in EOS "
                    f"({eos}): the request is terminal; do not migrate it")
            if max_new <= len(hist):
                raise ValueError(
                    f"history ({len(hist)} tokens) meets or exceeds the "
                    f"max_length budget ({max_new}): the request is "
                    "terminal; do not migrate it")
        pages = None
        if kv_payloads is not None:
            self._refuse_under_mesh("shipped KV (kv_payloads=)")
            if not self.paged:
                raise ValueError(
                    "kv_payloads requires the paged cache (paged=True): "
                    "shipped KV revives into pages")
            if not hist:
                raise ValueError(
                    "kv_payloads without history: the prefill replica "
                    "sampled the first token — pass it as history=[t0]")
            if len(hist) != 1:
                raise ValueError(
                    f"kv_payloads ship the prompt's pages only, but history "
                    f"holds {len(hist)} tokens: pass history=[t0] (a longer "
                    "history admits by replay, without kv_payloads)")
            need = -(-prompt.size // self.page_size)
            if len(kv_payloads) != need:
                raise ValueError(
                    f"kv_payloads has {len(kv_payloads)} page blob(s); a "
                    f"{prompt.size}-token prompt at page_size "
                    f"{self.page_size} ships {need}")
            # decoded and checked now: a corrupt or foreign ship fails this
            # submit loudly and never enters the queue
            pages = [self.cache_manager.check_payload(
                HostPageStore.payload_from_bytes(b)
                if isinstance(b, (bytes, bytearray, memoryview)) else b)
                for b in kv_payloads]
        rid = self._next_id
        self._next_id += 1
        if seed is None:
            seed = int(np.random.SeedSequence(
                [self.base_seed, rid]).generate_state(1)[0])
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        if strategy == "sampling":
            # the stream resumes where the history's draws left it
            skip_draws(generator, len(hist), vocab)
        req = Request(
            id=rid, prompt=prompt, max_new_tokens=max(max_new, 1),
            min_new_tokens=min_new, eos_token_id=eos,
            greedy=strategy == "greedy",
            temperature=float(temperature if temperature is not None
                              else g.temperature),
            top_k=tk,
            top_p=float(top_p if top_p is not None else g.top_p),
            generator=generator,
            on_token=on_token, submit_time=self._now(),
            queue_ttl_s=float(queue_ttl_s if queue_ttl_s is not None
                              else self.queue_ttl_s),
            deadline_s=float(deadline_s if deadline_s is not None
                             else self.deadline_s))
        # the history IS the token list from the start: a retirement before
        # admission still returns it
        req.tokens.extend(hist)
        req.kv_payloads = pages
        self.scheduler.submit(req)
        self.metrics.record_submit()
        return rid

    @torch.no_grad()
    def step(self) -> Dict:
        """One TRANSACTIONAL scheduler tick (module docstring). Returns a
        summary dict: ``admitted``, ``chunked`` (mid-prefill chunks run),
        ``decoded`` (lanes that decoded), ``retired`` (ids, timeouts
        included), ``timed_out``, ``recovered`` (the tick failed, rolled
        back and recovered), and the queue, lane, prefilling and parked
        counts after it. Raises only :class:`RecoveryExhausted`, a real
        CUDA error, and a recovery's failure to rebuild its storage; after
        each of them ``health()`` reads ``"dead"``."""
        t0 = self._now()
        self._flush_shutdown_event()
        if (self._shutting_down and self._shutdown_deadline is not None
                and t0 >= self._shutdown_deadline and self._in_flight()):
            # the grace window closed: everything left returns now
            summary = {"admitted": 0, "decoded": 0, "chunked": 0,
                       "retired": self._retire_all("shutdown"),
                       "timed_out": []}
        else:
            # phase-granular transaction: the snapshot re-commits after
            # each admission, so a decode fault rolls back only the decode
            snap = self._snapshot()

            def commit():
                snap.clear()
                snap.update(self._snapshot())

            try:
                summary = self._step_inner(commit)
                if (summary["decoded"] or summary["admitted"]
                        or summary["chunked"]):
                    # a productive tick re-arms the budget and the strikes
                    self._recoveries_consecutive = 0
                    if summary["decoded"]:
                        self._tick_strikes = 0
            except RecoveryExhausted:
                raise
            except Exception as exc:  # the crash-safety seam
                if _is_device_fault(exc):
                    self._dead = True
                    raise
                summary = self._handle_tick_fault(snap, exc)
        self._ticks += 1
        self.metrics.observe_tick(self.scheduler.queue_depth,
                                  len(self._active), self._now() - t0)
        if self.paged:
            self.metrics.observe_pages(self.cache_manager.pages_in_use,
                                       self.cache_manager.usable_pages)
        if self._dram_store is not None:
            self.metrics.observe_host_tier(self._dram_store)
        if self._disk_store is not None:
            self.metrics.observe_disk_tier(self._disk_store)
        self.metrics.observe_queue_tokens(self._queue_tokens())
        if self.log_every and self._ticks % self.log_every == 0:
            self.metrics.log_snapshot()
        summary.setdefault("recovered", False)
        summary["queue_depth"] = self.scheduler.queue_depth
        summary["active_slots"] = len(self._active)
        summary["prefilling"] = len(self._prefilling)
        summary["prefilled"] = len(self._prefilled)
        return summary

    def _step_inner(self, commit=lambda: None) -> Dict:
        """The tick body: the queued-expiry sweep, prefill work
        (admissions, or exactly one chunk of the prefilling request), one
        batched decode step, retirements, the active-deadline sweep.
        ``commit`` re-bases the transactional snapshot after each
        completed prefill phase."""
        timed_out = self._expire_queued(self._now())
        admitted = chunked = 0
        prefill_t0 = self._now()
        if self._prefilling:
            # FIFO holds: the prefilling request IS the admission head
            n, expired = self._chunk_tick()
            chunked += n
            timed_out += expired
            commit()  # chunk progress stays committed
        else:
            while (len(self.scheduler)
                   and self._can_admit(self.scheduler.peek())):
                self._admit(self.scheduler.pop_next())
                admitted += 1
                commit()  # an admission that completed stays admitted
                if self.prefill_chunk:
                    break  # one prefill-shaped call per tick
        if admitted or chunked:
            self.metrics.observe_prefill_stall(self._now() - prefill_t0)
        decoded = len(self._active)
        retired = []
        if decoded:
            retired = (self._tick_decode_spec() if self._proposer is not None
                       else self._tick_decode())
        # a fresh clock: the work above may have eaten the deadline
        timed_out += self._expire_active(self._now())
        return {"admitted": admitted, "decoded": decoded, "chunked": chunked,
                "retired": retired + timed_out, "timed_out": timed_out}

    def drain(self, max_ticks: Optional[int] = None
              ) -> Dict[int, ServingResult]:
        """Tick until queue and lanes are empty (or ``max_ticks``), then
        return-and-clear every finished result since the last drain.
        Raises when a queued request can never be admitted (its pages
        exceed the whole pool)."""
        n = 0
        while len(self.scheduler) or self._active or self._prefilling:
            summary = self.step()
            n += 1
            if not (summary["admitted"] or summary["decoded"]
                    or summary["chunked"] or summary["retired"]
                    or summary["recovered"]):
                raise RuntimeError(
                    f"request {self.scheduler.peek().id} can never be "
                    f"admitted: it needs more than the pool's "
                    f"{self.cache_manager.usable_pages} pages")
            if max_ticks is not None and n >= max_ticks:
                break
        out, self._results = self._results, {}
        return out

    def cancel(self, request_id: int) -> bool:
        """Cancel a queued, in-flight or parked request: its lane and pages
        (if any) are freed at once and its partial output is recorded with
        ``finish_reason="cancelled"``. False when the id is unknown or
        already finished."""
        req = self.scheduler.remove(request_id)
        if req is None:
            req = self._live(request_id)
        if req is None:
            return False
        self._finalize(req, "cancelled", self._now())
        obs_emit("request_cancelled", request=request_id)
        return True

    def result(self, request_id: int) -> Optional[ServingResult]:
        """Finished result for ``request_id`` (None while in flight)."""
        return self._results.get(request_id)

    def take_result(self, request_id: int) -> Optional[ServingResult]:
        """Remove and return one finished result (None while in flight)."""
        return self._results.pop(request_id, None)

    def emitted_tokens(self, request_id: int) -> Optional[list]:
        """A live (queued, prefilling, active or parked) request's emitted
        tokens as the host holds them; None for unknown or finished ids —
        a router re-bases its stream on this after a recovered tick."""
        req = self._live(request_id)
        if req is None:
            req = next((r for r in self.scheduler.snapshot()
                        if r.id == request_id), None)
        return None if req is None else list(req.tokens)

    def generate_batch(self, input_ids,
                       gen_cfg: Optional[GenerationConfig] = None,
                       seed: Optional[int] = None) -> torch.Tensor:
        """One-shot ``generate()`` contract over the engine: each row of
        ``input_ids`` [b, prompt_len] becomes a request; returns the
        [b, prompt_len + max_length] int32 buffer (pad after each row's
        end). Sampling rows draw from per-row seeds derived from ``seed``
        (default ``base_seed``) and the row."""
        g = gen_cfg or self.gen_cfg
        ids = np.asarray(input_ids, np.int32)
        if ids.ndim == 1:
            ids = ids[None]
        b, prompt_len = ids.shape
        limit = self.submit_limit
        if prompt_len + g.max_length > limit:
            raise ValueError(
                f"prompt_len({prompt_len}) + max_length({g.max_length}) "
                f"exceeds the engine's decode limit ({limit}: "
                "min(cache_len, max_position_embeddings))")
        base = self.base_seed if seed is None else int(seed)
        rids = [self.submit(
            ids[i], max_length=g.max_length, min_length=g.min_length,
            eos_token_id=g.eos_token_id, decode_strategy=g.decode_strategy,
            temperature=g.temperature, top_k=g.top_k, top_p=g.top_p,
            seed=int(np.random.SeedSequence([base, i]).generate_state(1)[0]))
            for i in range(b)]
        results = self.drain()
        out = np.full((b, prompt_len + g.max_length), g.pad_token_id,
                      np.int32)
        out[:, :prompt_len] = ids
        for i, rid in enumerate(rids):
            res = results.get(rid)
            if res is None:
                logger.error("serving: generate_batch request %d (row %d) "
                             "produced no result; row left as pad", rid, i)
                continue
            if res.finish_reason not in ("eos", "max_length", "cache_full"):
                logger.warning(
                    "serving: generate_batch request %d (row %d) retired "
                    "%r after %d token(s); the rest of the row is pad", rid,
                    i, res.finish_reason, len(res.tokens))
            out[i, prompt_len:prompt_len + len(res.tokens)] = res.tokens
        return torch.from_numpy(out)

    def prewarm(self, prompt) -> int:
        """Pull ``prompt``'s persisted prefix pages out of the page tiers
        into the device trie before traffic (a fresh replica over a shared
        disk tier): the longest stored prefix revives through the normal
        alloc path and the lane frees at once, leaving the pages warm, so
        the first real request hits them. Returns the prefix tokens now
        warm (0: no tiers, nothing persisted, or the pool is busy). Never
        registers pages without K/V."""
        self._refuse_under_mesh("prewarm")
        if not (self.paged and self.prefix_cache):
            return 0
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0 or prompt.size >= self.cache_len:
            return 0
        pool = self.cache_manager.pool
        chunks = pool._chunks(prompt)
        path = pool._match_path(chunks)
        covered = len(path) + len(pool._match_host(chunks, path))
        if covered == 0:
            return 0
        # alloc shares at most (n - 1) // page_size chunks: the probe
        # prompt spans one token past the covered ones
        n = min(int(prompt.size), covered * self.page_size + 1)
        if not self.cache_manager.can_admit(prompt[:n]):
            return 0
        got = self.cache_manager.alloc(-1, prompt[:n])
        if got is None:
            return 0
        lane, shared = got
        self.cache_manager.free(lane)  # the revived pages park warm
        if shared:
            obs_emit("prefix_prewarmed", engine=self.metrics.engine_label,
                     tokens=int(shared))
        return int(shared)

    # -------------------------------------------------------- crash safety

    def _snapshot(self) -> Dict:
        """The host bookkeeping a tick can change (module docstring). The
        device side is not captured: :meth:`recover` rebuilds it from this
        host truth. Metrics stay monotonic."""
        reqs = (list(self.scheduler.snapshot()) + list(self._active.values())
                + list(self._prefilling.values())
                + list(self._prefilled.values()))
        return {
            "queue": self.scheduler.snapshot(),
            "active": dict(self._active),
            "prefilling": dict(self._prefilling),
            "prefilled": dict(self._prefilled),
            "results": dict(self._results),
            # tokens roll back by truncation to the pre-tick length; a
            # sampling request's stream rolls back to its pre-tick state
            "reqs": [(r, r.slot, r.admit_time, r.first_token_time,
                      len(r.tokens), r.prefill_pos, r.phase,
                      r.spec_proposed, r.spec_accepted,
                      None if r.greedy else r.generator.get_state())
                     for r in reqs],
        }

    def _restore(self, snap: Dict) -> None:
        self.scheduler.restore(snap["queue"])
        self._active = snap["active"]
        self._prefilling = snap["prefilling"]
        self._prefilled = snap["prefilled"]
        self._results = snap["results"]
        for (r, slot, admit_t, first_t, ntok, ppos, phase, sprop, sacc,
             gen_state) in snap["reqs"]:
            r.slot = slot
            r.admit_time = admit_t
            r.first_token_time = first_t
            r.prefill_pos = ppos
            r.phase = phase
            r.spec_proposed = sprop
            r.spec_accepted = sacc
            del r.tokens[ntok:]
            if gen_state is not None:
                r.generator.set_state(gen_state)

    def _handle_tick_fault(self, snap: Dict, exc: Exception) -> Dict:
        """Rollback, recovery and escalation for one failed tick: nothing
        the tick produced was committed; the queue and every request are
        as they were before it."""
        ctx, self._fault_ctx = self._fault_ctx, None
        # the failed call's frames hold the old storage's tensors: freed
        # here, so that recovery allocates the new storage in their place
        err = exc
        while err is not None:
            traceback.clear_frames(err.__traceback__)
            err = err.__cause__ or err.__context__
        self._restore(snap)
        victim = ctx[1] if ctx else None
        obs_emit("tick_fault", tick=self._ticks, error=type(exc).__name__,
                 during_prefill=bool(ctx), request=victim)
        logger.error(
            "serving: tick %d failed (%s: %s)%s; host state rolled back, "
            "running replay recovery", self._ticks, type(exc).__name__, exc,
            f" during prefill of request {victim}" if ctx else "")
        if ctx:
            self._prefill_strikes[victim] = (
                self._prefill_strikes.get(victim, 0) + 1)
        else:
            self._tick_strikes += 1
        retired = list(self.recover())
        if ctx and self._prefill_strikes.get(victim, 0) >= 2:
            # a prefill that failed, survived a recovery and failed again:
            # the culprit is the request being admitted
            req = self.scheduler.remove(victim)
            if req is not None:
                logger.error(
                    "serving: quarantining request %d — its prefill failed "
                    "%d times across a recovery; finish_reason='error'",
                    victim, self._prefill_strikes[victim])
                self._finalize(req, "error", self._now())
                self.metrics.record_poison()
                obs_emit("poison_retired", request=victim, via="prefill")
                retired.append(victim)
            self._prefill_strikes.pop(victim, None)
        elif not ctx and self._tick_strikes >= 2:
            # the decode tick failed again right after a recovery: some
            # active request is poison
            retired += self._bisect_poison()
            self._tick_strikes = 0
        return {"admitted": 0, "decoded": 0, "chunked": 0,
                "retired": retired, "timed_out": [], "recovered": True}

    @torch.no_grad()
    def recover(self) -> List[int]:
        """Replay recovery (module docstring): fresh device storage, then
        every active and parked request re-admitted from host truth. The
        device warm prefix cache is lost (no correctness cost); the page
        tiers survive. Public: call it after an external device reset too.
        Returns the ids retired because their own replay failed."""
        self._recoveries_consecutive += 1
        self.metrics.record_recovery()
        if self._recoveries_consecutive > self.max_recoveries:
            self._dead = True  # health() reads "dead" before the raise
            raise RecoveryExhausted(
                f"{self._recoveries_consecutive - 1} consecutive recoveries "
                f"without a productive tick (FLEETX_SERVING_MAX_RECOVERIES="
                f"{self.max_recoveries}); the fault is not request-shaped — "
                "restart the engine")
        old = ([req for _, req in sorted(self._active.items())]
               + [req for _, req in sorted(self._prefilled.items())])
        parked = {req.id for req in self._prefilled.values()}
        self._active, self._prefilled = {}, {}
        # mid-prefill requests: their partial K/V died with the storage and
        # no token was emitted, so they restart from the queue head
        for _, req in sorted(self._prefilling.items(), reverse=True):
            req.slot = None
            req.prefill_pos = 0
            req.chunk_cache = None
            req.phase = "queued"
            self.scheduler.requeue(req)
        self._prefilling = {}
        try:
            retired, replayed = self._rebuild(old)
        except BaseException:
            # not request-shaped (a failed allocation, a real CUDA error):
            # the engine cannot serve, and says so before the raise
            self._dead = True
            raise
        for req, _ in replayed:
            if req.id in retired:
                continue
            if req.id in parked:
                req.phase = "prefilled"
                self._prefilled[req.slot] = req
            else:
                req.phase = "active"
                self._active[req.slot] = req
        # replayed: the requests back on the decode lanes (parked ones
        # not counted), as JAX counts them
        obs_emit("engine_recovery", number=self.metrics.engine_recoveries,
                 replayed=len(self._active), quarantined=len(retired))
        logger.warning(
            "serving: recovery #%d complete — %d request(s) replayed, %d "
            "quarantined", self.metrics.engine_recoveries,
            len(self._active) + len(self._prefilled), len(retired))
        return retired

    def _rebuild(self, old: List[Request]):
        """Fresh device storage, then each of ``old`` replayed onto it, a
        request whose own replay fails quarantined. The old storage is
        dropped before the new is allocated, so a recovery needs one
        pool's memory; a call the watchdog abandoned holds its own
        references and keeps the old tensors until it ends. Returns
        ``(retired ids, [(request, catch-up start)])``."""
        self._tables_dev = None
        self._tables_version = -1
        self.cache_manager = None
        self.cache_manager = self._new_cache_manager()
        if self._proposer is not None:
            self._proposer.reset()  # rebuilt lazily from host truth
        retired, replayed = [], []
        for req in old:
            req.slot = None
            try:
                replayed.append((req, self._replay_prefill(req)))
            except Exception as exc:  # isolate, do not cascade
                if _is_device_fault(exc):
                    raise
                retired.append(self._quarantine_replay(req))
        for req in self._catch_up(replayed):
            retired.append(self._quarantine_replay(req))
        return retired, replayed

    def _quarantine_replay(self, req: Request) -> int:
        """Retire a request whose own replay failed (its fault followed it
        into recovery): ``error`` with its partial tokens."""
        logger.exception(
            "serving: request %d failed its own replay during recovery; "
            "quarantining it (finish_reason='error', %d partial tokens)",
            req.id, len(req.tokens))
        self._finalize(req, "error", self._now())
        self.metrics.record_poison()
        obs_emit("poison_retired", request=req.id, via="replay")
        return req.id

    def _replay_prefill(self, req: Request) -> int:
        """First half of a replay: claim fresh storage for ``prompt +
        tokens[:-1]`` (the last token's K/V is the next tick's write) and
        rebuild the prompt's K/V through the admission's own prefill
        call(s), K/V only. One prefill attempt for the fault seam. Returns
        the first position the decode-shaped catch-up writes."""
        history = np.concatenate(
            [req.prompt, np.asarray(req.tokens[:-1], np.int32)])
        self._prefill_attempt(req)
        if self.paged:
            alloc = self.cache_manager.alloc(req.id, history)
            if alloc is None:
                raise RuntimeError(
                    f"replay alloc failed for request {req.id} "
                    f"({len(history)} history tokens; "
                    f"{self.cache_manager.pool.free_pages} pages free)")
            req.slot, shared = alloc
            if shared < req.prompt_len:
                self._prefill_prompt(req, shared)
            self.cache_manager.register_prefix(req.slot, req.prompt)
            return max(shared, req.prompt_len)
        slot = self.cache_manager.alloc(req.id, len(history))
        if slot is None:
            raise RuntimeError(
                f"replay alloc failed for request {req.id}: no free slot")
        req.slot = slot
        self._prefill_prompt(req, 0)
        return req.prompt_len

    def _prefill_prompt(self, req: Request, shared: int) -> None:
        """The prompt's K/V past ``shared`` through the call(s) its
        admission made — one prefill, or the chunk sequence from
        ``shared`` — so that they round as they did; no sampling."""
        chunk = self.prefill_chunk
        chunked = bool(chunk) and req.prompt_len - shared > chunk
        spans = ([(p, min(p + chunk, req.prompt_len))
                  for p in range(shared, req.prompt_len, chunk)] if chunked
                 else [(shared, req.prompt_len)])
        if self.paged:
            for start, end in spans:
                self._paged_prefill_call(req, req.prompt[start:end], start,
                                         req.slot, sample=False,
                                         guarded=False)
            return
        small = self.executor.init_cache(1, self.device)
        for start, end in spans:
            where = ({"cache_positions": self._tensor([start], torch.int32)}
                     if chunked else {})
            self._prefill(req, small, req.prompt[start:end], start,
                          self.cache_len - start, False, guarded=False,
                          **where)
        scatter_slot(self.cache_manager.cache, small, req.slot)

    def _catch_up(self, replayed) -> List[Request]:
        """Second half of a replay: each request's emitted tokens but the
        last, written through decode-shaped forwards — one per position,
        every lane with a token left at that step riding it, the others
        pinned as on a decode tick — so the K/V are the bytes the original
        ticks wrote (a row of a decode forward does not depend on the
        other rows). ``replayed`` holds ``(request, first position)``.
        When a batched forward fails, each lane is retried alone (a lone
        lane's failure is its own); returns the requests whose own
        catch-up failed."""
        todo = [(req, start) for req, start in replayed
                if start < int(self.cache_manager.lengths[req.slot])]
        if not todo:
            return []
        try:
            self._catch_up_forwards(todo)
            return []
        except Exception as exc:
            if _is_device_fault(exc):
                raise
            if len(todo) == 1:
                return [todo[0][0]]
        failed = []
        for item in todo:
            try:
                self._catch_up_forwards([item])
            except Exception as exc:
                if _is_device_fault(exc):
                    raise
                failed.append(item[0])
        return failed

    def _catch_up_forwards(self, todo) -> None:
        lengths = self.cache_manager.lengths
        max_pos = self.model.cfg.max_position_embeddings
        steps = max(int(lengths[req.slot]) - start for req, start in todo)
        for k in range(steps):
            ids = np.zeros(self.slots, np.int64)
            wpos = np.full(self.slots, self.cache_len - 1, np.int64)
            posid = np.zeros(self.slots, np.int64)
            for req, start in todo:
                p = start + k
                if p < int(lengths[req.slot]):
                    ids[req.slot] = (req.prompt[p] if p < req.prompt_len
                                     else req.tokens[p - req.prompt_len])
                    wpos[req.slot] = p
                    posid[req.slot] = min(p, max_pos - 1)
            self.executor.forward(
                self.cache_manager.cache, self._tensor(ids)[:, None],
                self._tensor(posid)[:, None],
                cache_positions=self._tensor(wpos, torch.int32),
                block_tables=self._device_tables())

    def _probe_fails(self, slots) -> bool:
        """One NON-COMMITTING decode forward over a subset of the active
        lanes (no sampling, no host state moved; its K/V writes land only
        where the next committed tick writes first). True iff it — or the
        poison injector — raised."""
        try:
            self._decode_forward(slots, probe=True)
            return False
        except Exception as exc:  # a probe exists to catch these
            if _is_device_fault(exc):
                raise
            return True

    def _bisect_poison(self) -> List[int]:
        """Binary-search the active set for the request whose presence
        kills the decode forward and retire it ``error`` with its partial
        tokens (one poison per escalation). [] when the failure does not
        reproduce under probing."""
        if not self._active:
            return []
        suspects = sorted(self._active)
        self.probes = 1
        if not self._probe_fails(suspects):
            logger.warning("serving: decode failures did not reproduce "
                           "under probing (transient?); no quarantine")
            return []
        while len(suspects) > 1:
            half = suspects[:len(suspects) // 2]
            self.probes += 1
            suspects = (half if self._probe_fails(half)
                        else suspects[len(suspects) // 2:])
        slot = suspects[0]
        req = self._active[slot]
        self.probes += 1
        if not self._probe_fails([slot]):
            logger.warning("serving: bisection could not pin the failure to "
                           "one request; no quarantine this round")
            return []
        logger.error(
            "serving: quarantining poison request %d (lane %d) isolated by "
            "bisection; finish_reason='error', %d partial token(s) kept",
            req.id, slot, len(req.tokens))
        self._finalize(req, "error", self._now())
        self.metrics.record_poison()
        obs_emit("poison_retired", request=req.id, via="bisection")
        return [req.id]

    def _run_device(self, fn):
        """Run one decode forward under the watchdog: a direct call without
        a timeout; with one, on the daemon worker, raising
        :class:`TickTimeout` (diagnostics banked) when it outlives the
        budget. The abandoned call runs on to its end on its worker."""
        if not self.tick_timeout_s or self.tick_timeout_s <= 0:
            return fn()
        if self._watchdog is None:
            self._watchdog = _Watchdog(self.device)
            # the idle worker ends with its engine
            weakref.finalize(self, self._watchdog.jobs.put, None)
        ok, value = self._watchdog.run(fn, self.tick_timeout_s)
        if ok:
            return value
        self.abandoned.append(self._watchdog.thread)
        self._watchdog = None
        self.hang_diagnostics = {
            "tick": self._ticks,
            "timeout_s": self.tick_timeout_s,
            "active_requests": sorted(r.id for r in self._active.values()),
            "queue_depth": self.scheduler.queue_depth,
            "recoveries": self.metrics.engine_recoveries,
        }
        obs_emit("tick_timeout", tick=self._ticks,
                 timeout_s=self.tick_timeout_s)
        logger.error(
            "serving: a decode forward exceeded FLEETX_SERVING_TICK_TIMEOUT_S"
            "=%.3fs; diagnostics in engine.hang_diagnostics, abandoning the "
            "call and recovering", self.tick_timeout_s)
        raise TickTimeout(
            f"decode forward exceeded {self.tick_timeout_s}s (hung device "
            "step; see engine.hang_diagnostics)")

    # ----------------------------------------------------- graceful drain

    def request_shutdown(self, grace_s: Optional[float] = None) -> None:
        """Stop admission (:class:`ShuttingDown` at submit) and retire what
        is left ``grace_s`` (default ``FLEETX_SERVING_GRACE_S``) from now;
        ticking goes on meanwhile. Idempotent, and safe in a signal
        handler (flag writes only)."""
        if self._shutting_down:
            return
        self._shutting_down = True
        grace = self.grace_s if grace_s is None else float(grace_s)
        self._shutdown_deadline = self._now() + max(grace, 0.0)
        # the event is emitted by the next step() or shutdown(): a signal
        # context must not take the event log's lock
        self._shutdown_event_pending = True

    def shutdown(self, grace_s: Optional[float] = None
                 ) -> Dict[int, ServingResult]:
        """Graceful drain to completion: :meth:`request_shutdown`, tick
        until everything finished or the grace window closed (the rest
        retires ``"shutdown"`` with partial tokens), and return-and-clear
        ALL results."""
        self.request_shutdown(grace_s)
        self._flush_shutdown_event()
        while self._in_flight():
            self.step()
        out, self._results = self._results, {}
        return out

    def _flush_shutdown_event(self) -> None:
        if self._shutdown_event_pending:
            self._shutdown_event_pending = False
            logger.warning(
                "serving: shutdown requested — admission stopped, draining "
                "%d active + %d queued request(s)", len(self._active),
                self.scheduler.queue_depth)
            obs_emit("shutdown", engine=self.metrics.engine_label,
                     active=len(self._active),
                     queued=self.scheduler.queue_depth)

    def _retire_all(self, reason: str) -> List[int]:
        """Retire every queued and in-flight request now: queued ones with
        no tokens, the others with their partial tokens."""
        now = self._now()
        retired = []
        for req in self.scheduler.drain_all():
            self._finalize(req, reason, now)
            retired.append(req.id)
        for req in (list(self._active.values())
                    + list(self._prefilling.values())
                    + list(self._prefilled.values())):
            self._finalize(req, reason, now)
            retired.append(req.id)
        return retired

    def install_sigterm_handler(self, grace_s: Optional[float] = None):
        """Register a SIGTERM handler that calls :meth:`request_shutdown`
        (flags only; the drain happens in the running tick loop) and then
        any handler it displaced. Main thread only. Returns the previous
        handler."""
        import signal

        prev = signal.getsignal(signal.SIGTERM)

        def on_sigterm(signum, frame):
            self.request_shutdown(grace_s)
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, frame)

        self._prev_sigterm = prev
        signal.signal(signal.SIGTERM, on_sigterm)
        return prev

    def uninstall_sigterm_handler(self) -> None:
        """Put back the SIGTERM handler :meth:`install_sigterm_handler`
        displaced."""
        import signal

        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None

    # ----------------------------------------------- the router's surface

    def health(self) -> Dict:
        """The drain-aware health report: ``state`` ``"ok"`` while serving,
        ``"draining"`` after a shutdown request, ``"dead"`` after
        :class:`RecoveryExhausted`, a real CUDA error or
        :meth:`declare_dead`; with the role, the model family and its
        capabilities, and the load (queue, queued prompt tokens, lanes)."""
        state = ("dead" if self._dead
                 else "draining" if self._shutting_down else "ok")
        out = {"state": state,
               "role": self.role,
               "model": self.model_family,
               "capabilities": self.capabilities.as_dict(),
               "queue_depth": self.scheduler.queue_depth,
               "queue_tokens": self._queue_tokens(),
               "active": (len(self._active) + len(self._prefilling)
                          + len(self._prefilled)),
               "slots": self.slots}
        if self.paged and self.cache_manager is not None:
            out["pages_in_use"] = self.cache_manager.pages_in_use
            out["usable_pages"] = self.cache_manager.usable_pages
        return out

    def declare_dead(self) -> None:
        """Mark the engine dead (``health()`` reads ``"dead"``) without
        running its shutdown: a supervisor decided the process or device
        behind it is gone."""
        self._dead = True

    @property
    def submit_limit(self) -> int:
        """The smallest refused prompt length (a request needs one token
        of decode room below it)."""
        return min(self.cache_len, self.model.cfg.max_position_embeddings)

    # ------------------------------------------- disaggregated prefill

    def prefilled_ready(self) -> list:
        """Ids parked on this prefill-role engine with their prompt K/V
        written, awaiting :meth:`export_kv`."""
        return sorted(r.id for r in self._prefilled.values())

    def export_kv(self, request_id: int) -> list:
        """Ship one parked request's prompt K/V: the
        ``ceil(prompt_len / page_size)`` pages covering the prompt, read
        with the spill tier's batched reads and serialized in the wire
        format. The request then retires ``"prefilled"`` (its pages stay
        warm in this engine's trie) and the blobs return in prompt order
        for ``submit(kv_payloads=, history=[t0])`` on a decode replica.
        KeyError for an id that is not parked; an export fault leaves the
        request parked."""
        req = next((r for r in self._prefilled.values()
                    if r.id == request_id), None)
        if req is None:
            raise KeyError(
                f"request {request_id} is not parked for export "
                f"(parked: {self.prefilled_ready()})")
        attempt = self._fault_ships
        self._fault_ships += 1
        faults.on_kv_ship(attempt, request_id)
        n_pages = -(-req.prompt_len // self.page_size)
        table = self.cache_manager.tables[req.slot]
        payloads = self.cache_manager.read_pages(
            [int(table[i]) for i in range(n_pages)])
        blobs = [HostPageStore.payload_to_bytes(p) for p in payloads]
        if faults.on_kv_ship_corrupt(attempt):
            # one byte flipped mid-blob: the receiver's crc32 refuses it
            mid = len(blobs) // 2
            flipped = bytearray(blobs[mid])
            flipped[len(flipped) // 2] ^= 0xFF
            blobs[mid] = bytes(flipped)
        nbytes = sum(len(b) for b in blobs)
        self.metrics.record_kv_shipped(len(blobs), nbytes)
        self._finalize(req, "prefilled", self._now())
        obs_emit("kv_shipped", request=request_id, pages=len(blobs),
                 bytes=nbytes)
        return blobs

    # ------------------------------------------------------------- internals

    def _expire_queued(self, now: float) -> List[int]:
        """Retire queued requests past their queue TTL or deadline (they
        never held a lane; ``finish_reason="timeout"``, no tokens)."""
        out = []
        for req in self.scheduler.pop_expired(now):
            self._finalize(req, "timeout", now)
            obs_emit("request_timeout", request=req.id, where="queue")
            out.append(req.id)
        return out

    def _expire_active(self, now: float) -> List[int]:
        """Retire decoding requests past their total deadline, freeing
        their lanes; partial tokens are kept in the result."""
        out = []
        for req in list(self._active.values()):
            if req.deadline_s and now - req.submit_time > req.deadline_s:
                self._finalize(req, "timeout", now)
                obs_emit("request_timeout", request=req.id, where="active")
                out.append(req.id)
        return out

    def _in_flight(self) -> bool:
        return bool(len(self.scheduler) or self._active or self._prefilling
                    or self._prefilled)

    def _queue_tokens(self) -> int:
        """Queued prompt tokens plus the unwritten rest of a chunked
        prefill (the prefill load)."""
        return self.scheduler.queued_tokens() + sum(
            r.prompt_len - r.prefill_pos for r in self._prefilling.values())

    def _live(self, request_id: int) -> Optional[Request]:
        """The prefilling, active or parked request of this id."""
        for r in (list(self._active.values())
                  + list(self._prefilling.values())
                  + list(self._prefilled.values())):
            if r.id == request_id:
                return r
        return None

    @staticmethod
    def _admission_tokens(req: Request) -> np.ndarray:
        """What admission stores: the prompt, and for a request with a
        history its tokens but the last (the next tick writes that one)."""
        if req.tokens:
            return np.concatenate(
                [req.prompt, np.asarray(req.tokens[:-1], np.int32)])
        return req.prompt

    def _can_admit(self, req: Request) -> bool:
        """A free decode lane and, paged, enough free pages for the FIFO
        head's prompt (and history). A too-big head BLOCKS, preserving
        arrival order; it unblocks as retiring requests return pages."""
        return self.cache_manager.can_admit(self._admission_tokens(req))

    def _device_tables(self) -> Optional[torch.Tensor]:
        """Device copy of the block tables, re-uploaded only when the
        pool's version counter moved (None on the slot path)."""
        if not self.paged:
            return None
        version = self.cache_manager.tables_version
        if version != self._tables_version:
            self._tables_dev = torch.tensor(self.cache_manager.tables,
                                            device=self.device)
            self._tables_version = version
        return self._tables_dev

    def _tensor(self, values, dtype=torch.int64) -> torch.Tensor:
        return torch.tensor(np.asarray(values), dtype=dtype,
                            device=self.device)

    def _claim_storage(self, req: Request) -> int:
        """Claim a decode lane (and, paged, a page chain); sets
        ``req.slot`` and returns the shared-prefix token count (0 on the
        slot path)."""
        if not self.paged:
            req.slot = self.cache_manager.alloc(req.id, req.prompt_len)
            return 0
        alloc = self.cache_manager.alloc(req.id, req.prompt)
        if alloc is None:  # _can_admit() passed, so this is an invariant
            raise RuntimeError(  # breach — fail loudly
                f"paged alloc failed after admission check for request "
                f"{req.id} (prompt {req.prompt_len} tokens; "
                f"{self.cache_manager.pool.free_pages} pages free)")
        req.slot, shared = alloc
        self._record_prefix(req.slot, shared, req.prompt_len)
        return shared

    def _record_prefix(self, lane: int, shared: int, prompt_len: int) -> None:
        """One paged admission's prefix counters and its fresh pages (the
        lane's pages past the shared ones)."""
        fresh = int(self.cache_manager.pool.alloc_counts[lane]
                    - shared // self.page_size)
        self.metrics.record_prefix(shared, prompt_len, fresh)

    def _admit(self, req: Request) -> None:
        """Admit the FIFO head: claim storage, then either the one-call
        prefill of the non-shared suffix (chunking off, or the suffix fits
        one chunk) or enter the ``prefilling`` state and run the first
        chunk. A request with shipped pages takes :meth:`_admit_shipped`;
        one with a history the replay seam (no callback re-fired)."""
        if req.kv_payloads is not None:
            self._admit_shipped(req)
            return
        self._fault_ctx = ("prefill", req.id)
        if req.tokens:
            # one lane: its catch-up raises rather than being set aside
            self._catch_up([(req, self._replay_prefill(req))])
            self._fault_ctx = None
            self._prefill_strikes.pop(req.id, None)
            req.admit_time = self._now()
            self.metrics.record_admit(req.admit_time - req.submit_time)
            req.phase = "active"
            self._active[req.slot] = req
            return
        shared = self._claim_storage(req)
        if self.prefill_chunk and req.prompt_len - shared > self.prefill_chunk:
            req.prefill_pos = shared
            req.phase = "prefilling"
            if not self.paged:
                req.chunk_cache = self.executor.init_cache(1, self.device)
            self._prefilling[req.slot] = req
            req.admit_time = self._now()
            self.metrics.record_admit(req.admit_time - req.submit_time)
            self._fault_ctx = None
            self._run_chunk(req)  # this tick's one chunk
            return
        if self.paged:
            tok = self._paged_prefill_call(req, req.prompt[shared:], shared,
                                           req.slot)
            self.cache_manager.register_prefix(req.slot, req.prompt)
        else:
            tok = self._slot_prefill_call(req, req.prompt, req.slot)
        self._fault_ctx = None
        self._prefill_strikes.pop(req.id, None)  # survived its prefill
        req.admit_time = self._now()
        self.metrics.record_admit(req.admit_time - req.submit_time)
        self._finish_first_token(req, tok)

    def _admit_shipped(self, req: Request) -> None:
        """Admit a request whose prompt K/V a prefill-role replica shipped
        (``submit(kv_payloads=)``): claim a page chain, write the shipped
        pages past any trie-shared prefix through the revive path — no
        prefill forward — register the prompt, and decode on from
        ``history[-1]``. The payloads are consumed first, so an admission
        that faults and rolls back re-admits by replay."""
        payloads, req.kv_payloads = req.kv_payloads, None
        self._fault_ctx = ("prefill", req.id)
        alloc = self.cache_manager.alloc(req.id, req.prompt)
        if alloc is None:  # _can_admit() passed: an invariant breach
            raise RuntimeError(
                f"paged alloc failed after admission check for shipped "
                f"request {req.id} (prompt {req.prompt_len} tokens; "
                f"{self.cache_manager.pool.free_pages} pages free)")
        lane, shared = alloc
        req.slot = lane
        table = self.cache_manager.tables[lane]
        entries = [(int(table[i]), payloads[i])
                   for i in range(shared // self.page_size, len(payloads))]
        if entries:
            self.cache_manager.revive_pages(entries)
        self.cache_manager.register_prefix(lane, req.prompt)
        self._fault_ctx = None
        self._prefill_strikes.pop(req.id, None)
        self._record_prefix(lane, shared, req.prompt_len)
        self.metrics.record_kv_revived_remote(len(entries))
        req.admit_time = self._now()
        self.metrics.record_admit(req.admit_time - req.submit_time)
        req.phase = "active"
        self._active[lane] = req
        obs_emit("kv_revived_remote", request=req.id, pages=len(entries),
                 shared=shared)

    def _bucket(self, n: int, room: int) -> int:
        """``n`` tokens right-padded to a multiple of ``prefill_bucket``,
        capped by the ``room`` left in the lane (a longer write would clamp
        back over live positions)."""
        bucket = -(-n // self.prefill_bucket) * self.prefill_bucket
        return min(max(bucket, n), room)

    def _prefill_attempt(self, req: Request) -> None:
        """The prefill fault seam: one attempt per prefill call of an
        admission or a chunk, one per replayed request."""
        attempt = self._fault_prefills
        self._fault_prefills += 1
        faults.on_serving_prefill(attempt, req.id)

    def _prefill(self, req: Request, cache, tokens, wpos: int, room: int,
                 sample: bool, guarded: bool = True,
                 **where) -> Optional[int]:
        """One batch-1 prefill-shaped forward of ``tokens`` at absolute
        positions ``wpos..`` into ``cache``, the tokens right-padded to a
        bucket (the padded tail is causally invisible to the real tokens,
        and its K/V land beyond the live window, where later writes
        replace them). ``sample``: return the next token, drawn from the
        last real token's logits; else write K/V only (an intermediate
        chunk: no draw from the request's generator). ``guarded`` counts
        a prefill attempt at the fault seam first."""
        if guarded:
            self._prefill_attempt(req)
        n = len(tokens)
        bucket = self._bucket(n, room)
        ids = np.zeros(bucket, np.int64)
        ids[:n] = tokens
        max_pos = self.model.cfg.max_position_embeddings
        pos = np.minimum(wpos + np.arange(bucket), max_pos - 1)
        logits, _ = self.executor.forward(
            cache, self._tensor(ids)[None], self._tensor(pos)[None], **where)
        if not sample:
            return None
        return self._sample([req], logits[0, n - 1][None])[0]

    def _paged_prefill_call(self, req: Request, suffix, shared: int,
                            lane: int, sample: bool = True,
                            guarded: bool = True) -> Optional[int]:
        """Batch-1 prefill of ``suffix`` straight into ``lane``'s pages at
        logical positions ``shared..``, attending the trie-shared prefix
        pages already in place (a chunk is the same call at its offset)."""
        return self._prefill(
            req, self.cache_manager.cache, suffix, shared,
            self.cache_len - shared, sample, guarded,
            cache_positions=self._tensor([shared], torch.int32),
            block_tables=self._tensor(self.cache_manager.tables[lane][None],
                                      torch.int32))

    def _slot_prefill_call(self, req: Request, tokens, slot: int) -> int:
        """Batch-1 prefill of the whole prompt into a fresh cache, copied
        into ``slot``'s row (JAX ``_make_prefill``); returns the first
        token."""
        small = self.executor.init_cache(1, self.device)
        tok = self._prefill(req, small, tokens, 0, self.cache_len, True)
        scatter_slot(self.cache_manager.cache, small, slot)
        return tok

    def _chunk_prefill_call(self, req: Request, tokens, wpos: int,
                            sample: bool) -> Optional[int]:
        """One slot-path chunk: ``tokens`` into the request's working
        cache at absolute positions ``wpos..`` (the bucket capped at the
        cache's remaining span)."""
        return self._prefill(
            req, req.chunk_cache, tokens, wpos, self.cache_len - wpos,
            sample, cache_positions=self._tensor([wpos], torch.int32))

    def _run_chunk(self, req: Request) -> None:
        """One prefill chunk of the prefilling request. Intermediate chunks
        only write K/V; the final chunk samples the first token as the
        one-call path does and moves the request to the decode set."""
        start = req.prefill_pos
        end = min(start + self.prefill_chunk, req.prompt_len)
        final = end == req.prompt_len
        tokens = req.prompt[start:end]
        self._fault_ctx = ("prefill", req.id)
        if self.paged:
            tok = self._paged_prefill_call(req, tokens, start, req.slot,
                                           sample=final)
        else:
            tok = self._chunk_prefill_call(req, tokens, start, sample=final)
        self._fault_ctx = None
        req.prefill_pos = end
        self.metrics.record_prefill_chunk(len(tokens))
        if not final:
            return
        if self.paged:
            self.cache_manager.register_prefix(req.slot, req.prompt)
        else:
            scatter_slot(self.cache_manager.cache, req.chunk_cache, req.slot)
            req.chunk_cache = None
        del self._prefilling[req.slot]
        self._prefill_strikes.pop(req.id, None)
        self._finish_first_token(req, tok)

    def _chunk_tick(self) -> Tuple[int, List[int]]:
        """Advance the prefilling request by ONE chunk — after checking its
        limits, so an expired request stops burning prefill (retired
        ``timeout`` with lane and pages freed; nothing was registered in
        the trie). Until its first token it is still waiting, so the queue
        TTL applies too. Returns ``(chunks run, timed-out ids)``."""
        req = self._prefilling[min(self._prefilling)]
        now = self._now()
        waited = now - req.submit_time
        if ((req.queue_ttl_s and waited > req.queue_ttl_s)
                or (req.deadline_s and waited > req.deadline_s)):
            self._finalize(req, "timeout", now)
            obs_emit("request_timeout", request=req.id, where="prefilling")
            return 0, [req.id]
        self._run_chunk(req)
        return 1, []

    def _sample(self, reqs: List[Request], logits: torch.Tensor) -> List[int]:
        """Next token of each request from its row of fp32 ``logits``
        [len(reqs), vocab]: EOS is banned while a request is below its
        ``min_length``; greedy rows take the argmax."""
        logits = logits.float()
        vocab = logits.shape[-1]
        for i, r in enumerate(reqs):
            if (0 <= r.eos_token_id < vocab
                    and len(r.tokens) < r.min_new_tokens):
                logits[i, r.eos_token_id] = _NEG
        if all(r.greedy for r in reqs):
            return torch.argmax(logits, dim=-1).tolist()
        tok = self.executor.sample(
            logits, [r.generator for r in reqs],
            self._knob(reqs, "greedy", torch.bool),
            self._knob(reqs, "temperature", torch.float32),
            self._knob(reqs, "top_k", torch.int32),
            self._knob(reqs, "top_p", torch.float32), topk_cap=self.topk_cap)
        return tok.tolist()

    def _knob(self, reqs: List[Request], attr: str, dtype) -> torch.Tensor:
        return self._tensor([getattr(r, attr) for r in reqs], dtype)

    def _finish_first_token(self, req: Request, tok: int) -> None:
        """Admission tail: record TTFT, fire the callback, route to the
        active set, to the parked set (a prefill-role engine never
        decodes) or straight to retirement."""
        now = self._now()
        req.first_token_time = now
        req.tokens.append(tok)
        self.metrics.record_first_token(now - req.submit_time)
        self.metrics.record_tokens(1)
        done_eos = req.eos_token_id >= 0 and tok == req.eos_token_id
        done = done_eos or req.max_new_tokens <= 1
        if not self._emit_token(req, tok, done):
            self._retire_error(req, now)
        elif done:
            self._finalize(req, "eos" if done_eos else "max_length", now)
        elif self.role == "prefill":
            req.phase = "prefilled"
            self._prefilled[req.slot] = req
            obs_emit("prefill_parked", request=req.id,
                     prompt_len=req.prompt_len)
        else:
            req.phase = "active"
            self._active[req.slot] = req

    def _claim_pending_pages(self, now: float) -> List[int]:
        """Paged: grow on demand BEFORE the write — a lane whose next
        position crosses into an unallocated page claims one now; a dry
        pool retires the request with its partial tokens (lowest lane
        first). Returns the retired ids."""
        retired = []
        if self.paged:
            for slot in sorted(self._active):
                req = self._active[slot]
                if not self.cache_manager.ensure_page(slot):
                    self._finalize(req, "cache_full", now)
                    obs_emit("cache_full", request=req.id,
                             tokens=len(req.tokens))
                    retired.append(req.id)
        return retired

    def _lane_inputs(self, slots=None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(active, lengths, last token)`` over every lane, ``slots``
        (default: every active lane) marked active."""
        slots = sorted(self._active) if slots is None else list(slots)
        active = np.zeros(self.slots, bool)
        active[slots] = True
        last_tok = np.zeros(self.slots, np.int64)
        last_tok[slots] = [self._active[s].tokens[-1] for s in slots]
        return active, self.cache_manager.lengths, last_tok

    def _decode_forward(self, slots, probe: bool = False) -> torch.Tensor:
        """The decode forward of one tick (or of a probe) over the lanes
        ``slots``; returns the logits. Host state is not touched."""
        active, lengths, last_tok = self._lane_inputs(slots)
        max_pos = self.model.cfg.max_position_embeddings
        wpos = np.where(active, lengths, self.cache_len - 1)
        posid = np.where(active, np.minimum(lengths, max_pos - 1), 0)
        return self._guarded_forward(
            last_tok[:, None], posid[:, None], wpos,
            [self._active[s].id for s in slots], probe)

    def _guarded_forward(self, ids, posid, wpos, request_ids,
                         probe: bool = False) -> torch.Tensor:
        """One forward of a decode tick, a verify or a probe, under the
        watchdog and behind the fault seams: ``ids`` and ``posid``
        ``[slots, s]``, the write offsets ``wpos`` ``[slots]``, all host
        arrays; returns the logits. The operands are bound here, on the
        calling thread, so a call the watchdog abandons can only write the
        tensors of the storage it was given; once the call returns or
        fails here, only a still-running abandoned call holds them. A
        probe is no tick attempt for the fault seam."""
        operands = [self.cache_manager.cache, self._tensor(ids),
                    self._tensor(posid), self._tensor(wpos, torch.int32),
                    self._device_tables()]
        attempt = None
        if not probe:
            attempt = self._fault_ticks
            self._fault_ticks += 1
        forward, sync = self.executor.forward, self._sync_in_watch

        def run():
            cache, ids, pos, cpos, tables = operands
            if attempt is not None:
                faults.on_serving_tick(attempt)
            faults.on_serving_batch(request_ids)
            logits, _ = forward(cache, ids, pos, cache_positions=cpos,
                                block_tables=tables)
            sync()
            return logits

        try:
            return self._run_device(run)
        finally:
            operands.clear()

    def _sync_in_watch(self) -> None:
        """Under the watchdog, wait for the device inside the watched call,
        so that a hung or failing device step surfaces there."""
        if self.tick_timeout_s > 0 and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tick_decode(self) -> List[int]:
        """ONE decode token for every active lane. Free lanes (and a
        prefilling or parked one) ride the batched forward with their
        write pinned to the last logical position — on the paged path
        their zeroed or unused table entries route it to the trash page or
        past the prompt; on the slot path it lands past every live window
        — and their outputs are ignored."""
        retired = self._claim_pending_pages(self._now())
        if not self._active:
            return retired
        slots = sorted(self._active)
        logits = self._decode_forward(slots)
        lengths = self.cache_manager.lengths
        toks = self._sample([self._active[s] for s in slots],
                            logits[slots, -1])
        now = self._now()
        for slot, t in zip(slots, toks):
            req = self._active[slot]
            req.tokens.append(t)
            lengths[slot] += 1
            self.metrics.record_tokens(1)
            done_eos = req.eos_token_id >= 0 and t == req.eos_token_id
            done_max = len(req.tokens) >= req.max_new_tokens
            finished = done_eos or done_max or lengths[slot] >= self.cache_len
            if not self._emit_token(req, t, finished):
                self._retire_error(req, now)
                retired.append(req.id)
            elif finished:
                self._finalize(req, "eos" if done_eos else "max_length"
                               if done_max else "cache_full", now)
                retired.append(req.id)
        return retired

    # ------------------------------------------------ speculative decoding

    def _tick_decode_spec(self) -> List[int]:
        """Speculative sibling of :meth:`_tick_decode`: clamp k, claim the
        pending-token pages, clamp each draft to its budget and pages,
        draft, verify once, commit each lane's accepted run. A tick where
        nothing was drafted is a plain tick."""
        lengths = self.cache_manager.lengths
        # every lane's verify writes land at lengths..lengths+k, all below
        # cache_len, so k is the smallest headroom (a lane only pins it
        # below spec_k within k tokens of its capacity)
        k = min(self.spec_k, min(self.cache_len - 1 - int(lengths[s])
                                 for s in self._active))
        if k <= 0:
            return self._tick_decode()
        # phase 1: the pending-token pages, in the plain tick's order, so
        # that cache_full decisions are the plain engine's
        retired = self._claim_pending_pages(self._now())
        if not self._active:
            return retired
        caps = {}
        for slot in sorted(self._active):
            req = self._active[slot]
            # a draft never overruns the remaining budget or its pages
            budget = max(req.max_new_tokens - len(req.tokens) - 1, 0)
            # phase 2: draft windows from whatever slack the pool has left
            # (returned by trim_span after the verify)
            covered = (self.cache_manager.ensure_span(slot,
                                                      min(k, budget) + 1)
                       if self.paged else k + 1)
            caps[slot] = min(k, budget, covered - 1)
        requests = {
            slot: (np.concatenate([req.prompt,
                                   np.asarray(req.tokens, np.int32)]),
                   caps[slot])
            for slot, req in self._active.items()}
        with self.executor.mesh_context():  # a draft model's calls too
            proposals = self._proposer.propose(requests, k)
        draft = np.zeros((self.slots, k), np.int64)
        dlen = np.zeros(self.slots, np.int64)
        for slot, (_, cap) in requests.items():
            d = np.asarray(proposals.get(slot, ()),
                           np.int64).reshape(-1)[:cap]
            draft[slot, :len(d)] = d
            dlen[slot] = len(d)
        if not dlen.any():
            # a (k+1)-wide verify would emit one token per lane at k+1
            # times the cost; the draft pages go back first, so the plain
            # tick sees the plain engine's pool
            if self.paged:
                for slot in sorted(self._active):
                    self.cache_manager.trim_span(slot)
            return retired + self._tick_decode()
        logits = self._verify(draft, k)
        out, emitted, accepted = self._accept(logits, draft, dlen)
        now = self._now()
        n_proposed = n_accepted = 0
        emitted_rows = []
        for slot, req in list(self._active.items()):
            n = int(emitted[slot])
            toks = [int(t) for t in out[slot, :n]]
            row_acc = min(int(accepted[slot]), n)
            n_proposed += int(dlen[slot])
            n_accepted += row_acc
            req.spec_proposed += int(dlen[slot])
            req.spec_accepted += row_acc
            emitted_rows.append(n)
            lengths[slot] += n
            if self.paged:
                # rejected-draft pages go back to the pool this tick
                self.cache_manager.trim_span(slot)
            self.metrics.record_tokens(n)
            self._proposer.observe(slot, n)
            done_eos = req.eos_token_id >= 0 and toks[-1] == req.eos_token_id
            done_max = len(req.tokens) + n >= req.max_new_tokens
            finished = done_eos or done_max or lengths[slot] >= self.cache_len
            failed = False
            for i, t in enumerate(toks):
                req.tokens.append(t)
                # a raising callback retires THIS request with the tokens
                # streamed so far
                if not self._emit_token(req, t, finished and i == n - 1):
                    self._retire_error(req, now)
                    retired.append(req.id)
                    failed = True
                    break
            if failed:
                continue
            if finished:
                self._finalize(req, "eos" if done_eos else "max_length"
                               if done_max else "cache_full", now)
                retired.append(req.id)
        self.metrics.record_spec(n_proposed, n_accepted, emitted_rows)
        return retired

    def _verify(self, draft: np.ndarray, k: int) -> torch.Tensor:
        """ONE prefill-shaped forward scoring all ``k + 1`` positions of
        every lane — ``[last token, d1..dk]`` written at the lane's own
        offsets (JAX ``_verify_fn``) — with the per-position ``min_length``
        EOS ban applied: position j gives generated token ``len(tokens) +
        j + 1``. Inactive lanes ride along with their writes pinned beyond
        every live window (paged: clamped onto the last logical position;
        slot: the row's last ``k + 1`` positions). Returns fp32 logits
        ``[slots, k + 1, vocab]``."""
        s = k + 1
        active, lengths, last_tok = self._lane_inputs()
        max_pos = self.model.cfg.max_position_embeddings
        pin = self.cache_len - 1 if self.paged else self.cache_len - s
        wpos = np.where(active, lengths, pin)
        ids = np.concatenate([last_tok[:, None], draft], axis=1)
        posid = np.minimum(wpos[:, None] + np.arange(s), max_pos - 1)
        posid = np.where(active[:, None], posid, 0)
        logits = self._guarded_forward(
            ids, posid, wpos, [r.id for r in self._active.values()]).float()
        vocab = logits.shape[-1]
        for slot, req in self._active.items():
            if 0 <= req.eos_token_id < vocab:
                banned = max(req.min_new_tokens - len(req.tokens), 0)
                logits[slot, :min(banned, s), req.eos_token_id] = _NEG
        return logits

    def _accept(self, logits: torch.Tensor, draft: np.ndarray,
                dlen: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
        """Acceptance of every active lane's draft against the verify's
        ``logits``; ``(tokens [slots, k + 1], emitted [slots], accepted
        [slots])``, each row's emitted run being ``tokens[:emitted]``.

        Greedy: the longest draft prefix equal to the per-position argmax,
        plus the correction token, cut after the first EOS. Sampling
        (speculative rejection, the proposers being deterministic): per
        position with a draft d, one uniform u from the request's
        generator, d kept when u < p(d), else one categorical draw from the
        residual, p with d removed; a position without a draft, one
        categorical draw from p; the run ends after a rejection or an
        EOS."""
        s = logits.shape[1]
        target = torch.argmax(logits, dim=-1).cpu().numpy()
        out = target.copy()
        emitted = np.zeros(self.slots, np.int64)
        accepted = np.zeros(self.slots, np.int64)
        for slot in sorted(self._active):
            req = self._active[slot]
            eos = req.eos_token_id
            if req.greedy:
                acc = 0
                while (acc < dlen[slot]
                       and draft[slot, acc] == target[slot, acc]):
                    acc += 1
                m = acc + 1
                hits = [j for j in range(m) if target[slot, j] == eos]
                if eos >= 0 and hits:
                    m = hits[0] + 1
                emitted[slot], accepted[slot] = m, min(acc, m)
                continue
            p = torch.softmax(self.executor.filter(
                logits[slot], self._knob([req] * s, "temperature",
                                         torch.float32),
                self._knob([req] * s, "top_k", torch.int32),
                self._knob([req] * s, "top_p", torch.float32),
                topk_cap=self.topk_cap), dim=-1)
            g = req.generator
            for j in range(s):
                took = False
                if j < dlen[slot]:
                    d = int(draft[slot, j])
                    u = torch.rand((), generator=g, device=p.device)
                    resid = p[j].clone()
                    resid[d] = 0.0
                    # a residual with no mass: p(d) rounded to 1
                    took = bool(u < p[j, d]) or not bool(resid.sum() > 0)
                    tok = d if took else int(torch.multinomial(
                        resid, 1, generator=g)[0])
                else:
                    tok = int(torch.multinomial(p[j], 1, generator=g)[0])
                out[slot, j] = tok
                emitted[slot] += 1
                accepted[slot] += took
                if not took or tok == eos:
                    break
        return out, emitted, accepted

    # -------------------------------------------------------- retirement

    def _emit_token(self, req: Request, tok: int, finished: bool) -> bool:
        """Invoke a request's streaming callback behind a firewall; False
        means the callback raised (the request retires as ``error``)."""
        if not req.on_token:
            return True
        try:
            req.on_token(req.id, tok, finished)
            return True
        except Exception:
            logger.exception(
                "serving: request %d on_token callback raised; retiring it "
                "with finish_reason='error' (other lanes unaffected)", req.id)
            return False

    def _retire_error(self, req: Request, now: float) -> None:
        """Retire one request whose callback raised."""
        self._finalize(req, "error", now)
        obs_emit("callback_error", request=req.id)

    def _finalize(self, req: Request, reason: str, now: float) -> None:
        """THE retirement path (finish, cancel, timeout, callback error):
        leave the active or prefilling set, drop a working cache, free the
        lane and pages (if held), record the result."""
        for table in (self._active, self._prefilling, self._prefilled):
            if table.get(req.slot) is req:
                del table[req.slot]
        req.chunk_cache = None
        req.phase = "finished"
        if req.slot is not None:  # a queued request never held a lane
            if self._proposer is not None:
                self._proposer.on_retire(req.slot)
            self.cache_manager.free(req.slot)
        self.metrics.record_retire(now - req.submit_time, reason)
        self._results[req.id] = ServingResult(
            id=req.id, prompt=req.prompt,
            tokens=np.asarray(req.tokens, np.int32), finish_reason=reason,
            ttft_s=(req.first_token_time or now) - req.submit_time,
            latency_s=now - req.submit_time)
