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

Not ported (ROADMAP Queue A, "Serving features still missing"), each
raising ``NotImplementedError`` when asked for: the host and disk page
tiers, prefill/decode roles and ``export_kv``, crash recovery
(transactional ticks, replay, poison bisection, the watchdog, graceful
shutdown, admit-with-history), mesh serving, int8 weights and the obs
exposition.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from fleetx_tpu_torch.models.gpt.generation import (
    GenerationConfig,
    _top_p_cutoff_bisect,
)
from fleetx_tpu_torch.models.gpt.model import inference_params
from fleetx_tpu_torch.ops.quant import resolve_serving_dtype
from fleetx_tpu_torch.serving.cache_manager import (
    PagedKVCacheManager,
    SlotKVCacheManager,
    scatter_slot,
)
from fleetx_tpu_torch.serving.metrics import ServingMetrics
from fleetx_tpu_torch.serving.model_protocol import GPTExecutor
from fleetx_tpu_torch.serving.scheduler import FIFOScheduler, Request
from fleetx_tpu_torch.serving.spec import build_proposer
from fleetx_tpu_torch.utils.device import resolve_device
from fleetx_tpu_torch.utils.log import logger

__all__ = ["QueueFull", "ServingEngine", "ServingResult", "filter_logits",
           "sample_tokens"]

_NEG = -1e9
_MISSING = 'ROADMAP Queue A, "Serving features still missing"'
# the JAX engine's switches this port leaves out: keyword -> (environment
# variable, what it asks for)
_LEFT_OUT = {
    "host_cache_bytes": ("FLEETX_SERVING_HOST_CACHE_BYTES",
                         "the host page tier"),
    "disk_cache_dir": ("FLEETX_SERVING_DISK_CACHE_DIR", "the disk page tier"),
    "disk_cache_bytes": ("FLEETX_SERVING_DISK_CACHE_BYTES",
                         "the disk page tier"),
    "role": ("FLEETX_SERVING_ROLE", "prefill/decode roles"),
    "mesh": (None, "mesh serving"),
    "weight_dtype": ("FLEETX_SERVING_WEIGHT_DTYPE", "int8 weights"),
    "max_recoveries": ("FLEETX_SERVING_MAX_RECOVERIES",
                       "crash recovery (replay, poison bisection)"),
    "tick_timeout_s": ("FLEETX_SERVING_TICK_TIMEOUT_S", "the tick watchdog"),
    "grace_s": ("FLEETX_SERVING_GRACE_S", "graceful shutdown"),
    "log_every": ("FLEETX_SERVING_LOG_EVERY", "the obs exposition"),
}
# values of those switches that ask for nothing (the JAX defaults)
_OFF = {None, "", "0", "both", "bf16", "0.0"}


class QueueFull(RuntimeError):
    """Admission refused: the queue is at ``FLEETX_SERVING_MAX_QUEUE``. The
    explicit backpressure signal — callers shed load or retry later."""


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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({_MISSING})")


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


@dataclasses.dataclass
class ServingResult:
    """Final outcome of one request: generated tokens + latency stats."""

    id: int
    prompt: np.ndarray
    tokens: np.ndarray  # generated tokens (EOS included when hit)
    # eos | max_length | cache_full | timeout | cancelled | error
    finish_reason: str
    ttft_s: float
    latency_s: float


class ServingEngine:
    """Continuous-batching serving loop (module docstring).

    ``model`` gives the architecture and its ``cfg`` (a module on the
    ``meta`` device is enough); ``params`` is its state dict
    (``convert.init_params`` / ``convert.params_from_jax``). The engine
    builds its own decode-configured copy on ``device`` — CUDA unless the
    caller passes another; without CUDA it raises — with the dense
    weights stored at the compute dtype (the forward casts them there
    anyway, so results are unchanged). Every keyword left at None takes
    its ``FLEETX_SERVING_*`` variable, else the JAX engine's default."""

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
                 spec_proposer=None, **left_out):
        for name, value in left_out.items():
            if name not in _LEFT_OUT:
                raise TypeError(f"ServingEngine got an unexpected keyword "
                                f"{name!r}")
            if value is not None and str(value) not in _OFF:
                raise _not_ported(f"{_LEFT_OUT[name][1]} ({name}=)")
        for env, what in _LEFT_OUT.values():
            if env and os.environ.get(env, "") not in _OFF:
                raise _not_ported(f"{what} ({env})")
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
                decode_page_size=self.page_size, decode_kv_dtype=decode_kv)
        else:
            self.num_pages = 0
            self.prefix_cache = False
            cfg = dataclasses.replace(
                model.cfg, decode_cache_len=cache_len, decode_num_pages=None,
                decode_page_size=None, decode_kv_dtype=decode_kv)
        self.model = type(model)(cfg, device="meta")
        self.model.load_state_dict(
            inference_params(self.model, params, self.device), assign=True)
        self.executor = GPTExecutor(self.model)
        self.capabilities = self.executor.capabilities
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
        if self.paged:
            self.cache_manager = PagedKVCacheManager(
                self.model, self.slots, cache_len, self.num_pages,
                self.page_size, prefix_cache=self.prefix_cache,
                device=self.device)
        else:
            self.cache_manager = SlotKVCacheManager(
                self.model, self.slots, cache_len, device=self.device)
        self._tables_dev = None       # device copy of the block tables,
        self._tables_version = -1     # refreshed when the pool's moves
        self.scheduler = FIFOScheduler()
        self.metrics = metrics or ServingMetrics(self.slots)
        self.publish_quant_metrics()
        self.base_seed = int(base_seed)
        self._next_id = 0
        self._active: Dict[int, Request] = {}  # slot -> request
        # chunked prefill: slot -> the request mid-prefill there (at most
        # one: the FIFO head)
        self._prefilling: Dict[int, Request] = {}
        self._results: Dict[int, ServingResult] = {}
        self._now = time.perf_counter
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

    def publish_quant_metrics(self) -> None:
        """Push the KV precision and its byte costs into ``metrics`` (JAX
        ``_publish_quant_metrics``): the K+V bytes one cached token costs
        over all layers (one fp32 scale per head vector at int8) and the
        cache's bytes. Call again after swapping ``engine.metrics``."""
        cfg = self.model.cfg
        quant = self.kv_dtype == "int8"
        item = 1 if quant else torch.empty(0, dtype=cfg.dtype).element_size()
        per_token = cfg.num_layers * cfg.num_attention_heads * 2 * (
            cfg.head_dim * item + (4 if quant else 0))
        self.metrics.set_quant_config(self.kv_dtype, per_token,
                                      self.cache_manager.cache_nbytes())

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
        :class:`QueueFull` when the bounded queue is full."""
        if history is not None:
            raise _not_ported("admit-with-history (submit(history=))")
        if kv_payloads is not None:
            raise _not_ported("shipped KV admission (submit(kv_payloads=))")
        if self.max_queue and self.scheduler.queue_depth >= self.max_queue:
            # dead entries must not hold live ones out
            self._expire_queued(self._now())
        if self.max_queue and self.scheduler.queue_depth >= self.max_queue:
            self.metrics.record_reject()
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
        rid = self._next_id
        self._next_id += 1
        if seed is None:
            seed = int(np.random.SeedSequence(
                [self.base_seed, rid]).generate_state(1)[0])
        req = Request(
            id=rid, prompt=prompt, max_new_tokens=max(max_new, 1),
            min_new_tokens=min_new, eos_token_id=eos,
            greedy=strategy == "greedy",
            temperature=float(temperature if temperature is not None
                              else g.temperature),
            top_k=tk,
            top_p=float(top_p if top_p is not None else g.top_p),
            generator=torch.Generator(device=self.device).manual_seed(
                int(seed)),
            on_token=on_token, submit_time=self._now(),
            queue_ttl_s=float(queue_ttl_s if queue_ttl_s is not None
                              else self.queue_ttl_s),
            deadline_s=float(deadline_s if deadline_s is not None
                             else self.deadline_s))
        self.scheduler.submit(req)
        self.metrics.record_submit()
        return rid

    @torch.no_grad()
    def step(self) -> Dict:
        """One scheduler tick (module docstring). Returns a summary dict:
        ``admitted``, ``chunked`` (mid-prefill chunks run), ``decoded``
        (lanes that decoded), ``retired`` (ids, timeouts included),
        ``timed_out``, and the queue, lane and prefilling counts after it.
        """
        t0 = self._now()
        summary = self._step_inner()
        if self.paged:
            pages = (self.cache_manager.pages_in_use,
                     self.cache_manager.usable_pages)
        else:
            pages = (0, 0)
        self.metrics.observe_tick(self._now() - t0, *pages)
        self.metrics.observe_queue_tokens(
            self.scheduler.queued_tokens() + sum(
                r.prompt_len - r.prefill_pos
                for r in self._prefilling.values()))
        summary["queue_depth"] = self.scheduler.queue_depth
        summary["active_slots"] = len(self._active)
        summary["prefilling"] = len(self._prefilling)
        return summary

    def _step_inner(self) -> Dict:
        """The tick body: the queued-expiry sweep, prefill work
        (admissions, or exactly one chunk of the prefilling request), one
        batched decode step, retirements, the active-deadline sweep."""
        timed_out = self._expire_queued(self._now())
        admitted = chunked = 0
        prefill_t0 = self._now()
        if self._prefilling:
            # FIFO holds: the prefilling request IS the admission head
            n, expired = self._chunk_tick()
            chunked += n
            timed_out += expired
        else:
            while (len(self.scheduler)
                   and self._can_admit(self.scheduler.peek())):
                self._admit(self.scheduler.pop_next())
                admitted += 1
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
                    or summary["chunked"] or summary["retired"]):
                raise RuntimeError(
                    f"request {self.scheduler.peek().id} can never be "
                    f"admitted: it needs more than the pool's "
                    f"{self.cache_manager.usable_pages} pages")
            if max_ticks is not None and n >= max_ticks:
                break
        out, self._results = self._results, {}
        return out

    def cancel(self, request_id: int) -> bool:
        """Cancel a queued or in-flight request: its lane and pages (if
        any) are freed at once and its partial output is recorded with
        ``finish_reason="cancelled"``. False when the id is unknown or
        already finished."""
        req = self.scheduler.remove(request_id)
        if req is None:
            for r in (list(self._active.values())
                      + list(self._prefilling.values())):
                if r.id == request_id:
                    req = r
                    break
        if req is None:
            return False
        self._finalize(req, "cancelled", self._now())
        return True

    def result(self, request_id: int) -> Optional[ServingResult]:
        """Finished result for ``request_id`` (None while in flight)."""
        return self._results.get(request_id)

    def take_result(self, request_id: int) -> Optional[ServingResult]:
        """Remove and return one finished result (None while in flight)."""
        return self._results.pop(request_id, None)

    def recover(self):
        """Replay recovery (JAX ``recover``) is not ported."""
        raise _not_ported("crash recovery (recover())")

    def shutdown(self, grace_s: Optional[float] = None):
        """Graceful drain toward shutdown (JAX ``shutdown``) is not
        ported."""
        raise _not_ported("graceful shutdown (shutdown())")

    request_shutdown = shutdown

    def export_kv(self, request_id: int):
        """The prefill role's KV export (JAX ``export_kv``) is not
        ported."""
        raise _not_ported("prefill/decode roles (export_kv())")

    def prefilled_ready(self):
        """The prefill role's parked requests are not ported."""
        raise _not_ported("prefill/decode roles (prefilled_ready())")

    # ------------------------------------------------------------- internals

    def _expire_queued(self, now: float) -> List[int]:
        """Retire queued requests past their queue TTL or deadline (they
        never held a lane; ``finish_reason="timeout"``, no tokens)."""
        out = []
        for req in self.scheduler.pop_expired(now):
            self._finalize(req, "timeout", now)
            out.append(req.id)
        return out

    def _expire_active(self, now: float) -> List[int]:
        """Retire decoding requests past their total deadline, freeing
        their lanes; partial tokens are kept in the result."""
        out = []
        for req in list(self._active.values()):
            if req.deadline_s and now - req.submit_time > req.deadline_s:
                self._finalize(req, "timeout", now)
                out.append(req.id)
        return out

    def _can_admit(self, req: Request) -> bool:
        """A free decode lane and, paged, enough free pages for the FIFO
        head's prompt. A too-big head BLOCKS, preserving arrival order; it
        unblocks as retiring requests return pages."""
        return self.cache_manager.can_admit(req.prompt)

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
        self.metrics.record_prefix(shared, req.prompt_len)
        return shared

    def _admit(self, req: Request) -> None:
        """Admit the FIFO head: claim storage, then either the one-call
        prefill of the non-shared suffix (chunking off, or the suffix fits
        one chunk) or enter the ``prefilling`` state and run the first
        chunk."""
        shared = self._claim_storage(req)
        if self.prefill_chunk and req.prompt_len - shared > self.prefill_chunk:
            req.prefill_pos = shared
            req.phase = "prefilling"
            if not self.paged:
                req.chunk_cache = self.executor.init_cache(1, self.device)
            self._prefilling[req.slot] = req
            req.admit_time = self._now()
            self.metrics.record_admit()
            self._run_chunk(req)  # this tick's one chunk
            return
        if self.paged:
            tok = self._paged_prefill_call(req, req.prompt[shared:], shared,
                                           req.slot)
            self.cache_manager.register_prefix(req.slot, req.prompt)
        else:
            tok = self._slot_prefill_call(req, req.prompt, req.slot)
        req.admit_time = self._now()
        self.metrics.record_admit()
        self._finish_first_token(req, tok)

    def _bucket(self, n: int, room: int) -> int:
        """``n`` tokens right-padded to a multiple of ``prefill_bucket``,
        capped by the ``room`` left in the lane (a longer write would clamp
        back over live positions)."""
        bucket = -(-n // self.prefill_bucket) * self.prefill_bucket
        return min(max(bucket, n), room)

    def _prefill(self, req: Request, cache, tokens, wpos: int, room: int,
                 sample: bool, **where) -> Optional[int]:
        """One batch-1 prefill-shaped forward of ``tokens`` at absolute
        positions ``wpos..`` into ``cache``, the tokens right-padded to a
        bucket (the padded tail is causally invisible to the real tokens,
        and its K/V land beyond the live window, where later writes
        replace them). ``sample``: return the next token, drawn from the
        last real token's logits; else write K/V only (an intermediate
        chunk: no draw from the request's generator)."""
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
                            lane: int, sample: bool = True) -> Optional[int]:
        """Batch-1 prefill of ``suffix`` straight into ``lane``'s pages at
        logical positions ``shared..``, attending the trie-shared prefix
        pages already in place (a chunk is the same call at its offset)."""
        return self._prefill(
            req, self.cache_manager.cache, suffix, shared,
            self.cache_len - shared, sample,
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
        if self.paged:
            tok = self._paged_prefill_call(req, tokens, start, req.slot,
                                           sample=final)
        else:
            tok = self._chunk_prefill_call(req, tokens, start, sample=final)
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
        active set or straight to retirement."""
        now = self._now()
        req.first_token_time = now
        req.tokens.append(tok)
        self.metrics.record_first_token(now - req.submit_time)
        self.metrics.record_tokens(1)
        done_eos = req.eos_token_id >= 0 and tok == req.eos_token_id
        done = done_eos or req.max_new_tokens <= 1
        if not self._emit_token(req, tok, done):
            self._finalize(req, "error", now)
        elif done:
            self._finalize(req, "eos" if done_eos else "max_length", now)
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
                    retired.append(req.id)
        return retired

    def _lane_inputs(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(active, lengths, last token)`` over every lane."""
        slots = sorted(self._active)
        active = np.zeros(self.slots, bool)
        active[slots] = True
        last_tok = np.zeros(self.slots, np.int64)
        last_tok[slots] = [self._active[s].tokens[-1] for s in slots]
        return active, self.cache_manager.lengths, last_tok

    def _tick_decode(self) -> List[int]:
        """ONE decode token for every active lane. Free lanes (and a
        prefilling one) ride the batched forward with their write pinned
        to the last logical position — on the paged path their zeroed or
        unused table entries route it to the trash page or past the
        prompt; on the slot path it lands past every live window — and
        their outputs are ignored."""
        retired = self._claim_pending_pages(self._now())
        if not self._active:
            return retired
        active, lengths, last_tok = self._lane_inputs()
        slots = sorted(self._active)
        max_pos = self.model.cfg.max_position_embeddings
        wpos = np.where(active, lengths, self.cache_len - 1)
        posid = np.where(active, np.minimum(lengths, max_pos - 1), 0)
        logits, _ = self.executor.forward(
            self.cache_manager.cache, self._tensor(last_tok)[:, None],
            self._tensor(posid)[:, None],
            cache_positions=self._tensor(wpos, torch.int32),
            block_tables=self._device_tables())
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
                self._finalize(req, "error", now)
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
                    self._finalize(req, "error", now)
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
        logits, _ = self.executor.forward(
            self.cache_manager.cache, self._tensor(ids), self._tensor(posid),
            cache_positions=self._tensor(wpos, torch.int32),
            block_tables=self._device_tables())
        logits = logits.float()
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

    def _finalize(self, req: Request, reason: str, now: float) -> None:
        """THE retirement path (finish, cancel, timeout, callback error):
        leave the active or prefilling set, drop a working cache, free the
        lane and pages (if held), record the result."""
        for table in (self._active, self._prefilling):
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
