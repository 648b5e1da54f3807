"""ServingEngine: continuous-batching decode over the paged KV cache.

Port of the paged path of the JAX package's ``serving/engine.py``:

- **submit()** queues a request (FIFO) with per-request overrides for
  max/min length, EOS, temperature, top-k/top-p and a seeded sampling
  stream.
- **step()** is one scheduler tick: admit queued requests whose pages fit
  (prefill-on-insert — the non-shared prompt suffix runs one cached
  forward straight into the request's pages and its first token is
  sampled), then ONE batched decode forward over all lanes, then per-lane
  EOS / max-length / cache-full retirement that frees lanes and pages for
  the next tick.
- **drain()** ticks until queue and lanes are empty and returns the
  finished :class:`ServingResult` records.

K/V live in a shared ``[num_pages, page_size, heads, head_dim]`` pool per
layer; each request holds a block table of page indices, and a refcounted
prefix trie lets requests sharing whole prompt pages reuse one prefill
(``cache_manager.py``). Each decode tick's attention runs in the paged
decode kernel (``ops/decode_attention.py``: B8, or B10 when ``kv_dtype``
is ``"int8"`` and the pools hold int8 K/V with fp32 scales); prefill
attention is the dense masked path. Lane state lives on the host and rides
each tick as three small int tensors; the page pools are updated in place.

Not ported yet: the slot cache, chunked prefill, the host/disk page tiers,
speculative decoding, mesh serving, int8 weights, prefill/decode
roles and KV export, crash recovery (transactional ticks, replay, poison
bisection, the watchdog), admission limits and deadlines, cancel, and the
observability exposition.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from fleetx_tpu_torch.models.gpt.generation import (
    GenerationConfig,
    _top_p_cutoff_bisect,
)
from fleetx_tpu_torch.models.gpt.model import inference_params
from fleetx_tpu_torch.ops.quant import resolve_serving_dtype
from fleetx_tpu_torch.serving.cache_manager import PagedKVCacheManager
from fleetx_tpu_torch.serving.metrics import ServingMetrics
from fleetx_tpu_torch.serving.model_protocol import GPTExecutor
from fleetx_tpu_torch.serving.scheduler import FIFOScheduler, Request
from fleetx_tpu_torch.utils.device import resolve_device
from fleetx_tpu_torch.utils.log import logger

__all__ = ["ServingEngine", "ServingResult", "filter_logits",
           "sample_tokens"]

_NEG = -1e9


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
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


@dataclasses.dataclass
class ServingResult:
    """Final outcome of one request: generated tokens + latency stats."""

    id: int
    prompt: np.ndarray
    tokens: np.ndarray  # generated tokens (EOS included when hit)
    finish_reason: str  # eos | max_length | cache_full | error
    ttft_s: float
    latency_s: float


class ServingEngine:
    """Paged continuous-batching serving loop (module docstring).

    ``model`` gives the architecture and its ``cfg`` (a module on the
    ``meta`` device is enough); ``params`` is its state dict
    (``convert.init_params`` / ``convert.params_from_jax``). The engine
    builds its own decode-configured copy on ``device`` — CUDA unless the
    caller passes another; without CUDA it raises — with the dense
    weights stored at the compute dtype (the forward casts them there
    anyway, so results are unchanged)."""

    def __init__(self, model, params: Dict[str, torch.Tensor], *,
                 device=None, slots: Optional[int] = None,
                 cache_len: Optional[int] = None,
                 gen_cfg: Optional[GenerationConfig] = None,
                 base_seed: int = 0, topk_cap: Optional[int] = None,
                 prefill_bucket: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None):
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
        self.page_size = page_size or _env_int("FLEETX_SERVING_PAGE_SIZE", 16)
        cache_len = (cache_len or _env_int("FLEETX_SERVING_CACHE_LEN", 0)
                     or model.cfg.max_position_embeddings)
        # per-request logical capacity rounds to whole pages
        cache_len += -cache_len % self.page_size
        self.cache_len = cache_len
        # default pool = every lane's full capacity + the trash page
        self.num_pages = (num_pages or _env_int("FLEETX_SERVING_PAGES", 0)
                          or self.slots * (cache_len // self.page_size) + 1)
        # KV precision: "bf16" keeps the model's compute dtype, "int8"
        # stores the pools as int8 with fp32 scales (decode through B10)
        self.kv_dtype = resolve_serving_dtype(kv_dtype,
                                              "FLEETX_SERVING_KV_DTYPE")
        cfg = dataclasses.replace(
            model.cfg, decode_cache_len=cache_len,
            decode_num_pages=self.num_pages, decode_page_size=self.page_size,
            decode_kv_dtype="int8" if self.kv_dtype == "int8" else None)
        self.model = type(model)(cfg, device="meta")
        self.model.load_state_dict(
            inference_params(self.model, params, self.device), assign=True)
        self.executor = GPTExecutor(self.model)
        self.capabilities = self.executor.capabilities
        self.topk_cap = topk_cap or _env_int("FLEETX_SERVING_TOPK_CAP", 64)
        self.prefill_bucket = (prefill_bucket
                               or _env_int("FLEETX_SERVING_PREFILL_BUCKET", 32))
        self.cache_manager = PagedKVCacheManager(
            self.model, self.slots, cache_len, self.num_pages,
            self.page_size, device=self.device)
        self._tables_dev = None       # device copy of the block tables,
        self._tables_version = -1     # refreshed when the pool's moves
        self.scheduler = FIFOScheduler()
        self.metrics = ServingMetrics(self.slots)
        self.publish_quant_metrics()
        self.base_seed = int(base_seed)
        self._next_id = 0
        self._active: Dict[int, Request] = {}  # slot -> request
        self._results: Dict[int, ServingResult] = {}
        self._now = time.perf_counter

    def publish_quant_metrics(self) -> None:
        """Push the KV precision and its byte costs into ``metrics`` (JAX
        ``_publish_quant_metrics``): the K+V bytes one cached token costs
        over all layers (one fp32 scale per head vector at int8) and the
        pools' bytes. Call again after swapping ``engine.metrics``."""
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
               seed: Optional[int] = None, on_token=None) -> int:
        """Queue one request; returns its id. Kwargs override the engine's
        ``gen_cfg`` per request; ``seed`` pins this request's sampling
        stream (default: derived from the engine's ``base_seed`` and the
        request id); ``on_token`` streams ``(request_id, token,
        finished)`` per decoded token."""
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
            on_token=on_token, submit_time=self._now())
        self.scheduler.submit(req)
        self.metrics.record_submit()
        return rid

    @torch.no_grad()
    def step(self) -> Dict:
        """One scheduler tick: admissions (prefill-on-insert), one batched
        decode step, retirements. Returns a summary dict."""
        t0 = self._now()
        admitted = 0
        while (len(self.scheduler)
               and self._can_admit(self.scheduler.peek())):
            self._admit(self.scheduler.pop_next())
            admitted += 1
        decoded = len(self._active)
        retired = self._tick_decode() if decoded else []
        self.metrics.observe_tick(self._now() - t0,
                                  self.cache_manager.pages_in_use,
                                  self.cache_manager.usable_pages)
        return {"admitted": admitted, "decoded": decoded,
                "retired": retired,
                "queue_depth": self.scheduler.queue_depth,
                "active_slots": len(self._active)}

    def drain(self, max_ticks: Optional[int] = None
              ) -> Dict[int, ServingResult]:
        """Tick until queue and lanes are empty (or ``max_ticks``), then
        return-and-clear every finished result since the last drain.
        Raises when a queued request can never be admitted (its pages
        exceed the whole pool)."""
        n = 0
        while len(self.scheduler) or self._active:
            summary = self.step()
            n += 1
            if not (summary["admitted"] or summary["decoded"]):
                raise RuntimeError(
                    f"request {self.scheduler.peek().id} can never be "
                    f"admitted: it needs more than the pool's "
                    f"{self.cache_manager.usable_pages} pages")
            if max_ticks is not None and n >= max_ticks:
                break
        out, self._results = self._results, {}
        return out

    def result(self, request_id: int) -> Optional[ServingResult]:
        """Finished result for ``request_id`` (None while in flight)."""
        return self._results.get(request_id)

    def take_result(self, request_id: int) -> Optional[ServingResult]:
        """Remove and return one finished result (None while in flight)."""
        return self._results.pop(request_id, None)

    # ------------------------------------------------------------- internals

    def _can_admit(self, req: Request) -> bool:
        """A free decode lane and enough free pages for the FIFO head's
        prompt. A too-big head BLOCKS, preserving arrival order; it
        unblocks as retiring requests return pages."""
        return self.cache_manager.can_admit(req.prompt)

    def _device_tables(self) -> torch.Tensor:
        """Device copy of the block tables, re-uploaded only when the
        pool's version counter moved."""
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
        """Claim a decode lane and a page chain; sets ``req.slot`` and
        returns the shared-prefix token count."""
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
        """Admit the FIFO head: claim storage, prefill the non-shared
        suffix, publish the prompt's full pages to the prefix trie, and
        install the first token."""
        shared = self._claim_storage(req)
        tok = self._paged_prefill_call(req, req.prompt[shared:], shared,
                                       req.slot)
        self.cache_manager.register_prefix(req.slot, req.prompt)
        self.metrics.record_admit()
        self._finish_first_token(req, tok)

    def _paged_prefill_call(self, req: Request, suffix, shared: int,
                            lane: int) -> int:
        """Batch-1 prefill of the non-shared ``suffix`` straight into
        ``lane``'s pages at logical positions ``shared..``, attending the
        trie-shared prefix pages already in place; returns the first
        token, sampled from the last true token's logits.

        The suffix is right-padded to a multiple of ``prefill_bucket``
        (capped by the lane's remaining capacity), as in the JAX engine:
        the padded tail is causally invisible to the real tokens and its
        K/V land beyond the live window, where decode overwrites them."""
        n = len(suffix)
        bucket = -(-n // self.prefill_bucket) * self.prefill_bucket
        bucket = min(max(bucket, n), self.cache_len - shared)
        ids = np.zeros(bucket, np.int64)
        ids[:n] = suffix
        max_pos = self.model.cfg.max_position_embeddings
        pos = np.minimum(shared + np.arange(bucket), max_pos - 1)
        logits, _ = self.executor.forward(
            self.cache_manager.cache, self._tensor(ids)[None],
            self._tensor(pos)[None],
            cache_positions=self._tensor([shared], torch.int32),
            block_tables=self._tensor(self.cache_manager.tables[lane][None],
                                      torch.int32))
        return self._sample([req], logits[0, n - 1][None])[0]

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

        def knob(attr, dtype):
            return self._tensor([getattr(r, attr) for r in reqs], dtype)

        tok = self.executor.sample(
            logits, [r.generator for r in reqs], knob("greedy", torch.bool),
            knob("temperature", torch.float32), knob("top_k", torch.int32),
            knob("top_p", torch.float32), topk_cap=self.topk_cap)
        return tok.tolist()

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
            self._active[req.slot] = req

    def _tick_decode(self) -> List[int]:
        """ONE decode token for every active lane. Free lanes ride the
        batched forward with their write pinned to the last logical
        position, which their zeroed block table routes to the trash page;
        their outputs are ignored."""
        retired = []
        now = self._now()
        # grow on demand BEFORE the write: a lane whose next position
        # crosses into an unallocated page claims one now; a dry pool
        # retires the request with its partial tokens (lowest lane first)
        for slot in sorted(self._active):
            req = self._active[slot]
            if not self.cache_manager.ensure_page(slot):
                self._finalize(req, "cache_full", now)
                retired.append(req.id)
        if not self._active:
            return retired
        slots = sorted(self._active)
        lengths = self.cache_manager.lengths
        active = np.zeros(self.slots, bool)
        active[slots] = True
        last_tok = np.zeros(self.slots, np.int64)
        last_tok[slots] = [self._active[s].tokens[-1] for s in slots]
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
        if self._active.get(req.slot) is req:
            del self._active[req.slot]
        self.cache_manager.free(req.slot)
        self.metrics.record_retire(now - req.submit_time, reason)
        self._results[req.id] = ServingResult(
            id=req.id, prompt=req.prompt,
            tokens=np.asarray(req.tokens, np.int32), finish_reason=reason,
            ttft_s=(req.first_token_time or now) - req.submit_time,
            latency_s=now - req.submit_time)
