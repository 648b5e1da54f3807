"""Speculative-decoding proposers for the serving engine.

Port of the JAX package's ``serving/spec.py``. Speculative decoding splits
each decode tick into DRAFT and VERIFY: a cheap proposer guesses up to
``k`` next tokens per active request, and the engine scores all ``k + 1``
positions with ONE batched prefill-shaped call; acceptance keeps the
longest prefix the target model agrees with (greedy), or runs speculative
rejection (sampling). This module owns the proposer side, behind the small
:class:`Proposer` protocol:

- :class:`NgramProposer` (the default): prompt lookup — match the
  request's trailing n-gram against its own ``prompt + generated`` history
  and propose what followed the previous occurrence. Pure host work.
- :class:`DraftModelProposer`: a small GPT drafts ``k`` greedy tokens per
  tick through its OWN decode lanes, a private contiguous cache ``[slots,
  cache_len]`` for the draft model's dims. Its single-token steps run the
  contiguous decode kernel (B7) on the card; its catch-up prefills are
  bucketed multi-token forwards (the dense path). Rollback after a
  rejection is a host-side pointer move: stale K/V beyond a lane's live
  window is never attended.

A proposer cannot change what the engine emits — verification gates every
token — only the acceptance rate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Protocol, Tuple

import numpy as np
import torch

from fleetx_tpu_torch.models.gpt.generation import (
    decode_step,
    init_decode_cache,
)
from fleetx_tpu_torch.models.gpt.model import inference_params, serving_logits
from fleetx_tpu_torch.utils.device import resolve_device

__all__ = ["DraftModelProposer", "NgramProposer", "Proposer",
           "build_proposer"]

# slot -> (prompt + generated history, max draft tokens wanted this tick)
SpecRequests = Dict[int, Tuple[np.ndarray, int]]


class Proposer(Protocol):
    """The draft side of speculative decoding (module docstring).

    The engine drives one proposer per tick: ``propose()`` over the active
    lanes, ``observe()`` after verification with how many tokens each lane
    emitted (so stateful proposers rewind their rejected tails),
    ``on_retire()`` when a lane frees, ``reset()`` to drop all lane state
    (the next ``propose()`` rebuilds it from the histories it is
    handed)."""

    name: str

    def bind(self, slots: int, cache_len: int) -> None:
        """Size per-lane state for ``slots`` decode lanes."""
        ...

    def propose(self, requests: SpecRequests, k: int
                ) -> Dict[int, np.ndarray]:
        """Draft up to ``min(k, cap)`` tokens per requested lane; lanes may
        be omitted from the result (no draft this tick)."""
        ...

    def observe(self, slot: int, emitted: int) -> None:
        """Verification emitted ``emitted`` tokens for ``slot``."""
        ...

    def on_retire(self, slot: int) -> None:
        """The request holding ``slot`` retired; free its lane state."""
        ...

    def reset(self) -> None:
        """Drop all lane state."""
        ...


class NgramProposer:
    """Prompt-lookup drafting: propose the continuation of the most recent
    earlier occurrence of the request's trailing n-gram inside its own
    ``prompt + generated`` history (the longest ``n`` in ``[min_n,
    max_n]`` that recurs wins)."""

    name = "ngram"

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(
                f"need 1 <= min_n <= max_n, got ({min_n}, {max_n})")
        self.max_n = max_n
        self.min_n = min_n

    def bind(self, slots: int, cache_len: int) -> None:
        """Stateless — nothing to size."""

    def propose(self, requests: SpecRequests, k: int
                ) -> Dict[int, np.ndarray]:
        """Suffix-match each lane's history; omit lanes with no match."""
        out = {}
        for slot, (hist, cap) in requests.items():
            if cap <= 0:
                continue
            d = self._match(np.asarray(hist, np.int64), min(cap, k))
            if d.size:
                out[slot] = d
        return out

    def _match(self, hist: np.ndarray, cap: int) -> np.ndarray:
        """Tokens that followed the most recent earlier occurrence of the
        trailing n-gram (longest n first); empty when none recurs."""
        size = len(hist)
        for n in range(self.max_n, self.min_n - 1, -1):
            if size <= n:
                continue
            pattern = hist[size - n:]
            windows = np.lib.stride_tricks.sliding_window_view(hist, n)
            # candidate starts: every position but the pattern's own
            hits = np.nonzero(
                (windows[:size - n] == pattern).all(axis=1))[0]
            if hits.size:
                start = int(hits[-1]) + n
                return hist[start:start + cap].astype(np.int32)
        return np.empty(0, np.int32)

    def observe(self, slot: int, emitted: int) -> None:
        """Stateless — the next propose() re-reads the history."""

    def on_retire(self, slot: int) -> None:
        """Stateless — nothing held per lane."""

    def reset(self) -> None:
        """Stateless — nothing to drop."""


def _gather_slot(cache: Dict, slot: int) -> Dict:
    """One lane's row of a contiguous cache as a batch-1 cache: views
    ``[L, 1, cache_len, h, *]`` of the K/V (and scale) tensors, so a
    forward over it writes straight into the lane's row (the JAX function
    slices a copy that ``scatter_slot`` writes back); the scalar ``index``
    passes through."""
    return {name: t[:, slot:slot + 1] if torch.is_tensor(t) else t
            for name, t in cache.items()}


class DraftModelProposer:
    """Draft-model speculative decoding: a small GPT predicts ``k`` greedy
    tokens per active lane each tick (module docstring).

    Per-lane state: a contiguous decode cache ``[slots, cache_len]`` for
    the DRAFT model's dims, a host ``lengths`` mirror (K/V valid over
    ``[0, lengths)``) and the last emitted token. ``propose()`` first
    prefills whatever history the draft cache is missing (a fresh
    admission's prompt; the one token a fully accepted tick leaves behind;
    everything after a ``reset()``) through bucketed multi-token forwards
    at the lane's absolute positions, then runs ``k`` batched single-token
    greedy steps. ``observe()`` moves the live length past the verified
    tokens only. ``single_token_forwards`` counts the forwards that take
    the decode kernel on the card: the ``k`` steps of each drafting tick
    and any catch-up of one token."""

    name = "draft"

    def __init__(self, model, params: Dict[str, torch.Tensor],
                 prefill_bucket: int = 32, device=None):
        self._base_model = model
        self.params = params
        self.prefill_bucket = max(int(prefill_bucket), 1)
        self.device = resolve_device(device)
        self.model = None  # sized at bind()
        self.single_token_forwards = 0

    def bind(self, slots: int, cache_len: int) -> None:
        """Build the draft model on a private contiguous cache (no pages,
        no KV quantization: the draft cache only ever holds suggestions).
        Tensors already on the device at the compute dtype are shared, not
        copied (the self-draft rides the engine's own weights)."""
        cfg = dataclasses.replace(
            self._base_model.cfg, decode_cache_len=cache_len,
            decode_num_pages=None, decode_page_size=None,
            decode_kv_dtype=None)
        base = self._base_model
        self.model = type(base)(
            cfg, device="meta", int8=getattr(base, "int8", False),
            fp32_partials=getattr(base, "fp32_partials", False))
        self.model.load_state_dict(
            inference_params(self.model, self.params, self.device),
            assign=True)
        self.slots = slots
        self.cache_len = cache_len
        self.cache = init_decode_cache(self.model, slots,
                                       cache_len=cache_len,
                                       device=self.device)
        self.lengths = np.zeros(slots, np.int64)
        self.last_tok = np.zeros(slots, np.int64)
        self._written: Dict[int, int] = {}  # lane -> draft K/V positions

    def _tensor(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int64),
                               device=self.device)

    def _step(self, cur: torch.Tensor, lengths: np.ndarray,
              active: np.ndarray) -> torch.Tensor:
        """One batched greedy draft token for every lane (inactive lanes
        ride along pinned to the last cache position, outputs ignored —
        the engine's decode-tick pattern)."""
        max_pos = self.model.cfg.max_position_embeddings
        wpos = np.where(active, lengths, self.cache_len - 1)
        posid = np.where(active, np.minimum(lengths, max_pos - 1), 0)
        logits, _ = decode_step(
            self.model, self.cache, cur[:, None],
            self._tensor(posid)[:, None],
            cache_positions=self._tensor(wpos).to(torch.int32))
        logits = serving_logits(self.model, logits)  # whole vocab under mp
        self.single_token_forwards += 1
        return torch.argmax(logits[:, -1, :].float(), dim=-1)

    def _catchup(self, slot: int, hist: np.ndarray) -> None:
        """Prefill ``hist[lengths[slot] : len(hist) - 1]`` into the lane
        (the last history token is the next step's feed, as in the
        engine); the logits are discarded."""
        lo = int(self.lengths[slot])
        hi = len(hist) - 1
        n = hi - lo
        if n <= 0:
            return
        bucket = -(-n // self.prefill_bucket) * self.prefill_bucket
        bucket = min(max(bucket, n), self.cache_len - lo)
        padded = np.zeros(bucket, np.int64)
        padded[:n] = hist[lo:hi]
        max_pos = self.model.cfg.max_position_embeddings
        pos = np.minimum(lo + np.arange(bucket), max_pos - 1)
        decode_step(self.model, _gather_slot(self.cache, slot),
                    self._tensor(padded)[None], self._tensor(pos)[None],
                    cache_positions=self._tensor([lo]).to(torch.int32))
        if bucket == 1:
            self.single_token_forwards += 1
        self.lengths[slot] = hi

    @torch.no_grad()
    def propose(self, requests: SpecRequests, k: int
                ) -> Dict[int, np.ndarray]:
        """Catch each lane up to its history, then ``k`` batched greedy
        draft steps; returns per-lane proposals clipped to their caps."""
        out: Dict[int, np.ndarray] = {}
        self._written = {}
        if not requests or k <= 0:
            return out
        for slot in sorted(requests):
            hist, _ = requests[slot]
            if self.lengths[slot] > len(hist) - 1:
                self.lengths[slot] = 0  # reused lane: rebuild from zero
            self._catchup(slot, np.asarray(hist, np.int64))
            self.last_tok[slot] = int(hist[-1])
        active = np.zeros(self.slots, bool)
        for slot, (_, cap) in requests.items():
            active[slot] = cap > 0
        if not active.any():
            return out
        cur = self._tensor(self.last_tok)
        cols = []
        for i in range(k):
            cur = self._step(cur, self.lengths + i, active)
            cols.append(cur)
        drafts = torch.stack(cols, dim=1).cpu().numpy().astype(np.int32)
        for slot, (_, cap) in requests.items():
            if active[slot]:
                self._written[slot] = k
                out[slot] = drafts[slot, :cap]
        return out

    def observe(self, slot: int, emitted: int) -> None:
        """Advance the lane past the verified tokens: of the ``k`` draft
        positions propose() wrote, the first ``emitted`` hold K/V of the
        true history; the rest is the rejected tail. A fully accepted tick
        leaves the lane one token short — the next catch-up writes it."""
        self.lengths[slot] += min(emitted, self._written.pop(slot, 0))

    def on_retire(self, slot: int) -> None:
        """Free the lane; the next tenant's catch-up writes from 0."""
        self.lengths[slot] = 0
        self._written.pop(slot, None)

    def reset(self) -> None:
        """Drop every lane pointer; the next propose() re-prefills each
        lane from the history it is handed."""
        self.lengths[:] = 0
        self._written = {}


def build_proposer(kind: str, model, params, prefill_bucket: int = 32,
                   device=None) -> "Proposer":
    """Resolve ``FLEETX_SERVING_SPEC_DRAFT`` to a proposer: unset/``0``/
    ``ngram`` = prompt-lookup drafting; ``1``/``self`` = a draft-model
    proposer drafting with the serving model itself (every draft accepted
    up to rounding — a correctness configuration, not a speedup; a small
    draft model rides the ``spec_proposer`` keyword of the engine)."""
    kind = (kind or "").strip().lower()
    if kind in ("", "0", "ngram"):
        return NgramProposer()
    if kind in ("1", "self"):
        return DraftModelProposer(model, params,
                                  prefill_bucket=prefill_bucket,
                                  device=device)
    raise ValueError(
        f"FLEETX_SERVING_SPEC_DRAFT={kind!r}: expected 'ngram' (default), "
        "or '1'/'self' (draft with the serving model itself); a draft "
        "model rides the ServingEngine(spec_proposer=...) keyword")
