"""Continuous-batching scheduler: admission queue + request records.

Port of the JAX package's ``serving/scheduler.py``. ``FIFOScheduler`` is
deliberately minimal — arrival order in, arrival order out: the engine only
asks "how deep is the queue" and "who is next", takes a queue
:meth:`~FIFOScheduler.snapshot` before each transactional tick (and
:meth:`~FIFOScheduler.restore` after a failed one), pulls a quarantined or
cancelled request out with :meth:`~FIFOScheduler.remove`, and empties the
queue with :meth:`~FIFOScheduler.drain_all` when a shutdown's grace window
closes.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np
import torch

__all__ = ["Request", "FIFOScheduler"]


@dataclasses.dataclass
class Request:
    """One in-flight serving request and its per-request decode knobs.

    ``generator`` is this request's OWN sampling stream (seeded from the
    engine's base seed and the request id, or an explicit per-request
    seed), so repeated identical submissions sample independently; greedy
    requests never draw from it. ``on_token`` streams each decoded token as
    ``on_token(request_id, token, finished)`` the tick it is produced.

    Lifecycle (``phase``): ``queued`` → [``prefilling``] → ``active`` (or,
    on a prefill-role engine, ``prefilled``: parked for ``export_kv``) →
    ``finished``. ``prefilling`` exists only under chunked prefill
    (``FLEETX_SERVING_PREFILL_CHUNK`` > 0): a long prompt's KV is written
    one chunk per tick, interleaved with the batched decode;
    ``prefill_pos`` counts the prompt tokens (shared prefix included)
    written so far and, on the slot path, ``chunk_cache`` holds the
    batch-1 working cache the chunks fill before the final scatter.
    ``kv_payloads`` holds the decoded page payloads a prefill-role replica
    shipped (``submit(kv_payloads=)``) until admission writes them into
    the pool."""

    id: int
    prompt: np.ndarray  # [prompt_len] int32, no padding
    max_new_tokens: int
    min_new_tokens: int
    eos_token_id: int  # -1 disables EOS retirement
    greedy: bool
    temperature: float
    top_k: int  # 0 = no filter (engine normalizes >=vocab to 0)
    top_p: float
    generator: torch.Generator
    on_token: Optional[Callable[[int, int, bool], None]] = None
    submit_time: float = 0.0
    # admission limits resolved at submit (0 = off): queue_ttl_s bounds the
    # time WAITING for a lane, deadline_s the whole submit -> finish
    # lifetime; both retire with finish_reason="timeout"
    queue_ttl_s: float = 0.0
    deadline_s: float = 0.0
    # filled in by the engine over the request's lifecycle
    slot: Optional[int] = None
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    phase: str = "queued"
    prefill_pos: int = 0
    chunk_cache: Any = dataclasses.field(default=None, repr=False)
    # speculative decoding: lifetime proposed / accepted draft tokens
    spec_proposed: int = 0
    spec_accepted: int = 0
    kv_payloads: Any = dataclasses.field(default=None, repr=False)

    @property
    def prompt_len(self) -> int:
        """Number of real prompt tokens."""
        return int(self.prompt.shape[0])


class FIFOScheduler:
    """First-in-first-out admission queue over :class:`Request`."""

    def __init__(self):
        self._queue: collections.deque = collections.deque()

    def submit(self, request: Request) -> None:
        """Append a request to the tail of the admission queue."""
        self._queue.append(request)

    def pop_next(self) -> Optional[Request]:
        """Next request to admit (None when the queue is empty)."""
        return self._queue.popleft() if self._queue else None

    def requeue(self, request: Request) -> None:
        """Put a request back at the HEAD of the queue (it was the head
        when it left, and no token was emitted, so arrival order holds)."""
        self._queue.appendleft(request)

    def peek(self) -> Optional[Request]:
        """Next request WITHOUT removing it — page-granular admission
        inspects the head's prompt and only pops once admission is
        certain, so a too-big head blocks FIFO order instead of being
        dropped or reordered."""
        return self._queue[0] if self._queue else None

    def remove(self, request_id: int) -> Optional[Request]:
        """Pull one queued request out by id (None if not queued) — the
        ``cancel()`` path for requests that never won a lane."""
        for r in self._queue:
            if r.id == request_id:
                self._queue.remove(r)
                return r
        return None

    def snapshot(self) -> tuple:
        """Immutable view of the queue for the engine's transactional tick:
        taken before device work, handed back to :meth:`restore` if the
        tick fails (the requests themselves are restored field by field by
        the engine)."""
        return tuple(self._queue)

    def restore(self, snap: tuple) -> None:
        """Reinstate a queue captured by :meth:`snapshot`."""
        self._queue = collections.deque(snap)

    def drain_all(self) -> List[Request]:
        """Remove and return every queued request (a shutdown's grace
        window closed: whatever never won a lane retires with no
        tokens)."""
        out = list(self._queue)
        self._queue.clear()
        return out

    def pop_expired(self, now: float) -> List[Request]:
        """Remove and return every queued request whose queue TTL or total
        deadline has passed at ``now``; the survivors keep their order."""
        if not any(r.queue_ttl_s or r.deadline_s for r in self._queue):
            return []
        dead, keep = [], collections.deque()
        for r in self._queue:
            waited = now - r.submit_time
            if ((r.queue_ttl_s and waited > r.queue_ttl_s)
                    or (r.deadline_s and waited > r.deadline_s)):
                dead.append(r)
            else:
                keep.append(r)
        self._queue = keep
        return dead

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a slot."""
        return len(self._queue)

    def queued_tokens(self) -> int:
        """Prompt tokens waiting in the queue (the engine adds in-flight
        chunked-prefill remainders on top)."""
        return sum(r.prompt_len for r in self._queue)
