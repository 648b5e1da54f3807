"""KV cache bookkeeping for the serving engine: the slot cache and the
paged cache.

Port of the JAX package's ``serving/cache_manager.py`` without its host and
disk page tiers (ROADMAP Queue A, "Serving features still missing").

The SLOT cache (:class:`SlotKVCacheManager`, ``FLEETX_SERVING_PAGED=0``) is
one contiguous ``[L, slots, cache_len, heads, head_dim]`` buffer per K and
V: lane ``s`` owns row ``s`` whole, and a prompt is prefilled into a batch-1
cache that :func:`scatter_slot` copies into its row. Inactive lanes ride the
batched decode step with their write pinned to the row's last positions; a
row only ever attends ``[0, length)``, so stale rows stay dark.

The PAGED cache: K/V live in one shared pool of
``[num_pages, page_size, heads, head_dim]`` pages per layer (int8 with
``[num_pages, page_size, heads, 1]`` fp32 scale pools when the model's
``decode_kv_dtype`` is int8: a page's scales ride the same page index);
each decode lane holds a block table of page indices, and a refcounted
prefix trie lets requests that share whole prompt pages reuse one prefill.

Safety without zeroing: physical page 0 is the TRASH page. It is never
handed to a request, and every unallocated block-table entry is 0, so a
write routed through one (an inactive lane riding the batched decode step,
a bucket-tail position past a row's last page) lands on page 0. A row only
ever attends its live window ``[0, length)``, whose pages it owns, so
neither the trash page nor a freed page's stale K/V is ever read.

:class:`PagePool` is pure host state (numpy, no tensors);
:class:`PagedKVCacheManager` adds the device pools and the decode lanes.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from fleetx_tpu_torch.models.gpt.generation import init_decode_cache

__all__ = ["PagePool", "PagedKVCacheManager", "SlotKVCacheManager",
           "scatter_slot"]


def scatter_slot(cache: Dict, small: Dict, slot: int) -> Dict:
    """Copy a batch-1 contiguous cache (``small``: ``[L, 1, cache_len, h,
    *]`` tensors) into row ``slot`` of the slot cache ``cache`` (``[L,
    slots, cache_len, h, *]``), in place, and return ``cache`` (JAX
    ``scatter_slot``, which returns a new tree). Non-tensor entries (the
    scalar ``index``) are left alone: per-lane progress lives in the
    manager."""
    for name, big in cache.items():
        if torch.is_tensor(big):
            big[:, slot] = small[name][:, 0]
    return cache


class _LaneBook:
    """Decode-lane bookkeeping: a min-heap free list (lowest lane first,
    deterministic), per-lane request ids, and the host mirror of per-lane
    live lengths."""

    def _init_lanes(self, slots: int) -> None:
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        self.slots = slots
        self.lengths = np.zeros(slots, np.int64)
        self.request_ids: List[Optional[int]] = [None] * slots
        self._free: List[int] = list(range(slots))

    @property
    def free_count(self) -> int:
        """Number of decode lanes available for admission."""
        return len(self._free)

    @property
    def active_count(self) -> int:
        """Number of decode lanes currently holding a live request."""
        return self.slots - len(self._free)

    def cache_nbytes(self) -> int:
        """Bytes of the device cache: K/V values plus, at int8, their fp32
        scales."""
        return sum(t.numel() * t.element_size() for t in self.cache.values()
                   if torch.is_tensor(t))

    def _check_lanes(self) -> None:
        """Assert the lane book: the free list and the tenants partition
        the lanes, and a free lane holds no length."""
        free = set(self._free)
        assert len(free) == len(self._free), "a lane is free twice"
        for lane in range(self.slots):
            held = self.request_ids[lane] is not None
            assert held != (lane in free), (
                f"lane {lane} is {'held and free' if held else 'lost'}")
            assert held or self.lengths[lane] == 0, (
                f"free lane {lane} keeps length {self.lengths[lane]}")

    def _claim_lane(self, request_id: int, length: int) -> int:
        lane = heapq.heappop(self._free)
        self.request_ids[lane] = request_id
        self.lengths[lane] = length
        return lane

    def _release_lane(self, slot: int) -> None:
        if self.request_ids[slot] is None:
            raise ValueError(f"slot {slot} is already free")
        self.request_ids[slot] = None
        self.lengths[slot] = 0
        heapq.heappush(self._free, slot)


class SlotKVCacheManager(_LaneBook):
    """Fixed-slot decode cache plus lane bookkeeping (module docstring).

    ``cache`` holds the contiguous ``{"key", "value"}`` tensors ``[L,
    slots, cache_len, heads, head_dim]`` (and, at int8, their
    ``key_scale``/``value_scale``), updated in place by the engine's
    forwards."""

    def __init__(self, model, slots: int, cache_len: int, device=None):
        if (model.cfg.decode_cache_len or 0) != cache_len:
            raise ValueError(
                f"model.cfg.decode_cache_len ({model.cfg.decode_cache_len}) "
                f"must equal the manager's cache_len ({cache_len})")
        if model.cfg.decode_num_pages is not None:
            raise ValueError("a slot cache needs a model without "
                             "decode_num_pages")
        self._init_lanes(slots)
        self.cache_len = cache_len
        self.cache: Dict[str, torch.Tensor] = init_decode_cache(
            model, slots, cache_len=cache_len, device=device)

    def can_admit(self, tokens) -> bool:
        """A free lane (a slot row holds any prompt the engine accepts)."""
        return bool(self._free)

    def alloc(self, request_id: int, prompt_len: int) -> Optional[int]:
        """Claim the lowest free slot for ``request_id`` (None when full)."""
        if not self._free:
            return None
        if prompt_len > self.cache_len:
            raise ValueError(
                f"prompt_len {prompt_len} exceeds cache_len {self.cache_len}")
        return self._claim_lane(request_id, prompt_len)

    def free(self, slot: int) -> None:
        """Release ``slot`` for the next request. No zeroing: the live-
        window contract keeps stale rows invisible to the next tenant."""
        self._release_lane(slot)

    def check_invariants(self) -> None:
        """Assert the lane book and that every live length fits its row."""
        self._check_lanes()
        assert (self.lengths <= self.cache_len).all(), (
            f"a lane's length passes cache_len {self.cache_len}")


class _TrieNode:
    """One full page of prompt tokens in the prefix trie: ``key`` is the
    page's token tuple, ``page`` its physical index; children extend the
    prefix by one more full page."""

    __slots__ = ("key", "page", "parent", "children")

    def __init__(self, key, page: int, parent: "_TrieNode" = None):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[tuple, "_TrieNode"] = {}


class PagePool:
    """Host-side page allocator + refcounted prefix trie.

    Physical page 0 is the reserved trash page (module docstring): born
    with a permanent refcount, never on the free stack.

    A full prompt page is prefilled into a refcount-1 page, registered in
    the trie (:meth:`register_prefix`), and from then on other lanes'
    :meth:`alloc` calls can match it (refcount++). When its last holder
    frees, the page parks in ``_cached`` — content intact, trie node
    alive — where a later match revives it or LRU eviction reclaims it
    (evicting a node evicts its whole subtree: a child's refcount never
    exceeds its parent's, so nothing live is stranded). With
    ``prefix_cache`` off (``FLEETX_SERVING_PREFIX_CACHE=0``) nothing is
    matched or registered: every page is private to its lane."""

    def __init__(self, num_pages: int, page_size: int, lanes: int,
                 lane_pages: int, prefix_cache: bool = True):
        if page_size < 1:
            raise ValueError(f"page_size must be positive, got {page_size}")
        if num_pages < lane_pages + 1:
            raise ValueError(
                f"num_pages {num_pages} cannot hold one full lane "
                f"({lane_pages} pages) plus the trash page")
        self.num_pages = num_pages
        self.page_size = page_size
        self.lanes = lanes
        self.lane_pages = lane_pages
        self.prefix_cache = prefix_cache
        # block tables: 0 = trash page = "not allocated"
        self.tables = np.zeros((lanes, lane_pages), np.int32)
        self.alloc_counts = np.zeros(lanes, np.int64)
        self.ref = np.zeros(num_pages, np.int64)
        self.ref[0] = 1  # trash page: permanently pinned
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._root = _TrieNode(None, 0, None)
        self._node_of_page: Dict[int, _TrieNode] = {}
        # refcount-0 pages still in the trie, insertion order = LRU
        self._cached: Dict[int, _TrieNode] = {}
        # bumped on every block-table change so the engine re-uploads the
        # device copy only when something moved
        self.version = 0

    @property
    def usable_pages(self) -> int:
        """Pages available to requests (the pool minus the trash page)."""
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        """Pages obtainable right now: the free stack plus refcount-0
        cached pages (reclaimable by LRU eviction)."""
        return len(self._free) + len(self._cached)

    @property
    def pages_in_use(self) -> int:
        """Pages pinned by at least one live lane."""
        return self.usable_pages - self.free_pages

    def _chunks(self, tokens) -> List[tuple]:
        """Full-page token tuples of a prompt, capped so at least the last
        prompt token is always prefilled (its logits seed the first
        sampled token)."""
        n = (len(tokens) - 1) // self.page_size
        return [tuple(int(t) for t in
                      tokens[i * self.page_size:(i + 1) * self.page_size])
                for i in range(n)]

    def _match_path(self, chunks) -> List[_TrieNode]:
        path, node = [], self._root
        for c in chunks:
            node = node.children.get(c)
            if node is None:
                break
            path.append(node)
        return path

    def _take_page(self) -> Optional[int]:
        """Pop a free page; when the stack is dry, evict the LRU cached
        prefix subtree (all refcount-0 by the parent>=child invariant)."""
        if not self._free:
            if not self._cached:
                return None
            self._evict_subtree(next(iter(self._cached.values())))
        return self._free.pop()

    def _evict_subtree(self, node: _TrieNode) -> None:
        """Reclaim a zero-ref cached subtree's physical pages."""
        if node.parent is not None:
            del node.parent.children[node.key]
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self._cached.pop(n.page, None)
            del self._node_of_page[n.page]
            self._free.append(n.page)
            n.children = {}
            n.parent = None

    def pages_needed(self, tokens) -> int:
        """Pages an ``alloc`` of this prompt would draw from the free or
        reclaimable pool: fresh pages covering the non-shared part of
        ``[0, prompt_len]`` (the +1 slot is the first sampled token's write
        position), plus matched prefix pages parked in the warm cache."""
        chunks = self._chunks(tokens) if self.prefix_cache else []
        path = self._match_path(chunks)
        fresh = len(tokens) // self.page_size + 1 - len(path)
        revived = sum(1 for n in path if self.ref[n.page] == 0)
        return fresh + revived

    def can_admit(self, tokens) -> bool:
        """True iff ``alloc`` would succeed right now."""
        return self.pages_needed(tokens) <= self.free_pages

    def alloc(self, lane: int, tokens) -> Optional[int]:
        """Build ``lane``'s block table for prompt ``tokens``: shared
        prefix pages from the trie (refcount++) plus fresh refcount-1
        pages covering the rest of ``[0, prompt_len]``. Returns the shared
        prefix length in TOKENS, or None — with nothing committed — when
        the pool cannot supply the pages."""
        if self.alloc_counts[lane]:
            raise ValueError(f"lane {lane} already holds pages")
        need_total = len(tokens) // self.page_size + 1
        if need_total > self.lane_pages:
            raise ValueError(
                f"prompt of {len(tokens)} tokens needs {need_total} logical "
                f"pages; a lane holds {self.lane_pages}")
        chunks = self._chunks(tokens) if self.prefix_cache else []
        path = self._match_path(chunks)
        # commit the matched refs FIRST: revived pages leave _cached, so
        # the availability check sees the true reclaimable count and
        # eviction can no longer touch the matched path
        for n in path:
            if self.ref[n.page] == 0:
                del self._cached[n.page]
            self.ref[n.page] += 1
        fresh = need_total - len(path)
        if fresh > self.free_pages:
            for n in reversed(path):  # unwind: nothing committed
                self.ref[n.page] -= 1
                if self.ref[n.page] == 0:
                    self._cached[n.page] = n
            return None
        row = self.tables[lane]
        row[:] = 0
        for i, n in enumerate(path):
            row[i] = n.page
        for i in range(len(path), need_total):
            page = self._take_page()
            self.ref[page] = 1
            row[i] = page
        self.alloc_counts[lane] = need_total
        self.version += 1
        return len(path) * self.page_size

    def register_prefix(self, lane: int, tokens) -> None:
        """Insert ``lane``'s freshly-prefilled FULL prompt pages into the
        trie so later prompts can share them. Idempotent over the already-
        matched prefix; pages become shareable exactly when they will never
        be written again."""
        if not self.prefix_cache:
            return
        node = self._root
        row = self.tables[lane]
        for i, c in enumerate(self._chunks(tokens)):
            nxt = node.children.get(c)
            if nxt is None:
                nxt = _TrieNode(c, int(row[i]), node)
                node.children[c] = nxt
                self._node_of_page[nxt.page] = nxt
            node = nxt

    def ensure_page(self, lane: int, pos: int) -> bool:
        """Make logical position ``pos`` writable for ``lane`` (grow on
        demand). False = the pool is dry, or ``pos`` is past the lane's
        logical capacity."""
        li = pos // self.page_size
        if li < self.alloc_counts[lane]:
            return True
        if li >= self.lane_pages:
            return False
        page = self._take_page()
        if page is None:
            return False
        self.ref[page] = 1
        self.tables[lane, li] = page
        self.alloc_counts[lane] = li + 1
        self.version += 1
        return True

    def ensure_span(self, lane: int, pos: int, n: int) -> int:
        """Make as many of logical positions ``[pos, pos + n)`` writable for
        ``lane`` as the pool can supply, in order (the speculative verify's
        write: the pending token plus up to k drafts). Returns the count of
        LEADING covered positions: the engine clamps the lane's draft to
        ``covered - 1``, so no accepted token's K/V lands on the trash
        page, while the uncovered tail's writes route there harmlessly."""
        covered = 0
        for i in range(n):
            if not self.ensure_page(lane, pos + i):
                break
            covered += 1
        return covered

    def trim_lane(self, lane: int, live_tokens: int) -> int:
        """Release ``lane``'s pages beyond those covering its
        ``live_tokens`` valid positions — the speculative tick's cleanup
        after the verify, returning rejected-draft pages to the pool the
        same tick, so that a lane's draft window never starves a
        neighbour's next pending-token page (the plain engine would not
        have held them, and its ``cache_full`` decisions must be
        repeated). Only private (refcount-1, unregistered) tail pages go;
        returns how many."""
        need = (max(int(live_tokens), 1) - 1) // self.page_size + 1
        freed = 0
        for i in range(int(self.alloc_counts[lane]) - 1, need - 1, -1):
            page = int(self.tables[lane, i])
            if self.ref[page] != 1 or page in self._node_of_page:
                break  # a shared page past the live span cannot happen
            self.ref[page] = 0
            self._free.append(page)
            self.tables[lane, i] = 0
            self.alloc_counts[lane] = i
            freed += 1
        if freed:
            self.version += 1
        return freed

    def free(self, lane: int) -> None:
        """Release every page of ``lane``'s chain (refcount--). Zero-ref
        pages return to the free stack, or park in the LRU cache with
        content intact when they are trie-registered."""
        if not self.alloc_counts[lane]:
            raise ValueError(f"lane {lane} holds no pages (double-freed?)")
        row = self.tables[lane]
        for i in range(int(self.alloc_counts[lane])):
            page = int(row[i])
            if self.ref[page] <= 0:
                raise ValueError(f"page {page} of lane {lane} double-freed")
            self.ref[page] -= 1
            if self.ref[page] == 0:
                node = self._node_of_page.get(page)
                if node is not None:
                    self._cached[page] = node
                else:
                    self._free.append(page)
        row[:] = 0
        self.alloc_counts[lane] = 0
        self.version += 1

    def check_invariants(self) -> None:
        """Assert page conservation and refcounts; AssertionError names
        the breach."""
        held = set()
        counts = np.zeros(self.num_pages, np.int64)
        for lane in range(self.lanes):
            n = int(self.alloc_counts[lane])
            for p in self.tables[lane, :n]:
                assert p != 0, f"lane {lane} maps a live page to trash"
                held.add(int(p))
                counts[p] += 1
            assert not self.tables[lane, n:].any(), (
                f"lane {lane} has table entries past its {n} pages")
        free, cached = set(self._free), set(self._cached)
        assert not (free & cached) and not (free & held) \
            and not (cached & held), "a page is in two states at once"
        assert free | cached | held == set(range(1, self.num_pages)), (
            f"page conservation broken: {len(free)} free + {len(cached)} "
            f"cached + {len(held)} held != {self.num_pages - 1} usable")
        assert self.ref[0] >= 1, "trash page unpinned"
        assert (self.ref[1:] == counts[1:]).all(), (
            "refcounts disagree with the lanes' chains")


class PagedKVCacheManager(_LaneBook):
    """The device page pools plus lane bookkeeping.

    Decode *lanes* (batch rows of the decode step) are allocated lowest-
    free-first; storage admission is by PAGES: a lane is claimable only
    when :class:`PagePool` can cover the prompt, and the chain grows page
    by page as the request decodes. ``cache`` holds the ``{"key",
    "value"}`` pools ``[L, num_pages, page_size, heads, head_dim]`` (and,
    at int8, their ``key_scale``/``value_scale`` pools); ``tables`` the
    host block tables the engine uploads when ``version`` moves."""

    def __init__(self, model, slots: int, cache_len: int, num_pages: int,
                 page_size: int, prefix_cache: bool = True, device=None):
        if page_size % 8:
            raise ValueError(
                f"page_size must be a multiple of 8 (the decode kernel's "
                f"contract), got {page_size}")
        if cache_len % page_size:
            raise ValueError(f"cache_len {cache_len} must be a multiple of "
                             f"page_size {page_size}")
        cfg = model.cfg
        if (cfg.decode_cache_len, cfg.decode_num_pages,
                cfg.decode_page_size) != (cache_len, num_pages, page_size):
            raise ValueError(
                "model cfg (decode_cache_len, decode_num_pages, "
                f"decode_page_size) = ({cfg.decode_cache_len}, "
                f"{cfg.decode_num_pages}, {cfg.decode_page_size}) must match "
                f"the manager's ({cache_len}, {num_pages}, {page_size})")
        self._init_lanes(slots)
        self.cache_len = cache_len
        self.page_size = page_size
        self.num_pages = num_pages
        self.pool = PagePool(num_pages, page_size, slots,
                             cache_len // page_size, prefix_cache)
        self.cache: Dict[str, torch.Tensor] = init_decode_cache(model,
                                                               device=device)

    @property
    def tables(self) -> np.ndarray:
        """Host block tables [slots, cache_len // page_size] int32."""
        return self.pool.tables

    @property
    def tables_version(self) -> int:
        """Monotone counter: re-upload the device tables when it moves."""
        return self.pool.version

    @property
    def pages_in_use(self) -> int:
        """Pages pinned by live requests (trash page excluded)."""
        return self.pool.pages_in_use

    @property
    def usable_pages(self) -> int:
        """Pages the pool can hand to requests."""
        return self.pool.usable_pages

    def can_admit(self, tokens) -> bool:
        """A free lane AND enough free pages for this prompt right now."""
        return bool(self._free) and self.pool.can_admit(tokens)

    def alloc(self, request_id: int, tokens) -> Optional[Tuple[int, int]]:
        """Claim the lowest free lane + a page chain for prompt ``tokens``.
        Returns ``(lane, shared_len)`` — ``shared_len`` tokens of trie-
        shared prefix whose prefill is skipped — or None (nothing claimed)
        when lanes or pages are short."""
        if not self._free:
            return None
        if len(tokens) >= self.cache_len:
            raise ValueError(
                f"prompt_len {len(tokens)} leaves no decode room "
                f"(cache_len {self.cache_len})")
        lane = self._free[0]  # peek: only claim once pages are certain
        shared = self.pool.alloc(lane, tokens)
        if shared is None:
            return None
        claimed = self._claim_lane(request_id, len(tokens))
        assert claimed == lane  # heap head == the lane the pool filled
        return lane, shared

    def register_prefix(self, slot: int, tokens) -> None:
        """Publish ``slot``'s freshly-prefilled full prompt pages."""
        self.pool.register_prefix(slot, tokens)

    def ensure_page(self, slot: int) -> bool:
        """Grow ``slot``'s chain to cover its next write position
        (``lengths[slot]``); False = pool dry, the caller retires the
        request."""
        return self.pool.ensure_page(slot, int(self.lengths[slot]))

    def ensure_span(self, slot: int, n: int) -> int:
        """Grow ``slot``'s chain toward covering its next ``n`` write
        positions (the verify window: pending token + k drafts); returns
        how many leading positions are covered (:meth:`PagePool.
        ensure_span`)."""
        return self.pool.ensure_span(slot, int(self.lengths[slot]), n)

    def trim_span(self, slot: int) -> int:
        """Return ``slot``'s pages past its live prefix (rejected-draft
        territory) to the pool (:meth:`PagePool.trim_lane`)."""
        return self.pool.trim_lane(slot, int(self.lengths[slot]))

    def check_invariants(self) -> None:
        """Assert the pool's invariants, the lane book, and that between
        ticks every live lane's chain covers exactly its span: the pages
        holding ``[0, length)`` and at most the page of the next write —
        none left over from a verify window (:meth:`trim_span`)."""
        self.pool.check_invariants()
        self._check_lanes()
        ps = self.page_size
        for lane in range(self.slots):
            n, length = int(self.pool.alloc_counts[lane]), self.lengths[lane]
            if self.request_ids[lane] is None:
                assert n == 0, f"free lane {lane} holds {n} pages"
                continue
            assert (n - 1) * ps <= length <= n * ps, (
                f"lane {lane} holds {n} pages of {ps} for {length} live "
                "positions")

    def free(self, slot: int) -> None:
        """Release the lane and its page chain (no zeroing: see the module
        docstring)."""
        if self.request_ids[slot] is None:
            raise ValueError(f"slot {slot} is already free")
        self.pool.free(slot)
        self._release_lane(slot)
