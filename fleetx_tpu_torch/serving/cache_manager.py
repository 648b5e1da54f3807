"""KV cache bookkeeping for the serving engine: the slot cache, the paged
cache, and the host and disk page tiers under it.

Port of the JAX package's ``serving/cache_manager.py``.

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

Page tiers: with a store attached, LRU eviction of a zero-ref warm trie
subtree SPILLS each page (every pool leaf: K, V and, at int8, the scales)
to the store instead of destroying it, keyed by the page's token-chunk path
from the trie root. A later prompt with the same prefix revives the
entries into fresh physical pages — one batched transfer and one
``index_copy_`` per pool leaf — and skips their prefill. Keys are content
addresses, so an entry outlives the pool that spilled it (the engine
threads one store through ``recover()``'s rebuilt manager) and identical
tokens always mean identical K/V. :class:`HostPageStore` is a byte-bounded
LRU dict in host memory; :class:`DiskPageStore` keeps one file per page
under a directory many replicas share (file names are the sha256 of the
token chunks, as the JAX package names them, so a JAX replica and a port
replica share one directory); :class:`TieredPageStore` stacks them.

A page's payload is the list of its leaves in the JAX package's
``jax.tree.leaves`` order of the scanned-layers cache — ``cache_index``
(None), ``cached_key``, [``cached_key_scale``], ``cached_value``,
[``cached_value_scale``] — each a host tensor ``[L, page_size, heads,
head_dim]`` (``[..., 1]`` for a scale). :meth:`HostPageStore.
payload_to_bytes` writes it in the JAX package's crc32-trailed wire
format, byte for byte. A payload whose leaves do not match the pool (a
JAX replica with unrolled layers writes one leaf set per layer) is
refused, never scattered.
"""

from __future__ import annotations

import hashlib
import heapq
import os
import struct
import time
import weakref
import zlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fleetx_tpu_torch.models.gpt.generation import init_decode_cache
from fleetx_tpu_torch.obs.events import emit as obs_emit
from fleetx_tpu_torch.utils.log import logger

__all__ = ["DiskPageStore", "HostPageStore", "PagePool",
           "PagedKVCacheManager", "SlotKVCacheManager", "TieredPageStore",
           "payload_nbytes", "scatter_slot"]

# the wire format's dtype names (numpy's ``dtype.name``, which the JAX
# package writes; ``bfloat16`` is ml_dtypes' name) and their torch dtypes
_WIRE_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                "bfloat16": torch.bfloat16, "float64": torch.float64,
                "int8": torch.int8, "uint8": torch.uint8,
                "int16": torch.int16, "int32": torch.int32,
                "int64": torch.int64, "bool": torch.bool}
_WIRE_NAMES = {v: k for k, v in _WIRE_DTYPES.items()}


def payload_nbytes(payload) -> int:
    """Bytes of a page payload's leaves (None leaves count nothing)."""
    return sum(a.numel() * a.element_size() if torch.is_tensor(a)
               else int(np.asarray(a).nbytes)
               for a in payload if a is not None)


def _leaf_wire(arr) -> Tuple[str, tuple, bytes]:
    """``(dtype name, shape, raw C-order bytes)`` of one payload leaf: a
    torch tensor (bf16 written as its raw 2-byte words) or a numpy
    array."""
    if torch.is_tensor(arr):
        t = arr.detach().to("cpu").contiguous()
        name = _WIRE_NAMES.get(t.dtype)
        if name is None:
            raise ValueError(f"payload leaf dtype {t.dtype} has no wire "
                             "name; only numeric cache leaves spill")
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16
               else t).numpy().tobytes()
        return name, tuple(t.shape), raw
    a = np.ascontiguousarray(arr)
    if a.dtype.names is not None or a.dtype.hasobject:
        raise ValueError(f"payload leaf dtype {a.dtype} is not a plain "
                         "array dtype; only numeric cache leaves spill")
    return a.dtype.name, a.shape, a.tobytes()


def _leaf_from_wire(name: str, shape: tuple, raw) -> torch.Tensor:
    dtype = _WIRE_DTYPES.get(name)
    if dtype is None:
        raise ValueError(f"payload leaf dtype {name!r} is not one the port "
                         "reads")
    if dtype == torch.bfloat16:
        words = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    return torch.from_numpy(
        np.frombuffer(raw, dtype=np_dtype).reshape(shape).copy())


class HostPageStore:
    """Bounded host-memory page tier (module docstring).

    A byte-budgeted LRU dict: ``key`` is a page's token-chunk path (a
    tuple of full-page token tuples from the trie root), the payload its
    per-leaf host tensors. Capacity pressure drops the OLDEST entries
    (``evicted_pages``); a payload larger than the whole budget is refused.
    The tier is inclusive: :meth:`get` leaves the entry in place, so a
    page revived into a pool that a fault then destroys revives again."""

    def __init__(self, capacity_bytes: int):
        if capacity_bytes < 0:
            raise ValueError(
                f"capacity_bytes must be >= 0, got {capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self._entries: Dict[tuple, Tuple[object, int]] = {}  # insertion=LRU
        self.nbytes = 0
        self.spilled_pages = 0  # lifetime puts accepted
        self.revived_pages = 0  # lifetime gets on a prefix match
        self.evicted_pages = 0  # lifetime drops under the budget

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def put(self, key, payload, nbytes: int) -> bool:
        """Insert one spilled page, evicting the oldest entries until it
        fits; False (nothing stored) when ``nbytes`` exceeds the budget.
        Re-putting a key refreshes its payload and LRU place."""
        if nbytes > self.capacity_bytes:
            return False
        old = self._entries.pop(key, None)
        if old is not None:
            self.nbytes -= old[1]
        while self.nbytes + nbytes > self.capacity_bytes and self._entries:
            k = next(iter(self._entries))
            self.nbytes -= self._entries.pop(k)[1]
            self.evicted_pages += 1
        self._entries[key] = (payload, nbytes)
        self.nbytes += nbytes
        self.spilled_pages += 1
        return True

    def get(self, key):
        """A matched page's payload, refreshing its LRU place; the entry
        stays. KeyError if absent."""
        payload, nbytes = self._entries.pop(key)
        self._entries[key] = (payload, nbytes)
        self.revived_pages += 1
        return payload

    def pop(self, key):
        """Remove and return an entry's payload. KeyError if absent."""
        payload, nbytes = self._entries.pop(key)
        self.nbytes -= nbytes
        return payload

    def check_invariants(self) -> None:
        """Byte accounting matches the entries and respects the budget."""
        want = sum(nb for _, nb in self._entries.values())
        assert self.nbytes == want, (
            f"host store nbytes {self.nbytes} != sum of entries {want}")
        assert self.nbytes <= self.capacity_bytes, (
            f"host store over budget: {self.nbytes} > {self.capacity_bytes}")

    # The wire format of one payload (little-endian): magic "FXPG", u16
    # version 2, u16 entry count; per entry a flag byte (0: None; 1: an
    # array, then a u8-length dtype name, a u8 ndim, u32 dims and a u64
    # byte count before the raw C-order bytes); a crc32 of everything
    # before it trails the blob. Version 1 (no crc) is refused.

    _MAGIC = b"FXPG"
    _VERSION = 2

    @staticmethod
    def payload_to_bytes(payload) -> bytes:
        """Serialize one payload (a list of ``Optional`` tensors or numpy
        arrays) to the wire format above, byte-identical to the JAX
        package's blob of the same values."""
        out = [HostPageStore._MAGIC,
               struct.pack("<HH", HostPageStore._VERSION, len(payload))]
        for arr in payload:
            if arr is None:
                out.append(b"\x00")
                continue
            name, shape, raw = _leaf_wire(arr)
            name = name.encode("ascii")
            out.append(b"\x01")
            out.append(struct.pack("<B", len(name)))
            out.append(name)
            out.append(struct.pack("<B", len(shape)))
            out.append(struct.pack(f"<{len(shape)}I", *shape))
            out.append(struct.pack("<Q", len(raw)))
            out.append(raw)
        body = b"".join(out)
        return body + struct.pack("<I", zlib.crc32(body))

    @staticmethod
    def payload_from_bytes(buf) -> list:
        """Inverse of :meth:`payload_to_bytes`: a list of ``Optional`` CPU
        tensors. The crc32 trailer is checked before any entry is parsed;
        a malformed, truncated, corrupted or v1 blob raises ValueError."""
        view = memoryview(buf)
        if bytes(view[:4]) != HostPageStore._MAGIC:
            raise ValueError("not a HostPageStore payload (bad magic)")
        if len(view) < 12:  # magic + header + crc32 trailer
            raise ValueError(
                f"truncated payload: {len(view)} bytes is shorter than the "
                "8-byte header + 4-byte crc32 trailer")
        version, count = struct.unpack("<HH", view[4:8])
        if version != HostPageStore._VERSION:
            raise ValueError(
                f"unsupported payload version {version}: this build reads "
                f"v{HostPageStore._VERSION} (crc32-trailed); v1 predates "
                "the checksum — re-spill the page with a current build")
        (want_crc,) = struct.unpack("<I", view[-4:])
        got_crc = zlib.crc32(view[:-4])
        if got_crc != want_crc:
            raise ValueError(
                f"payload crc32 mismatch (stored {want_crc:#010x}, "
                f"computed {got_crc:#010x}): the page was corrupted in "
                "flight or at rest")
        end = len(view) - 4
        pos, out = 8, []
        try:
            for _ in range(count):
                flag = view[pos]
                pos += 1
                if flag == 0:
                    out.append(None)
                    continue
                nlen = view[pos]
                pos += 1
                name = bytes(view[pos:pos + nlen]).decode("ascii")
                pos += nlen
                ndim = view[pos]
                pos += 1
                shape = struct.unpack(f"<{ndim}I", view[pos:pos + 4 * ndim])
                pos += 4 * ndim
                (nbytes,) = struct.unpack("<Q", view[pos:pos + 8])
                pos += 8
                if pos + nbytes > end:
                    raise ValueError("entry runs past the crc trailer")
                out.append(_leaf_from_wire(name, shape,
                                           view[pos:pos + nbytes]))
                pos += nbytes
        except (struct.error, ValueError, IndexError, TypeError,
                UnicodeDecodeError) as e:
            raise ValueError(f"truncated/corrupt payload: {e}") from None
        if pos != end:
            raise ValueError(
                f"payload has {end - pos} trailing bytes before the crc")
        return out


def _weak_method(method: Callable) -> Callable:
    """``method`` without a strong reference to its object: a pool's hooks
    must not keep their manager, and its device storage, alive in a cycle
    that only the garbage collector would break."""
    ref = weakref.WeakMethod(method)
    return lambda *args: ref()(*args)


class DiskPageStore:
    """Content-addressed, byte-bounded page tier on a shared directory
    (``FLEETX_SERVING_DISK_CACHE_DIR`` / ``_BYTES``).

    The :class:`HostPageStore` surface over files: one file per page,
    named by the sha256 of its token-chunk path (the JAX package's names,
    so replicas of either package share the directory), holding the
    crc32-trailed wire format. Writes are atomic (a temp file, then a
    rename); eviction drops the oldest files by mtime (``get`` touches a
    file), coherent across the processes sharing the directory; a write
    that fails (a full or read-only directory) stores nothing and returns
    False. Capacity counts the files' bytes.

    A put keeps the budget from this instance's view of the directory
    (its files in mtime order and their bytes), kept current by its own
    puts, gets and removals and listed anew at most every ``rescan_s``
    seconds, when a sibling's writes show up; so a put costs no listing
    of the directory, and the per-tick gauge (:attr:`cached_nbytes`)
    none either. :attr:`nbytes` lists it."""

    _SUFFIX = ".fxpg"
    #: seconds a put trusts this instance's view of the directory
    rescan_s = 1.0

    def __init__(self, cache_dir: str, capacity_bytes: int):
        if capacity_bytes < 0:
            raise ValueError(
                f"capacity_bytes must be >= 0, got {capacity_bytes}")
        if not cache_dir:
            raise ValueError("cache_dir must be a non-empty path")
        self.cache_dir = str(cache_dir)
        self.capacity_bytes = int(capacity_bytes)
        os.makedirs(self.cache_dir, exist_ok=True)
        self.spilled_pages = 0  # lifetime puts accepted (this instance)
        self.revived_pages = 0  # lifetime gets served
        self.evicted_pages = 0  # lifetime files dropped under the budget
        self.hits = 0           # gets served
        self.misses = 0         # membership probes that found nothing
        self._view: Optional[OrderedDict] = None  # path -> bytes, oldest 1st
        self._view_bytes = 0
        self._view_at = 0.0

    def _path(self, key) -> str:
        """A key's file: sha256 over its int64 chunks, each followed by
        ``/`` (so ``((1, 2),)`` and ``((1,), (2,))`` differ)."""
        h = hashlib.sha256()
        for chunk in key:
            h.update(np.asarray(chunk, np.int64).tobytes())
            h.update(b"/")
        return os.path.join(self.cache_dir, h.hexdigest() + self._SUFFIX)

    def _files(self):
        """``(path, stat)`` of every store file, oldest mtime first; files
        a sibling process removed meanwhile are skipped."""
        out = []
        try:
            names = os.listdir(self.cache_dir)
        except OSError:
            return []
        for name in names:
            if not name.endswith(self._SUFFIX):
                continue
            path = os.path.join(self.cache_dir, name)
            try:
                out.append((path, os.stat(path)))
            except OSError:
                continue
        out.sort(key=lambda ps: (ps[1].st_mtime, ps[0]))
        return out

    def __len__(self) -> int:
        return len(self._files())

    @property
    def nbytes(self) -> int:
        """Bytes of the directory's page files (every writer's), listed."""
        return sum(st.st_size for _, st in self._files())

    @property
    def cached_nbytes(self) -> int:
        """The directory's bytes as of this instance's last listing, with
        its own writes and removals since; lists only the first time."""
        if self._view is None:
            self._refresh(force=True)
        return self._view_bytes

    def _refresh(self, force: bool = False) -> None:
        """List the directory into the view when it is older than
        ``rescan_s`` (or ``force``)."""
        now = time.monotonic()
        if force or self._view is None or now - self._view_at >= self.rescan_s:
            self._view = OrderedDict(
                (path, st.st_size) for path, st in self._files())
            self._view_bytes = sum(self._view.values())
            self._view_at = now

    def _forget(self, path: str) -> None:
        if self._view is not None:
            self._view_bytes -= self._view.pop(path, 0)

    def _saw(self, path: str, size: int) -> None:
        """``path`` holds ``size`` bytes and is the newest file."""
        if self._view is not None:
            self._forget(path)
            self._view[path] = size
            self._view_bytes += size

    def __contains__(self, key) -> bool:
        if os.path.exists(self._path(key)):
            return True
        self.misses += 1
        return False

    def put(self, key, payload, nbytes: int = 0) -> bool:
        """Serialize and store one page, evicting the oldest files until
        the budget holds; False (nothing stored) when the blob alone
        exceeds it or the write fails. ``nbytes`` is ignored: the file's
        bytes are what counts."""
        del nbytes
        blob = HostPageStore.payload_to_bytes(payload)
        if len(blob) > self.capacity_bytes:
            return False
        path = self._path(key)
        tmp = path + f".tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)  # readers see the old bytes or the new
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False
        self.spilled_pages += 1
        self._refresh()
        self._saw(path, len(blob))
        if self._view_bytes > self.capacity_bytes:
            for victim in list(self._view):
                if victim == path:
                    continue  # never the page just written
                self._forget(victim)
                try:
                    os.remove(victim)
                except OSError:
                    continue  # a sibling removed it first
                self.evicted_pages += 1
                if self._view_bytes <= self.capacity_bytes:
                    break
        return True

    def get(self, key):
        """A stored page's payload, touching its mtime. KeyError when
        absent; ValueError when the file is corrupt (the file is removed,
        so the entry reads as absent afterwards)."""
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            raise KeyError(key) from None
        try:
            payload = HostPageStore.payload_from_bytes(blob)
        except ValueError:
            self._forget(path)
            try:
                os.remove(path)
            except OSError:
                pass
            self.misses += 1
            raise
        try:
            os.utime(path)
            self._saw(path, len(blob))
        except OSError:
            self._forget(path)  # a sibling evicted it mid-read
        self.revived_pages += 1
        self.hits += 1
        return payload

    def pop(self, key):
        """Remove and return an entry's payload. KeyError if absent or
        corrupt (a corrupt file is removed either way)."""
        try:
            payload = self.get(key)
        except ValueError:
            raise KeyError(key) from None
        self.hits -= 1  # a pop is not a hit
        self.revived_pages -= 1
        path = self._path(key)
        self._forget(path)
        try:
            os.remove(path)
        except OSError:
            pass
        return payload

    def check_invariants(self) -> None:
        """The directory's bytes respect the budget (a single file may
        overshoot it only when a sibling wrote after this instance's last
        eviction)."""
        total = self.nbytes
        assert total <= self.capacity_bytes or len(self._files()) <= 1, (
            f"disk store over budget: {total} > {self.capacity_bytes}")


class TieredPageStore:
    """The host tier over the disk tier, behind one store surface: puts
    write through to both, gets serve host-first and promote a disk hit
    into the host tier (the engine syncs each tier's counters apart)."""

    def __init__(self, host: HostPageStore, disk: DiskPageStore):
        self.host = host
        self.disk = disk

    def __contains__(self, key) -> bool:
        return key in self.host or key in self.disk

    def put(self, key, payload, nbytes: int) -> bool:
        """Write-through: True when either tier kept the page."""
        kept_host = self.host.put(key, payload, nbytes)
        kept_disk = self.disk.put(key, payload, nbytes)
        return kept_host or kept_disk

    def get(self, key):
        """Host tier first; a disk hit is promoted into the host tier."""
        try:
            return self.host.get(key)
        except KeyError:
            pass
        payload = self.disk.get(key)
        self.host.put(key, payload, payload_nbytes(payload))
        return payload

    def pop(self, key):
        """Invalidate in both tiers; the payload of whichever had it."""
        payload = None
        try:
            payload = self.host.pop(key)
        except KeyError:
            pass
        try:
            disk_payload = self.disk.pop(key)
            payload = payload if payload is not None else disk_payload
        except KeyError:
            pass
        if payload is None:
            raise KeyError(key)
        return payload

    def check_invariants(self) -> None:
        self.host.check_invariants()
        self.disk.check_invariants()


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
    matched or registered: every page is private to its lane.

    With a page store (``host_store``, and the manager's ``spill_fn`` /
    ``revive_fn``) an evicted subtree spills to it, and :meth:`alloc`
    continues a trie match into the store, reviving the entries into
    fresh pages; ``check_fn`` refuses a stored payload that does not fit
    the pool (read as a miss, like a corrupt file)."""

    def __init__(self, num_pages: int, page_size: int, lanes: int,
                 lane_pages: int, prefix_cache: bool = True,
                 host_store=None, spill_fn: Optional[Callable] = None,
                 revive_fn: Optional[Callable] = None,
                 check_fn: Optional[Callable] = None):
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
        # the page tier, live only with the trie (entries are matched by
        # token-chunk path) and both device callbacks
        self.host_store = (host_store if prefix_cache and spill_fn
                           and revive_fn else None)
        self._spill_fn = spill_fn
        self._revive_fn = revive_fn
        self._check_fn = check_fn

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

    @property
    def cached_pages(self) -> int:
        """Refcount-0 pages kept warm in the trie (reclaimable)."""
        return len(self._cached)

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

    @staticmethod
    def _node_key(node: _TrieNode) -> tuple:
        """A node's token-chunk path from the root: the content address
        its spilled payload is stored under."""
        parts = []
        while node is not None and node.key is not None:
            parts.append(node.key)
            node = node.parent
        return tuple(reversed(parts))

    def _evict_subtree(self, node: _TrieNode) -> None:
        """Reclaim a zero-ref cached subtree's physical pages, spilling
        them to the page store first when one is attached (one batched
        device read for the whole subtree)."""
        if node.parent is not None:
            del node.parent.children[node.key]
        victims: List[_TrieNode] = []
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            victims.append(n)
        if self.host_store is not None:
            keys = [self._node_key(n) for n in victims]
            for (payload, nbytes), key in zip(
                    self._spill_fn([n.page for n in victims]), keys):
                self.host_store.put(key, payload, nbytes)
        for n in victims:
            self._cached.pop(n.page, None)
            del self._node_of_page[n.page]
            self._free.append(n.page)
            n.children = {}
            n.parent = None

    def _match_host(self, chunks: List[tuple],
                    path: List[_TrieNode]) -> List[tuple]:
        """The chunk paths continuing the trie match ``path`` that the
        page store holds, up to the first miss (a revived page is only
        attendable when every page before it is present)."""
        if self.host_store is None:
            return []
        key = self._node_key(path[-1]) if path else ()
        out = []
        for c in chunks[len(path):]:
            key = key + (c,)
            if key not in self.host_store:
                break
            out.append(key)
        return out

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
        prefix pages from the trie (refcount++), stored prefix pages
        revived into fresh pages (one batched device write), plus fresh
        refcount-1 pages covering the rest of ``[0, prompt_len]``. Returns
        the shared prefix length in TOKENS (trie-shared and revived pages
        both skip their prefill), or None — with nothing committed — when
        the pool cannot supply the pages (a revived page costs a fresh
        one, so :meth:`pages_needed` counts it)."""
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
        # the stored payloads BEFORE drawing pages: a draw may spill more,
        # and the store's budget could drop an entry this alloc revives
        host_keys = self._match_host(chunks, path)
        payloads = []
        for k in host_keys:
            try:
                payload = self.host_store.get(k)
                if self._check_fn is not None:
                    self._check_fn(payload)
            except (KeyError, ValueError) as e:
                # a sibling replica evicted the file (KeyError), it failed
                # its crc or does not fit this pool (ValueError): this key
                # and every deeper one read as misses and are prefilled
                if isinstance(e, ValueError):
                    logger.warning("serving: page store entry refused, "
                                   "read as a miss: %s", e)
                break
            payloads.append(payload)
        host_keys = host_keys[:len(payloads)]
        row = self.tables[lane]
        row[:] = 0
        for i, n in enumerate(path):
            row[i] = n.page
        parent = path[-1] if path else self._root
        revive = []
        for j, key in enumerate(host_keys):
            # revived pages re-enter the trie as registered pages (refcount
            # 1, shareable at once) at fresh physical homes
            page = self._take_page()
            self.ref[page] = 1
            row[len(path) + j] = page
            node = _TrieNode(key[-1], page, parent)
            parent.children[key[-1]] = node
            self._node_of_page[page] = node
            parent = node
            revive.append((page, payloads[j]))
        for i in range(len(path) + len(host_keys), need_total):
            page = self._take_page()
            self.ref[page] = 1
            row[i] = page
        if revive:
            self._revive_fn(revive)
        self.alloc_counts[lane] = need_total
        self.version += 1
        return (len(path) + len(host_keys)) * self.page_size

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
        """Assert page conservation and refcounts (and the page store's
        byte accounting); AssertionError names the breach."""
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
        if self.host_store is not None:
            self.host_store.check_invariants()


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
                 page_size: int, prefix_cache: bool = True, device=None,
                 host_store=None):
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
        self.host_store = host_store
        self.pool = PagePool(num_pages, page_size, slots,
                             cache_len // page_size, prefix_cache,
                             host_store=host_store,
                             spill_fn=_weak_method(self._spill_pages),
                             revive_fn=_weak_method(self._revive_pages),
                             check_fn=_weak_method(self.check_payload))
        self.cache: Dict[str, torch.Tensor] = init_decode_cache(model,
                                                               device=device)
        # the payload's leaves in the JAX cache tree's order (module
        # docstring): cache_index (None), key[, key_scale], value[, ...]
        self.payload_leaves = (None,) + tuple(
            name for name in ("key", "key_scale", "value", "value_scale")
            if name in self.cache)

    # ------------------------------------------------------- page tiers

    def check_payload(self, payload) -> List[Optional[torch.Tensor]]:
        """``payload`` as host tensors, after checking that it is one page
        of this pool: its leaves in :attr:`payload_leaves` order, each
        ``[L, page_size, heads, head_dim]`` (scales ``[..., 1]``) in the
        pool's dtype. ValueError otherwise — such a page is never
        written."""
        names = self.payload_leaves
        if len(payload) != len(names):
            raise ValueError(
                f"a page payload of {len(payload)} leaves does not match "
                f"this pool's {len(names)} (cache_index, "
                f"{', '.join(names[1:])}); a JAX replica with unrolled "
                "layers writes one leaf set per layer")
        out = []
        for name, leaf in zip(names, payload):
            if name is None:
                if leaf is not None:
                    raise ValueError("a page payload's cache_index leaf "
                                     "must be empty")
                out.append(None)
                continue
            if leaf is None:
                raise ValueError(f"a page payload lacks its {name} leaf")
            if not torch.is_tensor(leaf):
                try:
                    leaf = torch.from_numpy(np.ascontiguousarray(leaf))
                except TypeError as e:
                    raise ValueError(f"page payload leaf {name}: {e}") \
                        from None
            pool = self.cache[name]
            want = (pool.shape[0],) + tuple(pool.shape[2:])
            if tuple(leaf.shape) != want or leaf.dtype != pool.dtype:
                raise ValueError(
                    f"page payload leaf {name} is {tuple(leaf.shape)} "
                    f"{leaf.dtype}; this pool's pages are {want} "
                    f"{pool.dtype}")
            out.append(leaf)
        return out

    def _spill_pages(self, pages: List[int]) -> List[Tuple[list, int]]:
        """Read ``pages`` out of the device pool as host payloads, one
        ``index_select`` and one device-to-host copy per pool leaf for the
        whole list; returns ``(payload, nbytes)`` per page."""
        idx = torch.tensor(pages, dtype=torch.long, device=self._device)
        per_leaf = [None if name is None else
                    self.cache[name].index_select(1, idx).movedim(1, 0)
                    .contiguous().to("cpu")
                    for name in self.payload_leaves]
        out = []
        for j in range(len(pages)):
            payload = [None if a is None else a[j] for a in per_leaf]
            out.append((payload, payload_nbytes(payload)))
        obs_emit("page_spill", pages=len(pages))
        return out

    def _revive_pages(self, entries: List[Tuple[int, list]]) -> None:
        """Write ``(physical page, payload)`` entries into the device pool,
        one host-to-device copy and one ``index_copy_`` per pool leaf.
        Every payload is checked first (:meth:`check_payload`): nothing is
        written unless all fit."""
        checked = [self.check_payload(payload) for _, payload in entries]
        idx = torch.tensor([p for p, _ in entries], dtype=torch.long,
                           device=self._device)
        for i, name in enumerate(self.payload_leaves):
            if name is None:
                continue
            upd = torch.stack([payload[i] for payload in checked])
            self.cache[name].index_copy_(
                1, idx, upd.to(self._device).movedim(0, 1))
        obs_emit("page_revive", pages=len(entries))

    def read_pages(self, pages: List[int]) -> List[list]:
        """Physical ``pages`` as host payloads (the prefill role's export:
        the spill tier's batched reads)."""
        return [payload for payload, _ in self._spill_pages(pages)]

    def revive_pages(self, entries: List[Tuple[int, list]]) -> None:
        """Write ``(physical page, payload)`` entries into the pool (the
        decode role's shipped admission: the revive path). The pages must
        already belong to the receiving lane."""
        self._revive_pages(entries)

    @property
    def _device(self) -> torch.device:
        return self.cache["key"].device

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
