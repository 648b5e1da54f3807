"""The port's host and disk page tiers against the JAX package.

The wire format of a spilled page is byte-identical in both packages (bf16,
int8 and fp32 leaves; JAX writes numpy arrays, the port torch tensors) and
each package decodes the other's blobs bit for bit; a truncated, flipped,
v1 or padded blob raises ValueError. ``DiskPageStore`` names its files as
JAX's does, so the two packages share one directory. ``PagePool`` under a
seeded spill/revive churn builds the same page tables and spills the same
keys as JAX's. An engine with a host and a disk tier gives JAX's engine's
greedy streams and spill/revive counts, and a directory written by either
package's engine is revived by the other's (``prewarm``).
"""

import os
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from fleetx_tpu.serving.cache_manager import DiskPageStore as JaxDiskStore
from fleetx_tpu.serving.cache_manager import HostPageStore as JaxHostStore
from fleetx_tpu.serving.cache_manager import PagePool as JaxPagePool
from fleetx_tpu_torch.serving.cache_manager import (
    DiskPageStore,
    HostPageStore,
    PagePool,
    TieredPageStore,
)
from torch_serving_cases import jax_engine, port_engine, weights

TO, FROM = HostPageStore.payload_to_bytes, HostPageStore.payload_from_bytes


@pytest.fixture(scope="module")
def w():
    return weights()


def _numpy_payload(seed=0):
    """A page payload as the JAX engine spills it: a None cache_index,
    bf16 and fp32 pages, an int8 page and its fp32 scales."""
    rng = np.random.RandomState(seed)
    return [None,
            rng.randn(2, 8, 2, 16).astype(ml_dtypes.bfloat16),
            rng.randn(2, 8, 2, 16).astype(np.float32),
            rng.randint(-128, 128, (2, 8, 2, 16)).astype(np.int8),
            rng.rand(2, 8, 2, 1).astype(np.float32)]


def _torch_leaf(a):
    if a is None:
        return None
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _same_bits(t, a):
    """A torch leaf and a numpy leaf hold the same dtype, shape and
    bytes."""
    raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    return (tuple(t.shape) == a.shape and raw.tobytes() == a.tobytes()
            and str(t.dtype).split(".")[1] == a.dtype.name)


# ------------------------------------------------------------- wire format

def test_wire_blobs_equal_jax_and_cross_decode():
    """Tolerance: byte-equal blobs, bit-equal leaves."""
    payload = _numpy_payload()
    theirs = JaxHostStore.payload_to_bytes(payload)
    ours = TO([_torch_leaf(a) for a in payload])
    assert ours == theirs
    back = FROM(theirs)
    assert back[0] is None
    assert all(_same_bits(t, a) for t, a in zip(back[1:], payload[1:]))
    for a, b in zip(JaxHostStore.payload_from_bytes(ours)[1:], payload[1:]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # numpy leaves of plain dtypes serialize the same through the port
    assert TO([None] + payload[2:]) == JaxHostStore.payload_to_bytes(
        [None] + payload[2:])


@pytest.mark.parametrize("damage", ["truncated", "flipped", "v1",
                                    "trailing", "magic"])
def test_wire_refuses_damaged_blobs(damage):
    blob = TO([_torch_leaf(a) for a in _numpy_payload(1)])
    if damage == "truncated":
        bad = [blob[:cut] for cut in (3, 8, 12, len(blob) // 2,
                                      len(blob) - 1)]
    elif damage == "flipped":
        bad = []
        for pos in (9, len(blob) // 2, len(blob) - 2):
            b = bytearray(blob)
            b[pos] ^= 0xFF
            bad.append(bytes(b))
    elif damage == "v1":
        v1 = bytearray(blob[:-4])
        v1[4:6] = struct.pack("<H", 1)
        bad = [bytes(v1)]
    elif damage == "trailing":
        body = blob[:-4] + b"xx"
        import zlib
        bad = [body + struct.pack("<I", zlib.crc32(body))]
    else:
        bad = [b"NOPE" + blob[4:]]
    for b in bad:
        with pytest.raises(ValueError):
            FROM(b)
        with pytest.raises(ValueError):  # JAX refuses the same bytes
            JaxHostStore.payload_from_bytes(b)


# ------------------------------------------------------------ the stores

def test_disk_file_names_equal_jax(tmp_path):
    ours = DiskPageStore(str(tmp_path / "a"), 1 << 20)
    theirs = JaxDiskStore(str(tmp_path / "b"), 1 << 20)
    for key in [((1, 2, 3),), ((1, 2), (3, 4)), ((1,), (2,)),
                (tuple(range(16)), tuple(range(16, 32)))]:
        assert (os.path.basename(ours._path(key))
                == os.path.basename(theirs._path(key)))


def _page(seed):
    return [None, torch.randn(2, 4, generator=torch.Generator()
                              .manual_seed(seed))]


def test_disk_store_lru_budget_atomicity_and_corruption(tmp_path):
    payload = _page(2)
    one = len(TO(payload))
    store = DiskPageStore(str(tmp_path), int(one * 2.5))  # fits two files
    keys = [((i, i + 1),) for i in range(4)]
    for k in keys:
        assert store.put(k, payload, 0)
    assert store.evicted_pages == 2 and keys[-1] in store
    assert store.nbytes <= store.capacity_bytes
    assert not any(".tmp." in f for f in os.listdir(tmp_path))
    store.check_invariants()
    assert not DiskPageStore(str(tmp_path / "tiny"), 8).put(keys[0],
                                                              payload, 0)
    # a fresh instance on the directory reads the entry back
    got = DiskPageStore(str(tmp_path), 1 << 20).get(keys[-1])
    assert torch.equal(got[1], payload[1])
    # a file corrupted at rest raises and removes itself
    path = store._path(keys[-1])
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="crc32|corrupt"):
        store.get(keys[-1])
    assert not os.path.exists(path) and keys[-1] not in store


def test_disk_store_puts_and_gauge_keep_off_the_directory(tmp_path,
                                                        monkeypatch):
    """Puts, gets and the per-tick gauge list the directory once, not per
    call, while the budget holds as JAX's store keeps it; a sibling's
    write shows in the gauge at the next listing, and the eviction after
    it counts the sibling's bytes."""
    payload = _page(5)
    one = len(TO(payload))
    store = DiskPageStore(str(tmp_path), int(one * 2.5))
    theirs = JaxDiskStore(str(tmp_path / "jax"), int(one * 2.5))
    listings = []
    files = DiskPageStore._files
    monkeypatch.setattr(DiskPageStore, "_files",
                        lambda self: listings.append(1) or files(self))
    keys = [((i, i + 1),) for i in range(6)]
    for k in keys:
        assert store.put(k, payload, 0)
        theirs.put(k, [None, payload[1].numpy()], 0)
        assert store.cached_nbytes <= store.capacity_bytes
        if keys[0] in store:
            store.get(keys[0])
    assert len(listings) == 1
    assert store.evicted_pages == theirs.evicted_pages == 4
    assert store.cached_nbytes == store.nbytes == theirs.nbytes
    sibling = DiskPageStore(str(tmp_path), 1 << 20)
    sibling.put(((9, 9),), payload, 0)
    assert store.cached_nbytes == 2 * one  # not listed since
    store.rescan_s = 0.0
    assert store.put(((7, 8),), payload, 0)
    assert store.nbytes <= store.capacity_bytes
    assert store.cached_nbytes == store.nbytes
    store.check_invariants()


def test_disk_store_put_degrades_on_io_error(tmp_path):
    store = DiskPageStore(str(tmp_path / "cache"), 1 << 20)
    os.rmdir(store.cache_dir)
    open(store.cache_dir, "w").close()  # every write under it fails
    assert store.put(((1, 2),), _page(3), 0) is False
    assert store.spilled_pages == 0 and ((1, 2),) not in store
    tiered = TieredPageStore(HostPageStore(1 << 20), store)
    assert tiered.put(((1, 2),), _page(3), 64) is True
    assert torch.equal(tiered.get(((1, 2),))[1], _page(3)[1])


def test_host_store_budget_and_tiered_promotion(tmp_path):
    store = HostPageStore(128)
    assert not store.put(("a",), "huge", 200)
    assert store.put(("a",), "pa", 64) and store.put(("b",), "pb", 64)
    assert store.get(("b",)) == "pb"
    assert store.put(("c",), "pc", 64)  # drops ("a",), the oldest
    assert ("a",) not in store and store.evicted_pages == 1
    assert store.pop(("b",)) == "pb" and store.nbytes == 64
    store.check_invariants()
    host, disk = HostPageStore(1 << 20), DiskPageStore(str(tmp_path), 1 << 20)
    tiered = TieredPageStore(host, disk)
    tiered.put(((0, 1),), _page(4), 1024)
    assert ((0, 1),) in host and ((0, 1),) in disk
    host.pop(((0, 1),))
    assert torch.equal(tiered.get(((0, 1),))[1], _page(4)[1])
    assert ((0, 1),) in host  # the disk hit was promoted


# ----------------------------------------------------------- the page pool

class _Recording(HostPageStore):
    """A host store that journals every put (key -> payload)."""

    def __init__(self, capacity):
        super().__init__(capacity)
        self.journal = {}

    def put(self, key, payload, nbytes):
        self.journal[key] = payload
        return super().put(key, payload, nbytes)


class _JaxRecording(JaxHostStore):
    def __init__(self, capacity):
        super().__init__(capacity)
        self.journal = {}

    def put(self, key, payload, nbytes):
        self.journal[key] = payload
        return super().put(key, payload, nbytes)


def _pool(cls, store_cls, log):
    store = store_cls(10 * 64)

    def spill_fn(pages):
        log.append(("spill", list(pages)))
        return [(("payload", p), 64) for p in pages]

    def revive_fn(entries):
        log.append(("revive", [p for p, _ in entries]))

    return cls(16, 4, 5, 8, host_store=store, spill_fn=spill_fn,
               revive_fn=revive_fn), store


def test_spill_revive_churn_matches_jax_pool():
    """The same seeded ops on both pools: equal tables, refcounts,
    spill/revive journals and stored keys after every op."""
    rng = np.random.RandomState(42)
    log_j, log_t = [], []
    jpool, jstore = _pool(JaxPagePool, _JaxRecording, log_j)
    tpool, tstore = _pool(PagePool, _Recording, log_t)
    held = {}
    zoo = [rng.randint(1, 7, (n,)).astype(np.int32)
           for n in (5, 9, 13, 17, 21, 29)]
    for _ in range(400):
        op = rng.randint(3)
        if op == 0 and len(held) < 5:
            lane = min(set(range(5)) - set(held))
            toks = zoo[rng.randint(len(zoo))]
            if rng.randint(2):
                toks = np.concatenate(
                    [toks, rng.randint(1, 7, (rng.randint(1, 4),))]
                ).astype(np.int32)
            got = tpool.alloc(lane, toks)
            assert got == jpool.alloc(lane, toks)
            if got is not None:
                tpool.register_prefix(lane, toks)
                jpool.register_prefix(lane, toks)
                held[lane] = toks
        elif op == 1 and held:
            lane = sorted(held)[rng.randint(len(held))]
            pos = int(tpool.alloc_counts[lane]) * 4
            if pos < 32:
                assert tpool.ensure_page(lane, pos) == jpool.ensure_page(
                    lane, pos)
        elif op == 2 and held:
            lane = sorted(held)[rng.randint(len(held))]
            tpool.free(lane)
            jpool.free(lane)
            del held[lane]
        assert (tpool.tables == jpool.tables).all()
        assert (tpool.ref == jpool.ref).all()
        assert log_t == log_j
        tpool.check_invariants()
    assert set(tstore.journal) == set(jstore.journal)
    assert (tstore.spilled_pages, tstore.revived_pages,
            tstore.evicted_pages) == (jstore.spilled_pages,
                                      jstore.revived_pages,
                                      jstore.evicted_pages)
    assert tstore.revived_pages > 0 and tstore.evicted_pages > 0


# ----------------------------------------------------------- the engines

PREFIX = np.arange(10, 34, dtype=np.int32) % 61  # three full pages of 8


def _waves(seed=3):
    """Wave 1: three prompts over one 24-token prefix; wave 2: unrelated
    prompts that push wave 1's pages out of a 9-page pool; wave 3: wave 1
    again."""
    rng = np.random.RandomState(seed)
    first = [np.concatenate([PREFIX, rng.randint(0, 61, n)]).astype(np.int32)
             for n in (3, 6, 9)]
    second = [rng.randint(0, 61, n).astype(np.int32) for n in (30, 27, 33)]
    return first, second


def _serve_waves(engine, first, second):
    out = []
    for wave in (first, second, first):
        rids = [engine.submit(p, max_length=6) for p in wave]
        res = engine.drain()
        out.append([res[r].tokens.tolist() for r in rids])
    return out


def _tier_kw(disk_dir=None):
    """A host tier of eight pages alone, or one of two pages over a disk
    tier (a page of K and V: 2 layers x 8 x 2 x 16 x 4 B x 2 = 4096 B)."""
    kw = dict(num_pages=10, slots=2,
              host_cache_bytes=(2 if disk_dir else 8) * 4096)
    if disk_dir:
        kw.update(disk_cache_dir=disk_dir, disk_cache_bytes=1 << 20)
    return kw


@pytest.fixture(scope="module")
def jax_tier_runs(w, tmp_path_factory):
    """JAX's engine over both tier setups: its streams, its snapshot and,
    for the disk tier, the directory it wrote."""
    out = {}
    for disk in (False, True):
        path = str(tmp_path_factory.mktemp("jax_disk")) if disk else None
        eng = jax_engine(w, **_tier_kw(path))
        out[disk] = (_serve_waves(eng, *_waves()), eng.metrics.snapshot(),
                     path)
    return out


@pytest.mark.parametrize("disk", [False, True], ids=["host", "host+disk"])
def test_engine_tiers_match_jax_engine(w, tmp_path, jax_tier_runs, disk):
    """Greedy streams byte-equal to JAX's engine and to a pool that never
    evicts; spill, revive and disk-hit counts equal JAX's."""
    first, second = _waves()
    want = _serve_waves(port_engine(w, slots=2), first, second)
    port = port_engine(w, **_tier_kw(str(tmp_path) if disk else None))
    theirs_streams, theirs, jax_dir = jax_tier_runs[disk]
    assert _serve_waves(port, first, second) == want == theirs_streams
    ours = port.metrics.snapshot()
    for key in ("host_spilled_pages", "host_revived_pages",
                "host_evicted_pages", "prefix_hits", "prefill_tokens_saved",
                "disk_cache_hits"):
        assert ours[key] == theirs[key], key
    assert ours["disk_cache_hits" if disk else "host_revived_pages"] > 0
    port.cache_manager.pool.check_invariants()
    if disk:
        assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(jax_dir))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_disk_directory_is_shared_across_packages(w, tmp_path, jax_tier_runs,
                                                  writer):
    """A disk tier written by one package's engine: a fresh engine of the
    other package on the same directory prewarms the prefix and serves
    the prompt with the never-evicting engine's greedy stream, its
    prefill skipped."""
    first, second = _waves()
    if writer == "jax":
        path = jax_tier_runs[True][2]
    else:
        path = str(tmp_path)
        _serve_waves(port_engine(w, **_tier_kw(path)), first, second)
    assert any(f.endswith(".fxpg") for f in os.listdir(path))
    ref = port_engine(w, slots=2)
    rid = ref.submit(first[1], max_length=6)
    want = ref.drain()[rid].tokens.tolist()
    reader = (port_engine if writer == "jax" else jax_engine)(
        w, **_tier_kw(path))
    assert reader.prewarm(first[1]) == 24
    rid = reader.submit(first[1], max_length=6)
    assert reader.drain()[rid].tokens.tolist() == want
    assert reader.metrics.snapshot()["prefill_tokens_saved"] == 24
