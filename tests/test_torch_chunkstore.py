"""The port's chunk stores against the JAX package's (DESIGN.md §10).

Every case of ``tests/test_chunkstore.py``'s ``TestDiskStore``,
``TestInMemoryStore`` and ``TestChunkRefPlumbing`` runs here on the port with
``device="cpu"``: LRU residency, refcounted pins, spill-on-eviction written
once, prefetch hits, two-phase spills, cleanup, and the zero-load invariant
of lowering over refs.  Beyond them: a bf16 spill round trip bit for bit, a
``put`` of a view that does not keep its parent alive, and one scripted
sequence of store calls run on the JAX ``DiskStore`` and on the port's from
one numpy seed, with equal ``StoreStats`` after every step.
"""

import dataclasses
import gc
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro_torch.api import (
    Baseline,
    ChunkPinnedError,
    ChunkRef,
    ChunkStore,
    ChunkStoreError,
    Collection,
    DiskStore,
    InMemoryStore,
    LocalExecutor,
    SplIter,
    StreamExecutor,
    ThreadedExecutor,
)
from repro_torch.core.blocked import BlockedArray, round_robin_placement


def _dataset(rows=4096, d=8, seed=0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((rows, d)).astype(np.float32))


def _sum_plan(x, block_rows, locs, policy, ex, store=None):
    c = Collection.from_array(
        x, block_rows=block_rows, num_locations=locs,
        placement=round_robin_placement, store=store, device="cpu",
    )
    return c.split(policy).map_blocks(torch.sum).reduce(lambda a, b: a + b).compute(executor=ex)


def _store(budget, **kw):
    return DiskStore(residency_bytes=budget, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the store contract
# ---------------------------------------------------------------------------


class TestDiskStore:
    def test_put_get_roundtrip_bit_identical(self):
        with _store(1 << 20) as store:
            block = _dataset(rows=64)
            ref = store.put(block)
            assert isinstance(ref, ChunkRef)
            assert ref.shape == tuple(block.shape) and ref.dtype == block.dtype
            assert ref.device == torch.device("cpu")
            assert torch.equal(ref.resolve(), block)

    def test_reload_after_spill_bit_identical(self):
        blocks = [_dataset(rows=64, seed=i) for i in range(8)]
        nb = blocks[0].nbytes
        with _store(2 * nb) as store:
            refs = [store.put(b) for b in blocks]
            assert store.stats.spills >= 6
            assert store.stats.resident_bytes <= 2 * nb
            for ref, b in zip(refs, blocks):
                assert torch.equal(ref.resolve(), b)

    def test_spill_file_written_once(self):
        b = _dataset(rows=64)
        with _store(b.nbytes) as store:
            r0 = store.put(b)
            store.put(b + 1)  # evicts r0 -> spill file
            assert store.stats.spills == 1
            r0.resolve()      # reload r0 (evicts the other)
            store.put(b + 2)  # evict r0 again: clean, no second write
            assert store.stats.spills == 2  # only the OTHER chunk spilled
            assert len(store.spill_files()) == 2

    def test_lru_prefers_cold_victims(self):
        b = _dataset(rows=64)
        with _store(2 * b.nbytes) as store:
            r0, r1 = store.put(b), store.put(b + 1)
            r0.resolve()            # r0 now most-recently-used
            store.put(b + 2)        # evicts r1, the LRU entry
            assert r0.chunk_id in store.resident_ids()
            assert r1.chunk_id not in store.resident_ids()

    def test_eviction_of_pinned_chunk_refused(self):
        b = _dataset(rows=64)
        with _store(4 * b.nbytes) as store:
            ref = store.put(b)
            store.pin(ref)
            with pytest.raises(ChunkPinnedError):
                store.evict(ref)
            small = _store(b.nbytes)  # fits exactly one
            r2 = small.put(b)
            small.pin(r2)
            small.put(b + 1)  # r2 is pinned: survives; the newcomer evicts
            assert r2.chunk_id in small.resident_ids()
            assert small.stats.peak_resident_bytes > small.residency_bytes
            store.unpin(ref)
            store.evict(ref)  # now allowed
            assert ref.chunk_id not in store.resident_ids()
            small.close()

    def test_pins_are_refcounted(self):
        b = _dataset(rows=64)
        with _store(4 * b.nbytes) as store:
            ref = store.put(b)
            store.pin(ref)
            store.pin(ref)
            store.unpin(ref)
            assert store.is_pinned(ref)
            store.unpin(ref)
            assert not store.is_pinned(ref)

    def test_prefetch_marks_hits(self):
        b = _dataset(rows=64)
        with _store(b.nbytes) as store:
            r0 = store.put(b)
            store.put(b + 1)          # spill r0
            store.prefetch([r0])
            assert store.stats.prefetch_hits == 0
            r0.resolve()
            assert store.stats.prefetch_hits == 1
            r0.resolve()              # plain resident hit, not a prefetch hit
            assert store.stats.prefetch_hits == 1

    def test_prefetch_self_evicted_under_pin_pressure_is_not_a_hit(self):
        b = _dataset(rows=64)
        with _store(b.nbytes) as store:
            pinned = store.put(b)
            store.pin(pinned)
            c = store.put(b + 1)       # evicted at put (pinned fills budget)
            store.prefetch([c])        # loads, then self-evicts again
            assert c.chunk_id not in store.resident_ids()
            c.resolve()                # plain miss -> load
            c.resolve()                # still no phantom hit
            assert store.stats.prefetch_hits == 0

    def test_prefetch_during_inflight_spill_serves_pending(self):
        # Freeze the two-phase eviction mid-flight (chunk moved to the
        # pending-spill queue, write not yet run) and prefetch it.
        b = _dataset(rows=64)
        with _store(4 * b.nbytes) as store:
            ref = store.put(b)
            with store._lock:
                store._evict_one(ref.chunk_id)  # pending, write deferred
            store.prefetch([ref])               # must not raise (no _load race)
            assert store.stats.spills == 1
            assert torch.equal(ref.resolve(), b)

    def test_close_removes_spill_dir_and_rejects_use(self):
        store = _store(1)
        ref = store.put(_dataset(rows=64))
        d = store.spill_dir
        assert os.path.isdir(d)
        store.close()
        assert not os.path.exists(d)
        with pytest.raises(ChunkStoreError):
            ref.resolve()
        store.close()  # idempotent

    def test_gc_finalizer_removes_spill_dir(self):
        store = _store(1)
        store.put(_dataset(rows=64))
        d = store.spill_dir
        del store
        gc.collect()
        assert not os.path.exists(d)

    def test_trim_spills_everything_unpinned(self):
        b = _dataset(rows=64)
        with _store(4 * b.nbytes) as store:
            refs = [store.put(b + i) for i in range(3)]
            store.pin(refs[0])
            store.trim()
            assert store.resident_ids() == [refs[0].chunk_id]
            assert store.stats.resident_bytes == b.nbytes


class TestPortStore:
    """What only the port's store has to show: its dtypes, copies and device."""

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.int8, torch.float64])
    def test_spill_round_trip_keeps_every_bit(self, dtype):
        # random bit patterns: NaN payloads, infinities, subnormals, -0
        bits = torch.from_numpy(
            np.random.default_rng(7).integers(0, 256, size=(64, 16 * dtype.itemsize),
                                              dtype=np.uint8)
        )
        x = bits.view(dtype)
        with _store(1) as store:
            ref = store.put(x)
            store.put(torch.zeros(4))  # evicts (and spills) the first chunk
            assert ref.chunk_id not in store.resident_ids()
            got = ref.resolve()
            assert store.stats.loads == 1
        assert got.dtype == dtype and got.shape == x.shape
        assert torch.equal(got.view(torch.uint8), bits)

    def test_put_of_a_view_keeps_no_parent_alive(self):
        parent = _dataset(rows=256)
        with _store(1 << 20) as store:
            ref = store.put(parent[64:128])
            chunk = ref.resolve()
            assert chunk.untyped_storage().nbytes() == ref.nbytes == 64 * 8 * 4
            assert chunk.untyped_storage().data_ptr() != parent.untyped_storage().data_ptr()
            assert torch.equal(chunk, parent[64:128])
            # the same through BlockedArray.from_array, whose blocks are views
            ba = BlockedArray.from_array(parent, 32, num_locations=2, store=store,
                                         device="cpu")
            for i, r in enumerate(ba.blocks):
                assert r.resolve().untyped_storage().nbytes() == r.nbytes
                assert torch.equal(r.resolve(), parent[32 * i:32 * (i + 1)])

    def test_numpy_put_copies_its_input(self):
        a = np.arange(32, dtype=np.float32)
        with _store(1 << 20) as store:
            ref = store.put(a)
            a[:] = -1
            assert torch.equal(ref.resolve(), torch.arange(32, dtype=torch.float32))

    def test_card_is_the_default_device(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DiskStore(residency_bytes=1 << 20)


class TestInMemoryStore:
    def test_contract_and_identity_semantics(self):
        store = InMemoryStore()
        assert isinstance(store, ChunkStore)
        assert isinstance(_store(1), ChunkStore)
        b = _dataset(rows=64)
        ref = store.put(b)
        assert ref.resolve() is ref.resolve()  # same resident buffer
        store.pin(ref)
        store.unpin(ref)  # no-ops
        assert store.stats.bytes_loaded == 0 and store.stats.bytes_spilled == 0

    def test_plan_results_match_plain_arrays(self):
        x = _dataset()
        plain = _sum_plan(x, 256, 4, SplIter(), LocalExecutor())
        stored = _sum_plan(x, 256, 4, SplIter(), LocalExecutor(), store=InMemoryStore())
        assert torch.equal(stored.value, plain.value)
        assert stored.report.dispatches == plain.report.dispatches
        assert stored.report.bytes_loaded == 0
        assert stored.report.prefetch_hits == 0


# ---------------------------------------------------------------------------
# chunk-ref plumbing: metadata stays zero-copy
# ---------------------------------------------------------------------------


class TestChunkRefPlumbing:
    def test_blocked_geometry_needs_no_loads(self):
        x = _dataset()
        store = _store(x.nbytes)
        ba = BlockedArray.from_array(
            x, 256, num_locations=4, policy=round_robin_placement, store=store, device="cpu"
        )
        loads0 = store.stats.loads
        assert ba.is_chunked
        assert ba.num_rows == x.shape[0]
        assert ba.row_shape == tuple(x.shape[1:])
        assert ba.nbytes == x.nbytes
        assert ba.device == torch.device("cpu")
        ba.row_offsets(), ba.blocks_at(0)
        assert store.stats.loads == loads0  # geometry is metadata-only
        store.close()

    def test_prepare_and_lower_are_zero_copy_over_refs(self):
        x = _dataset()
        store = _store(x.nbytes // 4)  # most chunks spilled: any resolve would load
        c = Collection.from_array(
            x, 128, num_locations=4, placement=round_robin_placement, store=store,
            device="cpu",
        )
        ex = StreamExecutor(close_stores=False)
        loads0 = store.stats.loads
        for ppl in (1, 2, 4):
            plan = c.split(SplIter(partitions_per_location=ppl)) \
                    .map_blocks(torch.sum).reduce(lambda a, b: a + b).plan()
            graph = ex.lower(plan)
            assert all(t.chunk_refs for t in graph.tasks)
        assert store.stats.loads == loads0
        assert ex.prepare_stats.splits == 1          # one placement scan
        assert ex.prepare_stats.regroups == 2        # ppl=2,4 derived free
        ex.close()
        store.close()

    @pytest.mark.parametrize("pol", [Baseline(), SplIter(), SplIter(materialize=True)],
                             ids=lambda p: p.mode_name)
    def test_chunk_refs_only_attached_for_out_of_core_backends(self, pol):
        x = _dataset(rows=512)
        store = _store(x.nbytes)
        c = Collection.from_array(x, 128, num_locations=2, store=store, device="cpu")
        plan = c.split(pol).map_blocks(torch.sum).reduce(lambda a, b: a + b).plan()
        local_graph = LocalExecutor().lower(plan)
        stream_graph = StreamExecutor(close_stores=False).lower(plan)
        assert all(t.chunk_refs == () for t in local_graph.tasks)
        assert all(len(t.chunk_refs) > 0 for t in stream_graph.tasks)
        for t in stream_graph.tasks:  # the refs of the task's own blocks, in order
            assert [r.chunk_id for r in t.chunk_refs] == [
                plan.spec.inputs[0].blocks[b].chunk_id for b in t.block_ids
            ]
        store.close()

    def test_prepare_cache_eviction_trims_store(self):
        x = _dataset(rows=512)
        store = _store(x.nbytes)
        ex = LocalExecutor()
        res = _sum_plan(x, 128, 2, SplIter(), ex, store=store)
        assert store.stats.resident_bytes > 0
        for i in range(ex.prepare_cache_size + 1):
            _sum_plan(_dataset(rows=64, seed=i), 32, 2, SplIter(), ex)
        assert store.stats.resident_bytes == 0  # trimmed on eviction
        assert res is not None
        store.close()

    def test_executor_close_trims_stores(self):
        x = _dataset(rows=512)
        store = _store(x.nbytes)
        ex = ThreadedExecutor()
        _sum_plan(x, 128, 2, SplIter(), ex, store=store)
        assert store.stats.resident_bytes > 0
        ex.close()
        assert store.stats.resident_bytes == 0
        assert len(store.spill_files()) == 4  # data survives as spill files
        store.close()


# ---------------------------------------------------------------------------
# one scripted sequence on both packages' stores
# ---------------------------------------------------------------------------


def _script(seed=0, n=10, rows=32):
    """Blocks and store calls from one numpy seed: (op, chunk index) steps."""
    rng = np.random.default_rng(seed)
    blocks = [rng.random((rows, 4)).astype(np.float32) for _ in range(n)]
    steps = [("put", i) for i in range(n)]
    ops = ["get", "pin", "unpin", "prefetch", "evict", "trim", "get", "get"]
    pinned: list[int] = []
    for _ in range(60):
        op = ops[rng.integers(len(ops))]
        i = int(rng.integers(n))
        if op == "unpin":
            if not pinned:
                continue
            i = pinned.pop(int(rng.integers(len(pinned))))
        elif op == "pin":
            pinned.append(i)
        elif op == "evict" and i in pinned:
            op = "evict_refused"
        steps.append((op, i))
    steps += [("unpin", i) for i in pinned] + [("trim", 0)]
    return blocks, steps


def _apply(store, refs, blocks, op, i, put, pinned_error):
    if op == "put":
        refs.append(store.put(put(blocks[i])))
    elif op == "get":
        return np.asarray(refs[i].resolve())
    elif op == "pin":
        store.pin(refs[i])
    elif op == "unpin":
        store.unpin(refs[i])
    elif op == "prefetch":
        store.prefetch([refs[i], refs[(i + 1) % len(blocks)]])
    elif op == "evict":
        store.evict(refs[i])
    elif op == "evict_refused":
        with pytest.raises(pinned_error):
            store.evict(refs[i])
    elif op == "trim":
        store.trim()
    return None


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("budget_chunks", [1, 3])
def test_scripted_sequence_counts_what_the_reference_counts(seed, budget_chunks):
    blocks, steps = _script(seed)
    budget = budget_chunks * blocks[0].nbytes
    jstore = japi.DiskStore(residency_bytes=budget)
    tstore = _store(budget)
    jrefs, trefs = [], []
    try:
        for op, i in steps:
            jv = _apply(jstore, jrefs, blocks, op, i, jnp.asarray, japi.ChunkPinnedError)
            tv = _apply(tstore, trefs, blocks, op, i, torch.from_numpy, ChunkPinnedError)
            assert dataclasses.asdict(tstore.stats) == dataclasses.asdict(jstore.stats), (op, i)
            assert tstore.resident_ids() == jstore.resident_ids(), (op, i)
            assert tstore.spill_files() == jstore.spill_files(), (op, i)
            if jv is not None:
                np.testing.assert_array_equal(tv, jv)
                np.testing.assert_array_equal(tv, blocks[i])
        assert tstore.stats.spills > 0 and tstore.stats.loads > 0
    finally:
        jstore.close()
        tstore.close()
