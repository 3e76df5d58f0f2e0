"""The port's shared-memory data plane against the JAX package's.

Every case of ``tests/test_shm.py``, on ``repro_torch.api.shm``: descriptors
pickle small and exact; the arena (``ShmStore``) caches exports by identity,
declines over-budget exports, evicts only unpinned/unlocked segments and
leaves ``/dev/shm`` clean on ``close()``; the ChunkStore contract holds;
the reply transport has a strict send→consume→unlink lifecycle;
``DiskStore.manifest`` is shm-first and incremental and bills spills once;
``EngineReport`` sums and round-trips every field.  Where the reference
computes the same quantity (export bytes, the manifest's entries and spill
bill), the same numpy input goes through both packages and the numbers
are compared.  Tensors on the card get their own cases in
``tests/test_torch_cuda_cluster.py``.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.api.shm as jshm
from repro_torch.api import ChunkRef, DiskStore
from repro_torch.api.chunkstore import AttachedStore, ChunkStoreError
from repro_torch.api.shm import (
    ShmAttachments,
    ShmBlockRef,
    ShmStore,
    discard_tree,
    host_array,
    leaked_segments,
    pack_tree,
    shm_available,
    sweep_segments,
    unpack_tree,
)
from repro_torch.core.engine import _FIELD_RULES, EngineReport

pytestmark = pytest.mark.skipif(not shm_available(), reason="host has no POSIX shared memory")


def _arr(n=1024, seed=0, shape=None):
    rng = np.random.default_rng(seed)
    return rng.random(shape or (n,)).astype(np.float64)


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------


def test_block_ref_pickles_small_and_exact():
    ref = ShmBlockRef("rtshm1x1a1", 256, (128, 4), "<f4")
    blob = pickle.dumps(ref)
    assert len(blob) < 200  # descriptors, not payloads
    assert pickle.loads(blob) == ref
    assert ref.nbytes == 128 * 4 * 4 == jshm.ShmBlockRef("rshm1x1a1", 256, (128, 4), "<f4").nbytes


# ---------------------------------------------------------------------------
# the arena
# ---------------------------------------------------------------------------


class TestShmStore:
    @pytest.mark.parametrize("as_tensor", [False, True], ids=["ndarray", "tensor"])
    def test_export_round_trip(self, as_tensor):
        a = _arr()
        obj = torch.from_numpy(a) if as_tensor else a
        with ShmStore() as store, jshm.ShmStore() as jstore:
            ref, wrote = store.export(obj)
            jref, jwrote = jstore.export(a)
            assert ref is not None and wrote == jwrote == a.nbytes
            assert (ref.offset, ref.shape, ref.dtype_str) == (jref.offset, jref.shape, jref.dtype_str)
            att = ShmAttachments()
            view = att.view(ref)
            assert not view.flags.writeable
            np.testing.assert_array_equal(view, a)
            assert torch.equal(att.tensor(ref, torch.device("cpu")), torch.from_numpy(a))
            att.close()

    def test_export_caches_by_identity(self):
        a = torch.from_numpy(_arr())
        with ShmStore() as store:
            ref1, wrote1 = store.export(a)
            ref2, wrote2 = store.export(a)
            assert ref1 == ref2
            assert wrote1 == a.nbytes and wrote2 == 0  # one copy, ever
            assert store.bytes_exported == a.nbytes

    def test_small_blocks_decline(self):
        with ShmStore(min_bytes=1024) as store:
            ref, wrote = store.export(torch.zeros(4))
            assert ref is None and wrote == 0

    def test_budget_exhaustion_declines_not_raises(self):
        with ShmStore(budget_bytes=1 << 16, segment_bytes=1 << 16) as store:
            pinned, _ = store.export(_arr(4096, seed=1))  # 32KB
            store.pin_refs([pinned])
            b, c = _arr(4096, seed=2), _arr(8192, seed=3)
            refb, _ = store.export(b)
            store.pin_refs([refb])
            # nothing evictable is left and c does not fit: decline
            refc, wrote = store.export(c)
            assert refc is None and wrote == 0
            assert store.pinned_segments() == {pinned.segment: 2}
            store.unpin_refs([pinned])
            store.unpin_refs([refb])
            assert store.pinned_segments() == {}

    def test_lru_eviction_spares_pinned_segments(self):
        # 32KB segments, 96KB budget: each 32KB export fills one segment.
        def run(mod):
            with mod.ShmStore(budget_bytes=3 << 15, segment_bytes=1 << 15) as store:
                a, b, c = (_arr(4096, seed=i) for i in (1, 2, 3))
                ra, _ = store.export(a)
                rb, _ = store.export(b)
                store.pin_refs([ra])
                rc, _ = store.export(c)  # budget now fully allocated
                rd, _ = store.export(_arr(4096, seed=4))  # must evict one segment
                assert rd is not None
                live = store.live_segments()
                store.unpin_refs([ra])
                return tuple(r.segment in live for r in (ra, rb, rc))

        import repro_torch.api.shm as tshm

        # pinned survived, recently used survived, the LRU unpinned went
        assert run(tshm) == run(jshm) == (True, False, True)

    def test_close_unlinks_everything_and_is_reusable(self):
        store = ShmStore()
        store.export(_arr(seed=4))
        prefix = store.prefix
        assert leaked_segments(prefix)
        store.close()
        assert leaked_segments(prefix) == []
        ref, wrote = store.export(_arr(seed=5))  # reusable after close
        assert ref is not None and wrote > 0
        store.close()
        assert leaked_segments(prefix) == []


class TestShmChunkStore:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64])
    def test_put_get_bit_identical(self, dtype):
        a = torch.from_numpy(_arr(seed=6).astype(np.float32) * 100).to(dtype)
        with ShmStore() as store:
            ref = store.put(a)
            assert isinstance(ref, ChunkRef) and ref.dtype == dtype
            got = store.get(ref)
            assert got.dtype == dtype and torch.equal(got, a)
            assert store.handle(ref) is not None  # picklable descriptor
        if dtype == torch.float32:  # the reference stores the same bits
            with jshm.ShmStore() as jstore:
                jref = jstore.put(a.numpy())
                np.testing.assert_array_equal(np.asarray(jstore.get(jref)), a.numpy())

    def test_put_ignores_min_bytes_floor(self):
        with ShmStore(min_bytes=1 << 20) as store:
            ref = store.put(np.arange(8.0))
            np.testing.assert_array_equal(store.get(ref).numpy(), np.arange(8.0))

    def test_put_raises_when_budget_exhausted(self):
        with ShmStore(budget_bytes=1 << 14, segment_bytes=1 << 14) as store:
            store.put(_arr(1024, seed=7))  # 8KB, locked by put
            with pytest.raises(ChunkStoreError):
                store.put(_arr(4096, seed=8))  # 32KB can never fit


# ---------------------------------------------------------------------------
# reply transport
# ---------------------------------------------------------------------------


class TestReplyTransport:
    def test_pack_unpack_round_trip_unlinks(self):
        tree = {"big": _arr(1024, seed=9), "small": np.float64(3.5)}
        packed, seg, wrote = pack_tree(tree, threshold=1024, name="rtshmtestp1")
        jpacked, _, jwrote = jshm.pack_tree(tree, threshold=1024, name="rshmtesttp1")
        assert seg == "rtshmtestp1" and wrote == jwrote == tree["big"].nbytes
        assert isinstance(packed["big"], ShmBlockRef)
        assert packed["small"] == tree["small"]  # under threshold: inline
        out, segs = unpack_tree(packed)
        np.testing.assert_array_equal(out["big"], tree["big"])
        assert segs == ["rtshmtestp1"]
        assert leaked_segments("rtshmtestp1") == []  # consume == unlink
        jshm.unpack_tree(jpacked)

    def test_pack_without_big_leaves_is_a_no_op(self):
        tree = (np.arange(4.0), 7)
        packed, seg, wrote = pack_tree(tree, threshold=1024, name="rtshmtestp2")
        assert seg is None and wrote == 0 and packed is tree
        assert leaked_segments("rtshmtestp2") == []

    def test_discard_tree_unlinks_unconsumed_replies(self):
        packed, seg, _ = pack_tree([_arr(1024, seed=10)], threshold=1024, name="rtshmtestp3")
        assert leaked_segments("rtshmtestp3") == [seg]
        discard_tree(packed)  # the stale-reply path
        assert leaked_segments("rtshmtestp3") == []

    def test_sweep_reaps_orphans(self):
        pack_tree([_arr(1024, seed=11)], threshold=1024, name="rtshmtestp4x1")
        pack_tree([_arr(1024, seed=12)], threshold=1024, name="rtshmtestp4x2")
        assert sweep_segments("rtshmtestp4") == 2
        assert leaked_segments("rtshmtestp4") == []

    def test_bfloat16_travels_as_its_bits(self):
        t = torch.linspace(-3, 3, 1024).to(torch.bfloat16)
        arr, tag = host_array(t)
        assert tag == "bfloat16" and arr.dtype == np.int16
        with ShmStore(min_bytes=0) as store:
            ref, _ = store.export(t)
            att = ShmAttachments()
            assert torch.equal(att.tensor(ref, torch.device("cpu")), t)
            att.close()


# ---------------------------------------------------------------------------
# DiskStore.manifest — shm-first, incremental, honest billing
# ---------------------------------------------------------------------------


def _bill(store):
    return store.stats.spills, store.stats.bytes_spilled


class TestManifestHandoff:
    def _stores_with_chunks(self, n=4):
        """The same chunks in the port's store and in the reference's."""
        # float32: the reference runs with JAX's default 32-bit types
        arrs = [_arr(512, seed=20 + i).astype(np.float32) for i in range(n)]
        store = DiskStore(residency_bytes=64 << 20, device="cpu")
        jstore = japi.DiskStore(residency_bytes=64 << 20)
        refs = [store.put(a) for a in arrs]
        jrefs = [jstore.put(a) for a in arrs]
        return store, refs, jstore, jrefs

    @staticmethod
    def _exporter(arena):
        def export(cid, arr):
            ref, _ = arena.export(arr, key=cid, min_bytes=0, lock=True)
            return ref

        return export

    def test_shm_first_writes_no_files(self):
        store, refs, jstore, _ = self._stores_with_chunks()
        with ShmStore() as arena, jshm.ShmStore() as jarena:
            m = store.manifest(export=self._exporter(arena))
            jm = jstore.manifest(export=self._exporter(jarena))
            assert {tag for tag, *_ in m.chunks.values()} == {"shm"}
            assert _bill(store) == _bill(jstore) == (0, 0)
            assert len(m.chunks) == len(jm.chunks) == len(refs)
            assert arena.bytes_exported == jarena.bytes_exported
            att = AttachedStore(m)
            for r in refs:  # a worker reads back every bit
                assert torch.equal(att.resolve(store.handle(r)), r.resolve())
            att.close()
        store.close()
        jstore.close()

    def test_fallback_spill_billed_once(self):
        store, refs, jstore, _ = self._stores_with_chunks()
        m1 = store.manifest()  # no exporter: force-spill path
        jstore.manifest()
        assert {tag for tag, *_ in m1.chunks.values()} == {"file"}
        first = _bill(store)
        assert first == _bill(jstore) and first[0] == len(refs) and first[1] > 0
        # a second manifest reuses the files for free
        m2 = store.manifest()
        jstore.manifest()
        assert _bill(store) == _bill(jstore) == first
        assert m2.chunks.keys() == m1.chunks.keys()
        att = AttachedStore(m2)
        assert torch.equal(att.resolve(store.handle(refs[2])), refs[2].resolve())
        assert att.stats.bytes_loaded == refs[2].nbytes  # a disk read is billed
        att.close()
        store.close()
        jstore.close()

    def test_known_yields_only_the_delta(self):
        store, _, jstore, _ = self._stores_with_chunks(n=2)
        m1 = store.manifest()
        jm1 = jstore.manifest()
        grown = store.put(_arr(512, seed=99).astype(np.float32))
        jgrown = jstore.put(_arr(512, seed=99).astype(np.float32))
        delta = store.manifest(known=m1.chunks.keys())
        jdelta = jstore.manifest(known=jm1.chunks.keys())
        assert set(delta.chunks) == {grown.chunk_id} == {jgrown.chunk_id} == set(jdelta.chunks)
        att = AttachedStore(m1)
        att.merge(delta)
        assert torch.equal(att.resolve(store.handle(grown)), grown.resolve())
        att.close()
        store.close()
        jstore.close()

    def test_manifested_resident_chunks_get_handles(self):
        store, refs, _, _ = self._stores_with_chunks(n=2)
        assert store.handle(refs[0]) is None  # resident, never handed off
        with ShmStore() as arena:
            store.manifest(export=self._exporter(arena))
            h = store.handle(refs[0])  # no spill file, but manifested
            assert h is not None and h.chunk_id == refs[0].chunk_id
            assert h.nbytes == refs[0].nbytes and pickle.loads(pickle.dumps(h)) == h
        store.close()


# ---------------------------------------------------------------------------
# EngineReport — the single field registry drives every aggregation path
# ---------------------------------------------------------------------------


class TestReportFieldRegistry:
    def test_registry_covers_every_non_sum_field(self):
        names = {f.name for f in dataclasses.fields(EngineReport)}
        assert set(_FIELD_RULES) <= names
        assert _FIELD_RULES["mode"] == "label"

    def test_every_field_round_trips_and_sums_generically(self):
        kw = {
            f.name: ("m" if f.name == "mode" else i + 1)
            for i, f in enumerate(dataclasses.fields(EngineReport))
        }
        rep = EngineReport(**kw)
        assert EngineReport.from_json(rep.to_json()) == rep
        summed = EngineReport.from_json(rep.to_json())
        summed += rep
        for f in dataclasses.fields(EngineReport):
            rule = _FIELD_RULES.get(f.name, "sum")
            want = {"sum": kw[f.name] * 2, "latest": kw[f.name], "label": kw[f.name]}[rule]
            assert getattr(summed, f.name) == want, f.name

    def test_shm_bytes_is_a_summed_counter(self):
        a = EngineReport(mode="x", shm_bytes=100, ipc_bytes=5)
        b = EngineReport(mode="x", shm_bytes=40, ipc_bytes=2)
        out = a.merge(b)
        assert (out.shm_bytes, out.ipc_bytes) == (140, 7)
        assert EngineReport.from_json(out.to_json()).shm_bytes == 140
