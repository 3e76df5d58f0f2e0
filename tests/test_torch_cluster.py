"""The port's ClusterExecutor against LocalExecutor and the JAX package's.

Every case of ``tests/test_cluster.py`` outside its fault-tolerance class
(which ``tests/test_torch_cluster_faults.py`` mirrors), on the CPU: the
same numpy input goes through the port's cluster, the port's Local backend
and the reference's cluster.  Values are bit-identical to Local's and equal
to the reference's; ``remote_dispatches``, ``retries``, ``shm_bytes`` and
the structural columns equal the reference's exactly.  ``ipc_bytes`` is
only checked positive (and against the port's own runs): pickles of torch
and JAX objects differ in size.  The reference cluster runs once per plan
in a module-scoped fixture, since each of its workers imports JAX.

Block functions that ship to workers live in ``tests/_torch_cluster_fns.py``,
so a worker of the port never imports JAX.
"""

from __future__ import annotations

import pickle
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cluster_fns as fns
import repro.api as japi
from repro.core import blocked as jblocked
from repro.core.apps.cascade_svm import cascade_svm as j_svm
from repro.core.apps.histogram import histogram as j_histogram
from repro.core.apps.kmeans import kmeans as j_kmeans
from repro.core.apps.knn import knn as j_knn
from repro_torch.api import (
    Baseline,
    ClusterExecutor,
    Collection,
    DiskStore,
    Executor,
    LocalExecutor,
    MeshExecutor,
    SplIter,
    StreamExecutor,
    ThreadedExecutor,
    decode_fn,
    encode_fn,
    engine,
    shm_available,
)
from repro_torch.api.executors import _SchedulerState, _Unit
from repro_torch.api.shm import leaked_segments
from repro_torch.core.apps.cascade_svm import cascade_svm
from repro_torch.core.apps.histogram import histogram
from repro_torch.core.apps.kmeans import kmeans
from repro_torch.core.apps.knn import knn
from repro_torch.core.blocked import BlockedArray, round_robin_placement

POL = "SplIter(partitions_per_location=2)"
PALLAS = "SplIter(partitions_per_location=2, fusion='pallas')"
STRUCTURAL = ("dispatches", "merges", "bytes_moved", "granularity")
REMOTE = ("remote_dispatches", "retries", "shm_bytes")
KNN_TOL = dict(rtol=1e-4, atol=1e-4)
needs_shm = pytest.mark.skipif(not shm_available(), reason="host has no POSIX shared memory")

warnings.filterwarnings("ignore", category=DeprecationWarning)


def _policy(api, text):
    return eval(text, {"SplIter": api.SplIter, "Baseline": api.Baseline})


def _blocked(a, block_rows=256, locs=2) -> BlockedArray:
    return BlockedArray.from_array(
        a, block_rows, num_locations=locs, policy=round_robin_placement, device="cpu"
    )


def _jblocked(a, block_rows=256, locs=2):
    return jblocked.BlockedArray.from_array(
        jnp.asarray(a), block_rows, num_locations=locs, policy=jblocked.round_robin_placement
    )


def _labels(seed=2):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(2048) > 0.5, 1.0, -1.0).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(0).random((2048, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def points(data) -> BlockedArray:
    return _blocked(data)


@pytest.fixture(scope="module")
def cluster():
    """One shared pool for the fault-free tests (spawn paid once)."""
    with engine("cluster") as ex:
        yield ex


@pytest.fixture(scope="module")
def jref(data):
    """The reference cluster's run of every fault-free plan here, once."""
    pts = _jblocked(data)
    qry = _jblocked(np.random.default_rng(1).random((256, 4)).astype(np.float32), 128)
    y = _jblocked(_labels())
    out = {}
    ex = japi.engine("cluster")
    try:
        out["histogram"] = j_histogram(pts, bins=8, policy=_policy(japi, POL), executor=ex)
        out["pallas"] = j_histogram(pts, bins=8, policy=_policy(japi, PALLAS), executor=ex)
        res = j_kmeans(pts, k=4, iters=3, policy=_policy(japi, POL), executor=ex)
        out["kmeans"] = (res.centers, res.reports)
        res = j_knn(pts, qry, k=4, policy=_policy(japi, POL), executor=ex)
        out["knn"] = (res.indices, res.distances, res.report)
        res = j_svm(pts, y, num_sv=16, steps=30, iterations=1, policy=_policy(japi, POL),
                    executor=ex)
        out["svm"] = (res.sv_x, res.sv_y, res.report)
    finally:
        ex.close()
    return out


def identical(a, b) -> bool:
    return bool(torch.equal(a, b))


def _same_columns(rep, jrep, cols=STRUCTURAL + REMOTE):
    assert {c: getattr(rep, c) for c in cols} == {c: getattr(jrep, c) for c in cols}


# ---------------------------------------------------------------------------
# bit-identity vs LocalExecutor, equality vs the reference — all four apps
# ---------------------------------------------------------------------------


class TestBitIdentity:
    def test_histogram(self, points, cluster, jref):
        ref, ref_rep = histogram(points, bins=8, policy=SplIter(partitions_per_location=2))
        h, rep = histogram(points, bins=8, policy=SplIter(partitions_per_location=2),
                           executor=cluster)
        jh, jrep = jref["histogram"]
        assert identical(h, ref)
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
        assert rep.dispatches == ref_rep.dispatches  # C1 parity over IPC
        assert rep.remote_dispatches == ref_rep.dispatches - ref_rep.merges
        assert rep.ipc_bytes > 0 and rep.retries == 0
        _same_columns(rep, jrep)

    def test_histogram_pallas_fusion(self, points, cluster, jref):
        pol = SplIter(partitions_per_location=2, fusion="pallas")
        ref, _ = histogram(points, bins=8, policy=pol)
        h, rep = histogram(points, bins=8, policy=pol, executor=cluster)
        jh, jrep = jref["pallas"]
        assert identical(h, ref)
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
        assert rep.remote_dispatches >= 1  # kernel rehydrated by name remotely
        _same_columns(rep, jrep)

    def test_kmeans(self, points, cluster, jref):
        pol = SplIter(partitions_per_location=2)
        ref = kmeans(points, k=4, iters=3, policy=pol)
        res = kmeans(points, k=4, iters=3, policy=pol, executor=cluster)
        jcenters, jreports = jref["kmeans"]
        assert identical(res.centers, ref.centers)
        np.testing.assert_allclose(res.centers.numpy(), np.asarray(jcenters), rtol=2e-5, atol=2e-5)
        assert sum(r.remote_dispatches for r in res.reports) >= 3 * 4
        for r, j in zip(res.reports, jreports, strict=True):
            _same_columns(r, j)

    def test_knn(self, points, cluster, jref):
        pol = SplIter(partitions_per_location=2)
        qry = _blocked(np.random.default_rng(1).random((256, 4)).astype(np.float32), 128)
        ref = knn(points, qry, k=4, policy=pol)
        res = knn(points, qry, k=4, policy=pol, executor=cluster)
        jind, jdist, jrep = jref["knn"]
        assert identical(res.indices, ref.indices)
        assert identical(res.distances, ref.distances)
        np.testing.assert_array_equal(res.indices.numpy(), np.asarray(jind))
        np.testing.assert_allclose(res.distances.numpy(), np.asarray(jdist), **KNN_TOL)
        # fit builds + lookup/merge loops are driver RPCs on the cluster
        assert res.report.remote_dispatches >= 1
        _same_columns(res.report, jrep)

    def test_svm(self, points, cluster, jref):
        pol = SplIter(partitions_per_location=2)
        y = _blocked(_labels())
        ref = cascade_svm(points, y, num_sv=16, steps=30, iterations=1, policy=pol)
        res = cascade_svm(points, y, num_sv=16, steps=30, iterations=1, policy=pol,
                          executor=cluster)
        jx, jy, jrep = jref["svm"]
        assert identical(res.sv_x, ref.sv_x)
        assert identical(res.sv_y, ref.sv_y)
        np.testing.assert_array_equal(res.sv_x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(res.sv_y.numpy(), np.asarray(jy))
        assert res.report.remote_dispatches >= 1
        _same_columns(res.report, jrep)

    def test_unreduced_map_partials_order(self, points, cluster):
        plan = Collection.from_blocked(points).split(Baseline()).map_blocks(fns.row_sum)
        ref = plan.compute(executor=LocalExecutor())
        got = plan.compute(executor=cluster)
        assert len(got.value) == len(ref.value) == points.num_blocks
        for g, r in zip(got.value, ref.value):
            assert identical(g, r)


def test_large_payloads_do_not_deadlock_pipes():
    """Both control-channel directions are blocking writes over ~64KB OS
    pipes; with shm off, 128KB operands and results ship inline.  The
    one-un-replied-command-per-worker window must keep every send aimed at
    a worker parked in ``recv``.  (The join's limit only turns a hang into
    a failure; no assertion reads a clock.)"""
    big_np = np.random.default_rng(3).random((2048, 128)).astype(np.float32)
    big = _blocked(big_np, 256)  # 128KB/block
    plan = Collection.from_blocked(big).split(Baseline()).map_blocks(fns.double)
    ref = plan.compute(executor=LocalExecutor())
    ex = ClusterExecutor(shm=False)  # force inline payloads: this test IS the pipe path
    box: dict = {}

    def run():
        box["got"] = plan.compute(executor=ex)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=180)
    try:
        if t.is_alive():
            pytest.fail("cluster run deadlocked on >64KB pipe payloads")
    finally:
        if not t.is_alive():
            ex.close()
    got = box["got"]
    assert got.report.remote_dispatches == big.num_blocks
    # operands AND results crossed the wire: ipc dwarfs the dataset
    assert got.report.ipc_bytes > 1.9 * big.nbytes
    assert got.report.shm_bytes == 0
    for g, r in zip(got.value, ref.value):
        assert identical(g, r)


# ---------------------------------------------------------------------------
# chunk-backed plans: bytes stay off the control channel
# ---------------------------------------------------------------------------


def test_chunk_handles_keep_bytes_off_the_wire(points, data):
    """shm=False — the spill-file path."""
    pol = SplIter(partitions_per_location=2)
    ref, _ = histogram(points, bins=8, policy=pol)
    ex_mem = ClusterExecutor(shm=False)
    _, rep_mem = histogram(points, bins=8, policy=pol, executor=ex_mem)
    ex_mem.close()

    store = DiskStore(residency_bytes=1 << 20, device="cpu")
    chunked = points.to_store(store)
    ex = ClusterExecutor(shm=False)
    h, rep = histogram(chunked, bins=8, policy=pol, executor=ex)
    ex.close()
    assert identical(h, ref)
    # operands travel as ChunkHandles resolved worker-side from the
    # manifested spill files: the dataset's bytes leave the control
    # channel and reappear as worker-side spill reads (bytes_loaded).
    assert rep_mem.ipc_bytes - rep.ipc_bytes > 0.9 * points.nbytes
    assert rep.bytes_loaded >= points.nbytes
    assert all(not store.is_pinned(r) for r in chunked.blocks)
    store.close()

    jstore = japi.DiskStore(residency_bytes=1 << 20)
    jex = japi.ClusterExecutor(shm=False)
    try:
        jh, jrep = j_histogram(_jblocked(data).to_store(jstore), bins=8,
                               policy=_policy(japi, POL), executor=jex)
    finally:
        jex.close()
        jstore.close()
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    _same_columns(rep, jrep, STRUCTURAL + REMOTE + ("bytes_loaded", "bytes_spilled"))


@needs_shm
def test_chunk_manifest_hands_off_via_shm_without_spilling(points):
    """shm on — resident chunks manifest as segments: no spill, no loads."""
    pol = SplIter(partitions_per_location=2)
    ref, _ = histogram(points, bins=8, policy=pol)
    store = DiskStore(residency_bytes=64 << 20, device="cpu")  # everything stays resident
    chunked = points.to_store(store)
    ex = ClusterExecutor(shm=True)
    h, rep = histogram(chunked, bins=8, policy=pol, executor=ex)
    assert identical(h, ref)
    # Asserted before close(): the close-time trim legitimately spills.
    assert store.stats.spills == 0 and store.stats.bytes_spilled == 0
    ex.close()
    assert rep.bytes_spilled == 0 and rep.bytes_loaded == 0
    assert rep.shm_bytes >= points.nbytes  # each chunk copied exactly once
    # exactly: the handoff's exports bill this execute (the reference bills
    # them to the report current before it), plus one reply per task
    assert rep.shm_bytes == points.nbytes + rep.remote_dispatches * 8**4 * 4
    assert rep.ipc_bytes < points.nbytes  # descriptors, not block bytes
    assert all(not store.is_pinned(r) for r in chunked.blocks)
    store.close()


# ---------------------------------------------------------------------------
# the shared-memory data plane
# ---------------------------------------------------------------------------


@needs_shm
class TestShmDataPlane:
    """Block payloads move through /dev/shm; the pipes carry descriptors:
    ≥10× less control-channel traffic on the two payload-heavy apps, with
    results bit-identical to Local and to the shm-off cluster."""

    def _run_both(self, app):
        out = {}
        for shm in (False, True):
            ex = ClusterExecutor(shm=shm)
            try:
                for _ in range(2):  # 2nd call: steady-state, export cache warm
                    res = app(ex)
            finally:
                ex.close()
            out[shm] = res
        return out[False], out[True]

    def test_knn_ipc_bytes_drop_10x(self):
        pol = SplIter(partitions_per_location=2)
        rng = np.random.default_rng(0)
        fit = _blocked(rng.random((2048, 3)).astype(np.float32))
        qry = _blocked(rng.random((512, 3)).astype(np.float32), 256)
        ref = knn(fit, qry, k=4, policy=pol)
        off, on = self._run_both(lambda ex: knn(fit, qry, k=4, policy=pol, executor=ex))
        for res in (off, on):
            assert identical(res.indices, ref.indices)
            assert identical(res.distances, ref.distances)
        assert off.report.ipc_bytes >= 10 * on.report.ipc_bytes
        assert on.report.shm_bytes > 0 and off.report.shm_bytes == 0

    def test_svm_ipc_bytes_drop_10x(self):
        pol = SplIter(partitions_per_location=2)
        rng = np.random.default_rng(0)
        pts = rng.standard_normal((4096, 16)).astype(np.float32)
        w = rng.standard_normal(16).astype(np.float32)
        labels = np.sign(pts @ w + 0.05 * rng.standard_normal(4096)).astype(np.float32)
        x, y = _blocked(pts, 512), _blocked(labels, 512)

        def app(ex):
            return cascade_svm(x, y, num_sv=32, steps=30, iterations=1, policy=pol, executor=ex)

        ref = cascade_svm(x, y, num_sv=32, steps=30, iterations=1, policy=pol)
        off, on = self._run_both(app)
        for res in (off, on):
            assert identical(res.sv_x, ref.sv_x)
            assert identical(res.sv_y, ref.sv_y)
        assert off.report.ipc_bytes >= 10 * on.report.ipc_bytes
        assert on.report.shm_bytes > 0

    def test_grown_store_reattaches_as_a_delta(self, points):
        # A second dataset lands in an ALREADY handed-off store: run 2 ships
        # only the new chunks' descriptors (manifest delta, merged in place).
        pol = SplIter(partitions_per_location=2)
        store = DiskStore(residency_bytes=64 << 20, device="cpu")
        chunked = points.to_store(store)
        ref, _ = histogram(points, bins=8, policy=pol)
        ex = ClusterExecutor(shm=True)
        h1, _ = histogram(chunked, bins=8, policy=pol, executor=ex)
        assert identical(h1, ref)
        pts2 = _blocked(np.random.default_rng(7).random((1024, 4)).astype(np.float32))
        ref2, _ = histogram(pts2, bins=8, policy=pol)
        chunked2 = pts2.to_store(store)  # the SAME store, grown mid-session
        h2, rep2 = histogram(chunked2, bins=8, policy=pol, executor=ex)
        assert identical(h2, ref2)
        assert store.stats.spills == 0  # delta handed off via shm too
        assert rep2.ipc_bytes < pts2.nbytes  # descriptors, not block bytes
        ex.close()
        store.close()


# ---------------------------------------------------------------------------
# scheduler-state ownership hooks, references, protocol, close
# ---------------------------------------------------------------------------


def test_scheduler_state_requeue_hooks():
    units = [_Unit(index=i, location=0, tasks=(), run=lambda: i, kind="task") for i in range(3)]
    state = _SchedulerState(units)
    state.assign(units[0], "w0")
    state.assign(units[1], "w0")
    state.assign(units[2], "w1")
    state.complete(units[1], "done-1")
    lost = state.requeue("w0")
    assert [u.index for u in lost] == [0]  # completed unit 1 is not lost
    assert state.attempts[0] == 1
    state.assign(units[0], "w1")
    assert state.attempts[0] == 2
    # duplicate completion (late reply from a presumed-dead worker) is a no-op
    assert state.complete(units[1], "dup") == []
    assert state.results[1] == "done-1"
    assert state.is_done(1) and not state.is_done(0)


def test_fnref_roundtrip():
    import functools

    from repro_torch.core.apps.kmeans import _combine, partial_sum_block

    ref = encode_fn(_combine)
    assert ref[0] == "import"
    assert decode_fn(ref) is _combine
    p = functools.partial(partial_sum_block)
    assert decode_fn(encode_fn(p)).func is partial_sum_block
    k = 3
    f = lambda x: x * k  # noqa: E731 — the shape under test
    g = decode_fn(encode_fn(f))
    assert g(7) == 21
    lock = threading.Lock()
    assert encode_fn(lambda x: (lock, x)) is None


def test_fnref_code_ref_of_the_older_form_still_decodes():
    """A ``("code", ...)`` reference journaled before the modules a
    function names were recorded (its defaults a pair) resolves against
    the defining module, as it did then."""
    k = 3
    ref = encode_fn(lambda x: torch.full((2,), float(x * k)))
    kind, module, code, name, defaults, closure = ref
    dflt, kwdflt, modules = pickle.loads(defaults)
    assert modules == {"torch": "torch"}
    old = decode_fn((kind, module, code, name, pickle.dumps((dflt, kwdflt)), closure))
    assert old.__globals__ is globals()
    assert torch.equal(old(7), torch.full((2,), 21.0))


def test_cluster_executor_satisfies_protocol():
    # (prefer_pallas is not compared: the port prefers its kernel whenever a
    # plan's blocks lie on the card, and lowering decides that per plan)
    flags = ("pallas_fusion", "grouped_dispatch", "out_of_core", "remote", "pipelined")
    ex, jex = ClusterExecutor(), japi.ClusterExecutor()
    assert isinstance(ex, Executor)
    assert {f: getattr(ex.capabilities, f) for f in flags} == {
        f: getattr(jex.capabilities, f) for f in flags
    }
    assert ex.capabilities.exporter is not None  # the shm data plane is on
    ex.close()
    jex.close()


def _make(name):
    if name == "MeshExecutor":
        return MeshExecutor(devices=(torch.device("cpu"),))
    return {"LocalExecutor": LocalExecutor, "ThreadedExecutor": ThreadedExecutor,
            "StreamExecutor": StreamExecutor, "ClusterExecutor": ClusterExecutor}[name]()


@pytest.mark.parametrize(
    "make",
    ["LocalExecutor", "ThreadedExecutor", "MeshExecutor", "StreamExecutor", "ClusterExecutor"],
)
def test_close_is_idempotent(make, points):
    pol = SplIter(partitions_per_location=2)
    ex = _make(make)
    _, _ = histogram(points, bins=8, policy=pol, executor=ex)
    ex.close()
    ex.close()  # second close must be a clean no-op
    # close → reuse → close: pools/workers respawn transparently
    h, _ = histogram(points, bins=8, policy=pol, executor=ex)
    ref, _ = histogram(points, bins=8, policy=pol)
    assert identical(h, ref)
    ex.close()
    ex.close()
    if make == "ClusterExecutor":
        assert ex.workers_alive() == [] and leaked_segments(ex._shm.prefix) == []


def test_stream_close_twice_with_disk_store(points):
    """Double close must not re-enter the (already closed) store's teardown."""
    store = DiskStore(residency_bytes=1 << 14, device="cpu")
    chunked = points.to_store(store)
    ex = StreamExecutor()
    _, _ = histogram(chunked, bins=8, policy=SplIter(partitions_per_location=2), executor=ex)
    ex.close()
    assert store.closed
    ex.close()  # second close: store already gone, must not raise
    assert store.closed


def test_task_spec_pickles_and_names_its_device(points):
    """The descriptor a worker receives: picklable, with the blocks' device."""
    plan = Collection.from_blocked(points).split(SplIter()).map_blocks(fns.row_sum) \
        .reduce(fns.combine)
    with ClusterExecutor(shm=False) as ex:
        graph = ex.lower(plan.plan())
    spec = graph.tasks[0].spec()
    assert spec.device == "cpu" and spec.kind == "partition_scan"
    assert pickle.loads(pickle.dumps(spec)).fn_ref == spec.fn_ref
