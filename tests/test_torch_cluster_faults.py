"""The port's ClusterExecutor under injected faults, against the reference.

Every case of ``tests/test_cluster.py``'s ``TestFaultTolerance``, on the
CPU: a worker killed mid-run has its units replayed on a survivor with a
value bit-identical to Local's; a kill releases the dead dispatch's chunk
pins; two kills of one unit exhaust ``max_retries`` into a typed
:class:`ClusterFailedError`; a torn command pipe and a worker dying under a
driver RPC both replay; nothing leaks in ``/dev/shm``.  Where the reference
runs the same fault plan (module-scoped fixture, one run per plan), its
value and its ``retries`` / ``remote_dispatches`` / ``shm_bytes`` are the
port's too.

No assertion reads a clock: the hung worker is buried once its own log says
it went mute, by raising the silence the supervisor observed for it past
the timeout (the supervisor check itself does the burying), never by
waiting out ``heartbeat_timeout_s``.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import blocked as jblocked
from repro.core.apps.histogram import histogram as j_histogram
from repro_torch.api import ClusterExecutor, ClusterFailedError, DiskStore, FaultPlan, SplIter
from repro_torch.api.shm import leaked_segments, shm_available
from repro_torch.core.apps.histogram import histogram
from repro_torch.core.apps.knn import knn
from repro_torch.core.blocked import BlockedArray, round_robin_placement

from _torch_cluster_fns import bury_when_mute

POL = SplIter(partitions_per_location=2)
POL4 = SplIter(partitions_per_location=4)
REMOTE = ("dispatches", "merges", "remote_dispatches", "retries", "shm_bytes")
needs_shm = pytest.mark.skipif(not shm_available(), reason="host has no POSIX shared memory")

warnings.filterwarnings("ignore", category=DeprecationWarning)


def _blocked(a, block_rows=256, locs=2) -> BlockedArray:
    return BlockedArray.from_array(
        a, block_rows, num_locations=locs, policy=round_robin_placement, device="cpu"
    )


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(0).random((2048, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def points(data) -> BlockedArray:
    return _blocked(data)


@pytest.fixture(scope="module")
def jfaults(data):
    """The reference cluster under each fault plan compared here, once."""
    pts = jblocked.BlockedArray.from_array(
        jnp.asarray(data), 256, num_locations=2, policy=jblocked.round_robin_placement
    )
    pol4 = japi.SplIter(partitions_per_location=4)
    out = {}
    for name, kill in (("midrun", (0, 2)), ("merge_wait", (0, 4))):
        ex = japi.ClusterExecutor(fault_plan=japi.FaultPlan(kill_after=(kill,)))
        try:
            out[name] = j_histogram(pts, bins=8, policy=pol4, executor=ex)
        finally:
            ex.close()
    return out


def identical(a, b) -> bool:
    return bool(torch.equal(a, b))


def _same_as_reference(h, rep, jrun):
    jh, jrep = jrun
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    assert {c: getattr(rep, c) for c in REMOTE} == {c: getattr(jrep, c) for c in REMOTE}


class TestFaultTolerance:
    def test_kill_midrun_replays_bit_identical(self, points, jfaults):
        ref, _ = histogram(points, bins=8, policy=POL4)
        ex = ClusterExecutor(fault_plan=FaultPlan(kill_after=((0, 2),)))
        h, rep = histogram(points, bins=8, policy=POL4, executor=ex)
        assert identical(h, ref)
        assert rep.retries >= 1
        assert len(ex.retry_log) == rep.retries
        _same_as_reference(h, rep, jfaults["midrun"])
        # the pool healed onto survivors: a follow-up run still works
        h2, rep2 = histogram(points, bins=8, policy=POL4, executor=ex)
        assert identical(h2, ref) and rep2.retries == 0
        ex.close()

    def test_kill_during_merge_dependency_wait(self, points, jfaults):
        # Worker 0 dies on its LAST queued unit: by then every task unit is
        # dispatched and the parent waits for the merge's dependencies —
        # the requeue must un-stick that wait.
        ref, ref_rep = histogram(points, bins=8, policy=POL4)
        ex = ClusterExecutor(fault_plan=FaultPlan(kill_after=((0, 4),)))
        h, rep = histogram(points, bins=8, policy=POL4, executor=ex)
        ex.close()
        assert identical(h, ref)
        assert rep.retries >= 1
        assert rep.merges == ref_rep.merges  # the merge still ran, once
        _same_as_reference(h, rep, jfaults["merge_wait"])

    def test_kill_worker_owning_pinned_chunk_releases_pins(self, points):
        store = DiskStore(residency_bytes=1 << 20, device="cpu")
        chunked = points.to_store(store)
        ref, _ = histogram(points, bins=8, policy=POL4)
        ex = ClusterExecutor(fault_plan=FaultPlan(kill_after=((1, 1),)))
        h, rep = histogram(chunked, bins=8, policy=POL4, executor=ex)
        ex.close()
        assert identical(h, ref)
        assert rep.retries >= 1
        # release-on-requeue: no pin outlives the dead dispatch
        assert all(not store.is_pinned(r) for r in chunked.blocks)
        store.close()

    def test_two_kills_exhaust_max_retries(self, points, tmp_path):
        # worker 0 dies on first receipt; the replay lands on surviving
        # worker 1, which dies on any retried unit → attempts exceed
        # max_retries=1 → typed failure naming the poisoned task.
        ex = ClusterExecutor(
            max_retries=1,
            fault_plan=FaultPlan(kill_after=((0, 1),), kill_on_retry=(1,)),
            log_dir=str(tmp_path),
        )
        with pytest.raises(ClusterFailedError, match="poisoned") as ei:
            histogram(points, bins=8, policy=POL, executor=ex)
        assert ei.value.task_key is not None
        assert "histogramdd_block" in ei.value.task_key
        assert len(ei.value.attempts) >= 2
        assert len({a["worker"] for a in ei.value.attempts}) >= 2
        assert all(a["error"] for a in ei.value.attempts)
        assert "attempt history" in str(ei.value)
        # with worker logging on, the error points at the log files
        assert ei.value.log_paths
        assert all(p.startswith(str(tmp_path)) for p in ei.value.log_paths)
        # the executor survives the failure: fresh workers, clean run
        ref, _ = histogram(points, bins=8, policy=POL)
        h, _ = histogram(points, bins=8, policy=POL, executor=ex)
        assert identical(h, ref)
        ex.close()

    def test_send_boundary_death_requeues_unit(self, points):
        # A worker that passes the liveness check but whose command pipe is
        # already torn raises OSError inside the send itself.  The unit is
        # assigned before the transport is touched, so it is replayed.
        ref, _ = histogram(points, bins=8, policy=POL)
        ex = ClusterExecutor()
        h0, _ = histogram(points, bins=8, policy=POL, executor=ex)  # warm pool
        assert identical(h0, ref)
        ex._workers[0]._conn.close()  # torn transport, process still alive
        h, rep = histogram(points, bins=8, policy=POL, executor=ex)
        ex.close()
        assert identical(h, ref)
        assert rep.retries >= 1

    def test_driver_rpc_retries_on_worker_death(self, points):
        qry = _blocked(np.random.default_rng(1).random((256, 4)).astype(np.float32), 128)
        ref = knn(points, qry, k=4, policy=POL)
        ex = ClusterExecutor(fault_plan=FaultPlan(kill_after=((0, 3),)))
        res = knn(points, qry, k=4, policy=POL, executor=ex)
        ex.close()
        assert identical(res.indices, ref.indices)
        assert identical(res.distances, ref.distances)
        assert res.report.retries >= 1

    @needs_shm
    def test_kill_midrun_leaks_no_shm_segments(self, points):
        # The dead worker's in-flight reply segment (and every operand
        # segment pinned for its units) must be swept.
        ref, _ = histogram(points, bins=8, policy=POL4)
        ex = ClusterExecutor(fault_plan=FaultPlan(kill_after=((0, 2),)))
        prefix = ex._shm.prefix
        h, rep = histogram(points, bins=8, policy=POL4, executor=ex)
        assert identical(h, ref)
        assert rep.retries >= 1
        assert ex._shm.pinned_segments() == {}  # every dispatch pin dropped
        ex.close()
        assert leaked_segments(prefix) == []
        assert ex.workers_alive() == []

    @needs_shm
    def test_poisoned_run_leaks_no_shm_segments(self, points):
        ex = ClusterExecutor(
            max_retries=1, fault_plan=FaultPlan(kill_after=((0, 1),), kill_on_retry=(1,))
        )
        prefix = ex._shm.prefix
        with pytest.raises(ClusterFailedError):
            histogram(points, bins=8, policy=POL, executor=ex)
        ex.close()
        assert leaked_segments(prefix) == []

    def test_hung_worker_detected_by_heartbeat_timeout(self, points, tmp_path):
        # mute: the worker process stays alive but stops heartbeating and
        # never replies — only the staleness detector can reclaim it.
        ex = ClusterExecutor(
            fault_plan=FaultPlan(mute_after=((0, 2),)), heartbeat_s=0.1, log_dir=str(tmp_path)
        )
        bury_when_mute(ex, 0)
        ref, _ = histogram(points, bins=8, policy=POL)
        h, rep = histogram(points, bins=8, policy=POL, executor=ex)
        ex.close()
        assert identical(h, ref)
        assert rep.retries >= 1
        assert {e["cause"] for e in ex.retry_log} == {"hung (heartbeat stale)"}
