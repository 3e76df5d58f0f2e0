"""The port's JobServer, JobClient and JobJournal against ``tests/test_jobserver.py``.

Every case of the reference's job-service tests runs here on the port with
``device="cpu"``: report channel copies and segment merges, the journal's
torn-tail tolerance, two tenants multiplexed bit-identically onto one pool,
stride fairness by weight, shared assets across tenants, typed admission
and failures, the lifecycle event order, and kill + restart resuming only
the unfinished units, bit for bit.

The tests wait on the server's own events (a hook on ``JobServer._emit``)
and conditions, never on a sleep: a kill lands right after the unit it
waits for, whatever the host's speed.  Beyond the reference's cases: a
journal either package wrote replays in the other's reader (the same
frames, byte for byte), a journaled job's inputs go back onto the device
type its payload records, the mesh backend serves and resumes jobs, and
the same plans through the JAX JobServer give equal values and structural
columns.
"""

from __future__ import annotations

import os
import pickle
import threading
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import blocked as jblocked
from repro.core.apps.histogram import histogram as jhistogram
from repro_torch.api import (
    Baseline,
    Collection,
    Executor,
    JobClient,
    JobFailedError,
    JobJournal,
    JobRejected,
    JobServer,
    LocalExecutor,
    SplIter,
    engine,
)
from repro_torch.core.apps.histogram import histogram, histogramdd_block
from repro_torch.core.apps.kmeans import kmeans
from repro_torch.core.blocked import BlockedArray
from repro_torch.core.engine import EngineReport

POL = SplIter(partitions_per_location=2)
WATCHDOG_S = 120.0  # every wait in this module is bounded
STRUCTURAL = ("dispatches", "merges", "traces", "bytes_moved", "granularity")


def _points(n=240, d=4, block_rows=30, locations=2, seed=0):
    x = np.random.default_rng(seed).uniform(size=(n, d)).astype(np.float32)
    return BlockedArray.from_array(x, block_rows, num_locations=locations, device="cpu")


def _hist_plan(ba, bins=4, policy=POL):
    return (
        Collection.from_blocked(ba)
        .split(policy)
        .map_blocks(partial(histogramdd_block, bins=bins, lo=0.0, hi=1.0))
        .reduce(lambda a, b: a + b)
        .plan()
    )


def identical(a, b) -> bool:
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def _watch(server: JobServer, predicate, *, stop: bool = False) -> threading.Event:
    """An event set the first time ``predicate(job, kind)`` holds for an
    emitted lifecycle event, after it is recorded.  With ``stop`` the
    scheduler also stops right there: on the scheduler thread, before it
    picks another unit, so the next ``kill()`` finds exactly that state."""
    hit = threading.Event()
    emit = server._emit

    def watched(job, kind, detail="", completed=0, total=0):
        emit(job, kind, detail, completed, total)
        if not hit.is_set() and predicate(job, kind):
            if stop:
                server._stop.set()
            hit.set()

    server._emit = watched
    return hit


def _unit_owners(server):
    return [e.job_id for e in server.event_log if e.kind in ("running", "merged") and e.total]


# ---------------------------------------------------------------------------
# EngineReport channel serialization + segment merging
# ---------------------------------------------------------------------------


class TestEngineReportChannel:
    def test_json_round_trip_is_exact(self):
        rep = EngineReport(
            mode="spliter", dispatches=12, merges=2, traces=3, bytes_moved=640,
            wall_s=1.25, granularity=4, retunes=1, bytes_loaded=100,
            bytes_spilled=50, prefetch_hits=7, remote_dispatches=8,
            ipc_bytes=4096, retries=1,
        )
        back = EngineReport.from_json(rep.to_json())
        assert back == rep
        assert back is not rep

    def test_from_json_ignores_unknown_keys(self):
        payload = EngineReport(mode="x", dispatches=1).to_json()
        payload = payload.replace("{", '{"counter_from_the_future": 9, ', 1)
        assert EngineReport.from_json(payload).dispatches == 1

    def test_merge_sums_counters_without_mutating_inputs(self):
        a = EngineReport(mode="spliter", dispatches=5, traces=2, granularity=2)
        b = EngineReport(mode="spliter", dispatches=3, traces=0, granularity=4)
        out = a.merge(b)
        assert (out.dispatches, out.traces, out.granularity) == (8, 2, 4)
        assert (a.dispatches, b.dispatches) == (5, 3)

    def test_merge_joins_disagreeing_modes(self):
        out = EngineReport(mode="spliter").merge(EngineReport(mode="rechunk"))
        assert out.mode == "spliter+rechunk"

    def test_reports_cross_the_channel_between_packages(self):
        from repro.core.engine import EngineReport as JReport

        rep = EngineReport(mode="spliter", dispatches=9, merges=1, bytes_moved=17)
        jrep = JReport.from_json(rep.to_json())
        assert jrep.to_json() == rep.to_json()
        assert EngineReport.from_json(jrep.to_json()) == rep


# ---------------------------------------------------------------------------
# the write-ahead journal
# ---------------------------------------------------------------------------

HOST_RECORDS = [
    ("job", "job-0000", "alice", 2, "f" * 32, b"\x00payload"),
    ("start", "job-0000", pickle.dumps(("a", 1))),
    ("unit", "job-0000", "u0:(part):0,1", pickle.dumps((np.arange(4, dtype=np.int32),))),
    ("done", "job-0000", '{"dispatches": 3}'),
    ("failed", "job-0001", "ValueError: x"),
]


class TestJobJournal:
    def test_append_replay_round_trip(self, tmp_path):
        path = str(tmp_path / "j.bin")
        with JobJournal(path, fsync=False) as j:
            j.append(("job", "job-0000", {"weight": 2}))
            j.append(("unit", "job-0000", "u0:abc:0,1", b"\x00payload"))
        assert list(JobJournal.replay(path)) == [
            ("job", "job-0000", {"weight": 2}),
            ("unit", "job-0000", "u0:abc:0,1", b"\x00payload"),
        ]

    def test_torn_tail_is_dropped_not_fatal(self, tmp_path):
        path = str(tmp_path / "j.bin")
        with JobJournal(path, fsync=False) as j:
            for i in range(3):
                j.append(("rec", i))
        size = os.path.getsize(path)
        with open(path, "ab") as f:  # crash mid-append: half a frame
            f.write(b"\x00\x00\x01\x00garbage")
        assert [r[1] for r in JobJournal.replay(path)] == [0, 1, 2]
        with open(path, "r+b") as f:  # corrupt the LAST record's payload
            f.seek(size - 1)
            f.write(b"\xff")
        assert [r[1] for r in JobJournal.replay(path)] == [0, 1]

    def test_missing_file_is_empty_history(self, tmp_path):
        assert list(JobJournal.replay(str(tmp_path / "absent.bin"))) == []

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_journal_replays_in_the_other_package(self, tmp_path, writer):
        path = str(tmp_path / "j.bin")
        cls, reader = (JobJournal, japi.JobJournal) if writer == "port" else (
            japi.JobJournal, JobJournal)
        with cls(path, fsync=True) as j:
            for rec in HOST_RECORDS:
                j.append(rec)
        assert list(reader.replay(path)) == HOST_RECORDS

    def test_both_packages_write_the_same_frames(self, tmp_path):
        for cls, name in ((JobJournal, "t.bin"), (japi.JobJournal, "j.bin")):
            with cls(str(tmp_path / name), fsync=False) as j:
                for rec in HOST_RECORDS:
                    j.append(rec)
        assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()

    def test_torn_tail_written_by_one_is_dropped_by_the_other(self, tmp_path):
        path = str(tmp_path / "j.bin")
        with JobJournal(path, fsync=False) as j:
            for rec in HOST_RECORDS:
                j.append(rec)
        with open(path, "ab") as f:
            f.write(b"\x00\x00\x00\x40torn")
        assert len(list(japi.JobJournal.replay(path))) == len(HOST_RECORDS)


# ---------------------------------------------------------------------------
# multiplexing: concurrent tenants on one pool
# ---------------------------------------------------------------------------


class TestMultiplexing:
    def test_jobclient_satisfies_executor_protocol(self):
        server = JobServer()
        assert isinstance(JobClient(server), Executor)
        server.close()

    def test_two_clients_bit_identical_and_interleaved(self):
        """The headline acceptance case: kmeans + histogram, one pool."""
        kdata = _points(seed=0)
        hdata = _points(n=400, d=2, block_rows=40, seed=1)
        ref_k = kmeans(kdata, k=4, iters=3, policy=POL, executor=LocalExecutor())
        ref_h, _ = histogram(hdata, bins=4, policy=POL, executor=LocalExecutor())

        # both tenants admitted BEFORE the scheduler starts, so their units
        # provably coexist in the run queue
        server = JobServer(autostart=False)
        queued: list[str] = []
        both = _watch(server, lambda job, kind: kind == "queued" and (
            queued.append(job.id) or len(queued) == 2))
        alice = JobClient(server, tenant="alice")
        bob = JobClient(server, tenant="bob")
        results: dict[str, object] = {}

        def run_kmeans():
            results["k"] = kmeans(kdata, k=4, iters=3, policy=POL, executor=alice)

        def run_hist():
            results["h"] = histogram(hdata, bins=4, policy=POL, executor=bob)[0]

        threads = [threading.Thread(target=run_kmeans), threading.Thread(target=run_hist)]
        for t in threads:
            t.start()
        assert both.wait(WATCHDOG_S)
        server.start()
        for t in threads:
            t.join(WATCHDOG_S)
            assert not t.is_alive()
        assert identical(results["k"].centers, ref_k.centers)
        assert identical(results["h"], ref_h)

        jobs = server.jobs()
        a_id, b_id = jobs[0].id, jobs[1].id
        owners = _unit_owners(server)
        first_b = owners.index(b_id)
        last_a = len(owners) - 1 - owners[::-1].index(a_id)
        assert first_b < last_a, "tenant B's units never ran between A's"
        server.close()

    def test_per_job_reports_are_channel_copies(self):
        server = JobServer()
        client = JobClient(server, tenant="t")
        res = client.execute(_hist_plan(_points()))
        job = server.jobs()[0]
        assert res.report is not job.report
        assert res.report.dispatches == job.report.dispatches
        assert res.report.dispatches > 0
        server.close()

    def test_weighted_tenant_gets_more_unit_slots(self):
        data = _points(n=480, block_rows=30, locations=2)
        server = JobServer(autostart=False)
        light = server.submit(_hist_plan(data), tenant="light", weight=1)
        heavy = server.submit(_hist_plan(data), tenant="heavy", weight=3)
        server.start()
        server.wait(light, WATCHDOG_S)
        server.wait(heavy, WATCHDOG_S)
        owners = _unit_owners(server)
        n = len(owners) // 2
        heavy_early = sum(1 for j in owners[:n] if j == heavy.id)
        assert heavy_early > n // 2, "weight-3 tenant did not lead the schedule"
        server.close()

    def test_weight_two_gets_twice_the_slots_while_both_are_open(self):
        """Stride fairness: while both jobs are open, a weight-2 tenant runs
        two units for each of a weight-1 tenant's (within one unit)."""
        data = _points(n=960, block_rows=30, locations=2)
        server = JobServer(autostart=False)
        light = server.submit(_hist_plan(data), tenant="light", weight=1)
        heavy = server.submit(_hist_plan(data), tenant="heavy", weight=2)
        server.start()
        server.wait(light, WATCHDOG_S)
        server.wait(heavy, WATCHDOG_S)
        owners = _unit_owners(server)
        first_done = min(owners.index(heavy.id) + heavy.total_units,
                         len(owners))
        window = owners[:first_done]
        h, l_ = window.count(heavy.id), window.count(light.id)
        assert abs(h - 2 * l_) <= 2, (h, l_)
        server.close()

    def test_scope_and_task_on_the_client(self):
        server = JobServer()
        client = JobClient(server, tenant="t")
        double = client.task(lambda x: x * 2.0, key="double")
        with client.scope("spliter") as report:
            client.execute(_hist_plan(_points()))
            double(torch.ones(2))
        assert report.dispatches > 1
        server.close()

    def test_shared_assets_reuse_probes_across_tenants(self):
        auto = SplIter(partitions_per_location="auto")
        a = _points(n=256, d=2, block_rows=16, seed=2)
        b = _points(n=256, d=2, block_rows=16, seed=3)
        server = JobServer()
        ca = JobClient(server, tenant="a")
        cb = JobClient(server, tenant="b")
        for _ in range(2):
            histogram(a, bins=4, policy=auto, executor=ca)
        for _ in range(2):
            histogram(b, bins=4, policy=auto, executor=cb)
        assert len(server.assets.tuners) == 1
        (_, tuner), = server.assets.tuners.values()
        assert len(tuner.samples) >= 2
        server.close()

    @pytest.mark.parametrize("backend", ["threaded", "mesh"])
    def test_pool_backend_is_pluggable(self, backend):
        data = _points()
        ref, _ = histogram(data, bins=4, policy=POL, executor=LocalExecutor())
        pool = engine(backend, devices=(torch.device("cpu"),) * 2)
        server = JobServer(executor=pool)
        h, rep = histogram(data, bins=4, policy=POL, executor=JobClient(server, tenant="t"))
        assert identical(h, ref)
        if backend == "mesh":  # every partition in one sharded unit, 2 ranks
            assert (rep.dispatches, rep.merges) == (1, 1)
        server.close()
        server.executor.close()

    def test_failed_job_raises_typed_error(self):
        def boom(block):
            raise ValueError("deliberate block failure")

        plan = (
            Collection.from_blocked(_points()).split(Baseline())
            .map_blocks(boom).reduce(lambda a, b: a).plan()
        )
        server = JobServer()
        client = JobClient(server, tenant="t")
        job = client.submit(plan)
        with pytest.raises(JobFailedError, match="deliberate"):
            client.wait(job, WATCHDOG_S)
        assert job.status == "failed"
        assert server.event_log[-1].kind == "failed"
        server.close()


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


class TestAdmission:
    def test_queue_full_is_typed_rejection(self):
        data = _points()
        server = JobServer(max_pending=2, autostart=False)
        server.submit(_hist_plan(data), tenant="t")
        server.submit(_hist_plan(data), tenant="t")
        with pytest.raises(JobRejected) as ei:
            server.submit(_hist_plan(data), tenant="t")
        assert ei.value.reason == "queue_full"
        server.start()
        for job in server.jobs():
            server.wait(job, WATCHDOG_S)
        server.submit(_hist_plan(data), tenant="t")
        server.close()

    def test_closed_server_rejects(self):
        server = JobServer()
        server.close()
        with pytest.raises(JobRejected) as ei:
            server.submit(_hist_plan(_points()))
        assert ei.value.reason == "closed"

    def test_lifecycle_event_order(self):
        server = JobServer()
        job = server.submit(_hist_plan(_points()), tenant="t")
        server.wait(job, WATCHDOG_S)
        kinds = [e.kind for e in job.events]
        assert kinds[0] == "queued"
        assert kinds[1] == "preparing"
        assert kinds[-2] == "merged"
        assert kinds[-1] == "done"
        assert all(k == "running" for k in kinds[2:-2])
        progress = [e.completed for e in job.events if e.total]
        assert progress == sorted(progress)
        assert job.events[-1].completed == job.total_units
        server.close()


# ---------------------------------------------------------------------------
# durability: kill + restart resumes from journal + snapshot
# ---------------------------------------------------------------------------


def _kill_after(server: JobServer, job_units: int) -> threading.Event:
    """Stop the scheduler right after ``job_units`` units have run."""
    return _watch(server, lambda job, kind: kind == "running"
                  and job.recomputed_units >= job_units, stop=True)


class TestDurability:
    @pytest.mark.parametrize("backend", ["local", "mesh"])
    def test_kill_and_resume_recomputes_only_unfinished_units(self, tmp_path, backend):
        data = _points(n=800, d=2, block_rows=50, locations=4, seed=5)
        ref, _ = histogram(data, bins=4, policy=POL, executor=LocalExecutor())
        plan = _hist_plan(data)
        cpu = (torch.device("cpu"),)

        server = engine("server", server_backend=backend, devices=cpu, root=str(tmp_path),
                        snapshot_every=2, autostart=False)
        job = server.submit(plan, tenant="alice")
        reached = _kill_after(server, 2 if backend == "local" else 1)
        server.start()
        assert reached.wait(WATCHDOG_S), job.error
        server.kill()  # crash: no terminal records, journal left as-is
        done_at_kill = job.recomputed_units
        assert job.status in ("preparing", "running")
        assert done_at_kill < job.total_units

        server2 = engine("server", server_backend=backend, devices=cpu, root=str(tmp_path))
        assert server2.resumed_jobs == 1
        job2 = server2.jobs()[0]
        res = server2.wait(job2, WATCHDOG_S)
        assert job2.restored_units == done_at_kill
        assert job2.restored_units + job2.recomputed_units == job2.total_units
        assert job2.recomputed_units < job2.total_units
        assert identical(res.value, ref)
        assert any(e.kind == "resumed" for e in job2.events)
        server2.close()

    def test_resumed_report_merges_segments(self, tmp_path):
        data = _points(n=400, d=2, block_rows=50, locations=2, seed=6)
        server = JobServer(root=str(tmp_path), snapshot_every=1, autostart=False)
        job = server.submit(_hist_plan(data), tenant="t")
        reached = _kill_after(server, 2)
        server.start()
        assert reached.wait(WATCHDOG_S)
        server.kill()

        server2 = JobServer(root=str(tmp_path))
        job2 = server2.jobs()[0]
        res = server2.wait(job2, WATCHDOG_S)
        assert res.report.dispatches == job2.total_units
        server2.close()

    def test_kmeans_job_resumes_bit_identically(self, tmp_path):
        """A plan with a tensor extra (the centers) resumes from its payload."""
        from repro_torch.core.apps.kmeans import _combine, partial_sum_block

        data = _points(n=600, d=3, block_rows=50, locations=3, seed=8)
        centers = torch.rand(4, 3, generator=torch.Generator().manual_seed(0))
        plan = (Collection.from_blocked(data).split(POL)
                .map_blocks(partial_sum_block, extra_args=(centers,)).reduce(_combine))
        ref = plan.compute(executor=LocalExecutor()).value
        server = JobServer(root=str(tmp_path), autostart=False)
        job = server.submit(plan.plan(), tenant="t")
        reached = _kill_after(server, 3)
        server.start()
        assert reached.wait(WATCHDOG_S)
        server.kill()
        server2 = JobServer(root=str(tmp_path))
        job2 = server2.jobs()[0]
        value = server2.wait(job2, WATCHDOG_S).value
        assert job2.restored_units == 3
        assert identical(value[0], ref[0]) and identical(value[1], ref[1])
        server2.close()

    def test_completed_job_survives_restart_without_rerun(self, tmp_path):
        server = JobServer(root=str(tmp_path))
        job = server.submit(_hist_plan(_points()), tenant="t")
        ref = server.wait(job, WATCHDOG_S)
        server.close()

        server2 = JobServer(root=str(tmp_path))
        assert server2.resumed_jobs == 0
        job2 = server2.jobs()[0]
        assert job2.status == "done"
        res = server2.wait(job2, WATCHDOG_S)
        assert identical(res.value, ref.value)
        assert job2.recomputed_units == 0
        server2.close()

    def test_non_durable_job_fails_cleanly_at_restart(self, tmp_path):
        lock = threading.Lock()  # unpicklable cell value

        def opaque(block):
            with lock:
                return block.sum(0)

        plan = (
            Collection.from_blocked(_points()).split(POL)
            .map_blocks(opaque).reduce(lambda a, b: a + b).plan()
        )
        server = JobServer(root=str(tmp_path), autostart=False)
        job = server.submit(plan, tenant="t")
        assert not job.durable
        server.kill()

        server2 = JobServer(root=str(tmp_path))
        job2 = server2.jobs()[0]
        with pytest.raises(JobFailedError, match="not durable"):
            server2.wait(job2, WATCHDOG_S)
        server2.close()

    def test_snapshots_use_committed_marker_layout(self, tmp_path):
        data = _points(n=400, d=2, block_rows=25, locations=2)
        server = JobServer(root=str(tmp_path), snapshot_every=2)
        job = server.submit(_hist_plan(data), tenant="t")
        server.wait(job, WATCHDOG_S)
        snaps = os.path.join(str(tmp_path), "snapshots")
        committed = [f for f in os.listdir(snaps) if f.endswith(".COMMITTED")]
        assert committed, "no committed scheduler snapshot written"
        manifest, _ = server.checkpointer.load_manifest()
        assert "tenant_pass" in manifest["extras"]
        server.close()


# ---------------------------------------------------------------------------
# the device of a journaled job's inputs
# ---------------------------------------------------------------------------


def test_payload_records_and_restores_the_input_device():
    spec = _hist_plan(_points()).spec
    payload = JobServer._encode_payload(spec)
    d = pickle.loads(payload)
    assert [inp[3] for inp in d["inputs"]] == ["cpu"]
    rebuilt = JobServer._decode_payload(payload)
    assert rebuilt.inputs[0].device.type == "cpu"
    assert all(identical(a, b) for a, b in zip(rebuilt.inputs[0].blocks, spec.inputs[0].blocks))


def test_a_cuda_payload_goes_back_onto_the_card_or_raises():
    """A job journaled from a CUDA plan rebuilds its blocks and extras on
    the current CUDA device — and raises on a host without one, rather than
    resuming on the CPU, where ``lower()`` would drop the kernel."""
    from repro_torch.core.apps.kmeans import _combine, partial_sum_block

    data = _points()
    plan = (Collection.from_blocked(data).split(POL)
            .map_blocks(partial_sum_block, extra_args=(torch.rand(3, 4),))
            .reduce(_combine).plan())
    d = pickle.loads(JobServer._encode_payload(plan.spec))
    d["inputs"] = tuple(inp[:3] + ("cuda",) for inp in d["inputs"])
    d["extra_args"] = tuple((e, "cuda") for e, _ in d["extra_args"])
    payload = pickle.dumps(d)
    if torch.cuda.is_available():
        spec = JobServer._decode_payload(payload)
        assert spec.inputs[0].device.type == "cuda"
        assert spec.extra_args[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="'cuda'"):
            JobServer._decode_payload(payload)


def test_deferred_extras_make_a_job_non_durable():
    data = _points()
    first = (Collection.from_blocked(data).split(POL).map_blocks(lambda b: b.sum(0))
             .reduce(lambda a, b: a + b))
    carried = first.compute_async(executor=LocalExecutor()).map(lambda v: v)
    plan = (Collection.from_blocked(data).split(POL)
            .map_blocks(lambda b, c: b.sum(0) + c, extra_args=(carried,))
            .reduce(lambda a, b: a + b).plan())
    assert JobServer._encode_payload(plan.spec) is None


# ---------------------------------------------------------------------------
# the same jobs through the JAX package's JobServer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["Baseline()", "SplIter(partitions_per_location=2)",
                                    "SplIter(fusion='pallas')"])
def test_matches_reference_jobserver(tmp_path, policy):
    x = np.random.default_rng(4).uniform(size=(400, 2)).astype(np.float32)
    ta = BlockedArray.from_array(x, 50, num_locations=2, device="cpu")
    ja = jblocked.BlockedArray.from_array(jnp.asarray(x), 50, num_locations=2)
    tp = eval(policy, {"Baseline": Baseline, "SplIter": SplIter})
    jp = eval(policy, {"Baseline": japi.Baseline, "SplIter": japi.SplIter})

    tsrv = JobServer(root=str(tmp_path / "t"))
    th, tr = histogram(ta, bins=4, policy=tp, executor=JobClient(tsrv, tenant="t"))
    jsrv = japi.JobServer(root=str(tmp_path / "j"))
    jh, jr = jhistogram(ja, bins=4, policy=jp, executor=japi.JobClient(jsrv, tenant="t"))
    assert np.array_equal(th.numpy(), np.asarray(jh))
    assert tuple(getattr(tr, f) for f in STRUCTURAL) == tuple(getattr(jr, f) for f in STRUCTURAL)
    assert tsrv.jobs()[0].total_units == jsrv.jobs()[0].total_units
    assert [e.kind for e in tsrv.jobs()[0].events] == [e.kind for e in jsrv.jobs()[0].events]
    tsrv.close()
    jsrv.close()
    # each journal's records, read by the other package's reader: the same
    # record kinds in the same order
    tk = [r[0] for r in japi.JobJournal.replay(str(tmp_path / "t" / "journal.bin"))]
    jk = [r[0] for r in JobJournal.replay(str(tmp_path / "j" / "journal.bin"))]
    assert tk == jk


# ---------------------------------------------------------------------------
# a restart in a fresh process (the JAX package's unit keys carry a
# namespace id, so there every unit recomputes)
# ---------------------------------------------------------------------------

_RESTART_CHILD = r"""
import functools, operator, sys, threading
import numpy as np
from repro_torch.api import Collection, SplIter, engine
from repro_torch.core.apps.histogram import histogramdd_block
from repro_torch.core.blocked import BlockedArray

root, phase = sys.argv[1], sys.argv[2]
if phase == "first":
    x = np.random.default_rng(0).random((800, 2)).astype(np.float32)
    ba = BlockedArray.from_array(x, 50, num_locations=4, device="cpu")
    plan = (Collection.from_blocked(ba).split(SplIter(2))
            .map_blocks(functools.partial(histogramdd_block, bins=4, lo=0.0, hi=1.0))
            .reduce(operator.add).plan())
    srv = engine("server", root=root, autostart=False)
    job = srv.submit(plan)
    hit, emit = threading.Event(), srv._emit
    def watched(j, kind, detail="", completed=0, total=0):
        emit(j, kind, detail, completed, total)
        if kind == "running" and j.recomputed_units >= 3 and not hit.is_set():
            srv._stop.set()
            hit.set()
    srv._emit = watched
    srv.start()
    assert hit.wait(120)
    srv.kill()
    print("KILLED", job.recomputed_units, job.total_units)
else:
    srv = engine("server", root=root)
    job = srv.jobs()[0]
    value = srv.wait(job, 120).value
    srv.close()
    ref = np.histogramdd(np.random.default_rng(0).random((800, 2)).astype(np.float32),
                         bins=4, range=[(0, 1)] * 2)[0]
    assert np.array_equal(value.numpy(), ref.astype(np.int32))
    print("RESUMED", job.restored_units, job.recomputed_units, job.total_units)
"""


def test_restart_in_a_fresh_process_restores_journaled_units(tmp_path):
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = []
    for phase in ("first", "second"):
        out = subprocess.run([sys.executable, "-c", _RESTART_CHILD, str(tmp_path), phase],
                             env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        outs.append(out.stdout.split())
    assert outs[0] == ["KILLED", "3", "9"]
    assert outs[1] == ["RESUMED", "3", "6", "9"]


def test_in_memory_server_encodes_no_payload(tmp_path):
    """Only a journaling server encodes the replay payload (a host copy of
    every input block); an in-memory one has nothing to replay it from."""
    plan = _hist_plan(_points())
    mem = JobServer(autostart=False)
    assert not mem.submit(plan).durable
    mem.close()
    durable = JobServer(root=str(tmp_path), autostart=False)
    assert durable.submit(plan).durable
    durable.close(drain=False)
