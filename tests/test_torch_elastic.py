"""The port's elastic cluster — stealing, autoscaling, chaos — on the CPU.

Every case of ``tests/test_elastic.py``, with no assertion that depends on
wall-clock timing:

* :class:`ChaosSchedule` derives the same fault plans and grow/shrink
  actions as the reference's for the same seed; under it every round is
  bit-identical to Local (and equal to the reference's value), and the
  ``steals`` / ``retries`` / ``scale_events`` counters reconcile exactly
  against the event logs however many steals the run happened to make;
* the straggler is a worker stopped with ``SIGSTOP`` whose observed
  service time is set high: its batch is provably queued when the idle
  sibling's probe reaches it, and the ``SIGCONT`` that follows the probe
  lets it grant all of the batch but its head — steals are certain, not
  raced;
* planned scale-down drains through the requeue path with no retries;
  ``grow``/``shrink``/the autoscaler are driven by direct calls and by the
  backlog the first flush leaves, never by a sleep;
* the heartbeat debouncer is driven by direct supervisor calls, and the
  truly silent worker is buried once its log records the mute;
* the steal cost gate and the ``_SchedulerState`` ownership invariants
  match the reference's on the same inputs.
"""

from __future__ import annotations

import os
import random
import signal
import warnings

import numpy as np
import pytest
import torch

import _torch_cluster_fns as fns
import repro.api as japi
import repro.api.autotune as jtune
from _torch_cluster_fns import bury_when_mute
from repro.core import blocked as jblocked
from repro.core.apps.histogram import histogram as j_histogram
from repro_torch.api import (
    ChaosSchedule,
    ClusterExecutor,
    Collection,
    FaultPlan,
    LocalExecutor,
    SplIter,
)
from repro_torch.api.autotune import CostModel, should_steal, steal_cost_estimate
from repro_torch.api.executors import _SchedulerState, _Unit
from repro_torch.api.shm import leaked_segments
from repro_torch.core.apps.histogram import histogram
from repro_torch.core.apps.kmeans import kmeans
from repro_torch.core.blocked import BlockedArray, round_robin_placement

try:  # optional in the execution environment
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - exercised where hypothesis is absent
    HAVE_HYPOTHESIS = False

POL = SplIter(partitions_per_location=4)
CHAOS_SEEDS = (11, 23, 47)

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
def jhist(data):
    """The reference's histogram of the same points (Local backend)."""
    pts = jblocked.BlockedArray.from_array(
        np.asarray(data), 256, num_locations=2, policy=jblocked.round_robin_placement
    )
    return np.asarray(j_histogram(pts, bins=8, policy=japi.SplIter(partitions_per_location=4))[0])


def identical(a, b) -> bool:
    return bool(torch.equal(a, b))


# ---------------------------------------------------------------------------
# ChaosSchedule: seeded, replayable fault + elasticity schedules
# ---------------------------------------------------------------------------


def _as_tuples(plan):
    return (plan.kill_after, plan.kill_on_retry, plan.mute_after, plan.slow)


class TestChaosSchedule:
    def test_deterministic(self):
        for seed in CHAOS_SEEDS:
            a, b = ChaosSchedule(seed=seed), ChaosSchedule(seed=seed)
            assert a.fault_plan() == b.fault_plan()
            assert a.actions() == b.actions()

    def test_seeds_differ(self):
        plans = {ChaosSchedule(seed=s).fault_plan() for s in range(16)}
        assert len(plans) > 1  # the seed actually steers the schedule

    def test_first_round_unscaled_and_shrink_never_outruns_growth(self):
        for seed in range(32):
            acts = ChaosSchedule(seed=seed, rounds=6).actions()
            assert acts == japi.ChaosSchedule(seed=seed, rounds=6).actions()
            assert acts[0] == "none"
            grown = 0
            for a in acts:
                grown += {"grow": 1, "shrink": -1}.get(a, 0)
                assert grown >= 0

    def test_kill_and_slow_target_different_workers(self):
        for seed in range(32):
            plan = ChaosSchedule(seed=seed).fault_plan()
            assert _as_tuples(plan) == _as_tuples(japi.ChaosSchedule(seed=seed).fault_plan())
            killed = {w for w, _ in plan.kill_after}
            slowed = {w for w, _ in plan.slow}
            assert not (killed & slowed)


# ---------------------------------------------------------------------------
# the chaos matrix: kills + stragglers + grow/shrink, bit-identical + exact
# accounting, zero leaked segments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_rounds_bit_identical_with_exact_accounting(points, jhist, seed, tmp_path):
    cs = ChaosSchedule(seed=seed, rounds=3)
    ref, _ = histogram(points, bins=8, policy=POL)
    np.testing.assert_array_equal(ref.numpy(), jhist)
    ex = ClusterExecutor(
        fault_plan=cs.fault_plan(), steal=True, max_workers=8, log_dir=str(tmp_path)
    )
    prefix = ex._shm.prefix
    applied = 0
    reports = []
    try:
        for action in cs.actions():
            if action == "grow":
                applied += ex.grow() is not None
            elif action == "shrink":
                applied += ex.shrink() is not None
            h, rep = histogram(points, bins=8, policy=POL, executor=ex)
            assert identical(h, ref)
            reports.append(rep)
        # the accounting contract: counters reconcile exactly vs the logs
        assert sum(r.steals for r in reports) == len(ex.steal_log)
        assert sum(r.retries for r in reports) == len(ex.retry_log)
        assert len(ex.scale_log) == applied
        assert ex._shm.pinned_segments() == {}
        # a kill that fired (the worker's log says so) was replayed and
        # billed — the only source of retries here; whether it fires depends
        # on how many units steals left the worker, which no assertion reads.
        # (Its cause may read "hung": a death seen as EOF on the reply pipe
        # can precede the exit's reaping.)
        logs = "".join(p.read_text() for p in tmp_path.glob("worker-*.log"))
        killed = "FAULT: killing" in logs
        assert killed == (len(ex.retry_log) >= 1)
    finally:
        ex.close()
    assert leaked_segments(prefix) == []
    assert ex.workers_alive() == []


# ---------------------------------------------------------------------------
# the straggler: a stopped worker -> steals > 0, zero retries, identical
# ---------------------------------------------------------------------------


def _resume_after_probe(ex: ClusterExecutor, wid: int, pid: int) -> None:
    """``SIGCONT`` worker ``wid`` right after the first steal probe to it."""
    handle = ex._workers[wid]
    send = handle.send

    def sending(msg):
        n = send(msg)
        if msg[0] == "steal":
            os.kill(pid, signal.SIGCONT)
            handle.send = send
        return n

    handle.send = sending


def test_straggler_triggers_steals_bit_identical(points):
    ref = kmeans(points, k=4, iters=3, policy=POL)
    ex = ClusterExecutor(steal=True)
    try:
        warm = kmeans(points, k=4, iters=1, policy=POL, executor=ex)  # spawn the pool
        pid = ex.worker_pids()[0]
        ex._task_ema[0] = 1.0  # worker 0 observed as a 1 s/unit straggler
        os.kill(pid, signal.SIGSTOP)
        _resume_after_probe(ex, 0, pid)
        res = kmeans(points, k=4, iters=3, policy=POL, executor=ex)
        steals = sum(r.steals for r in warm.reports + res.reports)
        # the stopped worker's first batch, but for its head, went to the thief
        assert res.reports[0].steals >= 3
        assert steals == len(ex.steal_log)  # exact, not approximate
        assert identical(res.centers, ref.centers)
        # a steal is a scheduling decision, not a failure
        assert sum(r.retries for r in res.reports) == 0
        assert ex.retry_log == []
        assert ex._shm.pinned_segments() == {}
    finally:
        ex.close()
    assert ex.workers_alive() == []


def test_steal_disabled_by_default(points):
    ex = ClusterExecutor(fault_plan=FaultPlan(slow=((0, 0.02),)))
    try:
        res = kmeans(points, k=4, iters=2, policy=POL, executor=ex)
        assert sum(r.steals for r in res.reports) == 0
        assert ex.steal_log == []
    finally:
        ex.close()


# ---------------------------------------------------------------------------
# planned scale-down == deliberate preemption through the replay path
# ---------------------------------------------------------------------------


def test_midrun_preemption_is_bit_identical_and_free_of_retries():
    """Shrink a worker with units in flight: the drain is the kill path,
    but attempts are refunded and nothing bills retries."""
    x = np.random.default_rng(3).random((512, 8)).astype(np.float32)
    c = torch.ones(8)

    def plan():
        return (
            Collection.from_array(x, block_rows=64, num_locations=2, device="cpu")
            .split(SplIter(partitions_per_location=2))
            .map_blocks(fns.partial, extra_args=(c,))
            .reduce(fns.combine)
        )

    ref = plan().compute(executor=LocalExecutor())
    # worker 0 is slowed so its queue is non-empty at shrink time
    ex = ClusterExecutor(fault_plan=FaultPlan(slow=((0, 0.1),)))
    try:
        fut = plan().compute_async(executor=ex)
        assert ex.shrink(0) == 0  # preempt the busy owner mid-run
        res = fut.result()
        assert identical(res.value, ref.value)
        assert res.report.retries == 0 and ex.retry_log == []
        assert res.report.scale_events == 1
        assert ex.scale_log == [{"event": "shrink", "worker": 0}]
    finally:
        ex.close()
    assert ex.workers_alive() == []


def test_grow_shrink_between_runs(points):
    ref, _ = histogram(points, bins=8, policy=POL)
    ex = ClusterExecutor(steal=True, max_workers=8)
    prefix = ex._shm.prefix
    try:
        h0, _ = histogram(points, bins=8, policy=POL, executor=ex)
        wid = ex.grow()
        assert wid is not None and wid in ex.workers_alive()
        h1, rep1 = histogram(points, bins=8, policy=POL, executor=ex)
        assert ex.shrink() == wid  # the idle roamer retires first
        assert wid not in ex.workers_alive()
        h2, rep2 = histogram(points, bins=8, policy=POL, executor=ex)
        assert identical(h0, ref) and identical(h1, ref) and identical(h2, ref)
        assert rep1.retries == 0 and rep2.retries == 0
        assert [e["event"] for e in ex.scale_log] == ["grow", "shrink"]
    finally:
        ex.close()
    assert leaked_segments(prefix) == []


def test_grow_respects_max_workers():
    ex = ClusterExecutor(max_workers=1)
    try:
        assert ex.grow() is not None  # pool empty: first roamer fits
        assert ex.grow() is None  # at the ceiling
        assert len(ex.workers_alive()) == 1
    finally:
        ex.close()


def test_autoscaler_grows_under_backlog(points):
    """The first flush leaves each owner 3 units behind its running one —
    a backlog of 6 against 2 live workers — so the autoscaler's first tick
    grows, whatever the timing."""
    ref, _ = histogram(points, bins=8, policy=POL)
    ex = ClusterExecutor(autoscale=True, scale_up_backlog=1, max_workers=6)
    prefix = ex._shm.prefix
    try:
        reports = []
        for _ in range(2):
            h, rep = histogram(points, bins=8, policy=POL, executor=ex)
            assert identical(h, ref)
            reports.append(rep)
        assert ex.scale_log[0]["event"] == "grow"
        # autoscaler events happen inside runs, so report sums reconcile
        assert sum(r.scale_events for r in reports) == len(ex.scale_log)
        assert sum(r.retries for r in reports) == 0
    finally:
        ex.close()
    assert leaked_segments(prefix) == []


# ---------------------------------------------------------------------------
# heartbeat debounce: a stalled driver must not bury idle workers
# ---------------------------------------------------------------------------


def test_stalled_driver_does_not_bury_idle_workers(points):
    """Staleness counts only *observed* silence — time the driver spent
    pumping — capped per check, so a stall of any length adds at most one
    capped tick."""
    ref, _ = histogram(points, bins=8, policy=POL)
    ex = ClusterExecutor()
    try:
        histogram(points, bins=8, policy=POL, executor=ex)
        alive = ex.workers_alive()
        assert alive
        before = dict(ex._silence)
        ex._last_pump -= 500.0  # a 500 s driver stall: both clocks "ancient"
        for wid in list(ex._last_hb):
            ex._last_hb[wid] -= 500.0
        ex._check_workers()
        assert ex.workers_alive() == alive  # nobody buried
        cap = max(ex.poll_s, ex.heartbeat_s) * 4
        assert all(s - before.get(wid, 0.0) <= cap + 1e-6 for wid, s in ex._silence.items())
        h, rep = histogram(points, bins=8, policy=POL, executor=ex)
        assert identical(h, ref) and rep.retries == 0
    finally:
        ex.close()


def test_truly_silent_worker_is_still_buried(points, tmp_path):
    """The debouncer must not break real hang detection: a muted worker's
    observed silence passes the timeout and its units replay."""
    ref, _ = histogram(points, bins=8, policy=POL)
    ex = ClusterExecutor(fault_plan=FaultPlan(mute_after=((0, 2),)), log_dir=str(tmp_path))
    bury_when_mute(ex, 0)
    try:
        h, rep = histogram(points, bins=8, policy=POL, executor=ex)
        assert identical(h, ref)
        assert rep.retries >= 1  # the mute was detected and replayed
        assert len(ex.retry_log) == rep.retries
    finally:
        ex.close()


# ---------------------------------------------------------------------------
# the steal cost gate (autotune), against the reference's
# ---------------------------------------------------------------------------


class TestStealCostGate:
    def test_fitted_model_waits_vs_fetch(self):
        model = CostModel(c0=0.0, c1=0.01, c2=0.0)
        wait, fetch = steal_cost_estimate(model, queued_tasks=4, span=1)
        assert wait == pytest.approx(0.04)
        assert fetch >= 0.01  # one extra dispatch to the thief
        jmodel = jtune.CostModel(c0=0.0, c1=0.01, c2=0.0)
        assert (wait, fetch) == jtune.steal_cost_estimate(jmodel, queued_tasks=4, span=1)
        assert should_steal(model, queued_tasks=4)
        assert not should_steal(model, queued_tasks=0)

    def test_bytes_bite_only_off_the_shm_plane(self):
        model = CostModel(c0=0.0, c1=0.001, c2=0.0)
        assert should_steal(model, queued_tasks=8, operand_bytes=0)
        assert not should_steal(model, queued_tasks=8, operand_bytes=1 << 30)

    def test_fallback_profile_estimate(self):
        wait, fetch = steal_cost_estimate(None, queued_tasks=3, fallback_task_s=0.2)
        assert wait == pytest.approx(0.6)
        assert (wait, fetch) == jtune.steal_cost_estimate(None, queued_tasks=3,
                                                          fallback_task_s=0.2)
        assert should_steal(None, queued_tasks=3, fallback_task_s=0.2)


# ---------------------------------------------------------------------------
# _SchedulerState ownership invariants, against the reference's
# ---------------------------------------------------------------------------


def _make_state(n=6, mod=None):
    unit_cls, state_cls = (_Unit, _SchedulerState) if mod is None else mod
    units = [unit_cls(index=i, location=i % 2, tasks=(), run=None) for i in range(n)]
    units.append(
        unit_cls(index=n, location=-1, tasks=(), run=None, deps=tuple(range(n)), kind="merge")
    )
    return state_cls(units), units


class TestOwnershipInvariants:
    def test_live_double_claim_raises(self):
        state, units = _make_state()
        state.assign(units[0], "w1")
        with pytest.raises(RuntimeError, match="double-claimed"):
            state.assign(units[0], "w2")
        state.assign(units[0], "w1")  # same owner re-assign is idempotent

    def test_assign_after_completion_raises(self):
        state, units = _make_state()
        state.assign(units[0], "w1")
        state.complete(units[0], 0)
        with pytest.raises(RuntimeError, match="after completion"):
            state.assign(units[0], "w2")

    def test_release_moves_ownership_and_refunds_the_attempt(self):
        state, units = _make_state()
        state.assign(units[0], "w1")
        assert state.release(units[0])  # the steal grant
        assert units[0].index not in state.owner
        assert state.attempts[units[0].index] == 0  # refunded
        state.assign(units[0], "w2")  # the thief's claim is legal
        assert state.attempts[units[0].index] == 1  # net zero for the steal

    def test_release_is_stale_safe(self):
        state, units = _make_state()
        assert not state.release(units[0])  # never owned
        state.assign(units[0], "w1")
        state.complete(units[0], 0)
        assert not state.release(units[0])  # completed: grant is stale

    def test_requeue_then_reassign(self):
        state, units = _make_state()
        state.assign(units[0], "w1")
        state.assign(units[1], "w1")
        state.complete(units[1], 1)
        lost = state.requeue("w1")
        assert [u.index for u in lost] == [0]  # completed unit not replayed
        state.assign(units[0], "w2")  # post-death claim is legal

    def test_refund_never_goes_negative(self):
        state, units = _make_state()
        state.refund_attempt(0)
        assert state.attempts[0] == 0
        state.assign(units[0], "w1")
        state.refund_attempt(0)
        state.refund_attempt(0)
        assert state.attempts[0] == 0

    @staticmethod
    def _chaos_run(rng: random.Random, mod=None, n=6, steps=200):
        """Drive one seeded interleaving of assign / steal / kill / preempt
        / complete; return the trace of (owner, attempts) after each step."""
        state, units = _make_state(n, mod)
        owners = ["w0", "w1", "w2"]
        completed = [0] * len(units)
        trace = []
        for _ in range(steps):
            op = rng.choice(("assign", "steal", "kill", "preempt", "complete"))
            u = units[rng.randrange(len(units))]
            if op == "assign":
                prev = state.owner.get(u.index)
                owner = rng.choice(owners)
                if state.is_done(u.index) or (prev is not None and prev != owner):
                    with pytest.raises(RuntimeError):
                        state.assign(u, owner)
                else:
                    state.assign(u, owner)
            elif op == "steal":
                before = state.attempts[u.index]
                if state.release(u):
                    assert state.attempts[u.index] == max(0, before - 1)
                    state.assign(u, rng.choice(owners))  # thief re-claims
            elif op == "kill":
                owner = rng.choice(owners)
                for lost in state.requeue(owner):
                    assert not state.is_done(lost.index)
                    state.assign(lost, rng.choice(owners))  # survivor replay
            elif op == "preempt":
                if state.release(u):
                    state.assign(u, rng.choice(owners))
            elif op == "complete" and u.index in state.owner:
                if not state.is_done(u.index):
                    state.complete(u, u.index)
                    completed[u.index] += 1
            assert all(v >= 0 for v in state.attempts.values())
            trace.append((dict(state.owner), dict(state.attempts)))
        for u in units:
            if not state.is_done(u.index):
                if u.index not in state.owner:
                    state.assign(u, "w0")
                state.complete(u, u.index)
                completed[u.index] += 1
            assert state.complete(u, -1) == []  # duplicates are dropped
        assert completed == [1] * len(units)
        assert state.done.is_set()
        return trace

    def test_seeded_interleavings(self):
        """The invariants over a fixed fan of seeds, and the same ownership
        trace as the reference's state under every one of them."""
        from repro.api.executors import _SchedulerState as JState
        from repro.api.executors import _Unit as JUnit

        for seed in range(25):
            ours = self._chaos_run(random.Random(seed))
            theirs = self._chaos_run(random.Random(seed), (JUnit, JState))
            assert ours == theirs

    if HAVE_HYPOTHESIS:

        @settings(max_examples=200, deadline=None)
        @given(st.integers(min_value=0, max_value=2**31 - 1))
        def test_property_interleavings(self, seed):
            self._chaos_run(random.Random(seed))
