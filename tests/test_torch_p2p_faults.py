"""The port's peer exchange of partials under faults, against the JAX package.

The fault cases of ``tests/test_p2p.py`` on the CPU, with no assertion that
reads a clock: a peer killed mid-exchange (the reference's case, and the
fold's own worker killed), a fold that fails naming its originating task,
seeded chaos rounds, and a steal of publishing units off a ``SIGSTOP``ped
worker.  Every case ends with ``leaked_segments(prefix) == []``; values
are bit-identical to Local's; ``dispatches``, ``merges``,
``remote_dispatches``, ``shm_bytes``, ``p2p_bytes`` and
``driver_merge_bytes`` equal the reference's on the same plan, and so do
``retries`` where the kill is deterministic.  The reference runs once, on
one pool with the same kill, in a module fixture.

The combine and block function of the failing fold are defined inside the
test, as the reference's are: a spawned worker of the port rebuilds them
without importing this module (which imports JAX).
"""

from __future__ import annotations

import contextlib
import os
import signal
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cluster_fns as fns
import repro.api as japi
from repro.core import blocked as jblocked
from repro.core.apps.histogram import histogram as j_histogram
from repro_torch.api import (
    Baseline,
    ChaosSchedule,
    ClusterFailedError,
    Collection,
    FaultPlan,
    SplIter,
    engine,
    shm_available,
)
from repro_torch.api.shm import leaked_segments
from repro_torch.core.apps.histogram import histogram
from repro_torch.core.blocked import BlockedArray, round_robin_placement

POL = SplIter(partitions_per_location=2)
COLUMNS = ("dispatches", "merges", "remote_dispatches", "shm_bytes", "p2p_bytes",
           "driver_merge_bytes")
#: the reference's kill: location 0's worker exits on receiving its 2nd dispatch
KILL = ((0, 2),)

pytestmark = pytest.mark.skipif(
    not shm_available(), reason="peer exchange needs POSIX shared memory"
)

warnings.filterwarnings("ignore", category=DeprecationWarning)


@contextlib.contextmanager
def _pool(**kw):
    """A p2p cluster that must leak NOTHING of its own into ``/dev/shm``."""
    kw.setdefault("p2p", True)
    ex = engine("cluster", **kw)
    prefix = ex._shm.prefix
    try:
        yield ex
    finally:
        ex.close()
    assert leaked_segments(prefix) == []
    assert ex.workers_alive() == []


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(0).random((2048, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def points(data) -> BlockedArray:
    return BlockedArray.from_array(data, 256, num_locations=2, policy=round_robin_placement,
                                   device="cpu")


@pytest.fixture(scope="module")
def jref(data):
    """The reference's kill-a-peer run and its failing fold, on one pool."""
    pts = jblocked.BlockedArray.from_array(
        jnp.asarray(data), 256, num_locations=2, policy=jblocked.round_robin_placement
    )

    def colsum(b):
        return jnp.sum(b, axis=0)

    def bad_combine(acc, p):
        raise ValueError("injected combine failure")

    out = {}
    with japi.engine("cluster", p2p=True, fault_plan=japi.FaultPlan(kill_after=KILL)) as ex:
        out["kill"] = j_histogram(pts, bins=8, policy=japi.SplIter(partitions_per_location=2),
                                  executor=ex)
        plan = (japi.Collection.from_blocked(pts).split(japi.Baseline())
                .map_blocks(colsum).reduce(bad_combine))
        with pytest.raises(japi.ClusterFailedError) as ei:
            plan.compute(executor=ex)
        out["fold_failure"] = ei.value
    return out


def identical(a, b) -> bool:
    return bool(torch.equal(a, b))


def _columns(rep, cols=COLUMNS) -> dict:
    return {c: getattr(rep, c) for c in cols}


# ---------------------------------------------------------------------------
# faults mid-exchange: replay, attribution, zero leaks
# ---------------------------------------------------------------------------


def test_kill_peer_mid_exchange_replays_subtree(points, jref):
    """A worker killed between publishing and folding: the subtree replays
    on a survivor, the result stays bit-identical, and every published
    segment — including the dead attempt's — is swept."""
    ref, _ = histogram(points, bins=8, policy=POL)
    jh, jrep = jref["kill"]
    with _pool(fault_plan=FaultPlan(kill_after=KILL)) as ex:
        h, rep = histogram(points, bins=8, policy=POL, executor=ex)
        assert identical(h, ref)
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
        assert rep.retries >= 1
        assert rep.p2p_bytes > 0 or rep.driver_merge_bytes > 0
        assert _columns(rep, COLUMNS + ("retries",)) == _columns(jrep, COLUMNS + ("retries",))


def test_kill_fold_worker_replays_the_fold(points, jref):
    """Location 0's worker dies on receiving its fold (its third dispatch,
    after both members published): the fold replays on a survivor over the
    same published segments, which the driver still owns — the bill is the
    fault-free one's plus one retry."""
    ref, _ = histogram(points, bins=8, policy=POL)
    _, jrep = jref["kill"]
    with _pool(fault_plan=FaultPlan(kill_after=((0, 3),))) as ex:
        h, rep = histogram(points, bins=8, policy=POL, executor=ex)
        assert identical(h, ref)
        assert [e["unit"] for e in ex.retry_log] == [4]  # the fold of location 0
        assert rep.retries == 1
        assert _columns(rep) == _columns(jrep)


def test_retried_fold_that_keeps_dying_poisons_naming_its_origin(points):
    """Location 0's worker dies on receiving its fold; the replay lands on
    worker 1, which exits on any retried unit or fold (``kill_on_retry``):
    past ``max_retries`` the run fails naming the fold's originating task,
    and both attempts' published members are swept."""
    plan = FaultPlan(kill_after=((0, 3),), kill_on_retry=(1,))
    with _pool(fault_plan=plan, max_retries=1) as ex:
        with pytest.raises(ClusterFailedError) as ei:
            histogram(points, bins=8, policy=POL, executor=ex)
    err = ei.value
    assert str(err).startswith("merge fold of task ") and "poisoned" in str(err)
    assert err.task_key is not None and "histogramdd_block" in err.task_key
    assert [a["worker"] for a in err.attempts] == [0, 1]


def test_fold_failure_names_originating_task_key(points, jref):
    """A failure inside a worker-side fold attributes to the subtree's
    ORIGINATING app task, never the synthetic fold unit."""

    def colsum(b):
        return torch.sum(b, dim=0)

    def bad_combine(acc, p):
        raise ValueError("injected combine failure")

    plan = (
        # Baseline: the combine first runs inside the FOLD unit (SplIter
        # would fuse it into the partition tasks and fail there instead).
        Collection.from_blocked(points)
        .split(Baseline())
        .map_blocks(colsum)
        .reduce(bad_combine)
    )
    with _pool() as ex:
        with pytest.raises(ClusterFailedError) as ei:
            plan.compute(executor=ex)
        # the workers rebuilt both functions without this module (or JAX)
        roots = ex.call_workers(fns.module_roots)
    assert roots and all("jax" not in r and "repro" not in r for r in roots.values())
    assert ei.value.task_key is not None
    assert "colsum" in ei.value.task_key
    assert "merge fold of" in str(ei.value)
    assert "injected combine failure" in str(ei.value)
    jerr = jref["fold_failure"]
    assert "colsum" in jerr.task_key and "merge fold of" in str(jerr)
    assert str(ei.value).splitlines()[0].split(" failed on")[0].startswith("merge fold of task")
    assert str(jerr).splitlines()[0].split(" failed on")[0].startswith("merge fold of task")


@pytest.mark.parametrize("seed", [3, 7])
def test_chaos_rounds_with_p2p_exact_accounting(points, jref, seed, tmp_path):
    """ChaosSchedule rounds with p2p forced on: kills, stragglers and
    steals compose with the exchange — results stay bit-identical and
    ``p2p_bytes`` stays EXACT (every member partial consumed exactly once,
    however its unit was routed), equal to the reference's."""
    cs = ChaosSchedule(seed=seed, rounds=3)
    ref, _ = histogram(points, bins=8, policy=POL)
    _, jrep = jref["kill"]
    with _pool(fault_plan=cs.fault_plan(), steal=True, max_workers=8,
               log_dir=str(tmp_path)) as ex:
        applied = 0
        reports = []
        for action in cs.actions():
            if action == "grow":
                applied += ex.grow() is not None
            elif action == "shrink":
                applied += ex.shrink() is not None
            h, rep = histogram(points, bins=8, policy=POL, executor=ex)
            assert identical(h, ref)
            reports.append(rep)
        assert sum(r.steals for r in reports) == len(ex.steal_log)
        assert sum(r.retries for r in reports) == len(ex.retry_log)
        assert len(ex.scale_log) == applied
        assert ex._shm.pinned_segments() == {}
        # a kill that fired (the worker's log says so) was replayed and
        # billed; whether it fires depends on the steals, which no
        # assertion reads
        logs = "".join(p.read_text() for p in tmp_path.glob("worker-*.log"))
        assert ("FAULT: killing" in logs) == (len(ex.retry_log) >= 1)
    exported = points.nbytes  # the first round exports the dataset once
    for i, rep in enumerate(reports):
        want = _columns(jrep)
        want["shm_bytes"] -= exported if i else 0
        assert _columns(rep) == want  # exact, per execute


def _resume_after_probe(ex, wid: int, pid: int) -> None:
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


def test_steal_of_publishing_units_keeps_the_bill_exact(points, jref):
    """A stopped worker's queued publishing unit is stolen (its voided
    attempt's publish name swept) and published by the thief under the same
    name: one steal, no retry, the fault-free bill, bit-identical."""
    ref, _ = histogram(points, bins=8, policy=POL)
    _, jrep = jref["kill"]
    with _pool(steal=True) as ex:
        _, warm = histogram(points, bins=8, policy=POL, executor=ex)  # spawn the pool
        pid = ex.worker_pids()[0]
        ex._task_ema[0] = 1.0  # worker 0 observed as a 1 s/unit straggler
        os.kill(pid, signal.SIGSTOP)
        _resume_after_probe(ex, 0, pid)
        h, rep = histogram(points, bins=8, policy=POL, executor=ex)
        assert identical(h, ref)
        # the stopped worker's batch, but for its head, went to the thief
        assert any(e["victim"] == 0 for e in ex.steal_log[warm.steals:])
        assert warm.steals + rep.steals == len(ex.steal_log)
        assert rep.retries == 0 and ex.retry_log == []
        want = _columns(jrep)
        want["shm_bytes"] -= points.nbytes  # exported by the first pass
        assert _columns(rep) == want
        assert ex._shm.pinned_segments() == {}
