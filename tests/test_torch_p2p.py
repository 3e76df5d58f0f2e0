"""The port's peer exchange of partials against Local and the JAX package's.

Every fault-free case of ``tests/test_p2p.py`` on the CPU (its fault cases
are in ``tests/test_torch_p2p_faults.py``): the same numpy input goes
through the port's cluster with worker-side folds, the port's Local
backend and the reference's cluster.  Values are bit-identical to Local's
and equal to the reference's; ``dispatches``, ``merges``,
``remote_dispatches``, ``retries``, ``shm_bytes``, ``p2p_bytes`` and
``driver_merge_bytes`` equal the reference's on the same plan.  The
reference's runs happen once, in a module fixture, on two pools (``p2p``
forced on, and the ``"auto"`` gate), since each of its workers imports JAX.
A JobServer over the cluster materializes the same fold units and journals
the same unit keys as the reference's.

Block functions that ship to workers live in ``tests/_torch_cluster_fns.py``,
so a worker of the port never imports JAX.
"""

from __future__ import annotations

import contextlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cluster_fns as fns
import repro.api as japi
import repro.api.lowering as jlow
import repro_torch.api as tapi
from repro.core import blocked as jblocked
from repro.core.apps.cascade_svm import cascade_svm as j_svm
from repro.core.apps.histogram import histogram as j_histogram
from repro.core.apps.kmeans import kmeans as j_kmeans
from repro.core.apps.knn import knn as j_knn
from repro_torch.api import JobJournal, cluster_worker, engine, shm, shm_available
from repro_torch.api.lowering import fold_plan, lower
from repro_torch.api.shm import leaked_segments
from repro_torch.core.apps.cascade_svm import cascade_svm
from repro_torch.core.apps.histogram import histogram
from repro_torch.core.apps.kmeans import kmeans
from repro_torch.core.apps.knn import knn
from repro_torch.core.blocked import BlockedArray, round_robin_placement

POL_TEXT = "SplIter(partitions_per_location=2)"
#: the columns each case holds equal to the reference's
COLUMNS = ("dispatches", "merges", "remote_dispatches", "retries", "shm_bytes",
           "p2p_bytes", "driver_merge_bytes")
KNN_TOL = dict(rtol=1e-4, atol=1e-4)
F32_TOL = dict(rtol=2e-5, atol=2e-5)

pytestmark = pytest.mark.skipif(
    not shm_available(), reason="peer exchange needs POSIX shared memory"
)

warnings.filterwarnings("ignore", category=DeprecationWarning)


def _policy(api, text=POL_TEXT):
    return eval(text, {"SplIter": api.SplIter, "Baseline": api.Baseline})


POL = _policy(tapi)


def _blocked(a, block_rows=256, locs=2) -> BlockedArray:
    return BlockedArray.from_array(
        a, block_rows, num_locations=locs, policy=round_robin_placement, device="cpu"
    )


def _jblocked(a, block_rows=256, locs=2):
    return jblocked.BlockedArray.from_array(
        jnp.asarray(a), block_rows, num_locations=locs, policy=jblocked.round_robin_placement
    )


def _labels():
    rng = np.random.default_rng(2)
    return np.where(rng.random(2048) > 0.5, 1.0, -1.0).astype(np.float32)


def _queries():
    return np.random.default_rng(1).random((256, 4)).astype(np.float32)


def _wide():
    """d = 5: a bins = 8 histogram partial is 8**5 int32 = 131,072 B, the
    card's Baseline partial, past the ``"auto"`` gate's 64 KiB floor."""
    return np.random.default_rng(3).random((1024, 5)).astype(np.float32)


def _jcolsum(b):
    return jnp.sum(b, axis=0)


def _jcolsum_and_one(b):
    return jnp.sum(b, axis=0), jnp.ones(())


def _jbig_partial(b):
    return jnp.tile(jnp.sum(b, axis=0), 65536 // 4)  # 64Ki float32 = 256KB partial


def _sum_plan(api, x, policy, fn):
    """``x``'s blocks mapped by ``fn`` and summed (the reference's plan)."""
    return api.Collection.from_blocked(x).split(policy).map_blocks(fn).reduce(
        lambda a, p: a + p
    )


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


def _fold_units(ex, plan, lower_fn):
    """``(index, location, fold_group)`` of the fold units an executor
    materializes for ``plan``, and the origin keys (the executor's own
    lowering path, minus scheduling)."""
    spec = plan.spec
    policy, _ = ex._resolve_policy(spec)
    prepared = ex._prepare(spec.inputs, policy, ex.engine.new_report(spec.policy.mode_name))
    graph = lower_fn(spec, prepared.arrays, prepared.groups, ex.capabilities)
    units, _state, _merge = ex._build_units(graph)
    folds = [u for u in units if u.kind == "fold"]
    return [(u.index, u.location, u.fold_group) for u in folds], [u.origin.key for u in folds]


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(0).random((2048, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def points(data) -> BlockedArray:
    return _blocked(data)


@pytest.fixture(scope="module")
def cluster():
    """One shared p2p pool for the fault-free tests (spawn paid once)."""
    with _pool() as ex:
        yield ex


@pytest.fixture(scope="module")
def jref(data):
    """The reference cluster's run of every plan here, once per pool."""
    pts = _jblocked(data)
    pol = _policy(japi)
    out = {}
    with japi.engine("cluster", p2p=True) as ex:
        out["histogram"] = j_histogram(pts, bins=8, policy=pol, executor=ex)
        res = j_kmeans(pts, k=4, iters=3, policy=pol, executor=ex)
        out["kmeans"] = (res.centers, res.reports)
        res = j_knn(pts, _jblocked(_queries(), 128), k=4, policy=pol, executor=ex)
        out["knn"] = (res.indices, res.distances, res.report)
        res = j_svm(pts, _jblocked(_labels()), num_sv=16, steps=30, iterations=1, policy=pol,
                    executor=ex)
        out["svm"] = (res.sv_x, res.sv_y, res.report)
        out["sum"] = _sum_plan(japi, pts, pol, _jcolsum).compute(executor=ex)
        out["baseline"] = _sum_plan(japi, pts, japi.Baseline(), _jcolsum).compute(executor=ex)
        out["fold_units"] = _fold_units(ex, _sum_plan(japi, pts, pol, _jcolsum).plan(),
                                        jlow.lower)[0]
        out["scalar"] = (japi.Collection.from_blocked(pts).split(pol)
                         .map_blocks(_jcolsum_and_one).reduce(fns.pipe_combine)
                         .compute(executor=ex))
    # the gate's cases each start on a fresh pool, as the port's do
    with japi.engine("cluster", p2p="auto") as ex:
        out["auto_small"] = [j_histogram(pts, bins=8, policy=pol, executor=ex) for _ in range(2)]
    with japi.engine("cluster", p2p="auto") as ex:
        plan = _sum_plan(japi, pts, pol, _jbig_partial)
        out["auto_big"] = [plan.compute(executor=ex) for _ in range(2)]
    with japi.engine("cluster", p2p="auto") as ex:
        wide = _jblocked(_wide(), 128)
        out["auto_baseline"] = [j_histogram(wide, bins=8, policy=japi.Baseline(), executor=ex)
                                for _ in range(3)]
    return out


def identical(a, b) -> bool:
    return bool(torch.equal(a, b))


def _same_columns(rep, jrep):
    assert {c: getattr(rep, c) for c in COLUMNS} == {c: getattr(jrep, c) for c in COLUMNS}


# ---------------------------------------------------------------------------
# bit-identity vs LocalExecutor — all four apps, folds forced worker-side
# ---------------------------------------------------------------------------


class TestBitIdentity:
    def test_histogram(self, points, cluster, jref):
        ref, _ = histogram(points, bins=8, policy=POL)
        h, rep = histogram(points, bins=8, policy=POL, executor=cluster)
        jh, jrep = jref["histogram"]
        assert identical(h, ref)
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
        # 2 locations × 2 partitions: both fold chains ran worker-side
        assert rep.p2p_bytes > 0
        assert rep.merges == 3  # two peer folds + the root fold
        assert rep.driver_merge_bytes * 2 == rep.p2p_bytes  # L·S vs N·S
        _same_columns(rep, jrep)

    def test_kmeans(self, points, cluster, jref):
        ref = kmeans(points, k=4, iters=3, policy=POL)
        res = kmeans(points, k=4, iters=3, policy=POL, executor=cluster)
        jcenters, jreports = jref["kmeans"]
        assert identical(res.centers, ref.centers)
        np.testing.assert_allclose(res.centers.numpy(), np.asarray(jcenters), rtol=2e-5, atol=2e-5)
        assert all(r.p2p_bytes > 0 for r in res.reports)
        for r, j in zip(res.reports, jreports, strict=True):
            _same_columns(r, j)

    def test_knn(self, points, cluster, jref):
        qry = _blocked(_queries(), 128)
        ref = knn(points, qry, k=4, policy=POL)
        res = knn(points, qry, k=4, policy=POL, executor=cluster)
        jind, jdist, jrep = jref["knn"]
        assert identical(res.indices, ref.indices)
        assert identical(res.distances, ref.distances)
        np.testing.assert_array_equal(res.indices.numpy(), np.asarray(jind))
        np.testing.assert_allclose(res.distances.numpy(), np.asarray(jdist), **KNN_TOL)
        _same_columns(res.report, jrep)

    def test_svm(self, points, cluster, jref):
        y = _blocked(_labels())
        ref = cascade_svm(points, y, num_sv=16, steps=30, iterations=1, policy=POL)
        res = cascade_svm(points, y, num_sv=16, steps=30, iterations=1, policy=POL,
                          executor=cluster)
        jx, jy, jrep = jref["svm"]
        assert identical(res.sv_x, ref.sv_x)
        assert identical(res.sv_y, ref.sv_y)
        np.testing.assert_array_equal(res.sv_x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(res.sv_y.numpy(), np.asarray(jy))
        _same_columns(res.report, jrep)


# ---------------------------------------------------------------------------
# the acceptance numbers: one merged partial per location per execute
# ---------------------------------------------------------------------------


def test_driver_receives_one_merged_partial_per_location(points, cluster, jref):
    """N units over L locations: p2p_bytes == N·S, driver_merge_bytes == L·S."""
    plan = _sum_plan(tapi, points, POL, fns.row_sum)
    with engine("local") as ex:
        ref = plan.compute(executor=ex)
    pinned_bytes = ref.report.driver_merge_bytes
    res = plan.compute(executor=cluster)
    assert identical(res.value, ref.value)
    # (f32 sums: XLA's and torch's reductions may differ in the last bit)
    np.testing.assert_allclose(res.value.numpy(), np.asarray(jref["sum"].value), **F32_TOL)
    rep = res.report
    partial = rep.p2p_bytes // 4  # 4 member partials crossed peer-side...
    assert partial > 0 and rep.p2p_bytes == 4 * partial
    # ...and the driver folded exactly one merged value per location
    assert rep.driver_merge_bytes == 2 * partial
    assert pinned_bytes == 4 * partial  # the pinned path moved N·S
    _same_columns(rep, jref["sum"].report)


def test_fold_tree_shape_is_deterministic():
    """The fold plan is a pure function of (index, location) pairs — the
    replay/resume contract — and the reference's for the same pairs."""
    entries = [(0, 1), (1, 1), (2, 0), (3, 0), (4, 1), (5, 2)]
    assert fold_plan(entries) == fold_plan(list(entries))
    assert fold_plan(entries) == ((1, (0, 1, 4)), (0, (2, 3)), (2, (5,)))
    assert fold_plan(entries) == jlow.fold_plan(entries)


def test_materialized_fold_units_identical_across_builds(points, jref):
    """Two independent executors materialize identical fold subtrees for the
    same plan — indices, groups, locations and origins — and the reference's
    executor the same indices, locations and groups."""
    plan = _sum_plan(tapi, points, POL, fns.row_sum).plan()
    with _pool() as a, _pool() as b:
        sa, sb = _fold_units(a, plan, lower), _fold_units(b, plan, lower)
    assert sa[0] and sa == sb
    assert sa[0] == jref["fold_units"]


# ---------------------------------------------------------------------------
# the cost gate: auto stays pinned for small partials, switches for big
# ---------------------------------------------------------------------------


def test_auto_gate_keeps_small_partials_pinned(points, jref):
    """Default ``p2p="auto"``: tiny accumulators never leave the pinned
    path — the structural counters stay exactly the driver fold's."""
    ref, ref_rep = histogram(points, bins=8, policy=POL)
    with _pool(p2p="auto") as ex:
        for (jh, jrep) in jref["auto_small"]:  # EMA populated after round 1; still no
            h, rep = histogram(points, bins=8, policy=POL, executor=ex)
            assert identical(h, ref)
            assert rep.p2p_bytes == 0
            assert rep.dispatches == ref_rep.dispatches
            assert rep.merges == ref_rep.merges
            _same_columns(rep, jrep)


def test_auto_gate_switches_on_for_large_partials(points, jref):
    """Iterative app with ≥64KB partials: execute 1 runs pinned (no
    evidence yet), execute 2 switches to peer folds off the observed EMA."""
    plan = _sum_plan(tapi, points, POL, fns.big_partial)
    with engine("local") as ex:
        ref = plan.compute(executor=ex)
    with _pool(p2p="auto") as ex:
        first = plan.compute(executor=ex)
        second = plan.compute(executor=ex)
    assert identical(first.value, ref.value)
    assert identical(second.value, ref.value)
    assert first.report.p2p_bytes == 0  # no EMA yet: pinned
    assert second.report.p2p_bytes > 0  # gate saw 256KB partials: peer folds
    assert second.report.driver_merge_bytes < first.report.driver_merge_bytes
    for rep, jres in zip((first.report, second.report), jref["auto_big"], strict=True):
        _same_columns(rep, jres.report)


def test_auto_gate_folds_a_baseline_histogram_from_its_second_pass(jref):
    """The card's Baseline histogram row at a CPU size: the first pass runs
    on the driver's fold; once its 131,072 B partials are observed, every
    later pass adds one fold unit a location (a dispatch, a remote dispatch
    and a merge each), publishes all N partials (N·S into ``shm_bytes`` and
    ``p2p_bytes``) and leaves the driver L partials (L·S) — the bill the
    reference charges on the same plan."""
    wide = _blocked(_wide(), 128)  # 2 locations × 4 blocks
    n, loc, s = wide.num_blocks, 2, 8**5 * 4
    ref, ref_rep = histogram(wide, bins=8, policy=tapi.Baseline())
    with _pool(p2p="auto") as ex:
        runs = [histogram(wide, bins=8, policy=tapi.Baseline(), executor=ex) for _ in range(3)]
    exported = wide.nbytes
    for i, ((h, rep), (jh, jrep)) in enumerate(zip(runs, jref["auto_baseline"], strict=True)):
        assert identical(h, ref)
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
        _same_columns(rep, jrep)
        folds = loc if i else 0
        assert rep.dispatches == ref_rep.dispatches + folds
        assert rep.merges == ref_rep.merges + folds
        assert rep.remote_dispatches == n + folds
        assert rep.p2p_bytes == (n * s if i else 0)
        assert rep.driver_merge_bytes == (loc * s if i else n * s)
        assert rep.shm_bytes == (exported + n * s if i == 0 else n * s + loc * s)


def test_baseline_policy_groups_blocks_per_location(points, cluster, jref):
    """Baseline (one unit per block) still folds per location worker-side:
    8 blocks over 2 locations collapse to 2 driver partials."""
    plan = _sum_plan(tapi, points, tapi.Baseline(), fns.row_sum)
    with engine("local") as ex:
        ref = plan.compute(executor=ex)
    res = plan.compute(executor=cluster)
    assert identical(res.value, ref.value)
    rep = res.report
    partial = rep.p2p_bytes // points.num_blocks
    assert partial > 0 and rep.p2p_bytes == points.num_blocks * partial
    assert rep.driver_merge_bytes == 2 * partial
    _same_columns(rep, jref["baseline"].report)


@pytest.mark.parametrize("declined", ["every", "alternate"])
def test_declined_publish_still_folds_in_the_worker(points, cluster, monkeypatch, declined):
    """A member whose publish the driver does not receive as segments (a
    full ``/dev/shm``: its reply comes back as values) still goes to its
    location's fold, on the plan's device: no fold runs in the driver, the
    value is Local's on Local's device, and only the published members'
    bytes bill ``p2p_bytes`` — every other column is the bill of the same
    plan run next on the same pool, with every publish received."""
    ref, _ = histogram(points, bins=8, policy=POL)
    s = 8**4 * 4  # one partial: bins = 8 over d = 4, int32
    real, seen = shm.tree_lease, []

    def lease_or_decline(tree):
        lease = real(tree)
        seen.append(lease)
        if declined == "every" or len(seen) % 2:
            return None  # the driver reads the reply's values in place
        return lease

    histogram(points, bins=8, policy=POL, executor=cluster)  # the operands' one export
    cluster.call_workers(cluster_worker.unit_stats, True)
    monkeypatch.setattr(shm, "tree_lease", lease_or_decline)
    h, rep = histogram(points, bins=8, policy=POL, executor=cluster)
    monkeypatch.undo()
    stats = cluster.call_workers(cluster_worker.unit_stats)
    _, clean = histogram(points, bins=8, policy=POL, executor=cluster)
    assert identical(h, ref) and h.device == ref.device
    assert sum(v["folds"] for v in stats.values()) == 2
    kept = 0 if declined == "every" else 2
    assert len(seen) == 4 and rep.p2p_bytes == kept * s
    assert rep.driver_merge_bytes == 2 * s
    assert clean.p2p_bytes == 4 * s
    assert {c: getattr(rep, c) for c in COLUMNS if c != "p2p_bytes"} == {
        c: getattr(clean, c) for c in COLUMNS if c != "p2p_bytes"
    }


def test_published_scalar_leaf_keeps_its_shape(points, cluster, jref):
    """A partial with a 0-d leaf (a count) is published whole and folded
    worker-side: the value keeps Local's shapes.  (The reference's
    ``pack_tree`` publishes a 0-d leaf as shape ``(1,)``, so its p2p value
    differs from its Local's in shape; the bytes billed are the same.)"""
    plan = (tapi.Collection.from_blocked(points).split(POL)
            .map_blocks(fns.colsum_and_one).reduce(fns.pipe_combine))
    with engine("local") as ex:
        ref = plan.compute(executor=ex)
    res = plan.compute(executor=cluster)
    assert [tuple(t.shape) for t in res.value] == [(4,), ()]
    assert all(identical(a, b) for a, b in zip(res.value, ref.value, strict=True))
    count = float(np.asarray(jref["scalar"].value[1]).item())
    assert float(res.value[1]) == count == points.num_blocks
    assert res.report.p2p_bytes > 0
    _same_columns(res.report, jref["scalar"].report)


# ---------------------------------------------------------------------------
# the job service over the cluster: the same fold units and unit keys
# ---------------------------------------------------------------------------


def _journal_keys(path) -> list[str]:
    """The journaled unit keys, with the task-key summary (whose text is
    each package's own) taken out: ``u<index>:<blocks>`` or ``merge:<index>``."""
    keys = [r[2] for r in JobJournal.replay(path) if r[0] == "unit"]
    return [k if k.startswith("merge:") else f"{k.split(':')[0]}:{k.split(':')[-1]}"
            for k in keys]


def test_cluster_server_materializes_fold_units_as_reference(data, tmp_path):
    """A JobServer over ``engine("cluster", p2p=True)`` builds its units
    through the cluster's fold plan: a fold unit per location (keyed
    ``merge:<index>``, having no task of its own) besides the merge, run in
    the server — the reference's unit count, unit keys and value."""
    pts, jpts = _blocked(data), _jblocked(data)
    srv = engine("server", server_backend="cluster", p2p=True, root=str(tmp_path / "t"))
    jsrv = japi.engine("server", server_backend="cluster", p2p=True, root=str(tmp_path / "j"))
    try:
        h, rep = histogram(pts, bins=8, policy=tapi.Baseline(),
                           executor=tapi.JobClient(srv, tenant="t"))
        jh, jrep = j_histogram(jpts, bins=8, policy=japi.Baseline(),
                               executor=japi.JobClient(jsrv, tenant="t"))
        job, jjob = srv.jobs()[0], jsrv.jobs()[0]
        assert job.total_units == jjob.total_units == pts.num_blocks + 2 + 1
        assert srv.executor.workers_alive() == []  # the server runs its units itself
    finally:
        srv.close()
        jsrv.close()
    ref, _ = histogram(pts, bins=8, policy=tapi.Baseline())
    assert identical(h, ref)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    assert (rep.dispatches, rep.merges) == (jrep.dispatches, jrep.merges)
    keys = _journal_keys(str(tmp_path / "t" / "journal.bin"))
    assert keys == _journal_keys(str(tmp_path / "j" / "journal.bin"))
    assert sum(k.startswith("merge:") for k in keys) == 3  # two folds + the merge
