"""The port's MeshExecutor against LocalExecutor and the JAX package's.

Every case of ``tests/test_api.py``'s ``TestMeshExecutor`` (and its
combine-identity regression), of ``tests/test_core_apps.py``'s
``TestPallasFusionApps`` (histogram and k-means with fusion on the mesh,
kNN and SVM through its fallback path) and ``tests/test_autotune.py``'s
sharded profile event runs here on the port with ``device="cpu"``.

The same numpy data then run on the JAX ``MeshExecutor`` and the port's
on one rank (the JAX side sees one CPU device here): the structural report
columns (``dispatches``, ``merges``, ``traces``, ``bytes_moved``,
``granularity``) are equal, and values equal where the reference is exact
(histogram counts) and within the reference's mesh tolerance ``MESH_TOL``
(``tests/test_api.py:427``) elsewhere.  The port's 8-rank mesh
(``devices=(cpu,) * 8``) is held to ``tests/_dist_child.py``'s
``check_mesh_executor``, run in a JAX subprocess with 8 forced host
devices: the same columns equal (``bytes_moved`` is (8 − 1) × the
partial's bytes, ``merges`` 1), values within ``MESH_TOL``.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.core import blocked as jblocked
from repro_torch.api import (
    Baseline,
    Collection,
    LocalExecutor,
    MeshExecutor,
    Rechunk,
    SplIter,
    ThreadedExecutor,
    engine,
    register_partition_kernel,
)
from repro_torch.api.kernels import PartitionKernel
from repro_torch.core import blocked as tblocked
from repro_torch.core.apps import cascade_svm, histogram, kmeans, knn
from repro_torch.core.blocked import BlockedArray, round_robin_placement

CPU = torch.device("cpu")
#: the reference's mesh tolerance (tests/test_api.py:427, tests/_dist_child.py:280)
MESH_TOL = dict(rtol=2e-4, atol=2e-4)
STRUCTURAL = ("dispatches", "merges", "traces", "bytes_moved", "granularity")
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")

POLICIES = [
    "Baseline()",
    "SplIter()",
    "SplIter(materialize=True)",
    "SplIter(partitions_per_location=3)",
    "SplIter(partitions_per_location=3, materialize=True)",
    "Rechunk()",
    "Rechunk(target_rows=17)",
]
# (rows, block_rows, locations, placement): uniform, ragged tail, ragged with
# many locations, single location, more locations than blocks
DATASETS = [
    (96, 8, 4, "round_robin_placement"),
    (97, 12, 3, "round_robin_placement"),
    (341, 100, 5, "contiguous_placement"),
    (40, 7, 1, "contiguous_placement"),
    (5, 2, 8, "round_robin_placement"),
]


def _policy(api, text):
    return eval(text, {k: getattr(api, k) for k in ("Baseline", "SplIter", "Rechunk")})


def _structural(report):
    return tuple(getattr(report, f) for f in STRUCTURAL)


def _mesh(ranks: int = 1) -> MeshExecutor:
    return engine("mesh", devices=(CPU,) * ranks)


def _pair(rows, block_rows, locs, placement, d=3, seed=0):
    pts = np.random.default_rng(seed).normal(size=(rows, d)).astype(np.float32)
    jx = jblocked.BlockedArray.from_array(
        jnp.asarray(pts), block_rows, num_locations=locs, policy=getattr(jblocked, placement)
    )
    tx = tblocked.BlockedArray.from_array(
        pts, block_rows, num_locations=locs, policy=getattr(tblocked, placement), device="cpu"
    )
    return pts, jx, tx


def _moments_fn(b):
    if isinstance(b, torch.Tensor):
        return b.sum(0), (b * b).sum(0), torch.tensor(float(b.shape[0]))
    return jnp.sum(b, 0), jnp.sum(b * b, 0), jnp.asarray(b.shape[0], jnp.float32)


def _moments_combine(a, b):
    return a[0] + b[0], a[1] + b[1], a[2] + b[2]


def _moments(api, x, pol):
    return (
        api.Collection.from_blocked(x).split(pol)
        .map_blocks(_moments_fn).reduce(_moments_combine)
    )


def _close(a, b, **tol):
    for u, v in zip(a, b):
        np.testing.assert_allclose(np.asarray(u), np.asarray(v), **tol)


# ---------------------------------------------------------------------------
# tests/test_api.py::TestMeshExecutor on the port
# ---------------------------------------------------------------------------


class TestMeshExecutor:
    @pytest.mark.parametrize("ds", DATASETS, ids=lambda d: f"n{d[0]}b{d[1]}l{d[2]}")
    def test_matches_local_all_policies(self, ds):
        _, _, tx = _pair(*ds)
        for text in POLICIES:
            plan = _moments(tapi, tx, _policy(tapi, text))
            loc = plan.compute(executor=LocalExecutor())
            mesh = plan.compute(executor=_mesh())
            _close(mesh.value, loc.value, **MESH_TOL, err_msg=text)
            # sharded calls never exceed the per-task dispatch count
            assert mesh.report.dispatches <= loc.report.dispatches

    def test_uniform_spliter_is_one_sharded_dispatch(self):
        _, _, tx = _pair(96, 8, 4, "round_robin_placement")  # 12 uniform blocks
        res = _moments(tapi, tx, SplIter()).compute(executor=_mesh())
        assert res.report.dispatches == 1  # all 4 partitions, one sharded call

    def test_map_partitions_fallback_covers_all_rows(self):
        _, _, tx = _pair(97, 12, 3, "round_robin_placement")
        views = (
            Collection.from_blocked(tx).split(SplIter())
            .map_partitions(lambda v: (v.location, v.item_indexes))
            .compute(executor=_mesh()).value
        )
        allidx = np.concatenate([idx for _, idx in views])
        assert sorted(allidx.tolist()) == list(range(97))

    def test_unreduced_map_falls_back_to_block_order(self):
        pts, _, tx = _pair(96, 8, 4, "round_robin_placement")
        partials = (
            Collection.from_blocked(tx).split(SplIter())
            .map_blocks(lambda b: b.sum(0))
            .compute(executor=_mesh()).value
        )
        assert len(partials) == tx.num_blocks
        np.testing.assert_allclose(partials[0].numpy(), pts[:8].sum(0), **MESH_TOL)

    def test_iterative_reuses_compiled_sharded_call(self):
        _, _, tx = _pair(96, 8, 4, "round_robin_placement")
        ex = _mesh()
        plan = _moments(tapi, tx, SplIter())
        r1 = plan.compute(executor=ex).report
        r2 = plan.compute(executor=ex).report
        assert r1.traces >= 1 and r2.traces == 0
        assert r2.dispatches == r1.dispatches == 1

    def test_mesh_cache_keyed_on_combine_identity(self):
        """Same map fn reduced by DIFFERENT combines on one MeshExecutor must
        not share a sharded fold (tests/test_api.py:656)."""
        pts, _, tx = _pair(96, 8, 4, "round_robin_placement")
        ex = _mesh()
        base = Collection.from_blocked(tx).split(Baseline()).map_blocks(lambda b: b.sum(0))
        s = base.reduce(lambda a, b: a + b).compute(executor=ex).value
        m = base.reduce(torch.maximum).compute(executor=ex).value
        np.testing.assert_allclose(s.numpy(), pts.sum(0), **MESH_TOL)
        np.testing.assert_allclose(
            m.numpy(), np.max(pts.reshape(12, 8, 3).sum(1), axis=0), **MESH_TOL
        )


@pytest.mark.parametrize("text", POLICIES)
@pytest.mark.parametrize("ds", DATASETS, ids=lambda d: f"n{d[0]}b{d[1]}l{d[2]}")
def test_matches_reference_mesh(ds, text):
    """One plan on the JAX MeshExecutor (one CPU device) and the port's (one
    rank): structural columns equal, values within MESH_TOL."""
    _, jx, tx = _pair(*ds)
    jres = _moments(japi, jx, _policy(japi, text)).compute(executor=japi.MeshExecutor())
    tres = _moments(tapi, tx, _policy(tapi, text)).compute(executor=_mesh())
    assert _structural(tres.report) == _structural(jres.report)
    _close(tres.value, jres.value, **MESH_TOL)


def test_capabilities_match_reference():
    j = japi.MeshExecutor().capabilities
    t = _mesh().capabilities
    assert t.grouped_dispatch and j.grouped_dispatch
    assert (t.pallas_fusion, t.out_of_core, t.remote, t.pipelined) == (
        j.pallas_fusion, j.out_of_core, j.remote, j.pipelined)


@pytest.mark.parametrize("n_tasks", [1, 2, 3, 4, 6, 7, 8, 12, 16, 17])
@pytest.mark.parametrize("n_devices", [1, 3, 4, 8])
def test_axis_size_matches_reference(n_tasks, n_devices):
    assert MeshExecutor._axis_size(n_tasks, n_devices) == japi.MeshExecutor._axis_size(
        n_tasks, n_devices)


def test_devices_default_to_the_visible_cuda_devices():
    """``devices=None`` means the card(s); a host without one raises and
    names the argument instead of falling back to the CPU."""
    if torch.cuda.is_available():
        ex = engine("mesh")
        assert all(d.type == "cuda" for d in ex.devices)
        assert len(ex.devices) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="devices"):
            engine("mesh")


def test_pallas_tasks_receive_blocks_in_place():
    """No group-axis stack: a fused task's kernel gets the partition's blocks
    themselves (same storage as the BlockedArray's), on every rank."""
    seen = []

    def block_fn(b):
        return b.sum(0)

    def kernel(blocks):
        seen.append(tuple(b.data_ptr() for b in blocks))
        return torch.stack([b.sum(0) for b in blocks]).sum(0)

    register_partition_kernel(
        block_fn,
        lambda args, kwargs: PartitionKernel(
            name="test_in_place", key=("test_in_place",), fn=kernel,
            supports=lambda shape, extra: True),
    )
    _, _, tx = _pair(96, 8, 4, "round_robin_placement")
    ptrs = {b.data_ptr() for b in tx.blocks}
    for ranks in (1, 4):
        seen.clear()
        res = (Collection.from_blocked(tx).split(SplIter(fusion="pallas"))
               .map_blocks(block_fn).reduce(lambda a, b: a + b)
               .compute(executor=_mesh(ranks)))
        assert res.report.dispatches == 1
        assert len(seen) == 4 and all(set(p) <= ptrs for p in seen)


# ---------------------------------------------------------------------------
# tests/test_core_apps.py::TestPallasFusionApps and the profile event
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def points():
    x = np.random.default_rng(7).uniform(0, 1, (512, 3)).astype(np.float32)
    return x, BlockedArray.from_array(
        x, 32, num_locations=4, policy=round_robin_placement, device="cpu"
    )


class TestPallasFusionApps:
    def test_histogram_pallas_local_and_mesh(self, points):
        _, ba = points
        ref, _ = histogram(ba, bins=4, policy=Baseline())
        for ex in (LocalExecutor(), ThreadedExecutor(), _mesh()):
            h, rep = histogram(ba, bins=4, policy=SplIter(fusion="pallas"), executor=ex)
            assert torch.equal(h, ref), type(ex).__name__
            assert rep.dispatches <= ba.num_locations + 1  # C1
            assert rep.bytes_moved == 0                    # one rank
            ex.close()

    def test_kmeans_pallas_local_and_mesh(self, points):
        _, ba = points
        base = kmeans(ba, k=4, iters=5, policy=Baseline())
        for ex in (LocalExecutor(), _mesh()):
            r = kmeans(ba, k=4, iters=5, policy=SplIter(fusion="pallas"), executor=ex)
            np.testing.assert_allclose(
                r.centers.numpy(), base.centers.numpy(), **MESH_TOL,
                err_msg=type(ex).__name__)
            assert r.total_dispatches <= 5 * (ba.num_locations + 1)  # C1

    def test_knn_and_svm_run_on_mesh_executor(self):
        """Apps built on scope()/task()/map_partitions use the fallback
        scheduling path: the mesh gives Local's bits."""
        rng = np.random.default_rng(2)
        fit = rng.normal(size=(120, 3)).astype(np.float32)
        q = rng.normal(size=(32, 3)).astype(np.float32)
        fb = BlockedArray.from_array(fit, 16, num_locations=4, policy=round_robin_placement,
                                     device="cpu")
        qb = BlockedArray.from_array(q, 16, num_locations=4, device="cpu")
        r_mesh = knn(fb, qb, k=3, policy=SplIter(), executor=_mesh())
        r_loc = knn(fb, qb, k=3, policy=SplIter(), executor=LocalExecutor())
        assert torch.equal(r_mesh.indices, r_loc.indices)
        assert torch.equal(r_mesh.distances, r_loc.distances)

        y = np.where(fit[:, 0] + fit[:, 1] > 0, 1.0, -1.0).astype(np.float32)
        xb = BlockedArray.from_array(fit, 16, num_locations=4, device="cpu")
        yb = BlockedArray.from_array(y, 16, num_locations=4, device="cpu")
        s_mesh = cascade_svm(xb, yb, num_sv=8, steps=20, iterations=1, executor=_mesh())
        s_loc = cascade_svm(xb, yb, num_sv=8, steps=20, iterations=1,
                            executor=LocalExecutor())
        assert torch.equal(s_mesh.sv_x, s_loc.sv_x)
        assert torch.equal(s_mesh.sv_alpha, s_loc.sv_alpha)


def _sum_plan(ba, pol):
    return Collection.from_blocked(ba).split(pol).map_blocks(lambda b: b.sum(0)).reduce(
        lambda a, b: a + b)


def test_mesh_records_sharded_units():
    """tests/test_autotune.py:297: one ``sharded`` profile event covering
    all four partitions."""
    _, _, tx = _pair(96, 8, 4, "round_robin_placement")
    ex = _mesh()
    _sum_plan(tx, SplIter()).compute(executor=ex)
    sharded = [p for p in ex.profile.snapshot() if p.kind == "sharded"]
    assert len(sharded) == 1
    assert sharded[0].tasks == 4


def test_every_backend_emits_profile_events():
    _, _, tx = _pair(96, 8, 4, "round_robin_placement")
    for ex in (LocalExecutor(), ThreadedExecutor(), _mesh()):
        _sum_plan(tx, SplIter()).compute(executor=ex)
        assert ex.profile.events, type(ex).__name__
        ex.close()


def test_sharded_units_feed_the_autotuner_overhead_hint():
    """``"sharded"`` is one of the task kinds the autotuner reads, as in the
    JAX package (executors.py ``_feed_tuner``)."""
    _, _, tx = _pair(96, 8, 4, "round_robin_placement")
    ex = _mesh()
    res = _sum_plan(tx, SplIter(partitions_per_location="auto")).compute(executor=ex)
    assert res.report.dispatches == 1
    keys = {p.key for p in ex.profile.snapshot() if p.kind == "sharded"}
    assert ex.profile.mean_task_overhead_s(kinds=("sharded",), keys=keys) > 0


# ---------------------------------------------------------------------------
# the association of the fold: where the mesh gives Local's bits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ranks,ppl,bit_identical", [
    (1, 1, True),    # one rank chains the 4 singleton partitions: Local's chain
    (4, 1, True),    # a rank per partition, then the rank chain: Local's chain
    (4, 2, True),    # a rank per location's pair: Local's per-location tree
    (1, 2, False),   # one flat chain over 8 partials: not Local's tree
])
def test_fold_association_decides_bit_identity(ranks, ppl, bit_identical):
    """k-means partials are float sums: the mesh equals Local bit for bit
    exactly where its association (rank shares, then ranks) is Local's
    (per-location chains, then locations), and within MESH_TOL elsewhere."""
    x = np.random.default_rng(3).normal(size=(4096, 6)).astype(np.float32)
    ba = BlockedArray.from_array(x, 128, num_locations=4, policy=round_robin_placement,
                                 device="cpu")
    pol = SplIter(ppl, fusion="pallas")
    loc = kmeans(ba, k=5, iters=2, policy=pol, executor=LocalExecutor())
    mesh = kmeans(ba, k=5, iters=2, policy=pol, executor=_mesh(ranks))
    if bit_identical:
        assert torch.equal(mesh.centers, loc.centers)
    else:
        np.testing.assert_allclose(mesh.centers.numpy(), loc.centers.numpy(), **MESH_TOL)
    assert [_structural(r)[0] for r in mesh.reports] == [1, 1]


# ---------------------------------------------------------------------------
# the 8-rank mesh against the JAX package on 8 forced host devices
# ---------------------------------------------------------------------------

_CHILD = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from functools import partial
from repro.api import Baseline, Collection, MeshExecutor, Rechunk, SplIter
from repro.core.apps.histogram import histogram
from repro.core.apps.kmeans import kmeans
from repro.core.blocked import BlockedArray, round_robin_placement

assert jax.device_count() == 8, jax.device_count()
cols = ("dispatches", "merges", "traces", "bytes_moved", "granularity")
row = lambda r: [getattr(r, c) for c in cols]
tree = lambda v: [np.asarray(x).tolist() for x in (v if isinstance(v, tuple) else (v,))]
x = np.random.default_rng(0).uniform(0, 1, (512, 3)).astype(np.float32)
ba = BlockedArray.from_array(jnp.asarray(x), 16, num_locations=8, policy=round_robin_placement)
out = {}
for name, pol in [("baseline", Baseline()), ("scan", SplIter(fusion="scan")),
                  ("pallas", SplIter(fusion="pallas")), ("spliter2", SplIter(2)),
                  ("rechunk", Rechunk())]:
    h, r = histogram(ba, bins=4, policy=pol, executor=MeshExecutor())
    out["histogram/" + name] = {"reports": [row(r)], "value": tree(h)}
km = kmeans(ba, k=4, iters=3, policy=SplIter(fusion="pallas"), executor=MeshExecutor())
out["kmeans/pallas"] = {"reports": [row(r) for r in km.reports], "value": tree(km.centers)}
y = np.random.default_rng(1).normal(size=(97, 3)).astype(np.float32)
ya = BlockedArray.from_array(jnp.asarray(y), 12, num_locations=3, policy=round_robin_placement)
res = (Collection.from_blocked(ya).split(SplIter()).map_blocks(
    lambda b: (jnp.sum(b, 0), jnp.sum(b * b, 0))).reduce(
    lambda a, b: (a[0] + b[0], a[1] + b[1])).compute(executor=MeshExecutor()))
out["moments/ragged"] = {"reports": [row(res.report)], "value": tree(res.value)}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_8_devices():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = next(l for l in out.stdout.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _port_8_ranks(case: str):
    x = np.random.default_rng(0).uniform(0, 1, (512, 3)).astype(np.float32)
    ba = BlockedArray.from_array(x, 16, num_locations=8, policy=round_robin_placement,
                                 device="cpu")
    ex = _mesh(8)
    app, name = case.split("/")
    if app == "histogram":
        pol = {"baseline": Baseline(), "scan": SplIter(fusion="scan"),
               "pallas": SplIter(fusion="pallas"), "spliter2": SplIter(2),
               "rechunk": Rechunk()}[name]
        h, r = histogram(ba, bins=4, policy=pol, executor=ex)
        return [r], (h,)
    if app == "kmeans":
        km = kmeans(ba, k=4, iters=3, policy=SplIter(fusion="pallas"), executor=ex)
        return km.reports, (km.centers,)
    y = np.random.default_rng(1).normal(size=(97, 3)).astype(np.float32)
    ya = BlockedArray.from_array(y, 12, num_locations=3, policy=round_robin_placement,
                                 device="cpu")
    res = (Collection.from_blocked(ya).split(SplIter())
           .map_blocks(lambda b: (b.sum(0), (b * b).sum(0)))
           .reduce(lambda a, b: (a[0] + b[0], a[1] + b[1])).compute(executor=ex))
    return [res.report], res.value


@pytest.mark.parametrize("case", [
    "histogram/baseline", "histogram/scan", "histogram/pallas", "histogram/spliter2",
    "histogram/rechunk", "kmeans/pallas", "moments/ragged",
])
def test_eight_ranks_match_reference_eight_devices(reference_8_devices, case):
    want = reference_8_devices[case]
    reports, value = _port_8_ranks(case)
    assert [list(_structural(r)) for r in reports] == want["reports"]
    for got, ref in zip(value, want["value"]):
        if case.startswith("histogram"):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref, np.int32))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **MESH_TOL)
    if case in ("histogram/scan", "histogram/pallas"):
        # tests/_dist_child.py::check_mesh_executor: one sharded call, the
        # cross-rank merge billed as (8 - 1) x the partial's bytes
        (r,) = reports
        assert (r.dispatches, r.merges, r.bytes_moved) == (1, 1, 7 * 4**3 * 4)
    if case == "kmeans/pallas":
        assert [r.dispatches for r in reports] == [1, 1, 1]
