"""The port's StreamExecutor against LocalExecutor and the JAX package's.

Every case of ``tests/test_chunkstore.py``'s ``TestStreamExecutor`` and
``TestAppsOutOfCore`` and of ``tests/test_pipeline.py``'s
``TestStreamPipeline`` runs here on the port with ``device="cpu"``: results
bit-identical to a LocalExecutor over the in-memory data under every policy,
the 4×-budget acceptance case (peak resident bytes at most 1.25× the budget,
a warm prefetch pipeline, the data spilled), re-iteration after spill,
store ownership on ``close()``, ``prefetch_depth=0``, map_partitions views,
errors that release every pin, the apps, and the prefetch crossing the
iteration boundary under ``compute_async``.

Then the same plans run on the JAX ``StreamExecutor`` and the port's from
one numpy input: values exact where the reference is exact (histogram and
k-means counts), else within the parity tests' f32 tolerance (``TOL``);
the structural report columns equal; and the streaming bill
(``bytes_spilled``, ``bytes_loaded``, ``prefetch_hits``) equal to the
reference's wherever two runs of the reference agree on it, else positive
where the reference's is (``_io_parity``).
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.api.futures import resolve_deferred as jresolve
from repro.core import blocked as jblocked
from repro_torch.api import (
    Baseline,
    Collection,
    DiskStore,
    LocalExecutor,
    Rechunk,
    SplIter,
    StreamExecutor,
    ThreadedExecutor,
)
from repro_torch.api.futures import resolve_deferred
from repro_torch.core import blocked as tblocked
from repro_torch.core.blocked import BlockedArray, round_robin_placement

jkm = importlib.import_module("repro.core.apps.kmeans")
tkm = importlib.import_module("repro_torch.core.apps.kmeans")
jhist = importlib.import_module("repro.core.apps.histogram")
thist = importlib.import_module("repro_torch.core.apps.histogram")

TOL = dict(rtol=2e-5, atol=2e-5)
STRUCTURAL = ("dispatches", "merges", "traces", "bytes_moved", "granularity")
IO = ("bytes_spilled", "bytes_loaded", "prefetch_hits")
POLICIES = (
    "Baseline()",
    "SplIter()",
    "SplIter(partitions_per_location=2)",
    "SplIter(materialize=True)",
    "Rechunk()",
)


def _policy(api, text):
    return eval(text, {k: getattr(api, k) for k in ("Baseline", "SplIter", "Rechunk")})


def _np_dataset(rows=4096, d=8, seed=0):
    return np.random.default_rng(seed).random((rows, d)).astype(np.float32)


def _dataset(rows=4096, d=8, seed=0) -> torch.Tensor:
    return torch.from_numpy(_np_dataset(rows, d, seed))


def _store(budget):
    return DiskStore(residency_bytes=budget, device="cpu")


def _sum_plan(x, block_rows, locs, policy, ex, store=None):
    c = Collection.from_array(
        x, block_rows=block_rows, num_locations=locs,
        placement=round_robin_placement, store=store, device="cpu",
    )
    return c.split(policy).map_blocks(torch.sum).reduce(lambda a, b: a + b).compute(executor=ex)


def _jsum_plan(x, block_rows, locs, policy, ex, store=None):
    c = japi.Collection.from_array(
        jnp.asarray(x), block_rows=block_rows, num_locations=locs,
        placement=jblocked.round_robin_placement, store=store,
    )
    return c.split(policy).map_blocks(jnp.sum).reduce(lambda a, b: a + b).compute(executor=ex)


def _structural(report):
    return tuple(getattr(report, f) for f in STRUCTURAL)


def _io(reports):
    return tuple(sum(getattr(r, f) for r in reports) for f in IO)


def _io_parity(port, ref, ref_again):
    """The port's streaming bill against the reference's: equal where two
    runs of the reference agree (on every plan here they did), else
    positive wherever the reference's is."""
    if ref == ref_again:
        assert port == ref
    else:
        for p, r, r2 in zip(port, ref, ref_again):
            assert (p > 0) == (r > 0) == (r2 > 0)


# ---------------------------------------------------------------------------
# StreamExecutor (tests/test_chunkstore.py TestStreamExecutor)
# ---------------------------------------------------------------------------


class TestStreamExecutor:
    @pytest.mark.parametrize("pol", POLICIES)
    def test_bit_identical_to_local_across_policies(self, pol):
        x = _dataset()
        ref = _sum_plan(x, 256, 4, _policy(tapi, pol), LocalExecutor())
        store = _store(x.nbytes // 4)
        ex = StreamExecutor()
        res = _sum_plan(x, 256, 4, _policy(tapi, pol), ex, store=store)
        assert torch.equal(res.value, ref.value)
        assert res.report.dispatches == ref.report.dispatches
        ex.close()

    def test_acceptance_4x_budget_bounded_residency(self):
        # a dataset 4x the residency budget completes, peak resident block
        # bytes stay <= 1.25x the budget, results are bit-identical to
        # LocalExecutor, and the prefetch pipeline was warm (hits > 0)
        x = _dataset(rows=8192, d=8)
        budget = x.nbytes // 4
        ref = _sum_plan(x, 256, 4, SplIter(partitions_per_location=8), LocalExecutor())
        store = _store(budget)
        ex = StreamExecutor()
        res = _sum_plan(x, 256, 4, SplIter(partitions_per_location=8), ex, store=store)
        assert torch.equal(res.value, ref.value)
        assert store.stats.peak_resident_bytes <= 1.25 * budget
        assert res.report.prefetch_hits > 0
        assert res.report.bytes_spilled > 0  # the dataset cannot fit: it spilled
        ex.close()

    def test_reiteration_after_spill_bit_identical(self):
        x = _dataset()
        store = _store(x.nbytes // 4)
        ex = StreamExecutor()
        c = Collection.from_array(
            x, 256, num_locations=4, placement=round_robin_placement, store=store, device="cpu"
        ).split(SplIter(partitions_per_location=4))
        plan = c.map_blocks(torch.sum).reduce(lambda a, b: a + b)
        first = plan.compute(executor=ex)
        assert first.report.bytes_spilled > 0 or store.stats.spills > 0
        second = plan.compute(executor=ex)   # every block re-read from spill
        third = plan.compute(executor=ex)
        assert torch.equal(first.value, second.value) and torch.equal(second.value, third.value)
        assert second.report.bytes_loaded > 0
        ex.close()

    def test_close_closes_streamed_stores(self):
        x = _dataset()
        store = _store(x.nbytes // 4)
        ex = StreamExecutor()
        _sum_plan(x, 256, 4, SplIter(), ex, store=store)
        d = store.spill_dir
        assert os.path.isdir(d)
        thread = ex._prefetcher._thread
        ex.close()
        assert store.closed and not os.path.exists(d)  # no temp-file leaks
        thread.join(timeout=10)
        assert not thread.is_alive()
        ex.close()  # idempotent

    def test_close_stores_false_keeps_store_usable(self):
        x = _dataset()
        store = _store(x.nbytes // 4)
        ex = StreamExecutor(close_stores=False)
        r1 = _sum_plan(x, 256, 4, SplIter(), ex, store=store)
        ex.close()
        assert not store.closed
        ex2 = StreamExecutor(close_stores=False)
        r2 = _sum_plan(x, 256, 4, SplIter(), ex2, store=store)
        assert torch.equal(r1.value, r2.value)
        ex2.close()
        store.close()

    @pytest.mark.parametrize("pol", POLICIES)
    def test_in_memory_inputs_degrade_gracefully(self, pol):
        x = _dataset()
        ex = StreamExecutor()
        ref = _sum_plan(x, 256, 4, _policy(tapi, pol), LocalExecutor())
        res = _sum_plan(x, 256, 4, _policy(tapi, pol), ex)  # no store at all
        assert torch.equal(res.value, ref.value)
        assert _io([res.report]) == (0, 0, 0)
        ex.close()

    def test_prefetch_depth_zero_still_correct(self):
        x = _dataset()
        store = _store(x.nbytes // 4)
        ex = StreamExecutor(prefetch_depth=0)
        ref = _sum_plan(x, 256, 4, SplIter(), LocalExecutor())
        res = _sum_plan(x, 256, 4, SplIter(), ex, store=store)
        assert torch.equal(res.value, ref.value)
        assert res.report.prefetch_hits == 0  # no lookahead issued
        assert res.report.bytes_loaded > 0
        ex.close()

    def test_map_partitions_views_stream_too(self):
        x = _dataset()
        ref_rows = (
            Collection.from_array(x, 256, num_locations=4, placement=round_robin_placement,
                                  device="cpu")
            .split(SplIter())
            .map_partitions(lambda v: torch.sum(v.materialized[0]))
            .compute(executor=LocalExecutor())
        )
        store = _store(x.nbytes // 4)
        ex = StreamExecutor()
        got = (
            Collection.from_array(x, 256, num_locations=4, placement=round_robin_placement,
                                  store=store, device="cpu")
            .split(SplIter())
            .map_partitions(lambda v: torch.sum(v.materialized[0]))
            .compute(executor=ex)
        )
        assert all(torch.equal(a, b) for a, b in zip(got.value, ref_rows.value))
        assert got.report.prefetch_hits > 0
        ex.close()

    def test_error_in_task_propagates_and_releases_pins(self):
        x = _dataset(rows=1024)
        store = _store(x.nbytes // 4)
        ba = BlockedArray.from_array(
            x, 256, num_locations=4, policy=round_robin_placement, store=store, device="cpu"
        )
        ex = StreamExecutor(close_stores=False)

        def boom(_):
            raise RuntimeError("task failed")

        with pytest.raises(RuntimeError, match="task failed"):
            Collection.from_blocked(ba).split(SplIter()).map_partitions(boom).compute(executor=ex)
        # every pin taken by prefetch/dispatch was dropped again
        assert not any(store.is_pinned(b) for b in ba.blocks)
        ex.close()
        store.close()

    def test_error_in_a_later_unit_releases_prefetched_pins(self):
        # the failing unit is not the first: its neighbour's prefetch pins
        # are in flight when it fails, and are dropped all the same
        x = _dataset(rows=2048)
        store = _store(x.nbytes // 4)
        ba = BlockedArray.from_array(
            x, 128, num_locations=4, policy=round_robin_placement, store=store, device="cpu"
        )
        ex = StreamExecutor(close_stores=False, prefetch_depth=2)
        seen = []

        def second_fails(view):
            seen.append(view.location)
            if len(seen) == 2:
                raise RuntimeError("second unit failed")
            return torch.sum(view.materialized[0])

        with pytest.raises(RuntimeError, match="second unit failed"):
            Collection.from_blocked(ba).split(SplIter(partitions_per_location=2)) \
                .map_partitions(second_fails).compute(executor=ex)
        assert not any(store.is_pinned(b) for b in ba.blocks)
        ex.close()
        store.close()

    def test_rejects_negative_prefetch_depth(self):
        with pytest.raises(ValueError):
            StreamExecutor(prefetch_depth=-1)


class TestThreadedOverDiskStore:
    """The pin hooks on a backend that is not out-of-core: every worker
    resolves chunks of one store, and the value equals Local's."""

    @pytest.mark.parametrize("pol", POLICIES)
    def test_threaded_equals_local(self, pol):
        x = _dataset(rows=2048)
        store = _store(x.nbytes // 4)
        with ThreadedExecutor() as ex, LocalExecutor() as local:
            for _ in range(2):  # the second pass re-reads spilled chunks
                ref = _sum_plan(x, 128, 4, _policy(tapi, pol), local)
                res = _sum_plan(x, 128, 4, _policy(tapi, pol), ex, store=store)
                assert torch.equal(res.value, ref.value)
                assert _structural(res.report) == _structural(ref.report)
        assert store.stats.loads > 0 and store.stats.spills > 0
        store.close()


# ---------------------------------------------------------------------------
# apps over chunk-backed data (tests/test_chunkstore.py TestAppsOutOfCore)
# ---------------------------------------------------------------------------


class TestAppsOutOfCore:
    def test_kmeans_streams_bit_identical(self):
        pts = _np_dataset(rows=2048, d=4, seed=3)
        x_mem = BlockedArray.from_array(
            pts, 128, num_locations=2, policy=round_robin_placement, device="cpu"
        )
        ref = tkm.kmeans(x_mem, k=4, iters=3, policy=SplIter(partitions_per_location=4))
        store = _store(pts.nbytes // 4)
        x_disk = x_mem.to_store(store)
        ex = StreamExecutor()
        res = tkm.kmeans(x_disk, k=4, iters=3, policy=SplIter(partitions_per_location=4),
                         executor=ex)
        assert torch.equal(res.centers, ref.centers)
        assert sum(r.bytes_loaded for r in res.reports) > 0
        ex.close()

    def test_histogram_streams_bit_exact(self):
        pts = _np_dataset(rows=4096, d=2, seed=4)
        x_mem = BlockedArray.from_array(
            pts, 256, num_locations=2, policy=round_robin_placement, device="cpu"
        )
        h_ref, _ = thist.histogram(x_mem, bins=8, policy=SplIter(partitions_per_location=4))
        store = _store(pts.nbytes // 4)
        ex = StreamExecutor()
        h, rep = thist.histogram(
            x_mem.to_store(store), bins=8, policy=SplIter(partitions_per_location=4),
            executor=ex,
        )
        assert torch.equal(h, h_ref)  # integer counts: exact
        assert rep.prefetch_hits > 0
        ex.close()


# ---------------------------------------------------------------------------
# the prefetch across the iteration boundary (tests/test_pipeline.py)
# ---------------------------------------------------------------------------


def _partial(b, c):
    return (b * c).sum(0), torch.ones(()) if isinstance(b, torch.Tensor) else jnp.ones(())


def _combine(a, b):
    return a[0] + b[0], a[1] + b[1]


def _ratio(v):
    return v[0] / v[1]


PIPE_POL = "SplIter(partitions_per_location=2)"


def _iterate(api, coll, c0, ex, iters, pipelined):
    c_op, futs, out = c0, [], []
    for _ in range(iters):
        plan = coll.split(_policy(api, PIPE_POL)).map_blocks(_partial, extra_args=(c_op,)) \
            .reduce(_combine)
        if pipelined:
            fut = plan.compute_async(executor=ex)
            futs.append(fut)
            c_op = fut.map(_ratio)
        else:
            res = plan.compute(executor=ex)
            out.append(res)
            c_op = _ratio(res.value)
    if pipelined:
        final = (resolve_deferred if api is tapi else jresolve)(c_op)
        out = [f.result() for f in futs]
        return out, final
    return out, c_op


class TestStreamPipeline:
    def test_prefetch_crosses_iteration_boundary(self):
        x = _np_dataset(512, 8)
        ref, ref_final = _iterate(
            tapi,
            Collection.from_array(x, block_rows=64, num_locations=2, device="cpu"),
            torch.ones(8), LocalExecutor(), 3, pipelined=False,
        )
        store = _store(x.nbytes // 2)
        ex = StreamExecutor(close_stores=False)
        try:
            xd = Collection.from_array(x, block_rows=64, num_locations=2, store=store,
                                       device="cpu")
            results, final = _iterate(tapi, xd, torch.ones(8), ex, 3, pipelined=True)
        finally:
            ex.close()
            store.close()
        assert all(torch.equal(_ratio(a.value), _ratio(b.value)) for a, b in zip(ref, results))
        assert torch.equal(final, ref_final)
        assert sum(r.report.overlapped_launches for r in results) > 0
        assert sum(r.report.prefetch_hits for r in results) > 0

    def test_kmeans_pipeline_equals_barriered_loop(self):
        pts = _np_dataset(rows=2048, d=4, seed=5)
        x_mem = BlockedArray.from_array(
            pts, 128, num_locations=2, policy=round_robin_placement, device="cpu"
        )
        pol = SplIter(partitions_per_location=2)
        ref = tkm.kmeans(x_mem, k=4, iters=3, policy=pol)
        store = _store(pts.nbytes // 4)
        with StreamExecutor(close_stores=False) as ex:
            x_disk = x_mem.to_store(store)
            barriered = tkm.kmeans(x_disk, k=4, iters=3, policy=pol, executor=ex)
            piped = tkm.kmeans(x_disk, k=4, iters=3, policy=pol, executor=ex, pipeline=True)
        store.close()
        assert torch.equal(barriered.centers, ref.centers)
        assert torch.equal(piped.centers, ref.centers)
        assert [r.overlapped_launches for r in barriered.reports] == [0, 0, 0]
        overlapped = [r.overlapped_launches for r in piped.reports]
        assert overlapped[0] == 0 and all(n > 0 for n in overlapped[1:])
        assert [_structural(r) for r in barriered.reports] == [_structural(r) for r in ref.reports]
        # the pipelined run reuses the barriered run's traces: all else equal
        assert [_structural(r)[:2] + _structural(r)[3:] for r in piped.reports] == \
            [_structural(r)[:2] + _structural(r)[3:] for r in ref.reports]


# ---------------------------------------------------------------------------
# the same plans on the JAX package's StreamExecutor
# ---------------------------------------------------------------------------


def _jstream_sum(x, pol, budget):
    store = japi.DiskStore(residency_bytes=budget)
    ex = japi.StreamExecutor()
    try:
        return _jsum_plan(x, 256, 4, _policy(japi, pol), ex, store=store)
    finally:
        ex.close()


@pytest.mark.parametrize("pol", POLICIES)
def test_sum_plan_matches_reference_stream(pol):
    x = _np_dataset()
    budget = x.nbytes // 4
    store = _store(budget)
    with StreamExecutor() as ex:
        res = _sum_plan(torch.from_numpy(x), 256, 4, _policy(tapi, pol), ex, store=store)
    jres, jres2 = _jstream_sum(x, pol, budget), _jstream_sum(x, pol, budget)
    np.testing.assert_allclose(res.value.numpy(), np.asarray(jres.value), **TOL)
    assert _structural(res.report) == _structural(jres.report)
    _io_parity(_io([res.report]), _io([jres.report]), _io([jres2.report]))
    assert res.report.bytes_spilled > 0 and res.report.bytes_loaded > 0


def _blocked_pair(pts, rows_per_block, locs):
    jx = jblocked.BlockedArray.from_array(
        jnp.asarray(pts), rows_per_block, num_locations=locs,
        policy=jblocked.round_robin_placement,
    )
    tx = tblocked.BlockedArray.from_array(
        pts, rows_per_block, num_locations=locs, policy=tblocked.round_robin_placement,
        device="cpu",
    )
    return jx, tx


HIST_POLICIES = ("SplIter(partitions_per_location=4)", "SplIter(fusion='pallas')",
                 "Baseline()")


@pytest.mark.parametrize("pol", HIST_POLICIES)
def test_histogram_matches_reference_stream(pol):
    pts = _np_dataset(rows=4096, d=2, seed=4)
    jx, tx = _blocked_pair(pts, 256, 2)
    budget = pts.nbytes // 4

    def jrun():
        ex = japi.StreamExecutor()
        try:
            return jhist.histogram(jx.to_store(japi.DiskStore(residency_bytes=budget)), bins=8,
                                   policy=_policy(japi, pol), executor=ex)
        finally:
            ex.close()

    with StreamExecutor() as ex:
        h, rep = thist.histogram(tx.to_store(_store(budget)), bins=8,
                                 policy=_policy(tapi, pol), executor=ex)
    (jh, jrep), (_, jrep2) = jrun(), jrun()
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))  # counts: exact
    assert _structural(rep) == _structural(jrep)
    _io_parity(_io([rep]), _io([jrep]), _io([jrep2]))
    assert rep.prefetch_hits > 0


def _kmeans_pair(seed=3, k=4, d=4, rows=2048):
    """Tight blobs around JAX's initial centers: no assignment near a tie,
    so k-means counts compare exactly across the packages."""
    import jax

    init = np.asarray(jax.random.uniform(jax.random.key(seed), (k, d), jnp.float32))
    rng = np.random.default_rng(seed)
    means = init + 0.05 * rng.standard_normal((k, d))
    pts = (means[rng.integers(0, k, rows)] + 0.01 * rng.standard_normal((rows, d)))
    return pts.astype(np.float32)


@pytest.mark.parametrize("pipeline", [False, True], ids=["barriered", "pipelined"])
def test_kmeans_matches_reference_stream(pipeline):
    pts = _kmeans_pair()
    jx, tx = _blocked_pair(pts, 128, 2)
    budget = pts.nbytes // 4
    pol = "SplIter(partitions_per_location=4)"

    def jrun():
        ex = japi.StreamExecutor()
        try:
            return jkm.kmeans(jx.to_store(japi.DiskStore(residency_bytes=budget)), k=4, iters=3,
                              seed=3, policy=_policy(japi, pol), executor=ex, pipeline=pipeline)
        finally:
            ex.close()

    with StreamExecutor() as ex:
        tres = tkm.kmeans(tx.to_store(_store(budget)), k=4, iters=3, seed=3,
                          policy=_policy(tapi, pol), executor=ex, pipeline=pipeline)
    jres, jres2 = jrun(), jrun()
    np.testing.assert_allclose(tres.centers.numpy(), np.asarray(jres.centers), **TOL)
    assert [_structural(r) for r in tres.reports] == [_structural(r) for r in jres.reports]
    assert [r.overlapped_launches for r in tres.reports] == \
        [r.overlapped_launches for r in jres.reports]
    _io_parity(_io(tres.reports), _io(jres.reports), _io(jres2.reports))
    assert _io(tres.reports)[1] > 0 and _io(tres.reports)[2] > 0
    # one more step from the converged centers: counts exact
    c = np.asarray(jres.centers)
    _, jc = japi.Collection.from_blocked(jx).split(_policy(japi, pol)) \
        .map_blocks(jkm.partial_sum_block, extra_args=(jnp.asarray(c),)) \
        .reduce(jkm._combine).compute().value
    _, tc = Collection.from_blocked(tx).split(_policy(tapi, pol)) \
        .map_blocks(tkm.partial_sum_block, extra_args=(torch.tensor(c),)) \
        .reduce(tkm._combine).compute().value
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_iteration_pipeline_matches_reference_stream():
    x = _np_dataset(512, 8)
    budget = x.nbytes // 2

    def jrun():
        store = japi.DiskStore(budget)
        ex = japi.StreamExecutor(close_stores=False)
        try:
            xd = japi.Collection.from_array(jnp.asarray(x), block_rows=64, num_locations=2,
                                            store=store)
            return _iterate(japi, xd, jnp.ones((8,)), ex, 3, pipelined=True)
        finally:
            ex.close()
            store.close()

    store = _store(budget)
    ex = StreamExecutor(close_stores=False)
    try:
        xd = Collection.from_array(x, block_rows=64, num_locations=2, store=store, device="cpu")
        results, final = _iterate(tapi, xd, torch.ones(8), ex, 3, pipelined=True)
    finally:
        ex.close()
        store.close()
    (jresults, jfinal), (jresults2, _) = jrun(), jrun()
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **TOL)
    for r, j in zip(results, jresults):
        assert _structural(r.report)[:2] == _structural(j.report)[:2]
        assert r.report.overlapped_launches == j.report.overlapped_launches
    _io_parity(_io([r.report for r in results]), _io([r.report for r in jresults]),
               _io([r.report for r in jresults2]))


def test_capabilities_match_reference():
    tex, jex = StreamExecutor(), japi.StreamExecutor()
    try:
        for f in ("pipelined", "out_of_core"):
            assert getattr(tex.capabilities, f) is getattr(jex.capabilities, f) is True
        assert LocalExecutor().capabilities.out_of_core is False
        assert tex.prefetch_depth == jex.prefetch_depth == 1
        assert tex.pipeline_depth == jex.pipeline_depth
    finally:
        tex.close()
        jex.close()
