"""The port's ThreadedExecutor and pipelined ``execute_async`` vs the JAX package.

Both packages run the same numpy data through the same plans.  On the
port, a ThreadedExecutor's values equal a LocalExecutor's bit for bit, and
a pipelined loop (``compute_async`` with the loop-carried value as a
``Deferred``) equals the barriered loop bit for bit.  The structural
EngineReport columns (``dispatches``, ``merges``, ``traces``,
``bytes_moved``, ``granularity``, ``overlapped_launches``) equal the
reference ThreadedExecutor's on the same plan.  Failure semantics, the
probe guard, the barrier rule, the in-flight window, ``close()`` with
futures in flight, and nested computes follow ``tests/test_pipeline.py``
and ``tests/test_api.py``.
"""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cluster_fns as fns
import repro.api as japi
import repro.api.lowering as jlow
import repro_torch.api as tapi
import repro_torch.api.lowering as tlow
from repro.core import blocked as jblocked
from repro_torch.api.futures import Deferred, PipelineBrokenError, resolve_deferred
from repro_torch.api.shm import leaked_segments
from repro_torch.core import blocked as tblocked
from repro_torch.kernels._build import count_launch

STRUCTURAL = ("dispatches", "merges", "traces", "bytes_moved", "granularity",
              "overlapped_launches")
POLICIES = [
    "Baseline()",
    "SplIter()",
    "SplIter(partitions_per_location=2)",
    "SplIter(materialize=True)",
    "SplIter(fusion='pallas')",
    "Rechunk()",
]
DATASETS = [(96, 8, 4, "round_robin_placement"), (97, 12, 3, "contiguous_placement")]


def _policy(api, text):
    return eval(text, {k: getattr(api, k) for k in ("Baseline", "SplIter", "Rechunk")})


def _structural(report):
    return tuple(getattr(report, f) for f in STRUCTURAL)


def _pair(rows, block_rows, locs, placement, d=3, seed=0):
    pts = np.random.default_rng(seed).random((rows, d)).astype(np.float32)
    jx = jblocked.BlockedArray.from_array(
        jnp.asarray(pts), block_rows, num_locations=locs, policy=getattr(jblocked, placement)
    )
    tx = tblocked.BlockedArray.from_array(
        pts, block_rows, num_locations=locs, policy=getattr(tblocked, placement), device="cpu"
    )
    return pts, jx, tx


def _moments(b):
    return b.sum(0), (b * b).sum(0)


def _moments_combine(a, b):
    return a[0] + b[0], a[1] + b[1]


def _moments_plan(api, x, pol):
    return (
        api.Collection.from_blocked(x).split(pol)
        .map_blocks(_moments).reduce(_moments_combine)
    )


# -- the iterative plan of tests/test_pipeline.py: partials -> merge -> map ----

POL_TEXT = "SplIter(partitions_per_location=2)"


def _partial(b, c):
    return (b * c).sum(0), torch.ones(()) if isinstance(b, torch.Tensor) else jnp.ones(())


def _combine(a, b):
    return a[0] + b[0], a[1] + b[1]


def _ratio(v):
    return v[0] / v[1]


def _data():
    return np.random.default_rng(0).random((512, 8), np.float32)


def _plan(x, c, *, fn=fns.pipe_partial, policy=None):
    """The port's plan; its functions live in ``tests/_torch_cluster_fns.py``
    so that a cluster worker running them never imports JAX."""
    policy = policy if policy is not None else _policy(tapi, POL_TEXT)
    return (
        tapi.Collection.from_array(x, block_rows=64, num_locations=2, device="cpu")
        .split(policy).map_blocks(fn, extra_args=(c,)).reduce(fns.pipe_combine)
    )


def _jplan(x, c, policy=None):
    policy = policy if policy is not None else _policy(japi, POL_TEXT)
    return (
        japi.Collection.from_array(jnp.asarray(x), block_rows=64, num_locations=2)
        .split(policy).map_blocks(_partial, extra_args=(c,)).reduce(_combine)
    )


def _barriered(x, ex, iters, *, policy=None):
    c, out, reports = torch.ones(8), [], []
    for _ in range(iters):
        res = _plan(x, c, policy=policy).compute(executor=ex)
        c = _ratio(res.value)
        out.append(c)
        reports.append(res.report)
    return out, reports


def _pipelined(x, ex, iters, *, policy=None):
    c_op, futs = torch.ones(8), []
    for _ in range(iters):
        fut = _plan(x, c_op, policy=policy).compute_async(executor=ex)
        futs.append(fut)
        c_op = fut.map(_ratio)
    final = resolve_deferred(c_op)
    results = [f.result() for f in futs]
    return [_ratio(r.value) for r in results], final, results


def _jpipelined(x, ex, iters):
    c_op, futs = jnp.ones((8,)), []
    for _ in range(iters):
        fut = _jplan(x, c_op).compute_async(executor=ex)
        futs.append(fut)
        c_op = fut.map(_ratio)
    resolve_deferred(c_op)
    return [f.result() for f in futs]


# ---------------------------------------------------------------------------
# ThreadedExecutor: bit-identity, the worker pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ds", DATASETS, ids=lambda d: f"n{d[0]}l{d[2]}")
@pytest.mark.parametrize("pol", POLICIES)
def test_threaded_identical_to_local(ds, pol):
    """Threaded equals Local bit for bit; its report columns equal the
    reference ThreadedExecutor's on the same plan."""
    _, jx, tx = _pair(*ds)
    seq = _moments_plan(tapi, tx, _policy(tapi, pol)).compute(executor=tapi.LocalExecutor())
    with tapi.ThreadedExecutor() as ex:
        thr = _moments_plan(tapi, tx, _policy(tapi, pol)).compute(executor=ex)
    for a, b in zip(seq.value, thr.value):
        assert torch.equal(a, b)
    jex = japi.ThreadedExecutor()
    try:
        jthr = _moments_plan(japi, jx, _policy(japi, pol)).compute(executor=jex)
    finally:
        jex.close()
    for a, b in zip(thr.value, jthr.value):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5)
    assert _structural(thr.report) == _structural(seq.report) == _structural(jthr.report)


def test_workers_persist_across_runs_and_join_on_close():
    _, _, tx = _pair(96, 8, 4, "round_robin_placement")
    ex = tapi.ThreadedExecutor()
    plan = _moments_plan(tapi, tx, tapi.SplIter())
    plan.compute(executor=ex)
    first = dict(ex._workers)
    assert len(first) == 4  # one worker per location
    plan.compute(executor=ex)
    assert dict(ex._workers) == first  # reused, not respawned
    threads = [w._thread for w in first.values()]
    ex.close()
    assert not ex._workers and not any(t.is_alive() for t in threads)
    res = plan.compute(executor=ex)  # the pool respawns on next use
    ref = plan.compute(executor=tapi.LocalExecutor())
    for a, b in zip(res.value, ref.value):
        assert torch.equal(a, b)
    ex.close()


def test_single_location_runs_inline():
    _, _, tx = _pair(40, 7, 1, "contiguous_placement")
    ex = tapi.ThreadedExecutor()
    _moments_plan(tapi, tx, tapi.SplIter()).compute(executor=ex)
    assert not ex._workers  # no threads for one location


def test_worker_error_propagates():
    _, _, tx = _pair(96, 8, 4, "round_robin_placement")

    def boom(view):
        raise RuntimeError("boom")

    with tapi.ThreadedExecutor() as ex, pytest.raises(RuntimeError, match="boom"):
        tapi.Collection.from_blocked(tx).split(tapi.SplIter()).map_partitions(boom) \
            .compute(executor=ex)


def test_nested_compute_does_not_deadlock():
    """A map_partitions callback computing on the SAME ThreadedExecutor runs
    inline instead of deadlocking its own location worker."""
    pts, _, tx = _pair(96, 8, 4, "round_robin_placement")
    ex = tapi.ThreadedExecutor()
    inner_plan = _moments_plan(tapi, tx, tapi.SplIter())

    def view_fn(view):
        inner = inner_plan.compute(executor=ex)  # nested, same executor
        return view.location, inner.value[0]

    res = tapi.Collection.from_blocked(tx).split(tapi.SplIter()).map_partitions(view_fn) \
        .compute(executor=ex)
    for _, total in res.value:
        np.testing.assert_allclose(total.numpy(), pts.sum(0), rtol=2e-5, atol=2e-5)
    ex.close()


def test_capabilities_match_reference():
    for tex, jex in ((tapi.LocalExecutor(), japi.LocalExecutor()),
                     (tapi.ThreadedExecutor(), japi.ThreadedExecutor())):
        assert tex.capabilities.pipelined is jex.capabilities.pipelined
        jex.close()
        tex.close()
    assert tapi.ThreadedExecutor.pipeline_depth == japi.ThreadedExecutor.pipeline_depth == 2


def test_launch_counts_from_threads_are_exact():
    """Kernel wrappers count launches through ``count_launch``: 32 threads
    (more than the cores) adding 2,000 each, switching as often as the
    interpreter allows, lose nothing."""

    def fn():
        pass

    fn.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [count_launch(fn) for _ in range(2000)])
                   for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert fn.launches == 64_000


# ---------------------------------------------------------------------------
# pipelined iteration (tests/test_pipeline.py)
# ---------------------------------------------------------------------------


#: the five backends and whether each pipelines (tests/test_pipeline.py)
PIPELINE_BACKENDS = [("local", False), ("threaded", True), ("mesh", False), ("stream", True),
                     ("cluster", True)]


def _backend(name):
    if name == "mesh":
        return tapi.engine("mesh", devices=(torch.device("cpu"),))
    return tapi.engine(name)


@pytest.mark.parametrize("name,pipelines", PIPELINE_BACKENDS,
                         ids=[b[0] for b in PIPELINE_BACKENDS])
def test_pipelined_matches_barriered(name, pipelines):
    x = _data()
    ex = _backend(name)
    try:
        assert ex.capabilities.pipelined is pipelines
        ref, _ = _barriered(x, ex, 4)
        got, final, results = _pipelined(x, ex, 4)
    finally:
        ex.close()
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    assert torch.equal(final, ref[-1])
    overlapped = [r.report.overlapped_launches for r in results]
    if pipelines:
        # frozen at submit time: iteration 0 has no predecessor, every later
        # submit finds one in flight, so the whole unit count overlaps
        assert overlapped[0] == 0 and all(n == overlapped[1] > 0 for n in overlapped[1:])
    else:
        assert overlapped == [0, 0, 0, 0]
        # non-pipelined backends degrade to sync futures: done at return
        with _backend(name) as ex2:
            fut = _plan(x, torch.ones(8)).compute_async(executor=ex2)
            assert fut.done()


# -- the cluster's pipeline: poisoned and closed contexts leak no segment --


@pytest.mark.skipif(not tapi.shm_available(), reason="host has no POSIX shared memory")
@pytest.mark.parametrize("p2p", ["auto", True])
def test_cluster_failure_poisons_and_leaks_nothing(p2p):
    """Iteration 1 fails in its workers: its future raises the original
    error, iteration 2's a typed poison naming it; with ``p2p=True`` the
    poisoned context's published partials are swept too."""
    x = _data()
    ex = tapi.engine("cluster", p2p=p2p)
    prefix = ex._shm.prefix
    try:
        f0 = _plan(x, torch.ones(8)).compute_async(executor=ex)
        f1 = _plan(x, f0.map(_ratio), fn=fns.pipe_boom).compute_async(executor=ex)
        f2 = _plan(x, f1.map(_ratio)).compute_async(executor=ex)
        assert f0.result() is not None
        assert (f0.result().report.p2p_bytes > 0) == (p2p is True)
        with pytest.raises(Exception) as exc:
            f1.result()
        assert "injected unit failure" in str(exc.value)
        with pytest.raises(PipelineBrokenError) as exc2:
            f2.result()
        assert exc2.value.iteration == f1.iteration
    finally:
        ex.close()
    assert leaked_segments(prefix) == []


@pytest.mark.skipif(not tapi.shm_available(), reason="host has no POSIX shared memory")
@pytest.mark.parametrize("p2p", ["auto", True])
def test_cluster_close_with_inflight_leaks_no_segments(p2p):
    """``close()`` with three pipelined submissions unresolved drains them:
    each equals the barriered loop's, and no segment survives — with
    ``p2p=True``, none of the published partials either."""
    x = _data()
    ref, _ = _barriered(x, tapi.LocalExecutor(), 3)
    ex = tapi.engine("cluster", p2p=p2p)
    prefix = ex._shm.prefix
    c_op, futs = torch.ones(8), []
    for _ in range(3):
        fut = _plan(x, c_op).compute_async(executor=ex)
        futs.append(fut)
        c_op = fut.map(_ratio)
    ex.close()
    got = [_ratio(f.result().value) for f in futs]
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    assert all((f.result().report.p2p_bytes > 0) == (p2p is True) for f in futs)
    assert leaked_segments(prefix) == []


def test_pipelined_reports_equal_reference():
    """Each future's report carries its own execute's counts, equal to the
    barriered run's and to the reference ThreadedExecutor's pipelined run."""
    x = _data()
    with tapi.ThreadedExecutor() as ex:
        _, sync_reports = _barriered(x, ex, 3)
        _, _, results = _pipelined(x, ex, 3)
    jex = japi.ThreadedExecutor()
    try:
        jresults = _jpipelined(x, jex, 3)
    finally:
        jex.close()
    for sync, r, j in zip(sync_reports, results, jresults):
        assert (r.report.dispatches, r.report.merges) == (sync.dispatches, sync.merges)
        assert _structural(r.report)[:2] == _structural(j.report)[:2]
        assert r.report.overlapped_launches == j.report.overlapped_launches
        assert r.report.granularity == j.report.granularity


def test_cross_iteration_edges_match_reference():
    """Two lowerings of one spec: every task of the next graph is gated on the
    same-partition tasks of the previous one, the same edges as the JAX
    package's for the same plan."""
    x = _data()
    edges = []
    for api, low, plan in ((tapi, tlow, _plan(x, torch.ones(8))),
                           (japi, jlow, _jplan(x, jnp.ones((8,))))):
        ex = api.LocalExecutor()
        spec = plan.plan().spec
        policy, _ = ex._resolve_policy(spec)
        prepared = ex._prepare(spec.inputs, policy, ex.engine.new_report("t"))
        g1 = low.lower(spec, prepared.arrays, prepared.groups, ex.capabilities)
        g2 = low.lower(spec, prepared.arrays, prepared.groups, ex.capabilities)
        e = low.cross_iteration_edges(g1, g2)
        assert e
        for idx, deps in e.items():
            key = low.partition_key(g2.tasks[idx])
            assert all(low.partition_key(g1.tasks[d]) == key for d in deps)
        edges.append(e)
        ex.close()
    assert edges[0] == edges[1]


def test_partition_versions_increment_across_submits():
    x = _data()
    ex = tapi.ThreadedExecutor()
    try:
        f1 = _plan(x, torch.ones(8)).compute_async(executor=ex)
        f2 = _plan(x, torch.ones(8)).compute_async(executor=ex)
        versions = [dict(e.state.partition_versions) for e in ex._pipeline]
        f1.result(), f2.result()
    finally:
        ex.close()
    assert len(versions) == 2 and set(versions[0]) == set(versions[1])
    for key, v in versions[0].items():
        assert versions[1][key] == v + 1 == 2


def test_probe_iterations_run_barriered():
    """An "auto" policy's probe iterations run barriered: each probe's future
    is resolved when ``compute_async`` returns."""
    x = _data()
    auto = tapi.SplIter(partitions_per_location="auto")
    with tapi.ThreadedExecutor() as ex:
        c_op, futs = torch.ones(8), []
        for _ in range(3):  # the deterministic probe ladder (seed 0)
            fut = _plan(x, c_op, policy=auto).compute_async(executor=ex)
            futs.append(fut)
            c_op = fut.map(_ratio)
        for fut in futs:
            assert fut.done()
            assert fut.result().report.overlapped_launches == 0


def test_failure_fails_own_future_and_poisons_next():
    x = _data()
    with tapi.ThreadedExecutor() as ex:
        f0 = _plan(x, torch.ones(8)).compute_async(executor=ex)
        f1 = _plan(x, f0.map(_ratio), fn=fns.pipe_boom).compute_async(executor=ex)
        f2 = _plan(x, f1.map(_ratio)).compute_async(executor=ex)
        assert f0.result() is not None
        with pytest.raises(ValueError, match="injected unit failure"):
            f1.result()
        with pytest.raises(PipelineBrokenError) as exc:
            f2.result()
        assert exc.value.iteration == f1.iteration
        assert str(f1.iteration) in str(exc.value)


def test_deferred_against_failed_future_raises_typed():
    x = _data()
    with tapi.ThreadedExecutor() as ex:
        fut = _plan(x, torch.ones(8), fn=fns.pipe_boom).compute_async(executor=ex)
        with pytest.raises(PipelineBrokenError) as exc:
            fut.map(_ratio).resolve()
        assert exc.value.iteration == fut.iteration


def test_close_with_inflight_futures_drains_cleanly():
    x = _data()
    ref, _ = _barriered(x, tapi.LocalExecutor(), 3)
    ex = tapi.ThreadedExecutor()
    c_op, futs = torch.ones(8), []
    for _ in range(3):
        fut = _plan(x, c_op).compute_async(executor=ex)
        futs.append(fut)
        c_op = fut.map(_ratio)
    threads = [w._thread for w in ex._workers.values()]
    ex.close()  # nothing resolved yet: close drains, then joins the pool
    assert threads and not any(t.is_alive() for t in threads)
    got = [_ratio(f.result().value) for f in futs]
    assert all(torch.equal(a, b) for a, b in zip(ref, got))


def test_close_after_failure_is_clean():
    x = _data()
    ex = tapi.ThreadedExecutor()
    f0 = _plan(x, torch.ones(8), fn=fns.pipe_boom).compute_async(executor=ex)
    f1 = _plan(x, f0.map(_ratio)).compute_async(executor=ex)
    ex.close()  # errors stay on the futures; close itself does not raise
    with pytest.raises(ValueError):
        f0.result()
    with pytest.raises(PipelineBrokenError):
        f1.result()


def test_sync_execute_drains_pipeline_first():
    x = _data()
    with tapi.ThreadedExecutor() as ex:
        f0 = _plan(x, torch.ones(8)).compute_async(executor=ex)
        f1 = _plan(x, f0.map(_ratio)).compute_async(executor=ex)
        res = _plan(x, f1.map(_ratio)).compute(executor=ex)
        assert f0.done() and f1.done() and not ex._pipeline
    ref, _ = _barriered(x, tapi.LocalExecutor(), 3)
    assert torch.equal(_ratio(res.value), ref[-1])


def test_window_caps_inflight_entries():
    x = _data()
    with tapi.ThreadedExecutor() as ex:
        c_op = torch.ones(8)
        for _ in range(5):
            fut = _plan(x, c_op).compute_async(executor=ex)
            c_op = fut.map(_ratio)
            assert len(ex._pipeline) <= ex.pipeline_depth


def test_map_chains_and_caches():
    x = _data()
    ex = tapi.LocalExecutor()
    fut = _plan(x, torch.ones(8)).compute_async(executor=ex)
    d = fut.map(_ratio).map(lambda c: c * 2.0)
    assert isinstance(d, Deferred)
    v1, v2 = d.resolve(), d.resolve()
    assert v1 is v2  # single-flight, cached
    assert torch.equal(v1, _ratio(fut.result().value) * 2.0)


@pytest.mark.parametrize("backend", ["local", "mesh", "stream"])
def test_pass_frees_its_partials_without_the_collector(backend):
    """A pass's partials are freed when the call returns, with the garbage
    collector off: the merge closures hold the scheduler state weakly, so
    no reference cycle keeps them (on the card, their memory) alive."""
    import gc
    import weakref

    refs = []

    def block(b):
        out = b.sum(0)
        refs.append(weakref.ref(out))
        return out

    _, _, x = _pair(96, 8, 4, "round_robin_placement")
    kw = {"devices": (torch.device("cpu"),) * 4} if backend == "mesh" else {}
    with tapi.engine(backend, **kw) as ex:
        plan = tapi.Collection.from_blocked(x).split(tapi.Baseline()).map_blocks(block)
        gc.collect()
        gc.disable()
        try:
            value = plan.reduce(lambda a, b: a + b).compute(executor=ex).value
            alive = sum(r() is not None for r in refs)
        finally:
            gc.enable()
    assert len(refs) == 12 and alive == 0
    assert torch.allclose(value, x.collect().sum(0))
