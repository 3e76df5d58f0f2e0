"""The port's ``engine()`` factory, ``EngineConfig`` and deprecation shims.

Mirrors the JAX package's factory contract (``src/repro/api/factory.py``,
``tests/test_api_surface.py``): every backend name builds through
``engine()`` on the CPU (the mesh over ``devices=(cpu,)``), ``EngineConfig``
has the reference's fields and defaults, keyword overrides patch fields and
an unknown one raises ``TypeError``, every backend is a context manager, a
direct constructor call warns and a factory construction does not, the
``run_map_reduce`` shim warns and matches the plan API, and
``engine("cluster")`` builds a ClusterExecutor carrying the config's
cluster knobs (its runs are tested in ``tests/test_torch_cluster*.py``).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core.engine import MODES as JMODES
from repro_torch.api import (
    BACKENDS,
    Collection,
    EngineConfig,
    JobServer,
    LocalExecutor,
    MeshExecutor,
    SplIter,
    StreamExecutor,
    ThreadedExecutor,
    engine,
)
from repro_torch.core.blocked import BlockedArray, round_robin_placement
from repro_torch.core.engine import MODES, TaskEngine, run_map_reduce

CPU = torch.device("cpu")
#: what each backend name builds on the CPU, with the overrides it needs here
BUILT = {
    "local": (LocalExecutor, {}),
    "threaded": (ThreadedExecutor, {}),
    "mesh": (MeshExecutor, {"devices": (CPU,)}),
    "stream": (StreamExecutor, {}),
    "server": (JobServer, {"root": None, "autostart": False, "devices": (CPU,)}),
}


def _data():
    x = np.random.default_rng(0).random((96, 3)).astype(np.float32)
    return x, BlockedArray.from_array(x, 8, num_locations=4, policy=round_robin_placement,
                                      device="cpu")


def _sum_plan(ba, pol=SplIter()):
    return Collection.from_blocked(ba).split(pol).map_blocks(lambda b: b.sum(0)).reduce(
        lambda a, b: a + b)


def test_backends_match_reference():
    assert BACKENDS == japi.BACKENDS


def test_engine_config_fields_and_defaults_match_reference():
    tf = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    jf = {f.name: f.default for f in dataclasses.fields(japi.EngineConfig)}
    assert tf == jf


def test_modes_match_reference():
    assert MODES == JMODES


@pytest.mark.parametrize("backend", [b for b in BACKENDS if b != "cluster"])
def test_every_backend_builds_and_runs(backend):
    cls, overrides = BUILT[backend]
    x, ba = _data()
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        obj = engine(backend, **overrides)
    assert type(obj) is cls
    with obj as ex:
        if backend == "server":
            ex.start()
            job = ex.submit(_sum_plan(ba).plan())
            value = ex.wait(job, 60).value
        else:
            value = _sum_plan(ba).compute(executor=ex).value
    np.testing.assert_allclose(value.numpy(), x.sum(0), rtol=2e-5, atol=2e-5)


def test_cluster_builds_with_the_configs_knobs():
    """``engine("cluster")`` builds a ClusterExecutor (no worker spawns
    before a dispatch) with the config's knobs, a server can own one, and
    ``p2p=True`` builds a pool that folds worker-side, as the reference's."""
    from repro_torch.api import ClusterExecutor, FaultPlan

    plan = FaultPlan(kill_after=((0, 2),))
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        ex = engine("cluster", max_retries=5, fault_plan=plan, steal=True)
    assert type(ex) is ClusterExecutor
    assert (ex.max_retries, ex.fault_plan, ex.steal_enabled) == (5, plan, True)
    assert ex.heartbeat_timeout_s == japi.ClusterExecutor().heartbeat_timeout_s == 30.0
    assert ex.workers_alive() == []
    ex.close()
    srv = engine("server", server_backend="cluster", autostart=False)
    assert type(srv.executor) is ClusterExecutor
    srv.close()
    ex = engine("cluster", p2p=True, p2p_min_bytes=1 << 10)
    jex = japi.engine("cluster", p2p=True, p2p_min_bytes=1 << 10)
    assert (ex.p2p, ex.p2p_min_bytes) == (jex.p2p, jex.p2p_min_bytes) == (True, 1 << 10)
    assert EngineConfig().p2p == japi.EngineConfig().p2p == "auto"
    assert ex.workers_alive() == []
    ex.close()
    jex.close()


def test_unknown_backend_and_field():
    with pytest.raises(ValueError, match="unknown backend"):
        engine("gpu")
    with pytest.raises(TypeError, match="prefetch_dept"):
        engine("stream", prefetch_dept=2)


def test_overrides_patch_the_config():
    cfg = EngineConfig(prefetch_depth=3, close_stores=False)
    ex = engine("stream", config=cfg)
    assert (ex.prefetch_depth, ex._close_stores) == (3, False)
    ex.close()
    ex = engine("stream", config=cfg, prefetch_depth=0)
    assert (ex.prefetch_depth, ex._close_stores) == (0, False)
    ex.close()
    assert cfg.prefetch_depth == 3  # the config itself never mutates
    mesh = engine("mesh", devices=(CPU, CPU), axis_name="ranks")
    assert mesh.devices == (CPU, CPU) and mesh.axis_name == "ranks"


def test_shared_engine_is_passed_through():
    eng = TaskEngine()
    for backend in ("local", "threaded", "stream"):
        ex = engine(backend, engine=eng)
        assert ex.engine is eng
        ex.close()
    assert engine("mesh", engine=eng, devices=(CPU,)).engine is eng


@pytest.mark.parametrize("inner", ["local", "threaded", "mesh", "stream"])
def test_server_owns_its_inner_backend(inner):
    x, ba = _data()
    srv = engine("server", server_backend=inner, devices=(CPU,))
    assert srv._owns_executor
    assert type(srv.executor).__name__ == {
        "local": "LocalExecutor", "threaded": "ThreadedExecutor",
        "mesh": "MeshExecutor", "stream": "StreamExecutor"}[inner]
    with srv:
        job = srv.submit(_sum_plan(ba).plan())
        np.testing.assert_allclose(srv.wait(job, 60).value.numpy(), x.sum(0),
                                   rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="server"):
        engine("server", server_backend="server")


@pytest.mark.parametrize("cls,kwargs", [
    (LocalExecutor, {}),
    (ThreadedExecutor, {}),
    (StreamExecutor, {}),
    (MeshExecutor, {"devices": (CPU,)}),
])
def test_direct_construction_warns(cls, kwargs):
    with pytest.warns(DeprecationWarning, match=f"constructing {cls.__name__} directly is "
                                                f"deprecated.*repro_torch.api.engine"):
        ex = cls(**kwargs)
    ex.close()


def test_internal_defaults_do_not_warn():
    """Library defaults (apps, ``Collection.compute``, the server's pool)
    build through the factory's suppressed path."""
    from repro_torch.core.apps.histogram import histogram

    _, ba = _data()
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        histogram(ba, bins=4)
        _sum_plan(ba).compute()
        JobServer(autostart=False).close()


def test_run_map_reduce_shim_warns_and_matches_plan_api():
    x, ba = _data()
    with pytest.warns(DeprecationWarning, match="run_map_reduce"):
        value, report = run_map_reduce(
            [ba], lambda b: b.sum(0), lambda a, b: a + b, mode="spliter")
    res = _sum_plan(ba).compute(executor=engine("local"))
    assert torch.equal(value, res.value)
    assert report.dispatches == res.report.dispatches
    for mode in MODES:
        with pytest.warns(DeprecationWarning):
            v, _ = run_map_reduce([ba], lambda b: b.sum(0), lambda a, b: a + b, mode=mode)
        np.testing.assert_allclose(v.numpy(), x.sum(0), rtol=2e-5, atol=2e-5)


def test_run_map_reduce_matches_reference_shim():
    import jax.numpy as jnp
    from repro.core import blocked as jblocked
    from repro.core.engine import run_map_reduce as jrun

    x, ba = _data()
    jba = jblocked.BlockedArray.from_array(jnp.asarray(x), 8, num_locations=4,
                                           policy=jblocked.round_robin_placement)
    for mode in MODES:
        with pytest.warns(DeprecationWarning):
            tv, tr = run_map_reduce([ba], lambda b: b.sum(0), lambda a, b: a + b,
                                    mode=mode, partitions_per_location=2)
            jv, jr = jrun([jba], lambda b: b.sum(0), lambda a, b: a + b,
                          mode=mode, partitions_per_location=2)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-5, atol=2e-5)
        assert (tr.dispatches, tr.merges, tr.traces, tr.bytes_moved, tr.granularity) == (
            jr.dispatches, jr.merges, jr.traces, jr.bytes_moved, jr.granularity), mode
