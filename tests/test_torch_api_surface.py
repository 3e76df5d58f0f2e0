"""The port's public surface, modelled on ``tests/test_api_surface.py``.

``repro_torch.api.__all__`` is curated: every exported name resolves, none
is listed twice, every backend built through ``engine()`` supports
``with engine(...) as ex:``, and the surface is the JAX package's minus
exactly the multi-process cluster's names still to port — a later slice
that ports the cluster has to shrink ``NOT_YET_PORTED``.
"""

from __future__ import annotations

import warnings

import pytest
import torch

import repro.api as japi
import repro_torch.api as api

#: ``repro.api`` names the port lacks: the cluster backend and its
#: shared-memory data plane (ROADMAP.md, Queue 1, the cluster item).
NOT_YET_PORTED = {
    "ClusterExecutor",
    "ClusterFailedError",
    "FaultPlan",
    "ChaosSchedule",
    "TaskSpec",
    "ChunkHandle",
    "StoreManifest",
    "AttachedStore",
    "ShmStore",
    "ShmBlockRef",
    "ShmAttachments",
    "shm_available",
}


def test_all_exports_resolve():
    missing = [n for n in api.__all__ if not hasattr(api, n)]
    assert missing == [], f"__all__ names without a binding: {missing}"


def test_no_duplicate_exports():
    assert len(api.__all__) == len(set(api.__all__))


def test_factory_is_exported():
    assert {"engine", "EngineConfig", "BACKENDS"} <= set(api.__all__)


def test_surface_is_the_reference_minus_the_cluster():
    assert set(api.__all__) <= set(japi.__all__)
    assert set(japi.__all__) - set(api.__all__) == NOT_YET_PORTED


@pytest.mark.parametrize("name", sorted(set(api.__all__)))
def test_exported_kind_matches_reference(name):
    """A class in one package is a class in the other, a function a function."""
    ours, theirs = getattr(api, name), getattr(japi, name)
    assert isinstance(ours, type) == isinstance(theirs, type), name
    assert callable(ours) == callable(theirs), name


def test_every_backend_is_a_context_manager():
    """``with engine(backend) as ex:`` works uniformly — exit closes; the
    cluster is the one name that raises until it is ported."""
    for backend in api.BACKENDS:
        overrides = {"devices": (torch.device("cpu"),)}
        if backend == "server":
            overrides.update(root=None, autostart=False)
        if backend == "cluster":
            with pytest.raises(NotImplementedError):
                api.engine(backend, **overrides)
            continue
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            obj = api.engine(backend, **overrides)
        assert hasattr(obj, "__enter__") and hasattr(obj, "__exit__"), backend
        with obj as entered:
            assert entered is obj


def test_every_executor_satisfies_the_protocol():
    from repro_torch.api import JobClient

    cpu = (torch.device("cpu"),)
    for backend in ("local", "threaded", "mesh", "stream"):
        with api.engine(backend, devices=cpu) as ex:
            assert isinstance(ex, api.Executor), backend
    with api.engine("server", autostart=False) as srv:
        assert isinstance(JobClient(srv), api.Executor)
