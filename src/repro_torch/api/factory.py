"""engine() — the one construction path for every execution backend.

The per-backend constructors (``LocalExecutor()``, ``ThreadedExecutor()``,
``MeshExecutor(devices=...)``, ``StreamExecutor(prefetch_depth=...)``,
``JobServer(executor=...)``) have slightly different keyword surfaces.
:func:`engine` consolidates them behind a single factory, as the JAX
package's does (DESIGN.md §16)::

    from repro_torch.api import engine, EngineConfig

    with engine("mesh", config=EngineConfig(devices=devices)) as ex:
        result = collection.compute(executor=ex)

* ``backend`` picks the strategy by name (the table below); ``config`` is
  a frozen :class:`EngineConfig` carrying every backend's knobs with
  their constructor defaults — each backend reads only the fields it
  understands, so one config object can describe a whole experiment
  matrix and be handed to different backends unchanged.
* keyword ``overrides`` patch individual fields without building a config
  first: ``engine("stream", prefetch_depth=2)``.
* every backend supports ``with engine(...) as ex:`` — context-manager
  exit is :meth:`close`, the idiom docs and examples construct with.

The old constructors keep working but emit a ``DeprecationWarning``
pointing here; library-internal defaults construct through the same
suppressed path this factory uses.

============  =========================================================
backend       class
============  =========================================================
``local``     :class:`~repro_torch.api.executors.LocalExecutor`
``threaded``  :class:`~repro_torch.api.executors.ThreadedExecutor`
``mesh``      :class:`~repro_torch.api.mesh_executor.MeshExecutor`
``stream``    :class:`~repro_torch.api.stream_executor.StreamExecutor`
``cluster``   :class:`~repro_torch.api.cluster_executor.ClusterExecutor`
``server``    :class:`~repro_torch.api.jobserver.JobServer` (over an inner
              ``server_backend`` engine it owns)
============  =========================================================

>>> import torch
>>> with engine("mesh", devices=(torch.device("cpu"),)) as ex:
...     type(ex).__name__, ex.capabilities.grouped_dispatch
('MeshExecutor', True)
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["EngineConfig", "engine", "BACKENDS"]

#: backend names :func:`engine` accepts, in documentation order.
BACKENDS = ("local", "threaded", "mesh", "stream", "cluster", "server")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Frozen union of every backend's constructor knobs.

    Fields default to the underlying constructors' defaults, so
    ``EngineConfig()`` reproduces ``LocalExecutor()`` /
    ``ClusterExecutor()`` / ... exactly.  A backend consumes only its own
    section; setting a foreign field is harmless (ignored), which is what
    lets one config drive an A/B matrix across backends.

    Use :meth:`dataclasses.replace` (or :func:`engine`'s keyword
    overrides) to derive variants — the object itself never mutates, so a
    config in a bench table or a test fixture stays a value.
    """

    # -- shared ------------------------------------------------------------
    engine: Any = None                  # repro_torch.core.engine.TaskEngine | None

    # -- stream ------------------------------------------------------------
    prefetch_depth: int = 1
    close_stores: bool = True

    # -- mesh --------------------------------------------------------------
    devices: tuple | None = None        # None: the visible CUDA devices
    axis_name: str = "loc"

    # -- cluster -----------------------------------------------------------
    max_retries: int = 2
    heartbeat_s: float = 0.2
    heartbeat_timeout_s: float = 30.0
    fault_plan: Any = None              # repro_torch.api.cluster_executor.FaultPlan
    log_dir: str | None = None
    poll_s: float = 0.02
    shm: bool | None = None
    shm_min_bytes: int = 1024
    shm_segment_bytes: int = 4 << 20
    shm_budget_bytes: int | None = None
    p2p: bool | str = "auto"
    p2p_min_bytes: int = 1 << 16
    steal: bool = False
    autoscale: bool = False
    min_workers: int = 1
    max_workers: int | None = None
    scale_up_backlog: int = 2
    scale_idle_ticks: int = 50

    # -- server ------------------------------------------------------------
    root: str | None = None
    server_backend: str = "local"       # inner engine() the server owns
    max_pending: int = 16
    snapshot_every: int = 8
    fsync: bool = True
    autostart: bool = True


def _cluster_kwargs(cfg: EngineConfig) -> dict:
    return dict(
        max_retries=cfg.max_retries,
        heartbeat_s=cfg.heartbeat_s,
        heartbeat_timeout_s=cfg.heartbeat_timeout_s,
        fault_plan=cfg.fault_plan,
        log_dir=cfg.log_dir,
        poll_s=cfg.poll_s,
        shm=cfg.shm,
        shm_min_bytes=cfg.shm_min_bytes,
        shm_segment_bytes=cfg.shm_segment_bytes,
        shm_budget_bytes=cfg.shm_budget_bytes,
        p2p=cfg.p2p,
        p2p_min_bytes=cfg.p2p_min_bytes,
        steal=cfg.steal,
        autoscale=cfg.autoscale,
        min_workers=cfg.min_workers,
        max_workers=cfg.max_workers,
        scale_up_backlog=cfg.scale_up_backlog,
        scale_idle_ticks=cfg.scale_idle_ticks,
    )


def engine(
    backend: str = "local",
    *,
    config: EngineConfig | None = None,
    **overrides,
):
    """Construct an execution backend by name (the blessed entry point).

    Args:
      backend: one of :data:`BACKENDS`.
      config: an :class:`EngineConfig`; ``None`` means all defaults.
      **overrides: individual :class:`EngineConfig` fields to replace —
        ``engine("stream", prefetch_depth=2)`` ≡
        ``engine("stream", config=EngineConfig(prefetch_depth=2))``.  Unknown
        names raise ``TypeError`` (a misspelled knob must not silently
        no-op).

    Returns an executor (or, for ``"server"``, a
    :class:`~repro_torch.api.jobserver.JobServer`) ready for
    ``with engine(...) as ex:`` — exit closes it.
    """
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}"
        )
    cfg = config if config is not None else EngineConfig()
    if overrides:
        names = {f.name for f in dataclasses.fields(EngineConfig)}
        unknown = sorted(set(overrides) - names)
        if unknown:
            raise TypeError(
                f"unknown EngineConfig field(s) {unknown}; "
                f"valid fields: {sorted(names)}"
            )
        cfg = dataclasses.replace(cfg, **overrides)

    # Late imports: the factory sits above every backend module, and the
    # cluster/server stacks are heavy (multiprocessing, journal) — pay only
    # for the backend actually constructed.
    from repro_torch.api.executors import _factory_construction

    with _factory_construction():
        if backend == "local":
            from repro_torch.api.executors import LocalExecutor

            return LocalExecutor(engine=cfg.engine)
        if backend == "threaded":
            from repro_torch.api.executors import ThreadedExecutor

            return ThreadedExecutor(engine=cfg.engine)
        if backend == "mesh":
            from repro_torch.api.mesh_executor import MeshExecutor

            return MeshExecutor(
                engine=cfg.engine,
                devices=cfg.devices,
                axis_name=cfg.axis_name,
            )
        if backend == "stream":
            from repro_torch.api.stream_executor import StreamExecutor

            return StreamExecutor(
                engine=cfg.engine,
                prefetch_depth=cfg.prefetch_depth,
                close_stores=cfg.close_stores,
            )
        if backend == "cluster":
            from repro_torch.api.cluster_executor import ClusterExecutor

            return ClusterExecutor(engine=cfg.engine, **_cluster_kwargs(cfg))
        # "server": a JobServer owning an inner engine() backend.
        from repro_torch.api.jobserver import JobServer

        if cfg.server_backend == "server":
            raise ValueError("server_backend cannot itself be 'server'")
        inner = engine(cfg.server_backend, config=cfg)
        server = JobServer(
            root=cfg.root,
            executor=inner,
            max_pending=cfg.max_pending,
            snapshot_every=cfg.snapshot_every,
            fsync=cfg.fsync,
            autostart=cfg.autostart,
        )
        # The factory built the inner engine FOR this server; the server's
        # close() must take it down (a caller-passed executor stays the
        # caller's to close — the constructor's contract).
        server._owns_executor = True
        return server
