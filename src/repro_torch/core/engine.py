"""Task engine — cached task registration and cost accounting.

In COMPSs/Dask a *task* is a scheduler-dispatched unit; here it is one call
of a registered PyTorch callable (host dispatch + the kernels it enqueues).
The :class:`TaskEngine` registers functions as tasks (once per key) and
counts dispatches, traces, merges and bytes moved in an
:class:`EngineReport`, so benchmarks can reproduce the paper's figures and
the structural claims (C1–C4 in DESIGN.md).

PyTorch runs eagerly, so nothing is compiled: a "trace" is the first
registration of a key, exactly the event the JAX engine counts when it
wraps a function in ``jax.jit``.  The report columns are therefore the
same numbers for the same plan in both packages.

Execution strategies live in ``repro_torch.api``: a lazy
:class:`~repro_torch.api.Collection` builds an
:class:`~repro_torch.api.ExecutionPlan` which an executor runs under a typed
:class:`~repro_torch.api.ExecutionPolicy` (``Baseline`` / ``SplIter`` /
``Rechunk``).

:func:`run_map_reduce` — the seed's stringly-typed entry point — remains
only as a deprecated shim over the plan-based layer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import warnings
from typing import Any, Callable, Hashable, Sequence

from repro_torch.core.blocked import BlockedArray

__all__ = ["EngineReport", "TaskEngine", "run_map_reduce", "MODES"]

# Legacy mode strings, accepted by the deprecated shim (and mapped onto the
# typed policies by repro_torch.api.as_policy).
MODES = ("baseline", "spliter", "spliter_mat", "rechunk")

BlockFn = Callable[..., Any]           # (*blocks, *extra_args) -> partial pytree
CombineFn = Callable[[Any, Any], Any]  # (acc, partial) -> acc, associative


#: Per-field aggregation rules for :meth:`EngineReport.__iadd__` /
#: :meth:`EngineReport.merge` — the single registry every aggregation and
#: (de)serialization path derives from ``dataclasses.fields``.
#:   "sum"    — counters/timers: add (the default for unlisted fields)
#:   "latest" — settings: keep the other window's value when non-zero
#:   "label"  — identity strings: untouched by ``+=`` (merge() joins them)
_FIELD_RULES = {
    "mode": "label",
    "granularity": "latest",
}


@dataclasses.dataclass
class EngineReport:
    """Cost accounting for one workload execution."""

    mode: str
    dispatches: int = 0          # task invocations (the "tasks")
    merges: int = 0              # merge-task dispatches (subset of dispatches)
    traces: int = 0              # distinct registered programs (this report)
    bytes_moved: int = 0         # inter-location traffic (rechunk only; SplIter: 0)
    wall_s: float = 0.0
    granularity: int = 0         # partitions_per_location in effect (SplIter; 0: n/a)
    retunes: int = 0             # autotuner granularity changes entering this window
    bytes_loaded: int = 0        # chunk-store spill reads during this window
    bytes_spilled: int = 0       # chunk-store spill writes (evictions of dirty chunks)
    prefetch_hits: int = 0       # chunk gets served by an earlier prefetch
    remote_dispatches: int = 0   # dispatches executed in a worker process (cluster)
    ipc_bytes: int = 0           # serialized control-channel bytes (cluster); block
    #                              payloads travel out-of-band via shm_bytes
    shm_bytes: int = 0           # bytes copied into shared-memory segments (cluster)
    retries: int = 0             # units replayed after a worker death (cluster)
    overlapped_launches: int = 0  # units admitted while an earlier execute was
    #                               still unresolved (pipelined iteration)
    steals: int = 0              # units moved to an idle worker by work stealing
    scale_events: int = 0        # autoscaler pool changes (grow + shrink)
    p2p_bytes: int = 0           # partial bytes exchanged worker→worker over
    #                              shared memory instead of through the driver
    driver_merge_bytes: int = 0  # partial bytes the driver itself folded

    def as_row(self) -> dict:
        return dataclasses.asdict(self)

    def merge(self, other: "EngineReport") -> "EngineReport":
        """A NEW report aggregating two windows (neither input is mutated).

        Counters and wall time sum, ``granularity`` keeps the most recent
        non-zero value, and the mode string joins when the windows disagree.
        """
        mode = self.mode if self.mode == other.mode else f"{self.mode}+{other.mode}"
        out = dataclasses.replace(self, mode=mode)
        out += other
        return out

    def to_json(self) -> str:
        """Serialize (see :meth:`from_json`)."""
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, payload: str) -> "EngineReport":
        """Rebuild a report serialized by :meth:`to_json`.

        Unknown keys are ignored so a payload written by a newer build (with
        extra counters) still loads; missing keys take field defaults.
        """
        data = json.loads(payload)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in names})

    def __iadd__(self, other: "EngineReport") -> "EngineReport":
        for f in dataclasses.fields(self):
            rule = _FIELD_RULES.get(f.name, "sum")
            if rule == "sum":
                setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))
            elif rule == "latest":
                value = getattr(other, f.name)
                if value:
                    setattr(self, f.name, value)
            # "label" fields (mode) are merge()'s business, untouched here
        return self


class TaskEngine:
    """Caches registered 'tasks' and counts dispatches (the @task decorator).

    Trace accounting: ``traces_total`` counts every distinct registration
    over the engine's lifetime; each report shows the *delta* accrued during
    its own window (snapshotted at :meth:`new_report`).

    Counter updates are lock-protected, and :meth:`bind_report` installs a
    *thread-local* billing target: :attr:`current_report` is what every
    counter site charges — the bound report when one is active on the
    calling thread, else ``self.report``.
    """

    def __init__(self):
        self._cache: dict[Hashable, Callable] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self.traces_total = 0
        self._trace_mark = 0
        self.report = EngineReport(mode="?")

    def new_report(self, mode: str) -> EngineReport:
        self.report = EngineReport(mode=mode)
        self._trace_mark = self.traces_total
        return self.report

    @property
    def current_report(self) -> EngineReport:
        """The report this thread bills: bound or engine-wide."""
        bound = getattr(self._local, "report", None)
        return bound if bound is not None else self.report

    @contextlib.contextmanager
    def bind_report(self, report: EngineReport):
        """Bill this thread's dispatches/traces/merges to ``report``."""
        prev = getattr(self._local, "report", None)
        self._local.report = report
        try:
            yield report
        finally:
            self._local.report = prev

    def task(self, fn: Callable, *, key: Hashable = None) -> Callable:
        """Register ``fn`` as a task (cached once per key, dispatch-counted).

        The first callable registered under a key serves every later call
        with that key: keys encode everything that makes two callables
        compute different functions (see
        :func:`~repro_torch.api.lowering.stable_task_key`).
        """
        key = key if key is not None else fn
        with self._lock:  # one registration per key, whichever thread asks
            if key not in self._cache:

                def dispatch(*args, _fn=fn, _self=self, **kw):
                    with _self._lock:
                        _self.current_report.dispatches += 1
                    return _fn(*args, **kw)

                self._cache[key] = dispatch
                self.traces_total += 1
                rep = self.current_report
                if rep is self.report:
                    rep.traces = self.traces_total - self._trace_mark
                else:
                    # Bound window: the engine-wide trace mark belongs to
                    # whichever report is current, so credit the newly paid
                    # trace to the bound report alone.
                    rep.traces += 1
            return self._cache[key]


def run_map_reduce(
    inputs: Sequence[BlockedArray],
    block_fn: BlockFn,
    combine: CombineFn,
    *,
    mode: str = "spliter",
    partitions_per_location: int = 1,
    extra_args: tuple = (),
    engine: TaskEngine | None = None,
) -> tuple[Any, EngineReport]:
    """DEPRECATED shim over the plan-based layer — use :mod:`repro_torch.api`.

    ``run_map_reduce(inputs, f, c, mode=m)`` is equivalent to::

        Collection.from_blocked(inputs).split(as_policy(m))
            .map_blocks(f, extra_args=...).reduce(c)
            .compute(executor=engine("local"))

    Returns ``(result, report)``; results are policy-independent up to
    floating-point reassociation.
    """
    warnings.warn(
        "run_map_reduce(mode=...) is deprecated; build a plan with "
        "repro_torch.api.Collection and run it with an Executor "
        "(see DESIGN.md §8 for the migration table)",
        DeprecationWarning,
        stacklevel=2,
    )
    from repro_torch.api import Collection, as_policy
    from repro_torch.api.executors import _default_local

    policy = as_policy(mode, partitions_per_location=partitions_per_location)
    res = (
        Collection.from_blocked(list(inputs))
        .split(policy)
        .map_blocks(block_fn, extra_args=tuple(extra_args))
        .reduce(combine)
        .compute(executor=_default_local(engine=engine))
    )
    return res.value, res.report
