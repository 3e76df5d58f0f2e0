"""Executor backends — the scheduling half of the execution layer.

Execution is split into two explicit stages (DESIGN.md §5):

1. **lowering** (:mod:`repro_torch.api.lowering`): ``(ExecutionPlan,
   policy, backend capabilities)`` → a frozen
   :class:`~repro_torch.api.lowering.TaskGraph` of placed, keyed task
   descriptors — all fusion/task-construction decisions happen there;
2. **scheduling** (this module): an executor prepares the policy's
   placement (cached, LRU-bounded), lowers the plan against its declared
   :class:`~repro_torch.api.lowering.Capabilities`, and schedules the
   TaskGraph.

Backends schedule through ONE dependency-driven scheduler core
(:meth:`_PlanExecutor._schedule`): the backend turns the TaskGraph into
dispatch *units* (hook ``_plan_dispatches``), the core appends the merge as
a unit depending on every task unit, and the backend drains the ready set
(hook ``_drain``).  Every unit runs instrumented: the core emits a
:class:`~repro_torch.api.profile.ProfileEvent` (dispatch overhead, wall,
bytes) into the executor's :class:`~repro_torch.api.profile.ProfileStore`.

:class:`LocalExecutor` dispatches sequentially on the calling thread.  CUDA
launches are asynchronous, so a unit's ``dispatch_s`` is the host-side
launch overhead; ``execute`` synchronises the result's device before it
stops its clock, so ``EngineReport.wall_s`` includes device time.

``SplIter(partitions_per_location="auto")`` closes the loop: the executor
owns an :class:`~repro_torch.api.autotune.Autotuner` per workload that
proposes the granularity before each execution and is fed the measured wall
time after it.  A retune between iterations is **logical regrouping only**:
the prepare cache keeps a ppl-independent :class:`_SplitBase` and derives
the retuned ``PlacedGroup`` list from the already-split blocks.

Executors also expose the engine-level ``task()`` registration for app
stages that do not fit the map/reduce plan shape, and a ``scope()`` context
manager that accumulates plan executions plus custom task dispatches into a
single report.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
from typing import Any, Callable, Hashable, Protocol, runtime_checkable

import torch

from repro_torch._pytree import tree_leaves, tree_map
from repro_torch.api.autotune import Autotuner
from repro_torch.api.chunkstore import chunk_stores
from repro_torch.api.futures import ComputeFuture
from repro_torch.api.lowering import (
    Capabilities,
    MergeSpec,
    PartitionView,
    PlacedGroup,
    Task,
    TaskGraph,
    fold_plan,
    inputs_signature,
    lower,
    planned_fold,
    stable_task_key,
    stacked_fold,
)
from repro_torch.api.plan import ExecutionPlan, MapReduceSpec
from repro_torch.api.policy import Baseline, ExecutionPolicy, Rechunk, SplIter
from repro_torch.api.profile import ProfileStore
from repro_torch.core.blocked import BlockedArray
from repro_torch.core.engine import EngineReport, TaskEngine
from repro_torch.core.rechunk import rechunk
from repro_torch.core.spliter import stripe_local_blocks

__all__ = [
    "ComputeResult",
    "ComputeFuture",
    "PartitionView",
    "Executor",
    "LocalExecutor",
    "PrepareStats",
]


@dataclasses.dataclass
class ComputeResult:
    """What ``Collection.compute`` returns: the value plus its cost report."""

    value: Any
    report: EngineReport

    def __iter__(self):
        # Allow ``value, report = plan.compute(...)`` unpacking.
        yield self.value
        yield self.report


@runtime_checkable
class Executor(Protocol):
    """The contract every execution backend satisfies (DESIGN.md §5).

    ``execute`` runs a validated plan; ``execute_async`` submits one and
    returns a :class:`~repro_torch.api.futures.ComputeFuture`; ``task``
    registers out-of-plan app stages against the same task cache and
    accounting; ``report`` exposes the current
    :class:`~repro_torch.core.engine.EngineReport`.

    >>> isinstance(LocalExecutor(), Executor)
    True
    """

    def execute(self, plan: ExecutionPlan) -> ComputeResult: ...

    def execute_async(self, plan: ExecutionPlan) -> ComputeFuture: ...

    def task(self, fn: Callable, *, key: Hashable = None) -> Callable: ...

    @property
    def report(self) -> EngineReport: ...


# ---------------------------------------------------------------------------
# prepared placement: policy -> (arrays, task groups), regroup-aware
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PrepareStats:
    """Counters over the prepare cache (DESIGN.md §9.3).

    ``splits`` counts *physical* split derivations (the placement scan that
    builds a :class:`_SplitBase`); ``regroups`` counts granularity changes
    served by logically regrouping an already-split base.
    """

    hits: int = 0        # prepare-cache hits (base or prepared entry)
    misses: int = 0      # cache misses (entry built)
    splits: int = 0      # placement scans (SplitBase builds)
    regroups: int = 0    # ppl regroups served WITHOUT re-splitting
    rechunks: int = 0    # physical rechunk preparations


@dataclasses.dataclass
class _Prepared:
    """Cached result of applying a policy to a set of inputs.

    ``inputs`` retains the original arrays: the cache key uses their ids,
    so the entry must pin them alive — otherwise a gc'd input whose id is
    reused by a new BlockedArray would silently hit a stale entry.
    """

    inputs: tuple[BlockedArray, ...]
    arrays: tuple[BlockedArray, ...]
    groups: list[PlacedGroup]


@dataclasses.dataclass
class _SplitBase:
    """The ppl-independent half of a SplIter preparation.

    Holds the placement scan (which blocks live where) once per cache
    entry; any ``partitions_per_location`` is then a *logical regrouping*
    of these block-id lists (``stripe_local_blocks``) with zero data
    movement.  Derived group lists are memoized per ppl.
    """

    inputs: tuple[BlockedArray, ...]
    local_blocks: tuple[tuple[int, tuple[int, ...]], ...]  # (location, ids)
    groups_by_ppl: dict[int, list[PlacedGroup]] = dataclasses.field(
        default_factory=dict
    )

    def groups_for(self, ppl: int) -> tuple[list[PlacedGroup], bool]:
        """Groups at a granularity; True when freshly derived (a regroup)."""
        groups = self.groups_by_ppl.get(ppl)
        if groups is not None:
            return groups, False
        derived = bool(self.groups_by_ppl)
        groups = [
            PlacedGroup(loc, ids)
            for loc, local in self.local_blocks
            for ids in stripe_local_blocks(local, ppl)
        ]
        self.groups_by_ppl[ppl] = groups
        return groups, derived


def _tree_nbytes(tree) -> int:
    """Total tensor bytes across a pytree's leaves (0 for non-tensors)."""
    return sum(int(getattr(leaf, "nbytes", 0) or 0) for leaf in tree_leaves(tree))


def _synchronize(tree) -> Any:
    """Wait for the CUDA devices holding ``tree``'s tensors; return ``tree``.

    The counterpart of ``jax.block_until_ready``: kernels launch
    asynchronously, so a clock stopped without this measures the enqueue.
    """
    devices = {
        leaf.device
        for leaf in tree_leaves(tree)
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"
    }
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


def _merge_partials(
    engine: TaskEngine,
    merge: MergeSpec,
    partials: list[Any],
    plan: tuple[tuple[int, tuple[int, ...]], ...] | None = None,
) -> Any:
    """Single merge task over the stacked partials (paper's @reduction task).

    Keyed by the MergeSpec's stable key — NOT the combine object, which apps
    typically recreate per call — so iterative workloads hit the task cache.

    ``plan`` is the :func:`~repro_torch.api.lowering.fold_plan` over the
    partials' list positions: when it has more than one group and any group
    chains, the fold runs along that tree via
    :func:`~repro_torch.api.lowering.planned_fold` — still ONE dispatch.  A
    trivial plan (one group, or all singletons) keeps the flat chain.

    ``driver_merge_bytes`` bills the partial bytes folded by the driver.
    """
    if len(partials) == 1:
        return partials[0]
    engine.current_report.driver_merge_bytes += _tree_nbytes(partials)
    stacked = tree_map(lambda *xs: torch.stack(xs, 0), *partials)
    groups = tuple(members for _, members in plan) if plan else ()
    if len(groups) > 1 and any(len(m) > 1 for m in groups):
        fold = planned_fold(merge.combine, groups)
        out = engine.task(fold, key=(merge.key, "fold_plan", groups))(stacked)
    else:
        out = engine.task(stacked_fold(merge.combine), key=merge.key)(stacked)
    engine.current_report.merges += 1
    return out


# ---------------------------------------------------------------------------
# the shared scheduler core: dispatch units + dependency bookkeeping
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Unit:
    """One schedulable unit: a task, or the merge.

    ``run`` is a nullary thunk; ``deps`` are unit indices that must
    complete first (the merge depends on every task unit).
    """

    index: int
    location: int                  # -1: any thread (merge)
    tasks: tuple[Task, ...]        # graph descriptors covered (merge: ())
    run: Callable[[], Any] | None
    deps: tuple[int, ...] = ()
    kind: str = "task"


class _SchedulerState:
    """Dependency/result bookkeeping for one TaskGraph run.

    The dependency core of the JAX package's scheduler state; the
    ownership, replay and subscription hooks of its threaded, pipelined
    and cluster backends are not ported yet.
    """

    def __init__(self, units: list[_Unit]):
        self.units = units
        self.results: list[Any] = [None] * len(units)
        self.errors: list[BaseException] = []
        self._indegree = [len(u.deps) for u in units]
        self._dependents: list[list[int]] = [[] for _ in units]
        for u in units:
            for d in u.deps:
                self._dependents[d].append(u.index)

    def initial_ready(self) -> list[_Unit]:
        return [u for u in self.units if not u.deps]

    def complete(self, unit: _Unit, value: Any) -> list[_Unit]:
        """Record a result; return units that just became ready."""
        self.results[unit.index] = value
        newly: list[_Unit] = []
        for di in self._dependents[unit.index]:
            self._indegree[di] -= 1
            if self._indegree[di] == 0:
                newly.append(self.units[di])
        return newly

    def fail(self, exc: BaseException) -> None:
        self.errors.append(exc)


class _PlanExecutor:
    """Shared prepare/lower/schedule core; subclasses customize dispatch."""

    #: bound on cached (inputs, policy) preparations (LRU eviction).
    prepare_cache_size: int = 8

    def __init__(self, engine: TaskEngine | None = None):
        self.engine = engine or TaskEngine()
        self._prepare_cache: collections.OrderedDict[tuple, Any] = (
            collections.OrderedDict()
        )
        self.prepare_stats = PrepareStats()
        self.profile = ProfileStore()
        self._tuners: collections.OrderedDict[tuple, tuple] = (
            collections.OrderedDict()
        )
        self._scope_depth = 0
        self._iteration = 0  # execute_async submit counter (error attribution)

    # -- backend capabilities (consumed by the lowering pass) -----------------

    @property
    def capabilities(self) -> Capabilities:
        # Resolved at call time: the hand-written kernels beat the fold on
        # a card, and there is nothing to prefer on a CPU-only host.
        return Capabilities(
            name=type(self).__name__,
            prefer_pallas=torch.cuda.is_available(),
        )

    # -- engine passthroughs -------------------------------------------------

    @property
    def report(self) -> EngineReport:
        return self.engine.report

    def task(self, fn: Callable, *, key: Hashable = None) -> Callable:
        return self.engine.task(fn, key=key)

    @contextlib.contextmanager
    def scope(self, mode: str):
        """Accumulate plan executions + custom dispatches into one report."""
        report = self.engine.new_report(mode)
        self._scope_depth += 1
        t0 = time.perf_counter()
        try:
            yield report
        finally:
            self._scope_depth -= 1
            report.wall_s = time.perf_counter() - t0

    # -- the Executor entry points --------------------------------------------

    def execute(self, plan: ExecutionPlan) -> ComputeResult:
        spec = plan.spec
        own_report = self._scope_depth == 0
        if own_report:
            report = self.engine.new_report(spec.policy.mode_name)
        else:
            report = self.engine.report
        t0 = time.perf_counter()
        traces0 = self.engine.traces_total

        policy, tuner = self._resolve_policy(spec)
        if (
            tuner is not None
            and tuner.last_ppl is not None
            and policy.partitions_per_location != tuner.last_ppl
        ):
            report.retunes += 1
        # Chunk-store accounting: report the I/O this execution caused as
        # window deltas of the input stores' lifetime counters.
        stores = chunk_stores(spec.inputs)
        store_marks = [(s, s.stats.snapshot()) for s in stores]
        prepared = self._prepare(spec.inputs, policy, report)
        graph = lower(spec, prepared.arrays, prepared.groups, self.capabilities)
        # Per-unit wall profiling (a device synchronise after every unit)
        # would serialize the asynchronous launch stream, so it is enabled
        # only for the tuner's probe iterations.
        sync_prev = self.profile.sync
        if tuner is not None and tuner.probing:
            self.profile.sync = True
        try:
            value = self._schedule(graph)
        finally:
            self.profile.sync = sync_prev
        value = _synchronize(value)
        dt = time.perf_counter() - t0

        for store, mark in store_marks:
            report.bytes_loaded += store.stats.bytes_loaded - mark.bytes_loaded
            report.bytes_spilled += store.stats.bytes_spilled - mark.bytes_spilled
            report.prefetch_hits += store.stats.prefetch_hits - mark.prefetch_hits
        if isinstance(policy, SplIter):
            report.granularity = policy.partitions_per_location
        if tuner is not None:
            self._feed_tuner(tuner, policy, graph, dt, traced=(
                self.engine.traces_total > traces0
            ))
        if own_report:
            report.wall_s = dt
        return ComputeResult(value=value, report=report)

    def execute_async(self, plan: ExecutionPlan) -> ComputeFuture:
        """Submit a plan; returns a :class:`ComputeFuture`.

        This backend does not overlap submissions: the plan executes now
        and the future is already completed (or failed), so application
        code written for pipelined backends runs unchanged.
        """
        iteration, self._iteration = self._iteration, self._iteration + 1
        try:
            result = self.execute(plan)
        except Exception as e:  # noqa: BLE001 — surfaced via the future
            return ComputeFuture.failed(e, iteration=iteration)
        return ComputeFuture.completed(result, iteration=iteration)

    def lower(self, plan: ExecutionPlan) -> TaskGraph:
        """Lower a plan for this backend without running it (inspection)."""
        spec = plan.spec
        policy, _ = self._resolve_policy(spec)
        prepared = self._prepare(spec.inputs, policy, self.engine.report)
        return lower(spec, prepared.arrays, prepared.groups, self.capabilities)

    # -- autotuning: resolve SplIter("auto") against the workload's tuner ------

    def _resolve_policy(
        self, spec: MapReduceSpec
    ) -> tuple[ExecutionPolicy, Autotuner | None]:
        pol = spec.policy
        if not (isinstance(pol, SplIter) and pol.autotuned):
            return pol, None
        tuner = self._tuner_for(spec, pol)
        return (
            dataclasses.replace(pol, partitions_per_location=tuner.propose()),
            tuner,
        )

    def _tuner_for(self, spec: MapReduceSpec, pol: SplIter) -> Autotuner:
        # Geometry-keyed (not id-keyed): two equal-geometry datasets resolve
        # to the SAME tuner, so probe cost is paid once per (geometry, kind,
        # fn, policy) rather than once per array object.
        key = (
            inputs_signature(spec.inputs),
            spec.kind,
            stable_task_key(spec.fn),
            pol,
        )
        entry = self._tuners.get(key)
        if entry is not None:
            self._tuners.move_to_end(key)
            return entry[1]
        x0 = spec.inputs[0]
        counts = [len(x0.blocks_at(loc)) for loc in range(x0.num_locations)]
        tuner = Autotuner(counts, seed=pol.autotune_seed)
        self._tuners[key] = (None, tuner)
        while len(self._tuners) > self.prepare_cache_size:
            self._tuners.popitem(last=False)
        return tuner

    def _feed_tuner(
        self,
        tuner: Autotuner,
        policy: SplIter,
        graph: TaskGraph,
        wall_s: float,
        *,
        traced: bool,
    ) -> None:
        counted = sum(1 for t in graph.tasks if t.counted)
        span = max((len(t.block_ids) for t in graph.tasks), default=0)
        tuner.observe(
            policy.partitions_per_location,
            wall_s,
            n_tasks=counted or None,
            span=span or None,
            traced=traced,
            # The overhead hint is scoped to THIS workload's task keys.
            overhead_s=self.profile.mean_task_overhead_s(
                kinds=(
                    "block",
                    "partition_scan",
                    "partition_pallas",
                    "partition_materialized",
                ),
                keys={t.key for t in graph.tasks if t.counted},
            ),
        )

    # -- prepare: policy -> (arrays, task groups), LRU-cached ------------------

    def _prepare(
        self,
        inputs: tuple[BlockedArray, ...],
        policy: ExecutionPolicy,
        report: EngineReport,
    ) -> _Prepared:
        stats = self.prepare_stats
        ids = tuple(id(a) for a in inputs)

        if isinstance(policy, SplIter):
            # SplIter preparations share ONE ppl-independent base per input
            # set: the placement scan is paid once; every granularity is a
            # logical regroup of the already-split block-id lists.
            ppl = policy.partitions_per_location
            assert isinstance(ppl, int), "auto must be resolved before prepare"
            key = (ids, SplIter)
            base = self._prepare_cache.get(key)
            if base is not None:
                self._prepare_cache.move_to_end(key)
                stats.hits += 1
            else:
                stats.misses += 1
                stats.splits += 1
                x0 = inputs[0]
                local_blocks = []
                for loc in range(x0.num_locations):
                    local = x0.blocks_at(loc)
                    if local:
                        local_blocks.append((loc, tuple(local)))
                base = _SplitBase(inputs=inputs, local_blocks=tuple(local_blocks))
                self._cache_put(key, base)
            groups, regrouped = base.groups_for(ppl)
            if regrouped:
                stats.regroups += 1
            return _Prepared(inputs=inputs, arrays=inputs, groups=groups)

        key = (ids, policy)
        hit = self._prepare_cache.get(key)
        if hit is not None:
            self._prepare_cache.move_to_end(key)
            stats.hits += 1
            return hit
        stats.misses += 1

        x0 = inputs[0]
        if isinstance(policy, Rechunk):
            stats.rechunks += 1
            target = policy.target_rows or math.ceil(x0.num_rows / x0.num_locations)
            arrays = []
            for a in inputs:
                na, st = rechunk(a, target)
                report.bytes_moved += st.bytes_moved
                arrays.append(na)
            arrays = tuple(arrays)
            groups = [
                PlacedGroup(int(arrays[0].placements[i]), (i,))
                for i in range(arrays[0].num_blocks)
            ]
        elif isinstance(policy, Baseline):
            arrays = inputs
            groups = [
                PlacedGroup(int(x0.placements[i]), (i,)) for i in range(x0.num_blocks)
            ]
        else:  # pragma: no cover
            raise TypeError(f"unknown policy {policy!r}")

        prepared = _Prepared(inputs=inputs, arrays=arrays, groups=groups)
        self._cache_put(key, prepared)
        return prepared

    def _cache_put(self, key: tuple, entry: Any) -> None:
        self._prepare_cache[key] = entry
        while len(self._prepare_cache) > self.prepare_cache_size:
            _, evicted = self._prepare_cache.popitem(last=False)
            self._release_prepared(evicted)

    def _release_prepared(self, entry: Any) -> None:
        """Un-cache hook: trim the chunk stores an evicted entry pinned."""
        for store in chunk_stores(getattr(entry, "inputs", ())):
            store.trim()

    def close(self) -> None:
        """Release cached preparations and trim their chunk stores (idempotent)."""
        entries = list(self._prepare_cache.values())
        self._prepare_cache.clear()
        self._tuners.clear()
        for entry in entries:
            self._release_prepared(entry)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- the shared scheduler core ---------------------------------------------

    def _bind(self, task: Task) -> Callable[[], Any]:
        """A nullary thunk running one task through the engine's task cache."""
        if not task.counted:
            return lambda: task.fn(*task.operands())
        t = self.engine.task(task.fn, key=task.key)
        return lambda: t(*task.operands())

    def _plan_dispatches(self, graph: TaskGraph) -> list[_Unit]:
        """TaskGraph → dispatch units (backend hook; default one per task)."""
        return [
            _Unit(index=i, location=t.location, tasks=(t,), run=self._bind(t),
                  kind=t.kind)
            for i, t in enumerate(graph.tasks)
        ]

    def _build_units(
        self, graph: TaskGraph
    ) -> tuple[list[_Unit], _SchedulerState, _Unit | None]:
        """TaskGraph → ``(units, state, merge_unit)``, merge closure bound.

        The merge folds along the canonical merge tree (DESIGN.md §16):
        per-location chains, then a root chain over the per-location
        values, in a single dispatch.
        """
        units = list(self._plan_dispatches(graph))
        merge_unit = None
        merge_plan: tuple = ()
        if graph.merge is not None:
            plan = fold_plan((u.index, u.location) for u in units)
            merge_deps: list[int] = []
            merge_plan_groups: list[tuple[int, tuple[int, ...]]] = []
            for loc, members in plan:
                merge_plan_groups.append(
                    (loc, tuple(range(len(merge_deps), len(merge_deps) + len(members))))
                )
                merge_deps.extend(members)
            merge_plan = tuple(merge_plan_groups)
            merge_unit = _Unit(
                index=len(units),
                location=-1,
                tasks=(),
                run=None,
                deps=tuple(merge_deps),
                kind="merge",
            )
            units.append(merge_unit)
        state = _SchedulerState(units)
        if merge_unit is not None:
            deps = merge_unit.deps

            def run_merge():
                partials = [state.results[i] for i in deps]
                return _merge_partials(
                    self.engine, graph.merge, partials, plan=merge_plan
                )

            merge_unit.run = run_merge
        return units, state, merge_unit

    def _schedule(self, graph: TaskGraph) -> Any:
        """Run a TaskGraph through the shared dependency-driven core.

        Returns the merged value when the graph has a merge, else the
        per-task partials in plan order.
        """
        units, state, merge_unit = self._build_units(graph)
        if units:
            self._drain(state)
        if state.errors:
            raise state.errors[0]
        if merge_unit is not None:
            return state.results[merge_unit.index]
        return list(state.results)

    def _run_unit(self, unit: _Unit, state: _SchedulerState) -> list[_Unit]:
        """Profiled execution of one ready unit; returns newly-ready units."""
        try:
            t0 = time.perf_counter()
            value = unit.run()
            t1 = time.perf_counter()
            if self.profile.sync:
                value = _synchronize(value)
            wall = time.perf_counter() - t0
            self.profile.record_tasks(
                unit.tasks,
                kind=unit.kind,
                location=unit.location,
                dispatch_s=t1 - t0,
                wall_s=wall,
            )
        except Exception as e:  # noqa: BLE001 — re-raised by _schedule
            state.fail(e)
            return []
        return state.complete(unit, value)

    def _drain(self, state: _SchedulerState) -> None:
        """Run ready units to completion (backend hook; default: inline)."""
        q = collections.deque(state.initial_ready())
        while q and not state.errors:
            q.extend(self._run_unit(q.popleft(), state))


class LocalExecutor(_PlanExecutor):
    """Sequential dispatch on the calling thread — the seed TaskEngine path."""


def _default_local(engine: TaskEngine | None = None) -> LocalExecutor:
    """The library's internal default backend (apps and ``Collection.compute``
    fall back to it when no executor is passed)."""
    return LocalExecutor(engine=engine)
