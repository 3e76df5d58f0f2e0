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
(hook ``_drain``: inline on the calling thread, or through the persistent
per-location worker pool).  Every unit runs instrumented: the core emits a
:class:`~repro_torch.api.profile.ProfileEvent` (dispatch overhead, wall,
bytes) into the executor's :class:`~repro_torch.api.profile.ProfileStore`.

:class:`LocalExecutor`
    Sequential dispatch on the calling thread.
:class:`ThreadedExecutor`
    A persistent worker thread per *location*, reused across executes,
    overlapping per-partition dispatch across locations.  Partials are
    collected by unit index and merged in plan order, so results are
    bit-identical to :class:`LocalExecutor`.  Its ``execute_async``
    overlaps consecutive submissions (DESIGN.md §14): iteration *k+1*'s
    unit for a partition launches when iteration *k*'s unit for the same
    partition (and the merge a :class:`~repro_torch.api.futures.Deferred`
    operand reads) has completed, at most :attr:`_PlanExecutor.pipeline_depth`
    submissions in flight.

:class:`~repro_torch.api.stream_executor.StreamExecutor` (its own module)
streams chunk-backed inputs through a budgeted
:class:`~repro_torch.api.chunkstore.DiskStore`.  Every unit runs between
the core's resolve/release hooks (:meth:`_PlanExecutor._acquire_unit` /
``_release_unit``), which pin an out-of-core backend's chunk operands
while it dispatches.

:class:`~repro_torch.api.mesh_executor.MeshExecutor` (its own module) turns
each same-signature run of tasks into ONE ``"sharded"`` unit folded rank by
rank over a list of devices (DESIGN.md §5.4).  Every backend is built
through :func:`repro_torch.api.engine`; a direct constructor call still
works and emits a ``DeprecationWarning``.

CUDA launches are asynchronous, so a unit's ``dispatch_s`` is the host-side
launch overhead; ``execute`` synchronises the result's device before it
stops its clock, so ``EngineReport.wall_s`` includes device time.  Every
worker launches on the device's default stream: a consumer unit (the
merge, a gated unit of the next iteration, a ``Deferred``) is enqueued
only after its producers' host calls returned, so the one stream orders
them, and what overlaps is host work (lowering, scheduling, wrapper
launches) with the card.

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

import atexit
import collections
import contextlib
import contextvars
import dataclasses
import math
import queue
import threading
import time
import warnings
import weakref
from typing import Any, Callable, Hashable, Protocol, runtime_checkable

import torch

from repro_torch._pytree import tree_leaves, tree_map
from repro_torch.api.autotune import Autotuner
from repro_torch.api.chunkstore import chunk_stores
from repro_torch.api.futures import ComputeFuture, Deferred, PipelineBrokenError
from repro_torch.api.lowering import (
    Capabilities,
    MergeSpec,
    PartitionView,
    PlacedGroup,
    Task,
    TaskGraph,
    cross_iteration_edges,
    fold_plan,
    inputs_signature,
    lower,
    partition_key,
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
    "Deferred",
    "PipelineBrokenError",
    "PartitionView",
    "Executor",
    "LocalExecutor",
    "ThreadedExecutor",
    "PrepareStats",
    "SharedAssets",
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
    returns a :class:`~repro_torch.api.futures.ComputeFuture` (pipelined
    backends overlap consecutive submissions, DESIGN.md §14; the rest
    complete it at once); ``task`` registers out-of-plan app stages against
    the same task cache and accounting; ``report`` exposes the current
    :class:`~repro_torch.core.engine.EngineReport`.

    >>> [isinstance(ex(), Executor) for ex in (LocalExecutor, ThreadedExecutor)]
    [True, True]
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
class SharedAssets:
    """Cross-executor caches, owned by a long-lived service (DESIGN.md §12).

    A standalone executor owns a private copy of each of these; a
    :class:`~repro_torch.api.jobserver.JobServer` builds ONE
    ``SharedAssets`` and has its pooled executor
    :meth:`~_PlanExecutor.adopt_shared_assets`, so prepared placements,
    profile events and autotuner state accumulate across tenants: tenant
    B's ``SplIter("auto")`` submission starts from the granularity tenant
    A's probes converged on, keyed by the geometry-based
    :func:`~repro_torch.api.lowering.inputs_signature` rather than object
    ids.

    The JobServer's single scheduler thread serializes unit execution, so
    no locking is layered on top of what each structure already has.
    """

    prepare_cache: collections.OrderedDict = dataclasses.field(
        default_factory=collections.OrderedDict
    )
    prepare_stats: PrepareStats = dataclasses.field(default_factory=PrepareStats)
    profile: ProfileStore = dataclasses.field(default_factory=ProfileStore)
    tuners: collections.OrderedDict = dataclasses.field(
        default_factory=collections.OrderedDict
    )


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
    """One schedulable unit: a task, a sharded bucket, a fold, or the merge.

    ``run`` is a nullary thunk; ``deps`` are unit indices that must
    complete first (the merge depends on every task unit).

    ``kind == "fold"`` units exist only when a backend materializes a
    :func:`~repro_torch.api.lowering.fold_plan` group as its own schedulable
    unit (the cluster's peer exchange, DESIGN.md §16): ``fold_group`` holds
    the member unit indices (== ``deps``), ``origin`` the first member's
    task descriptor (a failure names the originating app task, never the
    synthetic fold), and ``merge`` the graph's
    :class:`~repro_torch.api.lowering.MergeSpec`.  ``publish`` marks a task
    unit whose partial a sibling fold consumes in place: the cluster asks
    its worker to leave the result in a named shared-memory segment instead
    of shipping it back.
    """

    index: int
    location: int                  # -1: any thread (merge / sharded bucket)
    tasks: tuple[Task, ...]        # graph descriptors covered (merge, fold: ())
    run: Callable[[], Any] | None
    deps: tuple[int, ...] = ()
    kind: str = "task"
    fold_group: tuple[int, ...] = ()
    origin: Task | None = None
    merge: MergeSpec | None = None
    publish: bool = False


class _SchedulerState:
    """Thread-safe dependency/result bookkeeping for one TaskGraph run.

    Pipelined executes (DESIGN.md §14) add three things:

    * ``report`` — the :class:`~repro_torch.core.engine.EngineReport` this
      graph's units bill (``None``: the engine's current report, the
      synchronous path).  With several graphs in flight, billing rides
      with the graph, not with whichever report the engine points at.
    * per-unit / completion *subscriptions* — :meth:`subscribe` /
      :meth:`on_all_done` / :meth:`on_fail`: how the NEXT iteration's
      gated units learn their cross-iteration predecessors finished.
      :meth:`complete` fires unit subscriptions before completion
      subscriptions before ``done.set()``, all outside the lock — so a
      dependent iteration's launch is enqueued before the completed
      iteration's future can resolve.
    * ``partition_versions`` — for each
      :func:`~repro_torch.api.lowering.partition_key` this graph covers,
      which pipelined version of that partition it computes (predecessor's
      version + 1; first submission: 1).

    Beyond the dependency core, the state tracks *ownership*: which
    executor-defined owner (a cluster worker process) a unit was assigned
    to, how many times it has been attempted, and — via :meth:`requeue` —
    which in-flight units an owner took down with it.  Owners are opaque
    hashables; the hooks are what make the fault-tolerant backend
    (ClusterExecutor) a scheduling concern instead of a fork of the core.
    :meth:`is_done` is also what the JobServer reads when it restores
    journaled units.
    """

    def __init__(self, units: list[_Unit], report: EngineReport | None = None):
        self.units = units
        self.report = report
        self.results: list[Any] = [None] * len(units)
        self.errors: list[BaseException] = []
        self._lock = threading.Lock()
        self._indegree = [len(u.deps) for u in units]
        self._dependents: list[list[int]] = [[] for _ in units]
        for u in units:
            for d in u.deps:
                self._dependents[d].append(u.index)
        self._remaining = len(units)
        self._done_units: set[int] = set()
        self.owner: dict[int, Hashable] = {}        # unit index -> owner
        self.attempts: collections.Counter = collections.Counter()
        self._unit_subs: dict[int, list[Callable[[], None]]] = {}
        self._done_subs: list[Callable[[], None]] = []
        self._fail_subs: list[Callable[[BaseException], None]] = []
        self.partition_versions: dict[tuple, int] = {}
        # the graph's MergeSpec key (None: no merge): what the cluster's
        # observed partial sizes are keyed by
        self.merge_key: Hashable | None = None
        self.done = threading.Event()
        if not units:
            self.done.set()

    def initial_ready(self) -> list[_Unit]:
        return [u for u in self.units if not u.deps]

    def assign(self, unit: _Unit, owner: Hashable) -> None:
        """Record who is executing ``unit`` (attempt counted on assign).

        Double-claim prevention (the work-stealing invariant): a unit that
        is still owned by a *different* live owner cannot be re-assigned —
        ownership must first move through :meth:`requeue` (death),
        :meth:`release` (steal / preemption), or completion.  A late
        assign raced against a completed unit is equally rejected; both
        raise, so no interleaving can run a unit twice.
        """
        with self._lock:
            if unit.index in self._done_units:
                raise RuntimeError(f"unit {unit.index} assigned to {owner!r} after completion")
            prev = self.owner.get(unit.index)
            if prev is not None and prev != owner:
                raise RuntimeError(
                    f"unit {unit.index} double-claimed: owned by {prev!r}, "
                    f"assigned to {owner!r}"
                )
            self.owner[unit.index] = owner
            self.attempts[unit.index] += 1

    def release(self, unit: _Unit) -> bool:
        """Disown a claimed-but-unstarted unit (steal grant / preemption).

        The voided dispatch's attempt is refunded: a steal is a scheduling
        decision, not a failure, so it must not count against
        ``max_retries``.  Returns False — and changes nothing — when the
        unit already completed (the victim raced the grant) or was never
        owned, so callers can treat the grant as stale.
        """
        with self._lock:
            if unit.index in self._done_units or unit.index not in self.owner:
                return False
            del self.owner[unit.index]
            if self.attempts[unit.index] > 0:
                self.attempts[unit.index] -= 1
            return True

    def refund_attempt(self, index: int) -> None:
        """Refund one attempt after :meth:`requeue` of a *planned* preemption
        (scale-down must not push units toward retry exhaustion)."""
        with self._lock:
            if self.attempts[index] > 0:
                self.attempts[index] -= 1

    def is_done(self, index: int) -> bool:
        with self._lock:
            return index in self._done_units

    def requeue(self, owner: Hashable) -> list[_Unit]:
        """Disown ``owner``'s incomplete units (worker death) for replay.

        Returns the lost units; their ownership entries are cleared so a
        late/duplicate completion from the dead owner is ignorable via
        :meth:`is_done`, and a surviving owner may claim them.
        """
        with self._lock:
            lost = [
                self.units[i]
                for i, o in list(self.owner.items())
                if o == owner and i not in self._done_units
            ]
            for u in lost:
                del self.owner[u.index]
        return lost

    def subscribe(self, index: int, cb: Callable[[], None]) -> bool:
        """Fire ``cb`` when unit ``index`` completes; False if already done
        (the caller then runs its callback itself)."""
        with self._lock:
            if index in self._done_units:
                return False
            self._unit_subs.setdefault(index, []).append(cb)
            return True

    def on_all_done(self, cb: Callable[[], None]) -> None:
        """Fire ``cb`` once every unit has completed (not on failure)."""
        with self._lock:
            if self._remaining > 0:
                self._done_subs.append(cb)
                return
        cb()

    def on_fail(self, cb: Callable[[BaseException], None]) -> None:
        """Fire ``cb`` on the first failure (immediately if already failed)."""
        with self._lock:
            if not self.errors:
                self._fail_subs.append(cb)
                return
            exc = self.errors[0]
        cb(exc)

    def complete(self, unit: _Unit, value: Any) -> list[_Unit]:
        """Record a result; return units that just became ready.

        Unit subscriptions (cross-iteration launches) fire first, then —
        when this was the last unit — completion subscriptions (the
        future's raw value), then ``done.set()``; all outside the lock, on
        the completing thread.
        """
        newly: list[_Unit] = []
        finished = False
        with self._lock:
            if unit.index in self._done_units:
                return []
            self._done_units.add(unit.index)
            self.results[unit.index] = value
            for di in self._dependents[unit.index]:
                self._indegree[di] -= 1
                if self._indegree[di] == 0:
                    newly.append(self.units[di])
            self._remaining -= 1
            subs = self._unit_subs.pop(unit.index, ())
            if self._remaining == 0:
                finished = True
                done_subs, self._done_subs = self._done_subs, []
        for cb in subs:
            cb()
        if finished:
            for cb in done_subs:
                cb()
            self.done.set()
        return newly

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            self.errors.append(exc)
            fail_subs, self._fail_subs = self._fail_subs, []
        for cb in fail_subs:
            cb(exc)
        self.done.set()


@dataclasses.dataclass
class _PipelineEntry:
    """One in-flight pipelined execute (DESIGN.md §14).

    Everything the synchronous ``execute`` keeps on its stack — graph,
    scheduler state, report, policy/tuner snapshot, store marks, timing —
    promoted to an object so several executes can be in flight at once.
    :meth:`_PlanExecutor._finalize_entry` consumes it exactly once.
    """

    iteration: int
    graph: TaskGraph
    state: _SchedulerState
    merge_index: int | None
    report: EngineReport
    future: ComputeFuture
    policy: ExecutionPolicy
    tuner: Autotuner | None
    t0: float
    t_done: float = 0.0
    finalized: bool = False
    result: ComputeResult | None = None
    store_marks: list = dataclasses.field(default_factory=list)
    # Backend drive attachments (opaque to the core):
    pending: Any = None      # StreamExecutor: this entry's pending unit deque
    jobs: Any = None         # StreamExecutor: unit index -> prefetch job
    draining: bool = False   # StreamExecutor: drain in progress/finished
    ctx: Any = None          # ClusterExecutor: this entry's drain context

    def mark_stores(self, stores=None) -> None:
        """(Re)snapshot the input stores' lifetime counters.

        Pipelined report exactness for chunk I/O is *window-based*: the
        entry bills the store-counter delta between this mark and its
        finalization.  Backends that begin real I/O later than submit
        (StreamExecutor drains entries in order) re-mark at drain start so
        the window covers exactly this entry's streaming.
        """
        src = stores if stores is not None else [s for s, _ in self.store_marks]
        self.store_marks = [(s, s.stats.snapshot()) for s in src]


#: True while :func:`repro_torch.api.engine` is constructing a backend —
#: direct constructor calls outside the factory get a DeprecationWarning.
_via_factory: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_engine_via_factory", default=False
)


@contextlib.contextmanager
def _factory_construction():
    """Suppress the direct-construction warning (factory / internal defaults)."""
    token = _via_factory.set(True)
    try:
        yield
    finally:
        _via_factory.reset(token)


def _warn_direct_construction(cls: type) -> None:
    """One DeprecationWarning per direct (non-factory) backend construction.

    The per-backend constructors keep working; new code is pointed at the
    factory.
    """
    if not _via_factory.get():
        warnings.warn(
            f"constructing {cls.__name__} directly is deprecated; use "
            f"repro_torch.api.engine(backend=..., config=EngineConfig(...)) "
            f"(DESIGN.md §16)",
            DeprecationWarning,
            stacklevel=3,
        )


class _PlanExecutor:
    """Shared prepare/lower/schedule core; subclasses customize dispatch."""

    #: bound on cached (inputs, policy) preparations (LRU eviction).
    prepare_cache_size: int = 8

    #: backend overlaps consecutive execute_async submissions (DESIGN.md §14).
    _pipelined: bool = False

    #: in-flight window for execute_async: admitting a submission beyond
    #: this many unresolved entries finalizes the oldest first.
    pipeline_depth: int = 2

    def __init__(self, engine: TaskEngine | None = None):
        _warn_direct_construction(type(self))
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
        self._pipeline: collections.deque[_PipelineEntry] = collections.deque()
        self._iteration = 0  # execute_async submit counter (error attribution)

    def adopt_shared_assets(self, assets: SharedAssets) -> None:
        """Rebind this executor's caches to server-owned :class:`SharedAssets`.

        After adoption the executor reads and writes the shared structures
        directly (no copies).  Pre-adoption private profile history folds
        into the shared store so earlier probes keep informing the shared
        overhead hint; prepare/tuner entries migrate by dict update (shared
        entries win on key collision).
        """
        assets.profile.merge(self.profile)
        for key, entry in self._prepare_cache.items():
            assets.prepare_cache.setdefault(key, entry)
        for key, entry in self._tuners.items():
            assets.tuners.setdefault(key, entry)
        self._prepare_cache = assets.prepare_cache
        self.prepare_stats = assets.prepare_stats
        self.profile = assets.profile
        self._tuners = assets.tuners

    # -- backend capabilities (consumed by the lowering pass) -----------------

    @property
    def capabilities(self) -> Capabilities:
        # The hand-written kernels beat the fold on a card; ``lower`` keeps
        # the preference only for a plan whose blocks lie on a CUDA device.
        return Capabilities(
            name=type(self).__name__, prefer_pallas=True, pipelined=self._pipelined
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
        # Barrier rule: a synchronous execute never overlaps — in-flight
        # pipelined submissions resolve first, in submit order (their
        # futures keep the outcomes; errors surface there, not here).
        if self._pipeline:
            self._drain_pipeline()
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

    # -- pipelined (asynchronous) execution — DESIGN.md §14 --------------------

    def execute_async(self, plan: ExecutionPlan) -> ComputeFuture:
        """Submit a plan without draining it; returns a :class:`ComputeFuture`.

        On a pipelined backend (``capabilities.pipelined``) consecutive
        submissions overlap: each unit of this plan is gated on its
        same-partition predecessors in the previous in-flight submission
        (plus any :class:`~repro_torch.api.futures.Deferred` operand's
        source merge) via
        :func:`~repro_torch.api.lowering.cross_iteration_edges`, and
        launches the moment those complete.  At most :attr:`pipeline_depth`
        submissions stay unresolved; admitting one past the window
        finalizes the oldest first.

        Everywhere else — non-pipelined backends, inside a :meth:`scope`
        (one accumulated report means one report window at a time), or
        during an autotuner *probe* window (profiled walls must never
        measure overlapped executes) — this is a synchronous execute
        wrapped in an already-completed future, so application code is
        identical either way.
        """
        spec = plan.spec
        if not self.capabilities.pipelined or self._scope_depth:
            return self._sync_future(plan)
        policy, tuner = self._resolve_policy(spec)
        if tuner is not None and tuner.probing:
            # Probe guard: a probe iteration's wall feeds the cost model;
            # overlapping it with a neighbour would record contended walls.
            return self._sync_future(plan)
        return self._submit_entry(spec, policy, tuner)

    def _sync_future(self, plan: ExecutionPlan) -> ComputeFuture:
        """The non-overlapping path: execute now, return a done future."""
        self._drain_pipeline()
        iteration, self._iteration = self._iteration, self._iteration + 1
        try:
            result = self.execute(plan)
        except Exception as e:  # noqa: BLE001 — surfaced via the future
            return ComputeFuture.failed(e, iteration=iteration)
        return ComputeFuture.completed(result, iteration=iteration)

    def _submit_entry(
        self, spec: MapReduceSpec, policy: ExecutionPolicy, tuner: Autotuner | None
    ) -> ComputeFuture:
        # Flow control: the in-flight window is pipeline_depth whole
        # executes; the oldest entry resolves before a new one is admitted.
        while len(self._pipeline) >= max(1, int(self.pipeline_depth)):
            try:
                self._finalize_entry(self._pipeline[0])
            except Exception:  # noqa: BLE001 — kept on the evicted future
                pass

        prev = self._pipeline[-1] if self._pipeline else None
        iteration, self._iteration = self._iteration, self._iteration + 1
        report = EngineReport(mode=spec.policy.mode_name)
        if (
            tuner is not None
            and tuner.last_ppl is not None
            and policy.partitions_per_location != tuner.last_ppl
        ):
            report.retunes += 1
        t0 = time.perf_counter()
        # Prepare/lower/build under the entry's report binding so traces
        # paid at registration time are credited to this submission.
        with self.engine.bind_report(report):
            prepared = self._prepare(spec.inputs, policy, report)
            graph = lower(spec, prepared.arrays, prepared.groups, self.capabilities)
            units, state, merge_unit = self._build_units(graph, report=report)

        fut = ComputeFuture(iteration=iteration)
        entry = _PipelineEntry(
            iteration=iteration,
            graph=graph,
            state=state,
            merge_index=None if merge_unit is None else merge_unit.index,
            report=report,
            future=fut,
            policy=policy,
            tuner=tuner,
            t0=t0,
        )
        entry.mark_stores(chunk_stores(spec.inputs))
        fut._finalize = lambda: self._finalize_entry(entry)
        fut._drive = lambda: self._drive_raw(entry)

        # Versioned keys: each partition this graph covers computes the
        # next version after its predecessor's (1 on first submission).
        for t in graph.tasks:
            k = partition_key(t)
            base = prev.state.partition_versions.get(k, 0) if prev is not None else 0
            state.partition_versions[k] = base + 1

        self._wire_future(entry)
        if prev is not None:
            self._wire_poison(entry, prev)
            # Overlap accounting, frozen at SUBMIT time: an earlier
            # unresolved submission exists, so every unit of this one is
            # admitted before the previous execute's resolution — a
            # function of the call order alone, not of host speed.
            report.overlapped_launches = len(units)
        self._pipeline.append(entry)
        self._start_entry(entry, prev)
        return fut

    def _wire_future(self, entry: _PipelineEntry) -> None:
        """Raw-phase completion: state outcome → the entry's future."""
        state, fut = entry.state, entry.future
        merge_index = entry.merge_index

        def on_done():
            entry.t_done = time.perf_counter()
            fut._set_raw(
                state.results[merge_index]
                if merge_index is not None
                else list(state.results)
            )

        def on_fail(exc: BaseException):
            entry.t_done = time.perf_counter()
            fut._set_error(exc)

        state.on_all_done(on_done)
        state.on_fail(on_fail)

    def _wire_poison(self, entry: _PipelineEntry, prev: _PipelineEntry) -> None:
        """An upstream failure poisons this entry with a typed error naming
        the originating iteration; gated units that never launched stay
        unlaunched, and this entry's own failure cascades further."""

        def poison(exc: BaseException):
            entry.state.fail(
                PipelineBrokenError(
                    f"pipelined execute #{entry.iteration} aborted: upstream "
                    f"iteration #{prev.iteration} failed: {exc}",
                    iteration=prev.iteration,
                )
            )

        prev.state.on_fail(poison)

    def _gate_units(
        self,
        entry: _PipelineEntry,
        prev: _PipelineEntry | None,
        launch: Callable[[_Unit], None],
    ) -> None:
        """Launch ``entry``'s initially-ready units behind their cross-
        iteration gates.

        Each unit waits on (a) its same-partition predecessors in ``prev``
        (units a retune left unmatched fall back to ``prev``'s merge), plus
        (b) the merge of any in-flight submission one of this plan's
        ``Deferred`` operands resolves against — a data dependency, so
        resolution never blocks inside a dispatch.  Ungated units launch
        immediately; gate callbacks fire on whichever thread completed the
        last predecessor.
        """
        state = entry.state
        ready = state.initial_ready()
        gates: dict[int, list[tuple[_SchedulerState, int]]] = {}
        if prev is not None:
            edges = cross_iteration_edges(prev.graph, entry.graph)
            fallback = (
                [(prev.state, prev.merge_index)]
                if prev.merge_index is not None
                else []
            )
            for u in ready:
                if u.location < 0 or not u.tasks:
                    continue
                deps = [(prev.state, i) for i in edges.get(u.index, ())]
                gates[u.index] = deps if deps else list(fallback)
        merge_gates: list[tuple[_SchedulerState, int]] = []
        for e in entry.graph.spec.extra_args:
            if isinstance(e, Deferred):
                src = next(
                    (p for p in self._pipeline if p is not entry and p.future is e.future),
                    None,
                )
                if src is not None and src.merge_index is not None:
                    merge_gates.append((src.state, src.merge_index))
        if merge_gates:
            for u in ready:
                if u.location < 0 or not u.tasks:
                    continue
                gates.setdefault(u.index, []).extend(merge_gates)

        for u in ready:
            seen: set[tuple[int, int]] = set()
            uniq: list[tuple[_SchedulerState, int]] = []
            for dep in gates.get(u.index) or ():
                mark = (id(dep[0]), dep[1])
                if mark not in seen:
                    seen.add(mark)
                    uniq.append(dep)
            if not uniq:
                launch(u)
                continue
            hold = threading.Lock()
            left = [len(uniq)]

            def advance(u=u, hold=hold, left=left):
                with hold:
                    left[0] -= 1
                    fire = left[0] == 0
                if fire:
                    launch(u)

            for src_state, idx in uniq:
                if not src_state.subscribe(idx, advance):
                    advance()  # predecessor already completed

    def _start_entry(
        self, entry: _PipelineEntry, prev: _PipelineEntry | None
    ) -> None:  # pragma: no cover — every pipelined backend overrides
        """Begin executing a submitted entry (pipelined-backend hook)."""
        raise NotImplementedError(
            f"{type(self).__name__} declares pipelined capabilities but "
            "does not implement _start_entry"
        )

    def _drive_raw(self, entry: _PipelineEntry) -> None:
        """Make progress until ``entry`` reaches raw completion (hook).

        No-op by default: push-driven backends (ThreadedExecutor) complete
        entries from their worker threads and waiters just block on the
        state event.  Cooperative backends (StreamExecutor) override this
        to drain queued entries on the calling thread.
        """

    def _drive_entry(self, entry: _PipelineEntry) -> None:
        if not entry.state.done.is_set():
            self._drive_raw(entry)
            entry.state.done.wait()

    def _finalize_entry(self, entry: _PipelineEntry) -> ComputeResult:
        """The deferred half of ``execute()``: run exactly once per entry.

        Waits for raw completion (driving a cooperative backend, else
        blocking on the state's event), then does the per-execute
        bookkeeping the synchronous path does behind its barrier — device
        sync, store window deltas, granularity stamp, tuner feedback,
        ``wall_s`` — and seals the entry's ComputeResult.  Raises the
        entry's failure (the future carries it too).
        """
        if not entry.finalized:
            entry.finalized = True
            try:
                self._drive_entry(entry)
            finally:
                try:
                    self._pipeline.remove(entry)
                except ValueError:
                    pass
            state, report = entry.state, entry.report
            # wall_s runs from submit to raw completion, on the host clock
            dt = (entry.t_done or time.perf_counter()) - entry.t0
            report.wall_s = dt
            if not state.errors:
                try:
                    value = _synchronize(
                        state.results[entry.merge_index]
                        if entry.merge_index is not None
                        else list(state.results)
                    )
                except Exception as e:  # noqa: BLE001 — kept on the future
                    state.errors.append(e)
                    entry.future._set_error(e)
                else:
                    for store, mark in entry.store_marks:
                        st = store.stats
                        report.bytes_loaded += st.bytes_loaded - mark.bytes_loaded
                        report.bytes_spilled += st.bytes_spilled - mark.bytes_spilled
                        report.prefetch_hits += st.prefetch_hits - mark.prefetch_hits
                    if isinstance(entry.policy, SplIter):
                        report.granularity = entry.policy.partitions_per_location
                    if entry.tuner is not None:
                        self._feed_tuner(
                            entry.tuner, entry.policy, entry.graph, dt,
                            traced=report.traces > 0,
                        )
                    entry.result = ComputeResult(value=value, report=report)
                    entry.future._result = entry.result
        if entry.state.errors:
            raise entry.state.errors[0]
        return entry.result

    def _drain_pipeline(self) -> None:
        """Resolve every in-flight pipelined execute, in submit order.

        The pipeline's barrier: ``execute``, ``close`` and the sync path
        call this first.  Failures stay on the entries' futures; the
        barrier itself never raises another submission's error.
        """
        while self._pipeline:
            entry = self._pipeline[0]
            try:
                self._finalize_entry(entry)
            except Exception:  # noqa: BLE001 — kept on the entry's future
                pass
            if self._pipeline and self._pipeline[0] is entry:
                self._pipeline.popleft()  # defensive: never spin

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
                    "sharded",
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
        """Release cached preparations and trim their chunk stores.

        In-flight pipelined futures drain first (their results stay
        retrievable through ``result()`` after close).  Idempotent;
        backends with worker pools extend it and drain the pipeline before
        stopping whatever executes it.
        """
        self._drain_pipeline()
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
        self, graph: TaskGraph, *, report: EngineReport | None = None
    ) -> tuple[list[_Unit], _SchedulerState, _Unit | None]:
        """TaskGraph → ``(units, state, merge_unit)``, merge closure bound.

        The merge folds along the canonical merge tree (DESIGN.md §16):
        per-location chains, then a root chain over the per-location
        values.  Backends that fold location chains elsewhere (the
        cluster's peer exchange) materialize those groups as their own
        ``"fold"`` units through the :meth:`_remote_fold_plan` hook; every
        other backend keeps one merge unit that folds along the same tree
        in a single dispatch.  A :class:`~repro_torch.api.jobserver.JobServer`
        calls this directly and runs the units one by one.
        """
        units = list(self._plan_dispatches(graph))
        merge_unit = None
        fold_units: list[_Unit] = []
        merge_plan: tuple = ()
        if graph.merge is not None:
            plan = fold_plan((u.index, u.location) for u in units)
            remote_groups = set(self._remote_fold_plan(graph, units, plan))
            merge_deps: list[int] = []
            merge_plan_groups: list[tuple[int, tuple[int, ...]]] = []
            for loc, members in plan:
                if members in remote_groups and len(members) > 1:
                    first = units[members[0]]
                    fu = _Unit(
                        index=len(units),
                        location=loc,
                        tasks=(),
                        run=None,
                        deps=members,
                        kind="fold",
                        fold_group=members,
                        origin=first.tasks[0] if first.tasks else None,
                        merge=graph.merge,
                    )
                    units.append(fu)
                    fold_units.append(fu)
                    merge_plan_groups.append((loc, (len(merge_deps),)))
                    merge_deps.append(fu.index)
                else:
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
        state = _SchedulerState(units, report=report)
        state.merge_key = graph.merge.key if graph.merge is not None else None
        if merge_unit is not None:
            for fu in fold_units:
                # The driver-side run (the JobServer's path, and the
                # cluster's fallback): the chain a worker-side fold runs.
                def run_fold(members=fu.fold_group):
                    partials = [state.results[i] for i in members]
                    return _merge_partials(self.engine, graph.merge, partials)

                fu.run = run_fold
            deps = merge_unit.deps

            def run_merge():
                partials = [state.results[i] for i in deps]
                return _merge_partials(
                    self.engine, graph.merge, partials, plan=merge_plan
                )

            merge_unit.run = run_merge
        return units, state, merge_unit

    def _remote_fold_plan(
        self, graph: TaskGraph, units: list[_Unit], plan: tuple
    ) -> tuple[tuple[int, ...], ...]:
        """Fold groups to materialize as standalone units (backend hook).

        Default: none — the merge unit folds the whole plan itself.  The
        cluster returns the multi-member groups whose chains run worker-side
        over the peer exchange (DESIGN.md §16) and marks their member units
        ``publish``.
        """
        return ()

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

    def _acquire_unit(self, unit: _Unit) -> None:
        """Resolve hook before dispatch: pin the unit's chunk operands.

        Pins are refcounted eviction guards — while the unit runs, the
        residency-budget eviction of its store(s) must not drop buffers the
        ``operands()`` closure is about to (or did just) resolve.  Units of
        non-chunked inputs, and every unit of a backend that is not
        ``out_of_core``, carry no refs and the hook is free.
        """
        for task in unit.tasks:
            for ref in task.chunk_refs:
                ref.store.pin(ref)

    def _release_unit(self, unit: _Unit) -> None:
        """Release hook after dispatch: unpin, making the chunks evictable.

        The unit's kernels may still be queued on the card when this runs;
        what keeps their operands intact is the store's stream guard
        (:class:`~repro_torch.api.chunkstore.DiskStore`, "Stream order"),
        not the pin.  This unpin is what lets a streaming pass shed
        partition *k* while *k+1* loads.
        """
        for task in unit.tasks:
            for ref in task.chunk_refs:
                ref.store.unpin(ref)

    def _run_unit(self, unit: _Unit, state: _SchedulerState) -> list[_Unit]:
        """Profiled execution of one ready unit; returns newly-ready units.

        When the state carries its own report (a pipelined entry), the
        unit's dispatches/merges/traces bill that report through the
        engine's thread-local binding, whichever thread runs the unit.
        """
        if state.report is not None:
            with self.engine.bind_report(state.report):
                return self._run_unit_inner(unit, state)
        return self._run_unit_inner(unit, state)

    def _run_unit_inner(self, unit: _Unit, state: _SchedulerState) -> list[_Unit]:
        try:
            self._acquire_unit(unit)
            try:
                t0 = time.perf_counter()
                value = unit.run()
                t1 = time.perf_counter()
                if self.profile.sync:
                    value = _synchronize(value)
                wall = time.perf_counter() - t0
            finally:
                self._release_unit(unit)
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
    fall back to it when no executor is passed) — constructed through the
    factory's suppressed path, so library code never trips the nudge."""
    with _factory_construction():
        return LocalExecutor(engine=engine)


class _LocationWorker:
    """A persistent worker thread draining one location's job queue."""

    def __init__(self, name: str):
        self._jobs: queue.SimpleQueue = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            job()

    def submit(self, job: Callable[[], None]) -> None:
        self._jobs.put(job)

    def stop(self) -> None:
        """Post the poison pill and JOIN: a worker that launched CUDA work
        must not still be alive during the interpreter's CUDA teardown."""
        self._jobs.put(None)
        self._thread.join(timeout=5.0)


# Live thread-owning executors (ThreadedExecutor pools, StreamExecutor
# prefetchers), closed at interpreter exit so executors that were never
# close()d leave no thread that launched CUDA work alive into the CUDA
# runtime's teardown.
_LIVE_POOLS: "weakref.WeakSet[_PlanExecutor]" = weakref.WeakSet()


def _close_live_pools() -> None:
    for ex in list(_LIVE_POOLS):
        ex.close()


atexit.register(_close_live_pools)


class ThreadedExecutor(_PlanExecutor):
    """One persistent worker thread per location: overlapped dispatch.

    Workers are created lazily per location id and REUSED across
    ``execute`` calls, so iterative workloads pay thread startup once per
    executor lifetime.  :meth:`close` stops and joins them (they respawn on
    next use).

    Determinism: the shared scheduler core indexes partials by unit
    position and the merge unit folds them in plan order (on whichever
    worker completed the last dependency), so the value is bit-identical
    to :class:`LocalExecutor` regardless of thread timing.

    Pipelined (``execute_async``): gated units are submitted to the
    location workers from the completion callbacks of their
    cross-iteration predecessors, so iteration *k+1* starts on a location
    the moment *k* finishes there.  The pipelined path always routes
    through the pool, never the one-location inline path below.
    """

    _pipelined = True

    def __init__(self, engine: TaskEngine | None = None):
        super().__init__(engine)
        self._workers: dict[int, _LocationWorker] = {}
        _LIVE_POOLS.add(self)

    def _worker(self, location: int) -> _LocationWorker:
        w = self._workers.get(location)
        if w is None:
            w = self._workers[location] = _LocationWorker(f"repro-torch-loc-{location}")
            _LIVE_POOLS.add(self)  # respawned after close(): joined at exit again
        return w

    def _on_pool_thread(self) -> bool:
        cur = threading.current_thread()
        return any(w._thread is cur for w in self._workers.values())

    def _drain(self, state: _SchedulerState) -> None:
        locations = {u.location for u in state.units if u.location >= 0}
        if len(locations) <= 1 or self._on_pool_thread():
            # One location — or a nested compute() called from inside one
            # of our own workers (a map_partitions callback): submitting to
            # the pool from a pool thread would deadlock that location's
            # single-thread queue, so run inline on the calling thread.
            return super()._drain(state)
        for u in state.initial_ready():
            self._submit_unit(u, state)
        state.done.wait()

    def _submit_unit(self, unit: _Unit, state: _SchedulerState) -> None:
        if unit.location < 0:
            # Placement-free unit (the merge): run on the thread that
            # unblocked it; the fold order is fixed by unit indices.
            self._step(unit, state)
        else:
            self._worker(unit.location).submit(lambda: self._step(unit, state))

    def _step(self, unit: _Unit, state: _SchedulerState) -> None:
        for nxt in self._run_unit(unit, state):
            self._submit_unit(nxt, state)

    def _start_entry(self, entry: _PipelineEntry, prev: _PipelineEntry | None) -> None:
        state = entry.state

        def launch(unit: _Unit) -> None:
            if not state.errors:  # poisoned entries stop launching
                self._submit_unit(unit, state)

        self._gate_units(entry, prev, launch)

    def execute_async(self, plan: ExecutionPlan) -> ComputeFuture:
        if self._on_pool_thread():
            # Nested submission from inside one of our own units:
            # pipelining through the pool would queue work behind the very
            # unit that is waiting for it.
            return self._sync_future(plan)
        return super().execute_async(plan)

    def _drain_pipeline(self) -> None:
        if self._on_pool_thread():
            # A pool thread must not block on entries whose units are
            # queued on itself; the pool keeps draining them regardless.
            return
        super()._drain_pipeline()

    def close(self) -> None:
        """Drain in-flight submissions, then stop and join the worker pool
        (idempotent; workers respawn on next use)."""
        self._drain_pipeline()
        for w in self._workers.values():
            w.stop()
        self._workers.clear()
        super().close()
