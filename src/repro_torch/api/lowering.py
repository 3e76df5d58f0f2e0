"""Lowering pass — (plan spec, prepared placement, capabilities) → TaskGraph.

This is the first half of the execution layer's two-stage split
(DESIGN.md §5): *lowering* turns a validated
:class:`~repro_torch.api.plan.MapReduceSpec` plus the prepared placement (the
policy-derived task groups) into a frozen :class:`TaskGraph` of placed,
keyed :class:`Task` descriptors; *scheduling* (the executor backends) then
decides where and when each descriptor runs.

Fusion levels for a reduced ``map_blocks`` under ``SplIter``:

``partition_scan``
    The generic fusion (paper Listing 5): one task per same-shape run of a
    partition's blocks, folding the partition-local reduction over the
    blocks in index order.
``partition_pallas``
    A registered hand-written kernel (``repro_torch.api.kernels``): one
    launch over the run's blocks, read where they lie.  Chosen by the policy's ``fusion``
    knob ("pallas", or "auto" on backends that prefer it) with automatic
    fallback to the fold when no kernel is registered, the kernel rejects
    the shapes, or the plan has multiple inputs.  The kind keeps the JAX
    package's name so both packages describe a plan with the same text.

Task *keys* are stable across plan rebuilds: :func:`stable_task_key`
derives a key from code objects, closures and ``functools.partial``
statics, so an app that recreates its lambdas every call still hits the
engine's task cache.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import pickle
import sys
from typing import Any, Callable, Hashable

import numpy as np
import torch

from repro_torch._pytree import tree_map
from repro_torch.api.chunkstore import ChunkRef
from repro_torch.api.fnref import encode_fn
from repro_torch.api.futures import Deferred, resolve_deferred
from repro_torch.api.kernels import PartitionKernel, partition_kernel_for
from repro_torch.api.plan import MapReduceSpec
from repro_torch.api.policy import SplIter
from repro_torch.core.blocked import BlockedArray

__all__ = [
    "Capabilities",
    "PartitionView",
    "PlacedGroup",
    "Task",
    "MergeSpec",
    "TaskGraph",
    "cross_iteration_edges",
    "dtype_name",
    "fold_plan",
    "planned_fold",
    "lower",
    "inputs_signature",
    "key_summary",
    "partition_key",
    "plan_fingerprint",
    "stable_task_key",
    "stacked_fold",
]


# ---------------------------------------------------------------------------
# stable task keys (task-cache identity that survives plan rebuilds)
# ---------------------------------------------------------------------------


def stable_task_key(fn: Callable) -> Hashable:
    """A hashable identity for ``fn`` stable across re-creations.

    Two callables get the same key iff they share the same code object, the
    same global namespace, the same default arguments, the same closure cell
    values, and (for partials) the same statics — i.e. they compute the same
    function.  Anything non-hashable falls back to the object itself
    (identity keying).  A function whose globals are an imported module's
    namespace names that module, so its key renders the same in every
    process (the JobServer's journaled unit keys rely on it); other
    namespaces are told apart by identity.

    >>> import functools
    >>> def f(x, *, bins):
    ...     return x
    >>> stable_task_key(functools.partial(f, bins=8)) == stable_task_key(
    ...     functools.partial(f, bins=8))
    True
    """
    if isinstance(fn, functools.partial):
        inner = stable_task_key(fn.func)
        try:
            statics = (tuple(fn.args), tuple(sorted(fn.keywords.items())))
            hash(statics)
        except TypeError:
            return fn
        return ("partial", inner, statics)
    code = getattr(fn, "__code__", None)
    if code is None:
        return fn  # builtins / callables: identity is the best we can do
    # the namespace guards against identical bytecode resolving different
    # global bindings (two modules defining the same-looking fn)
    parts: list[Any] = [code, _namespace(fn)]
    defaults = getattr(fn, "__defaults__", None)
    cells = getattr(fn, "__closure__", None)
    try:
        if defaults:
            hash(defaults)
            parts.append(defaults)
        if cells:
            vals = tuple(c.cell_contents for c in cells)
            hash(vals)
            parts.append(vals)
    except (TypeError, ValueError):  # unhashable default/cell, or empty cell
        return fn
    return ("fn", *parts)


def _namespace(fn: Callable) -> Hashable:
    """The identity of ``fn``'s global namespace: its module's name when the
    globals are that module's ``__dict__`` (the same in every process),
    else the namespace's id.

    The JAX package keys on the id alone, so its journaled unit keys differ
    in a restarted process and a resumed job recomputes every unit.
    """
    g = getattr(fn, "__globals__", None)
    name = getattr(fn, "__module__", None)
    module = sys.modules.get(name) if isinstance(name, str) else None
    if g is not None and getattr(module, "__dict__", None) is g:
        return ("module", name)
    return id(g)


def dtype_name(dtype: torch.dtype) -> str:
    """A dtype's short name (``torch.float32`` → ``"float32"``).

    >>> dtype_name(torch.float32)
    'float32'
    """
    return str(dtype).removeprefix("torch.")


def inputs_signature(arrays: tuple) -> tuple:
    """The geometry identity of a set of inputs, independent of object ids.

    Two equal-geometry datasets (same blocking, dtypes and placements) share
    this signature even when the arrays are distinct objects.  It excludes
    buffer *contents*, so it is a cache/tuner sharing key, not a proof of
    data equality.
    """
    return tuple(
        (
            tuple(int(r) for r in a.block_rows),
            tuple(a.row_shape),
            dtype_name(a.dtype),
            int(a.num_locations),
            tuple(int(p) for p in a.placements),
        )
        for a in arrays
    )


def plan_fingerprint(spec: MapReduceSpec, policy=None) -> str:
    """A stable hex digest identifying a plan across processes and restarts.

    Combines the plan shape (kind, fn/combine references via
    :func:`~repro_torch.api.fnref.encode_fn`, extra-arg shapes and dtypes),
    the policy and the :func:`inputs_signature`.  The JobServer journals it
    per submission: equal fingerprints mean "the same work".  Unencodable
    callables degrade to their qualified name, so the fingerprint always
    exists — it is an identity, not a replay payload.
    """

    def fn_part(fn):
        if fn is None:
            return None
        ref = encode_fn(fn)
        if ref is not None:
            return ref
        return getattr(fn, "__qualname__", repr(type(fn)))

    def extra_part(e):
        # A Deferred (pipelined iteration) has no geometry until its source
        # execute resolves; fingerprinting must not block on it.
        if isinstance(e, Deferred):
            return ("deferred",)
        if isinstance(e, torch.Tensor):
            return (tuple(e.shape), dtype_name(e.dtype))
        a = np.asarray(e)
        return (tuple(a.shape), str(a.dtype))

    parts = (
        spec.kind,
        repr(policy if policy is not None else spec.policy),
        fn_part(spec.fn),
        fn_part(spec.combine),
        tuple(extra_part(e) for e in spec.extra_args),
        inputs_signature(spec.inputs),
    )
    return hashlib.sha256(pickle.dumps(parts)).hexdigest()[:32]


def key_summary(key: Hashable) -> str:
    """Short, address-free rendering of a task key (errors, journal keys).

    >>> print(key_summary(("pallas", ("kmeans_partial",))))
    ('pallas', ('kmeans_partial'))
    """
    if isinstance(key, tuple):
        return "(" + ", ".join(key_summary(k) for k in key) + ")"
    name = getattr(key, "co_name", None)
    if name is not None:
        return f"<code {name}>"
    r = repr(key)
    return r if len(r) <= 48 else r[:45] + "..."


# ---------------------------------------------------------------------------
# backend capabilities
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What an executor backend can (and wants to) run.

    Attributes:
      name: backend label (diagnostics only).
      pallas_fusion: backend can execute fused partition kernels; False
        lowers everything to the generic fold.
      prefer_pallas: under ``fusion="auto"`` pick the kernel when one is
        registered; :func:`lower` honours it only for a plan whose arrays
        lie on a CUDA device, where the hand-written kernel runs.
      grouped_dispatch: backend consumes location groups as single sharded
        dispatches (MeshExecutor) rather than per-task calls.
      out_of_core: backend streams chunk-backed blocks under a residency
        budget (StreamExecutor).  Lowering then attaches each task's
        :class:`~repro_torch.api.chunkstore.ChunkRef` operands to the
        descriptor (``Task.chunk_refs``) so the scheduler can
        pin/prefetch/release them around dispatch without materializing
        operands; non-streaming backends skip the bookkeeping (refs still
        resolve lazily inside ``operands()``).
      remote: backend dispatches tasks to other processes.  Not supported
        by this package yet: :func:`lower` raises ``NotImplementedError``.
      pipelined: backend overlaps consecutive ``execute_async`` submissions
        (DESIGN.md §14): iteration *k+1*'s units are gated on their
        same-partition *k* predecessors via :func:`cross_iteration_edges`
        instead of a global drain.  Non-pipelined backends run
        ``execute_async`` as a synchronous execute returning an
        already-completed future — same results, no overlap.

    The JAX package's ``exporter`` capability (the cluster's shared-memory
    data plane) arrives with the cluster backend.
    """

    name: str = "local"
    pallas_fusion: bool = True
    prefer_pallas: bool = False
    grouped_dispatch: bool = False
    out_of_core: bool = False
    remote: bool = False
    pipelined: bool = False


# ---------------------------------------------------------------------------
# prepared placement + partition views
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlacedGroup:
    """One policy-derived task group: which blocks one task consumes, where."""

    location: int
    block_ids: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class PartitionView:
    """A single-location group of aligned blocks, as seen by map_partitions.

    Generalizes :class:`~repro_torch.core.spliter.Partition` to multi-input
    plans and to the Baseline policy, where every block is its own
    single-block partition.
    """

    arrays: tuple[BlockedArray, ...]
    location: int
    block_ids: tuple[int, ...]

    @property
    def blocks(self) -> list[torch.Tensor]:
        """Blocks of the first (or only) input array."""
        return self.blocks_of(0)

    def blocks_of(self, i: int) -> list[torch.Tensor]:
        return [self.arrays[i].block(b) for b in self.block_ids]

    @property
    def num_rows(self) -> int:
        return int(sum(self.arrays[0].block_rows[b] for b in self.block_ids))

    @property
    def item_indexes(self) -> np.ndarray:
        """Global row ids of every element (paper §4.1 ``get_item_indexes``)."""
        x = self.arrays[0]
        offs = x.row_offsets()
        rows = x.block_rows
        return np.concatenate(
            [np.arange(offs[b], offs[b] + rows[b], dtype=np.int64) for b in self.block_ids]
        )

    @property
    def materialized(self) -> tuple[torch.Tensor, ...]:
        """Local concat of each input's blocks — intra-location copy only."""
        return tuple(
            torch.cat(self.blocks_of(i), dim=0) for i in range(len(self.arrays))
        )


# ---------------------------------------------------------------------------
# the TaskGraph IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Task:
    """One placed, keyed task descriptor.

    ``operands()`` builds the operand tuple lazily (stacking/concatenating
    block buffers only when the task actually runs; a ``partition_pallas``
    task's data operand is the tuple of its blocks); the first ``n_data``
    operands are per-task data, the rest are plan-wide extras shared by
    every task of the same ``key``.

    ``counted=False`` marks tasks that are *driver* work rather than engine
    dispatches (map_partitions views: the view callback itself dispatches
    engine tasks).
    """

    index: int
    location: int
    kind: str                # "block" | "partition_scan" | "partition_pallas"
                             # | "partition_materialized" | "partition_view"
    key: Hashable
    fn: Callable
    operands: Callable[[], tuple]
    block_ids: tuple[int, ...]
    n_data: int = 1
    counted: bool = True
    kernel_name: str | None = None
    #: ((shape, dtype_name), ...) of the per-task data operands — lets
    #: profiling size a task WITHOUT materializing operands.
    data_shapes: tuple = ()
    #: store-held chunk refs this task's operands resolve — populated only
    #: for out-of-core backends (``Capabilities.out_of_core``), which
    #: pin/prefetch/release them around dispatch.
    chunk_refs: tuple = ()


@dataclasses.dataclass(frozen=True)
class MergeSpec:
    """The final fold over task partials (the paper's @reduction task)."""

    combine: Callable[[Any, Any], Any]
    key: Hashable


@dataclasses.dataclass(frozen=True)
class TaskGraph:
    """Frozen result of lowering: placed tasks + the merge contract.

    Executors consume this and nothing else: scheduling a TaskGraph must
    produce the per-task partials in ``tasks`` order, then apply ``merge``
    in plan order.
    """

    tasks: tuple[Task, ...]
    merge: MergeSpec | None
    spec: MapReduceSpec

    @property
    def locations(self) -> tuple[int, ...]:
        return tuple(sorted({t.location for t in self.tasks}))

    def by_location(self) -> dict[int, list[Task]]:
        out: dict[int, list[Task]] = {}
        for t in self.tasks:
            out.setdefault(t.location, []).append(t)
        return out

    def describe(self) -> str:
        """One line per task: index, placement, kind, key summary.

        Free of memory addresses and other run-varying detail, and equal
        to the JAX package's text for the same plan, so the output is
        golden-testable against the reference.
        """
        lines = []
        for t in self.tasks:
            extra = f" kernel={t.kernel_name}" if t.kernel_name else ""
            lines.append(
                f"[{t.index}] loc={t.location} {t.kind} blocks={t.block_ids}{extra}"
            )
        if self.merge is not None:
            c = self.merge.combine
            name = getattr(c, "__name__", type(c).__name__)
            lines.append(f"[merge] combine={name}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# cross-iteration dependency edges (pipelined iteration, DESIGN.md §14)
# ---------------------------------------------------------------------------


def partition_key(task: Task) -> tuple:
    """The stable identity of the data partition one task covers:
    ``(location, block_ids)``, the same every iteration of a workload."""
    return (task.location, task.block_ids)


def cross_iteration_edges(prev: TaskGraph, nxt: TaskGraph) -> dict[int, tuple[int, ...]]:
    """Same-partition dependency edges from ``nxt``'s tasks to ``prev``'s.

    For consecutive pipelined executes, each task of ``nxt`` depends on the
    ``prev`` tasks covering the same :func:`partition_key`.  Keys are task
    indices in ``nxt``; values are matching task indices in ``prev``.
    Tasks with no same-partition predecessor (a retune re-partitioned the
    data) are absent from the mapping.
    """
    by_part: dict[tuple, list[int]] = {}
    for t in prev.tasks:
        by_part.setdefault(partition_key(t), []).append(t.index)
    out: dict[int, tuple[int, ...]] = {}
    for t in nxt.tasks:
        deps = by_part.get(partition_key(t))
        if deps:
            out[t.index] = tuple(deps)
    return out


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------


def stacked_fold(combine: Callable[[Any, Any], Any]) -> Callable[[Any], Any]:
    """Fold a stacked pytree of partials (leading axis) in index order.

    ``stacked_fold(c)(stacked)`` = ``c(c(s[0], s[1]), s[2]) ...`` — the
    single source of truth for "reduce N partials with an associative
    combine" (the host-side merge task folds stacked task partials with it).

    >>> import torch
    >>> stacked_fold(lambda a, b: 2 * a + b)(torch.tensor([1, 2, 3]))
    tensor(11)
    """

    def fold(stacked):
        n = _leading(stacked)
        acc = tree_map(lambda s: s[0], stacked)
        for i in range(1, n):
            acc = combine(acc, tree_map(lambda s, i=i: s[i], stacked))
        return acc

    return fold


def _leading(stacked) -> int:
    """The leading-axis length of a stacked pytree."""
    while isinstance(stacked, (tuple, list, dict)):
        stacked = next(iter(stacked.values() if isinstance(stacked, dict) else stacked))
    return stacked.shape[0]


def fold_plan(entries) -> tuple[tuple[int, tuple[int, ...]], ...]:
    """The canonical merge tree over ``(index, location)`` pairs.

    Returns ``((location, member_indices), ...)`` — one fold group per
    location, members in entry order, groups in first-appearance order of
    their location.  Each group's members reduce left-to-right (one
    :func:`stacked_fold` chain), then the per-group values reduce
    left-to-right in group order.

    >>> fold_plan([(0, 1), (1, 1), (2, 0), (3, 0)])
    ((1, (0, 1)), (0, (2, 3)))
    >>> fold_plan([(0, -1)])
    ((-1, (0,)),)
    """
    groups: dict[int, list[int]] = {}
    order: list[int] = []
    for idx, loc in entries:
        if loc not in groups:
            groups[loc] = []
            order.append(loc)
        groups[loc].append(idx)
    return tuple((loc, tuple(groups[loc])) for loc in order)


def planned_fold(
    combine: Callable[[Any, Any], Any],
    groups: tuple[tuple[int, ...], ...],
) -> Callable[[Any], Any]:
    """Fold a stacked pytree of partials along a :func:`fold_plan` tree.

    Reduces each group's members with the :func:`stacked_fold` chain, then
    chains the group values in group order.  Degenerates to
    ``stacked_fold(c)`` for a single group.  One task, one dispatch.

    >>> import torch
    >>> planned_fold(lambda a, b: 2 * a + b, ((0, 2), (1, 3)))(torch.tensor([1, 2, 3, 4]))
    tensor(18)
    """
    chain = stacked_fold(combine)

    def fold(stacked):
        accs = []
        for members in groups:
            if len(members) == 1:
                accs.append(tree_map(lambda s, i=members[0]: s[i], stacked))
            else:
                idx = list(members)
                accs.append(chain(tree_map(lambda s, x=idx: s[x], stacked)))
        if len(accs) == 1:
            return accs[0]
        return chain(tree_map(lambda *xs: torch.stack(xs, 0), *accs))

    return fold


def _partition_body(block_fn: Callable, combine: Callable, n_in: int) -> Callable:
    """The fused per-partition task (paper Listing 5 as a left fold)."""

    def partition_task(*operands):
        data, extra = operands[:n_in], operands[n_in:]
        acc = block_fn(*(s[0] for s in data), *extra)
        for i in range(1, data[0].shape[0]):
            acc = combine(acc, block_fn(*(s[i] for s in data), *extra))
        return acc

    return partition_task


def _pick_fusion(
    policy,
    caps: Capabilities,
    kernel: PartitionKernel | None,
    stacked_shape: tuple,
    extra_args: tuple,
) -> str:
    """Resolve the SplIter ``fusion`` knob for one same-shape run."""
    mode = getattr(policy, "fusion", "auto")
    if mode == "scan" or not caps.pallas_fusion:
        return "scan"
    if kernel is None or not kernel.supported(stacked_shape, extra_args):
        return "scan"  # automatic fallback: no kernel, or shapes rejected
    if mode == "pallas":
        return "pallas"
    return "pallas" if caps.prefer_pallas else "scan"


def lower(
    spec: MapReduceSpec,
    arrays: tuple[BlockedArray, ...],
    groups: list[PlacedGroup],
    caps: Capabilities,
) -> TaskGraph:
    """Lower a normalized plan over prepared placement into a TaskGraph.

    ``arrays``/``groups`` are the policy's prepared form (already rechunked
    for ``Rechunk``; the original arrays plus partition groups otherwise) —
    executors compute them once per ``(inputs, policy)`` and cache.
    """
    if caps.remote:
        raise NotImplementedError(
            "remote (multi-process) lowering is not ported to repro_torch yet"
        )
    # The kernel launches only on CUDA operands: a plan over CPU blocks lowers
    # as the reference's CPU plan does, whatever devices the host has.
    if caps.prefer_pallas and not all(a.device.type == "cuda" for a in arrays):
        caps = dataclasses.replace(caps, prefer_pallas=False)
    merge = (
        MergeSpec(spec.combine, key=("merge", stable_task_key(spec.combine)))
        if spec.combine is not None
        else None
    )

    if spec.kind == "map_partitions":
        tasks = _lower_partition_views(spec, arrays, groups, caps)
    else:
        tasks = _lower_map_blocks(spec, arrays, groups, caps)
    return TaskGraph(tasks=tuple(tasks), merge=merge, spec=spec)


def _refs_of(arrays, ids, caps: Capabilities) -> tuple:
    """The chunk refs a task over ``ids`` resolves — out-of-core backends only."""
    if not caps.out_of_core:
        return ()
    return tuple(
        a.blocks[i] for a in arrays for i in ids if isinstance(a.blocks[i], ChunkRef)
    )


def _lower_partition_views(spec, arrays, groups, caps: Capabilities) -> list[Task]:
    tasks = []
    for g in groups:
        view = PartitionView(arrays=arrays, location=g.location, block_ids=g.block_ids)
        tasks.append(
            Task(
                index=len(tasks),
                location=g.location,
                kind="partition_view",
                key=None,
                fn=spec.fn,
                operands=(lambda view=view: (view,)),
                block_ids=g.block_ids,
                n_data=1,
                counted=False,
                chunk_refs=_refs_of(arrays, g.block_ids, caps),
            )
        )
    return tasks


def _lower_map_blocks(spec, arrays, groups, caps: Capabilities) -> list[Task]:
    extra = spec.extra_args
    n_in = len(arrays)
    pol = spec.policy
    fn_key = stable_task_key(spec.fn)
    tasks: list[Task] = []

    fused = isinstance(pol, SplIter) and not pol.materialize and spec.combine is not None
    if fused:
        # Fused iteration: ONE dispatch folding (or one kernel over) the
        # partition's local blocks, carrying the partition-local reduction.
        # Ragged tails lower per same-shape run — at most one extra task per
        # tail, so C1's dispatch bound survives the fusion choice.
        kernel = partition_kernel_for(spec.fn) if n_in == 1 else None
        scan_fn = _partition_body(spec.fn, spec.combine, n_in)
        scan_key = ("part", fn_key, stable_task_key(spec.combine), n_in)
        for g in groups:
            by_shape: dict[tuple, list[int]] = {}
            for b in g.block_ids:
                by_shape.setdefault(tuple(arrays[0].blocks[b].shape), []).append(b)
            for shape, ids in by_shape.items():
                ids = tuple(ids)
                stacked_shape = (len(ids), *shape)
                choice = _pick_fusion(pol, caps, kernel, stacked_shape, extra)

                if choice == "pallas":
                    # The kernel takes the run's blocks where they lie: no
                    # copy (SplIter's partitions move no data).
                    def operands(ids=ids):
                        return tuple(
                            tuple(a.block(b) for b in ids) for a in arrays
                        ) + tuple(resolve_deferred(e) for e in extra)

                    task_fn, key, kname = kernel.fn, ("pallas", kernel.key), kernel.name
                else:
                    # The scan folds one stacked operand, as the JAX package's
                    # does: a copy of the run's blocks per dispatch.
                    def operands(ids=ids):
                        return tuple(
                            torch.stack([a.block(b) for b in ids], dim=0) for a in arrays
                        ) + tuple(resolve_deferred(e) for e in extra)

                    task_fn, key, kname = scan_fn, scan_key, None
                tasks.append(
                    Task(
                        index=len(tasks),
                        location=g.location,
                        kind=f"partition_{choice}",
                        key=key,
                        fn=task_fn,
                        operands=operands,
                        block_ids=ids,
                        n_data=n_in,
                        kernel_name=kname,
                        chunk_refs=_refs_of(arrays, ids, caps),
                        data_shapes=tuple(
                            (
                                (len(ids), *a.blocks[ids[0]].shape),
                                dtype_name(a.blocks[ids[0]].dtype),
                            )
                            for a in arrays
                        ),
                    )
                )
    elif isinstance(pol, SplIter) and pol.materialize:
        # Materialized partition (paper §7): local concat, one call.
        for g in groups:
            def operands(g=g):
                return tuple(
                    torch.cat([a.block(b) for b in g.block_ids], dim=0)
                    for a in arrays
                ) + tuple(resolve_deferred(e) for e in extra)

            tasks.append(
                Task(
                    index=len(tasks),
                    location=g.location,
                    kind="partition_materialized",
                    key=("block", fn_key),
                    fn=spec.fn,
                    operands=operands,
                    block_ids=g.block_ids,
                    n_data=n_in,
                    chunk_refs=_refs_of(arrays, g.block_ids, caps),
                    data_shapes=tuple(
                        (
                            (
                                sum(a.blocks[b].shape[0] for b in g.block_ids),
                                *a.blocks[g.block_ids[0]].shape[1:],
                            ),
                            dtype_name(a.blocks[g.block_ids[0]].dtype),
                        )
                        for a in arrays
                    ),
                )
            )
    else:
        # Baseline / Rechunk (single-block groups), or an un-reduced SplIter
        # map: one task per block, in GLOBAL block order so an un-reduced
        # compute() returns partials aligned with the blocking regardless of
        # policy/partition layout.
        placed = sorted((b, g.location) for g in groups for b in g.block_ids)
        for b, loc in placed:
            def operands(b=b):
                return tuple(a.block(b) for a in arrays) + tuple(
                    resolve_deferred(e) for e in extra
                )

            tasks.append(
                Task(
                    index=len(tasks),
                    location=loc,
                    kind="block",
                    key=("block", fn_key),
                    fn=spec.fn,
                    operands=operands,
                    block_ids=(b,),
                    n_data=n_in,
                    chunk_refs=_refs_of(arrays, (b,), caps),
                    data_shapes=tuple(
                        (tuple(a.blocks[b].shape), dtype_name(a.blocks[b].dtype))
                        for a in arrays
                    ),
                )
            )
    return tasks
