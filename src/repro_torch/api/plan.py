"""Execution plan IR — the lazy middle layer between Collection and Executor.

A :class:`repro_torch.api.Collection` method chain builds a linked list of small
frozen node dataclasses; nothing runs until ``.compute(executor=...)``.
The grammar accepted by executors is

::

    plan    := [Reduce] map [Split] Source
    map     := MapBlocks | MapPartitions

:class:`ExecutionPlan` normalizes a node chain into a flat
:class:`MapReduceSpec` at construction time, so malformed chains fail fast
(with a :class:`PlanError`) instead of failing mid-execution, and every
executor backend consumes the same validated spec.  ``describe()`` renders
the plan for logging / DESIGN.md examples.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from repro_torch.api.policy import Baseline, ExecutionPolicy
from repro_torch.core.blocked import BlockedArray

__all__ = [
    "PlanError",
    "PlanNode",
    "Source",
    "Split",
    "MapBlocks",
    "MapPartitions",
    "Reduce",
    "MapReduceSpec",
    "ExecutionPlan",
]


class PlanError(ValueError):
    """A Collection chain does not form a valid execution plan."""


@dataclasses.dataclass(frozen=True)
class PlanNode:
    """Base class of plan IR nodes."""


@dataclasses.dataclass(frozen=True)
class Source(PlanNode):
    """Leaf: one or more blocking-aligned :class:`BlockedArray` inputs."""

    arrays: tuple[BlockedArray, ...]


@dataclasses.dataclass(frozen=True)
class Split(PlanNode):
    """Derive task granularity from the blocking via an ExecutionPolicy."""

    child: PlanNode
    policy: ExecutionPolicy


@dataclasses.dataclass(frozen=True)
class MapBlocks(PlanNode):
    """Apply ``fn(*blocks, *extra_args)`` to every aligned block group."""

    child: PlanNode
    fn: Callable[..., Any]
    extra_args: tuple = ()


@dataclasses.dataclass(frozen=True)
class MapPartitions(PlanNode):
    """Apply ``fn(view)`` to every :class:`~repro_torch.api.executors.PartitionView`.

    Under :class:`~repro_torch.api.policy.Baseline` each block is its own
    single-block partition, so the same app code expresses both the
    per-block and the consolidated (SplIter) execution — this is what
    removes the hand-written mode plumbing from k-NN and Cascade SVM.
    """

    child: PlanNode
    fn: Callable[..., Any]


@dataclasses.dataclass(frozen=True)
class Reduce(PlanNode):
    """Fold all map partials with an associative ``combine`` into one value."""

    child: PlanNode
    combine: Callable[[Any, Any], Any]


@dataclasses.dataclass(frozen=True)
class MapReduceSpec:
    """Normalized, validated view of a plan — what executors consume."""

    inputs: tuple[BlockedArray, ...]
    policy: ExecutionPolicy
    kind: str                       # "map_blocks" | "map_partitions"
    fn: Callable[..., Any]
    extra_args: tuple
    combine: Callable[[Any, Any], Any] | None


def _normalize(root: PlanNode) -> MapReduceSpec:
    node = root
    combine = None
    if isinstance(node, Reduce):
        combine = node.combine
        node = node.child

    if isinstance(node, MapBlocks):
        kind, fn, extra = "map_blocks", node.fn, node.extra_args
        node = node.child
    elif isinstance(node, MapPartitions):
        kind, fn, extra = "map_partitions", node.fn, ()
        node = node.child
    elif isinstance(node, (Source, Split)):
        raise PlanError("plan has no map stage; call .map_blocks() or .map_partitions()")
    else:
        raise PlanError(f"unexpected node under Reduce: {type(node).__name__}")

    policy: ExecutionPolicy = Baseline()
    if isinstance(node, Split):
        policy = node.policy
        node = node.child

    if not isinstance(node, Source):
        raise PlanError(
            f"expected Source at the bottom of the plan, got {type(node).__name__} "
            "(only one map stage and one split are supported per plan)"
        )
    inputs = node.arrays
    if not inputs:
        raise PlanError("empty Source")
    x0 = inputs[0]
    for a in inputs[1:]:
        if a.num_blocks != x0.num_blocks or not np.array_equal(a.placements, x0.placements):
            raise PlanError("Source inputs must be blocking-aligned (same blocks/placements)")
    return MapReduceSpec(
        inputs=inputs, policy=policy, kind=kind, fn=fn, extra_args=tuple(extra),
        combine=combine,
    )


class ExecutionPlan:
    """A validated plan: the node chain plus its normalized spec."""

    def __init__(self, root: PlanNode):
        self.root = root
        self.spec = _normalize(root)

    def describe(self) -> str:
        """Render the plan bottom-up, one node per line."""
        s = self.spec
        x0 = s.inputs[0]
        lines = [
            f"Source({len(s.inputs)} array(s), {x0.num_blocks} blocks, "
            f"{x0.num_locations} locations)",
            f"Split({s.policy!r})",
        ]
        fn_name = getattr(s.fn, "__name__", type(s.fn).__name__)
        if s.kind == "map_blocks":
            lines.append(f"MapBlocks({fn_name}, extra_args={len(s.extra_args)})")
        else:
            lines.append(f"MapPartitions({fn_name})")
        if s.combine is not None:
            cname = getattr(s.combine, "__name__", type(s.combine).__name__)
            lines.append(f"Reduce({cname})")
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover
        return f"ExecutionPlan(\n  " + self.describe().replace("\n", "\n  ") + "\n)"
