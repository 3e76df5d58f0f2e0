"""Collection — the fluent, lazy public surface of the execution layer.

::

    from repro_torch.api import Collection, SplIter, LocalExecutor

    result = (
        Collection.from_array(x, block_rows=128, num_locations=8)
        .split(SplIter(partitions_per_location=2))
        .map_blocks(block_fn, extra_args=(centers,))
        .reduce(combine)
        .compute(executor=LocalExecutor())
    )
    result.value, result.report.dispatches

Every fluent method returns a new Collection wrapping a plan node; nothing
executes until ``.compute()``.  Multi-input workloads (points + aligned
labels) zip sources: ``Collection.zip(cx, cy).split(p).map_partitions(f)``.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from repro_torch.api.executors import ComputeResult, Executor, _default_local
from repro_torch.api.futures import ComputeFuture
from repro_torch.api.plan import (
    ExecutionPlan,
    MapBlocks,
    MapPartitions,
    PlanError,
    PlanNode,
    Reduce,
    Source,
    Split,
)
from repro_torch.api.policy import ExecutionPolicy, as_policy
from repro_torch.core.blocked import BlockedArray, PlacementPolicy, contiguous_placement

__all__ = ["Collection"]


class Collection:
    """A lazy, executor-backed view over one or more blocked arrays.

    Nothing executes until :meth:`compute`; every fluent method returns a
    new Collection wrapping a plan node:

    >>> import torch
    >>> from repro_torch.api import Collection, SplIter, LocalExecutor
    >>> res = (
    ...     Collection.from_array(torch.arange(8.0), block_rows=2, num_locations=2,
    ...                           device="cpu")
    ...     .split(SplIter())
    ...     .map_blocks(torch.sum)
    ...     .reduce(lambda a, b: a + b)
    ...     .compute(executor=LocalExecutor())
    ... )
    >>> float(res.value)
    28.0
    >>> res.report.dispatches  # one fused task per location + the merge
    3
    """

    def __init__(self, node: PlanNode):
        self._node = node

    # -- construction ----------------------------------------------------------

    @classmethod
    def from_array(
        cls,
        x,
        block_rows: int,
        *,
        num_locations: int = 1,
        placement: PlacementPolicy = contiguous_placement,
        store=None,
        device: str | torch.device = "cuda",
    ) -> "Collection":
        """Block ``x`` along axis 0 (ragged tail allowed) on ``device`` and
        wrap it; see :meth:`BlockedArray.from_array`."""
        ba = BlockedArray.from_array(
            x, block_rows, num_locations=num_locations, policy=placement,
            store=store, device=device,
        )
        return cls(Source((ba,)))

    @classmethod
    def from_blocked(
        cls, arrays: BlockedArray | Sequence[BlockedArray]
    ) -> "Collection":
        """Wrap existing :class:`BlockedArray` input(s) (must be aligned)."""
        if isinstance(arrays, BlockedArray):
            arrays = (arrays,)
        return cls(Source(tuple(arrays)))

    @classmethod
    def zip(cls, *collections: "Collection") -> "Collection":
        """Zip raw (un-split, un-mapped) collections into one aligned source."""
        arrays: list[BlockedArray] = []
        for c in collections:
            if not isinstance(c._node, Source):
                raise PlanError("Collection.zip requires raw source collections")
            arrays.extend(c._node.arrays)
        return cls(Source(tuple(arrays)))

    # -- the fluent plan builders ----------------------------------------------

    def split(self, policy: ExecutionPolicy | str) -> "Collection":
        """Choose the execution granularity (Baseline / SplIter / Rechunk)."""
        return Collection(Split(self._node, as_policy(policy)))

    def map_blocks(self, fn: Callable[..., Any], *, extra_args: tuple = ()) -> "Collection":
        """Apply ``fn(*blocks, *extra_args)`` per aligned block group.

        ``extra_args`` are operands shared by every task (e.g. the current
        centroids) — arguments, not baked-in constants, so iterative
        callers re-dispatch the same registered task.
        """
        return Collection(MapBlocks(self._node, fn, tuple(extra_args)))

    def map_partitions(self, fn: Callable[..., Any]) -> "Collection":
        """Apply ``fn(view: PartitionView)`` per locality partition."""
        return Collection(MapPartitions(self._node, fn))

    def reduce(self, combine: Callable[[Any, Any], Any]) -> "Collection":
        """Fold all map partials with associative ``combine``."""
        return Collection(Reduce(self._node, combine))

    # -- materialization -------------------------------------------------------

    def plan(self) -> ExecutionPlan:
        """Validate and return the plan IR without executing it."""
        return ExecutionPlan(self._node)

    def compute(self, executor: Executor | None = None) -> ComputeResult:
        """Execute the plan; a fresh :class:`LocalExecutor` when none given."""
        ex = executor if executor is not None else _default_local()
        return ex.execute(self.plan())

    def compute_async(self, executor: Executor | None = None) -> ComputeFuture:
        """Submit the plan without waiting; see ``Executor.execute_async``.

        ``fut.map(fn)`` derives a lazy
        :class:`~repro_torch.api.futures.Deferred` usable as the next
        iteration's ``extra_args`` operand (the loop-carried value).
        """
        ex = executor if executor is not None else _default_local()
        return ex.execute_async(self.plan())

    def __repr__(self) -> str:  # pragma: no cover
        return f"Collection<{type(self._node).__name__}>"
