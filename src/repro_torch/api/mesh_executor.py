"""MeshExecutor — sharded scheduling of a TaskGraph over a list of devices.

The mesh backend of the execution layer (DESIGN.md §5.3–§5.4): logical
*locations* are mapped onto a 1-D mesh of *ranks* and all partition tasks
of a same-signature run execute as ONE sharded dispatch.  Where
LocalExecutor emits one host dispatch per task and ThreadedExecutor
overlaps them with threads, MeshExecutor buckets the tasks of a lowered
:class:`~repro_torch.api.lowering.TaskGraph` by signature, gives rank *r*
the *r*-th contiguous share of a bucket, folds each rank's tasks on its
device with the plan's combine (first task, then ``combine`` in bucket
order — the arithmetic of the JAX package's ``_partition_body`` over the
group axis), and merges across ranks the way an all-gather + fold does:
each rank's partial is copied to rank 0's device and the partials fold in
rank order with :func:`~repro_torch.api.lowering.stacked_fold`, the same
fold the host-side merge task runs.

One process drives every rank, as ``shard_map`` is one program over one
process's devices: rank *r* is position *r* of ``devices``.  Each task's
operands are its own (a ``partition_pallas`` task's blocks where they lie,
a scan task's stacked run), moved to the rank's device when it differs:
nothing is stacked along the group axis, so a pass copies no dataset.
Kernel launches are asynchronous, so ranks on different cards overlap.

Accounting maps onto the existing :class:`~repro_torch.core.engine.EngineReport`:

* ``dispatches`` — sharded calls (one per same-signature task run), not
  per-task invocations; still bounded by C1.
* ``bytes_moved`` — the collective traffic estimate: each of the M ranks
  receives the other M-1 partial pytrees, so one cross-rank merge bills
  ``(M - 1) × partial_nbytes``.  Operand copies to a rank's device are
  not billed, as in the JAX package.
* ``merges`` — cross-rank merges (plus the plan-order fold over distinct
  task runs, e.g. ragged tails, exactly as on the other backends).

Tasks that cannot be bucketed — ``map_partitions`` views, un-reduced
maps, singleton runs — fall back to per-task dispatch, so every plan the
other backends accept runs here too, and results agree up to float
reassociation (C4).  Buckets preserve graph task order; with interleaved
signatures (a ragged run between uniform ones) partials fold bucket by
bucket, which reorders the combine relative to LocalExecutor: combines
must be commutative up to float reassociation for this backend.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Sequence

import torch

from repro_torch._pytree import tree_map
from repro_torch.api.executors import _PlanExecutor, _tree_nbytes, _Unit
from repro_torch.api.lowering import Capabilities, Task, TaskGraph, stacked_fold
from repro_torch.core.engine import TaskEngine

__all__ = ["MeshExecutor"]


def _to_device(ops: tuple, device: torch.device) -> tuple:
    """Operands on ``device`` (a no-op for tensors already there)."""

    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, (tuple, list)):  # a partition_pallas task's block list
            return type(x)(move(b) for b in x)
        return x

    return tuple(move(x) for x in ops)


def _mesh_program(fn: Callable, combine: Callable) -> Callable:
    """The sharded program of one bucket signature.

    ``program(devices, operands)`` folds rank *r*'s contiguous share of
    ``operands`` (each task's operand thunk, bucket order) on
    ``devices[r]``, then gathers the rank partials on ``devices[0]`` and
    folds them in rank order.  A thunk runs just before its task, so at most
    one task's operands (a scan task's stacked run) are alive at a time, as
    on LocalExecutor.  ``devices`` is an argument, not a closure: the
    engine serves every later call of the same key with this first
    registration.
    """
    fold = stacked_fold(combine)

    def program(devices: Sequence[torch.device], operands: Sequence[Callable]) -> Any:
        m = len(devices)
        share = len(operands) // m
        partials = []
        for r, dev in enumerate(devices):
            on_card = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
            with on_card:
                acc = None
                for thunk in operands[r * share:(r + 1) * share]:
                    part = fn(*_to_device(thunk(), dev))
                    acc = part if acc is None else combine(acc, part)
            partials.append(acc)
        if m == 1:
            return partials[0]
        root = devices[0]
        gathered = tree_map(lambda *xs: torch.stack([x.to(root) for x in xs], 0), *partials)
        return fold(gathered)

    return program


class MeshExecutor(_PlanExecutor):
    """Execute same-signature task runs as sharded dispatches over devices.

    Args:
      engine: shared :class:`TaskEngine` (accounting + task cache).
      devices: the mesh's ranks, in order; ``None`` means the visible CUDA
        devices.  A host without one raises: pass ``devices`` explicitly
        (``devices=(torch.device("cpu"),)`` on the CPU).  A device may
        appear more than once — ``devices=(torch.device("cuda", 0),) * 8``
        stands up an 8-rank mesh on one card, as the JAX package's tests
        force 8 host devices (torch has no such flag).  The mesh size for a
        run of G tasks is the largest divisor of G not exceeding the rank
        count (1 on a one-rank mesh — still one sharded dispatch, with zero
        collective traffic).
      axis_name: the mesh axis name (kept for the JAX package's signature;
        a 1-D mesh has one axis).
    """

    def __init__(
        self,
        engine: TaskEngine | None = None,
        *,
        devices=None,
        axis_name: str = "loc",
    ):
        super().__init__(engine)
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "MeshExecutor(devices=None) means the visible CUDA devices and "
                    "this host has none; pass devices=(torch.device('cpu'),) to run "
                    "the mesh on the CPU"
                )
            devices = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
        self._devices = tuple(torch.device(d) for d in devices)
        if not self._devices:
            raise ValueError("MeshExecutor needs at least one device in `devices`")
        self.axis_name = axis_name

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return self._devices

    @property
    def capabilities(self) -> Capabilities:
        # lower() keeps the kernel preference only for blocks on a card.
        return Capabilities(
            name=type(self).__name__, prefer_pallas=True, grouped_dispatch=True
        )

    @staticmethod
    def _axis_size(n_tasks: int, n_devices: int) -> int:
        """Largest mesh size that evenly tiles the bucket's tasks."""
        for m in range(min(n_tasks, max(n_devices, 1)), 0, -1):
            if n_tasks % m == 0:
                return m
        return 1

    # -- scheduling ------------------------------------------------------------

    def _plan_dispatches(self, graph: TaskGraph) -> list[_Unit]:
        """Bucketed dispatch units for the shared scheduler core.

        Tasks with the same dispatch signature — same task key + same
        per-task data shapes — form ONE sharded unit, PRESERVING graph task
        order, so within a bucket the fold visits partials in plan order
        (lowering emits partition tasks location-major, which maps
        contiguous location groups onto contiguous ranks).  Operands stay
        lazy: buckets form from ``Task.data_shapes`` metadata.  Views,
        un-reduced maps and singleton buckets fall back to per-task units.
        """
        if graph.merge is None or not graph.tasks or any(
            not t.counted for t in graph.tasks
        ):
            return super()._plan_dispatches(graph)

        buckets: dict[tuple, list[Task]] = {}
        for t in graph.tasks:
            buckets.setdefault((t.key, t.data_shapes), []).append(t)

        units: list[_Unit] = []
        for tasks in buckets.values():
            if len(tasks) == 1:
                t = tasks[0]
                units.append(
                    _Unit(index=len(units), location=t.location, tasks=(t,),
                          run=self._bind(t), kind=t.kind)
                )
            else:
                units.append(
                    _Unit(
                        index=len(units),
                        location=-1,
                        tasks=tuple(tasks),
                        run=functools.partial(self._sharded_dispatch, graph, tasks),
                        kind="sharded",
                    )
                )
        return units

    def _sharded_dispatch(self, graph: TaskGraph, tasks: list[Task]) -> Any:
        t0 = tasks[0]
        g = len(tasks)
        m = self._axis_size(g, len(self._devices))
        # the key carries the merge identity too: the same map fn reduced by
        # a different combine must not reuse this fold
        key = ("mesh", t0.key, graph.merge.key, m, t0.data_shapes, g)
        program = self.engine.task(_mesh_program(t0.fn, graph.merge.combine), key=key)
        value = program(self._devices[:m], [t.operands for t in tasks])
        if m > 1:
            report = self.engine.current_report
            report.merges += 1
            report.bytes_moved += (m - 1) * _tree_nbytes(value)
        return value
