"""Per-task profiling — the *measure* third of the adaptive-granularity loop.

Every executor backend schedules its :class:`~repro_torch.api.lowering.TaskGraph`
through the shared scheduler core in :mod:`repro_torch.api.executors`, and that
core emits one :class:`ProfileEvent` per scheduled unit (a task, a sharded
mesh bucket, or the merge) into the executor's :class:`ProfileStore`.
Events aggregate into :class:`TaskProfile` records keyed by the task's
*signature* — its :func:`~repro_torch.api.lowering.stable_task_key` plus the
per-task data shapes — so an iterative workload accumulates one profile per
distinct compiled program, not one per invocation.

What is measured per unit (DESIGN.md §9):

``dispatch_s``
    Time for the dispatch call to *return*.  Under CUDA's asynchronous
    launches this is the host-side overhead — the quantity the Tiny-Tasks
    granularity model (Bora et al., arXiv:2202.11464) calls the per-task
    overhead ``o``.
``wall_s``
    Time until the unit's outputs are ready (a device synchronise), i.e.
    dispatch + compute.  Only measured when the store's ``sync`` flag is
    on; the default is **off**, because blocking per unit would serialize
    the async-dispatch pipeline the executors rely on (the measurement
    must not distort the thing measured).  The autotuner turns ``sync``
    on only for its probe iterations; with it off, ``wall_s ==
    dispatch_s``.
``nbytes`` / ``rows``
    Input footprint, derived from the task descriptors' ``data_shapes`` —
    no operand materialization, so recording is O(1) per unit.

The store is consumed by :mod:`repro_torch.api.autotune` (per-task overhead
estimates seed the cost model) and is inspectable by users via
``executor.profile.snapshot()``.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Hashable, Iterable, Sequence

import numpy as np
import torch

__all__ = ["ProfileEvent", "TaskProfile", "ProfileStore", "signature_nbytes"]


def signature_nbytes(data_shapes: tuple) -> int:
    """Bytes of the per-task data operands described by ``Task.data_shapes``
    (dtypes by their torch name, e.g. ``"float32"``)."""
    total = 0
    for shape, dtype in data_shapes:
        total += int(np.prod(shape)) * getattr(torch, dtype).itemsize
    return total


def _signature_rows(kind: str, data_shapes: tuple) -> int:
    """Input rows of the first data operand (cost-model work proxy).

    Stacked partition operands are ``(k, block_rows, *row)`` — rows is the
    product of the two leading dims; everything else is ``(rows, *row)``.
    """
    if not data_shapes:
        return 0
    shape = data_shapes[0][0]
    if kind in ("partition_scan", "partition_pallas") and len(shape) >= 2:
        return int(shape[0]) * int(shape[1])
    return int(shape[0]) if shape else 0


@dataclasses.dataclass(frozen=True)
class ProfileEvent:
    """One scheduled unit, as observed by the scheduler core."""

    key: Hashable                # stable task key (None for driver views)
    kind: str                    # Task.kind | "sharded" | "merge"
    location: int                # placement (-1: any / caller)
    tasks: int                   # graph tasks covered (mesh buckets: >1)
    blocks: int                  # source blocks covered
    rows: int                    # input rows (first data operand)
    nbytes: int                  # input bytes across data operands
    dispatch_s: float            # host-side dispatch overhead
    wall_s: float                # dispatch + compute (== dispatch_s if !sync)


@dataclasses.dataclass
class TaskProfile:
    """Aggregate over all events sharing one (key, data_shapes) signature."""

    key: Hashable
    data_shapes: tuple
    kind: str
    calls: int = 0
    tasks: int = 0
    blocks: int = 0
    rows: int = 0
    nbytes: int = 0
    dispatch_s: float = 0.0
    wall_s: float = 0.0

    def add(self, event: ProfileEvent) -> None:
        self.calls += 1
        self.tasks += event.tasks
        self.blocks += event.blocks
        self.rows += event.rows
        self.nbytes += event.nbytes
        self.dispatch_s += event.dispatch_s
        self.wall_s += event.wall_s

    @property
    def mean_dispatch_s(self) -> float:
        return self.dispatch_s / self.calls if self.calls else 0.0

    @property
    def mean_wall_s(self) -> float:
        return self.wall_s / self.calls if self.calls else 0.0

    @property
    def seconds_per_row(self) -> float:
        return self.wall_s / self.rows if self.rows else 0.0


class ProfileStore:
    """Thread-safe per-executor store of profile events and aggregates.

    ``sync=True`` blocks on each unit's outputs so ``wall_s`` covers
    compute; the default ``sync=False`` only times the dispatch overhead
    and never introduces extra synchronization points into scheduling
    (the executors flip it on transiently while the autotuner probes).
    A bounded deque of recent raw events is kept for inspection; the
    per-signature aggregates are unbounded but small (one per compiled
    program).
    """

    def __init__(self, *, sync: bool = False, keep_events: int = 256):
        self.sync = sync
        self.events: collections.deque[ProfileEvent] = collections.deque(
            maxlen=keep_events
        )
        self.profiles: dict[tuple, TaskProfile] = {}
        self._lock = threading.Lock()

    def record_tasks(
        self,
        tasks: Sequence[Any],
        *,
        kind: str,
        location: int,
        dispatch_s: float,
        wall_s: float,
    ) -> ProfileEvent:
        """Record one scheduled unit covering ``tasks`` graph descriptors.

        ``tasks`` duck-types :class:`~repro_torch.api.lowering.Task` (``key``,
        ``kind``, ``block_ids``, ``data_shapes``); an empty sequence records
        a task-less unit (the merge) under ``key=None``.
        """
        if tasks:
            t0 = tasks[0]
            key, shapes = t0.key, t0.data_shapes
            blocks = sum(len(t.block_ids) for t in tasks)
            rows = sum(_signature_rows(t.kind, t.data_shapes) for t in tasks)
            nbytes = sum(signature_nbytes(t.data_shapes) for t in tasks)
        else:
            key, shapes, blocks, rows, nbytes = None, (), 0, 0, 0
        event = ProfileEvent(
            key=key,
            kind=kind,
            location=location,
            tasks=max(len(tasks), 1),
            blocks=blocks,
            rows=rows,
            nbytes=nbytes,
            dispatch_s=dispatch_s,
            wall_s=wall_s,
        )
        sig = (_hashable(key), shapes, kind)
        with self._lock:
            self.events.append(event)
            prof = self.profiles.get(sig)
            if prof is None:
                prof = self.profiles[sig] = TaskProfile(
                    key=key, data_shapes=shapes, kind=kind
                )
            prof.add(event)
        return event

    # -- read side -----------------------------------------------------------

    def snapshot(self) -> list[TaskProfile]:
        """Aggregates, most expensive first (copy; safe to hold)."""
        with self._lock:
            profs = [dataclasses.replace(p) for p in self.profiles.values()]
        return sorted(profs, key=lambda p: -p.wall_s)

    def mean_task_overhead_s(
        self,
        kinds: Iterable[str] | None = None,
        keys: Iterable[Hashable] | None = None,
    ) -> float:
        """Mean per-task dispatch overhead across (optionally filtered) kinds.

        This is the measured seed for the cost model's per-task overhead
        coefficient when too few granularities have been sampled to fit.
        ``keys`` restricts the mean to specific task identities so one
        workload's hint is not polluted by everything else the executor
        ever ran.
        """
        key_set = None if keys is None else set(keys)
        with self._lock:
            profs = [
                p
                for p in self.profiles.values()
                if (kinds is None or p.kind in kinds)
                and (key_set is None or p.key in key_set)
            ]
            tasks = sum(p.tasks for p in profs)
            overhead = sum(p.dispatch_s for p in profs)
        return overhead / tasks if tasks else 0.0

    def merge(self, other: "ProfileStore") -> None:
        """Fold another store's aggregates into this one (events included).

        The shared-asset adoption path: when an executor joins a
        :class:`~repro_torch.api.executors.SharedAssets` pool, its pre-pool
        private history folds into the shared store so earlier probes
        keep informing the overhead hint.  ``other`` is left untouched.
        """
        with other._lock:
            events = list(other.events)
            profs = [dataclasses.replace(p) for p in other.profiles.values()]
        with self._lock:
            self.events.extend(events)
            for p in profs:
                sig = (_hashable(p.key), p.data_shapes, p.kind)
                mine = self.profiles.get(sig)
                if mine is None:
                    self.profiles[sig] = p
                else:
                    mine.calls += p.calls
                    mine.tasks += p.tasks
                    mine.blocks += p.blocks
                    mine.rows += p.rows
                    mine.nbytes += p.nbytes
                    mine.dispatch_s += p.dispatch_s
                    mine.wall_s += p.wall_s

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self.profiles.clear()


def _hashable(key: Hashable) -> Hashable:
    try:
        hash(key)
        return key
    except TypeError:
        return id(key)
