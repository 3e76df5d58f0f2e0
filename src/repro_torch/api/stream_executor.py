"""StreamExecutor — out-of-core scheduling with double-buffered prefetch.

The third backend of the port's execution layer (DESIGN.md §10): it drives
the same dependency-driven scheduler core as every other executor, but
assumes the inputs' blocks are :class:`~repro_torch.api.chunkstore.ChunkRef`
handles into a budgeted :class:`~repro_torch.api.chunkstore.DiskStore`, so a
dataset larger than the residency budget streams through device memory one
partition at a time.

The streaming discipline (hybrid task/dataflow iteration — Ramon-Cortes et
al., FGCS 2020: task-based iteration composed with streaming stages):

* units run **in plan order on the calling thread** (bit-identical results
  to :class:`~repro_torch.api.executors.LocalExecutor` — same TaskGraph,
  same merge fold order, and spill round-trips preserve every bit);
* while unit *k* computes, a background **prefetch thread** loads unit
  *k+1*'s chunks (``prefetch_depth`` units ahead, default 1 — the double
  buffer), disk → pinned host buffer → card on the store's side CUDA
  stream, so the read of the next partition overlaps the compute of the
  current one and its ``get()``s are *prefetch hits*;
* when unit *k* completes, its pins drop on the prefetch thread and the
  store's LRU eviction spills it (first pass: copy to the host and
  ``np.save``, off the compute thread) or simply releases it (later
  passes) — peak residency is bounded by roughly the current + prefetched
  working set, never the dataset.  The kernels of unit *k* may still be
  queued on the card then; the store's stream guard keeps their blocks
  from reuse until they ran.

``EngineReport`` rows gain the streaming bill: ``bytes_loaded`` /
``bytes_spilled`` / ``prefetch_hits`` (window deltas of the input stores'
counters).

Ownership: the streaming executor treats the chunk stores of datasets it
executed as its scratch tier — :meth:`close` closes them (deleting
``DiskStore`` spill files) unless constructed with ``close_stores=False``.
In-memory inputs (plain tensors or :class:`InMemoryStore` refs) degrade
gracefully: no refs → nothing to prefetch → plain sequential execution.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any

from repro_torch.api.chunkstore import chunk_stores
from repro_torch.api.executors import (
    _LIVE_POOLS,
    _LocationWorker,
    _PlanExecutor,
    _SchedulerState,
    _Unit,
)
from repro_torch.api.lowering import Capabilities
from repro_torch.api.plan import ExecutionPlan
from repro_torch.core.engine import TaskEngine

__all__ = ["StreamExecutor"]


class _PrefetchJob:
    """One lookahead request: load a unit's (already pinned) chunk refs.

    ``run``/``release`` execute on the prefetch worker thread (the shared
    :class:`~repro_torch.api.executors._LocationWorker` machinery — one
    queue, poison-pill stop, joined before CUDA teardown); ``wait``
    re-raises any load failure on the scheduling thread.
    """

    __slots__ = ("refs", "done", "error")

    def __init__(self, refs: tuple):
        self.refs = refs
        self.done = threading.Event()
        self.error: BaseException | None = None

    def run(self) -> None:
        try:
            # Group per store so one prefetch() call can batch I/O.
            by_store: dict[int, list] = {}
            for ref in self.refs:
                by_store.setdefault(id(ref.store), []).append(ref)
            for refs in by_store.values():
                refs[0].store.prefetch(refs)
        except BaseException as e:  # noqa: BLE001 — re-raised at wait()
            self.error = e
        finally:
            self.done.set()

    def wait(self) -> None:
        self.done.wait()
        if self.error is not None:
            raise self.error

    def release(self) -> None:
        for ref in self.refs:
            ref.store.unpin(ref)


class StreamExecutor(_PlanExecutor):
    """Sequential plan-order execution with background chunk prefetch.

    Args:
      engine: shared :class:`TaskEngine` (accounting + task cache).
      prefetch_depth: how many units ahead the background thread loads
        (default 1 = double buffering: partition *k+1* loads while *k*
        computes).  ``0`` disables lookahead (loads happen inline at
        operand resolution — still correct, no overlap).
      close_stores: when True (default), :meth:`close` also closes every
        chunk store backing datasets this executor ran — the streaming
        scratch tier (spill files) lives and dies with the executor.

    >>> import torch
    >>> from repro_torch.api import Collection, DiskStore, SplIter
    >>> x = torch.arange(64.0).reshape(16, 4)
    >>> store = DiskStore(residency_bytes=x.nbytes // 4, device="cpu")
    >>> c = Collection.from_array(x, 2, num_locations=2, store=store, device="cpu")
    >>> with StreamExecutor() as ex:
    ...     res = c.split(SplIter()).map_blocks(torch.sum).reduce(torch.add).compute(executor=ex)
    >>> float(res.value), res.report.bytes_loaded > 0, store.closed
    (2016.0, True, True)
    """

    #: pipelined iteration (DESIGN.md §14): queued submissions drain in
    #: submit order on the driving thread, and the prefetch lookahead
    #: crosses the iteration boundary — the next execute's first
    #: partitions load while the current execute still computes.
    _pipelined = True

    def __init__(
        self,
        engine: TaskEngine | None = None,
        *,
        prefetch_depth: int = 1,
        close_stores: bool = True,
    ):
        super().__init__(engine)
        if prefetch_depth < 0:
            raise ValueError(f"prefetch_depth must be >= 0, got {prefetch_depth}")
        self.prefetch_depth = prefetch_depth
        self._close_stores = close_stores
        self._seen_stores: dict[int, Any] = {}
        self._prefetcher: _LocationWorker | None = None
        # The shared atexit sweep (executors._close_live_pools) close()s us
        # if the user never does: the prefetch thread ran CUDA copies, so it
        # must be joined before the CUDA runtime's teardown.
        _LIVE_POOLS.add(self)

    @property
    def capabilities(self) -> Capabilities:
        return dataclasses.replace(
            super().capabilities, name=type(self).__name__, out_of_core=True
        )

    # -- the Executor entry point (records stores for close()) ---------------

    def execute(self, plan: ExecutionPlan):
        for store in chunk_stores(plan.spec.inputs):
            self._seen_stores.setdefault(id(store), store)
        return super().execute(plan)

    def execute_async(self, plan: ExecutionPlan):
        for store in chunk_stores(plan.spec.inputs):
            self._seen_stores.setdefault(id(store), store)
        return super().execute_async(plan)

    # -- streaming drain -------------------------------------------------------

    def _drain(self, state: _SchedulerState) -> None:
        """Plan-order consumption with a bounded prefetch pipeline."""
        pending: collections.deque[_Unit] = collections.deque(state.initial_ready())
        inflight: dict[int, _PrefetchJob] = {}
        self._drain_loop(state, pending, inflight)

    def _drain_loop(
        self,
        state: _SchedulerState,
        pending: "collections.deque[_Unit]",
        inflight: dict[int, _PrefetchJob],
        entry=None,
    ) -> None:
        """The plan-order unit loop, shared by the sync and pipelined paths.

        ``entry`` (a pipelined :class:`_PipelineEntry`) lets the lookahead
        cross the iteration boundary: when this entry's own queue has
        fewer than ``prefetch_depth`` units left, the top-up continues
        into the NEXT queued submission's launched units.
        """
        release = None  # the previous unit's prefetch pins, not yet dropped
        try:
            while pending and not state.errors:
                # A unit whose load an earlier step queued is waited for
                # BEFORE the lookahead pins: the pins of unit k+2 must not
                # land while unit k+1's load is still choosing its eviction
                # victims, or the bill would depend on how fast unit k
                # computed (a fast compute thread pinned — and so kept — a
                # block that a slow one lets the load evict and reload).
                queued = pending[0].index in inflight
                self._top_up(pending, inflight, entry)  # current unit's load
                unit = pending.popleft()
                job = inflight.pop(unit.index, None)
                if queued and not self._await(job, state):
                    return
                # Lookahead NOW, before this unit computes: unit k+1's read
                # overlaps unit k's dispatch and the card's work.  The
                # previous unit's release is queued after the lookahead's
                # pins and before its load, so every eviction on the
                # prefetch thread sees one fixed set of pins.
                self._top_up(pending, inflight, entry, release)
                release = None
                if job is not None and not queued and not self._await(job, state):
                    return
                try:
                    # _run_unit pins again around dispatch (the shared
                    # resolve/release hooks), so dropping the prefetch pin
                    # after it returns is what ends this unit's residency.
                    newly = self._run_unit(unit, state)
                except BaseException:
                    if job is not None:
                        job.release()
                    raise
                if job is not None:
                    # Released on the worker thread: the last unpin evicts
                    # the finished partition, and a first-pass eviction
                    # performs the spill write — I/O serializes with I/O
                    # while compute keeps running.
                    release = job.release
                pending.extend(sorted(newly, key=lambda u: u.index))
        finally:
            if release is not None:
                self._prefetch_worker().submit(release)
            for job in inflight.values():  # error path: drop leftover pins
                job.done.wait()
                job.release()
            inflight.clear()
            if self._prefetcher is not None:
                # Drain queued releases (and their spill writes) before the
                # run reports: pin counts and store stats are settled when
                # execute() reads the window deltas.
                done = threading.Event()
                self._prefetcher.submit(done.set)
                done.wait()

    @staticmethod
    def _await(job: _PrefetchJob | None, state: _SchedulerState) -> bool:
        """Wait for ``job``'s chunks; on a load failure drop its pins, fail
        the run and return False."""
        if job is None:
            return True
        try:
            job.wait()  # chunks resident + pinned (the hit path)
        except BaseException as e:
            job.release()
            if not isinstance(e, Exception):
                raise
            state.fail(e)
            return False
        return True

    def _top_up(
        self,
        pending: "collections.deque[_Unit]",
        inflight: dict[int, _PrefetchJob],
        entry=None,
        release=None,
    ) -> None:
        """Keep the next ``prefetch_depth`` upcoming units' chunks loading.

        Upcoming means drain order: this queue first, then — pipelined —
        the next submission's launched units, each job filed against its
        owning entry so the later drain finds it.  ``release`` (a finished
        unit's unpin) goes to the prefetch thread after the new pins and
        before the new loads.
        """
        if self.prefetch_depth <= 0:
            if release is not None:
                self._prefetch_worker().submit(release)
            return
        lookahead: list[tuple[_Unit, dict]] = [(u, inflight) for u in pending]
        nxt = self._entry_after(entry) if entry is not None else None
        if nxt is not None and nxt.jobs is not None:
            lookahead.extend((u, nxt.jobs) for u in nxt.pending)
        loads = []
        for unit, jobs in lookahead[: self.prefetch_depth]:
            if unit.index in jobs:
                continue
            refs = tuple(r for t in unit.tasks for r in t.chunk_refs)
            if not refs:
                continue
            job = _PrefetchJob(refs)
            # Pin on THIS thread, before the load is queued: the chunks
            # must already be eviction-proof while earlier units' releases
            # shrink the store.
            for ref in refs:
                ref.store.pin(ref)
            jobs[unit.index] = job
            loads.append(job)
        if release is not None:
            self._prefetch_worker().submit(release)
        for job in loads:
            self._prefetch_worker().submit(job.run)

    # -- pipelined execution (DESIGN.md §14) -----------------------------------

    def _entry_after(self, entry):
        """The next undrained submission after ``entry``, if any."""
        take = False
        for e in self._pipeline:
            if take and not e.draining:
                return e
            if e is entry:
                take = True
        return None

    def _start_entry(self, entry, prev) -> None:
        """Queue a pipelined submission; nothing computes until driven.

        Launched units accumulate in the entry's own pending deque (gate
        callbacks fire on this same thread, inside the previous entry's
        ``state.complete``), so when its turn comes the drain consumes
        them in plan order — bit-identical to the synchronous path.
        """
        entry.pending = collections.deque()
        entry.jobs = {}

        def launch(unit, entry=entry):
            if not entry.state.errors:
                entry.pending.append(unit)

        self._gate_units(entry, prev, launch)

    def _drive_raw(self, entry) -> None:
        """Drain queued submissions in submit order, up through ``entry``."""
        for e in list(self._pipeline):
            if not e.draining:
                self._drain_entry(e)
            if e is entry:
                break
        if not entry.draining and not entry.state.done.is_set():
            self._drain_entry(entry)  # already popped from the queue
        if not entry.state.done.is_set():
            entry.state.fail(
                RuntimeError(
                    f"stream drain stalled: execute #{entry.iteration} has "
                    "no runnable units left"
                )
            )

    def _drain_entry(self, entry) -> None:
        if entry.draining:
            return
        entry.draining = True
        # Window-based I/O accounting: this entry's streaming starts NOW —
        # re-mark so earlier entries' drain I/O stays out of its report.
        entry.mark_stores()
        state = entry.state
        if state.done.is_set():
            # Poisoned upstream (or already failed): nothing will run, but
            # cross-boundary prefetch may have pinned chunks for it.
            for job in entry.jobs.values():
                job.done.wait()
                job.release()
            entry.jobs.clear()
            return
        self._drain_loop(state, entry.pending, entry.jobs, entry)

    def _prefetch_worker(self) -> _LocationWorker:
        if self._prefetcher is None:
            self._prefetcher = _LocationWorker("repro-torch-prefetch")
            _LIVE_POOLS.add(self)  # respawned after close(): joined at exit again
        return self._prefetcher

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        """Stop the prefetch thread; close (or trim) the streamed stores.

        With ``close_stores=True`` every :class:`DiskStore` this executor
        streamed is closed — its spill directory is deleted, so a
        StreamExecutor leaves no temp files behind.  With
        ``close_stores=False`` stores are only trimmed (resident chunks
        shed, spill files kept) and remain usable by other executors.

        Idempotent: the seen-store set is consumed by the first call, and
        a store that is already closed is never re-entered; the executor
        remains usable (the prefetch thread respawns on next use).
        """
        self._drain_pipeline()
        if self._prefetcher is not None:
            self._prefetcher.stop()
            self._prefetcher = None
        stores = list(self._seen_stores.values())
        self._seen_stores.clear()
        super().close()
        for store in stores:
            if getattr(store, "closed", False):
                continue  # already torn down; re-entering close would be a bug
            if self._close_stores:
                store.close()
            else:
                store.trim()
