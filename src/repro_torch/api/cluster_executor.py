"""ClusterExecutor — multi-process, fault-tolerant scheduling of a TaskGraph.

The fifth backend of the port's execution layer (DESIGN.md §11) and the
first where dispatch crosses a real serialization/IPC boundary: the shared
scheduler core runs in the parent, but task units execute in **spawn-based
worker processes** (:mod:`repro_torch.api.cluster_worker`), one per logical
location by default, each computing on the device its units' blocks lie
on — for a plan on the card, in its own CUDA context on the card, where the
registered partition kernels launch.  What crosses the control channel is
a DuctTeip-style *cheap task descriptor* — the picklable
:class:`~repro_torch.api.lowering.TaskSpec` projection (code reference via
:mod:`repro_torch.api.fnref` / the named kernel registry, geometry, operand
payloads, device) — never a closure.

Locality (the paper's placement story, with real transport costs):

* units route to the worker that owns their partition's location, reusing
  the placement metadata the SplIter prepare derived;
* chunk-backed plans hand off their :class:`~repro_torch.api.chunkstore.DiskStore`
  via shm-first, *incremental* manifests
  (:meth:`~repro_torch.api.chunkstore.DiskStore.manifest`): resident chunks
  export as shared-memory descriptors, already-spilled chunks reuse their
  files, and a grown store ships only the delta;
* ``EngineReport`` bills the boundary: ``ipc_bytes`` (exact serialized
  control-channel bytes both directions), ``shm_bytes`` (block bytes
  copied into shared memory, once per block), ``remote_dispatches`` and
  ``retries``.

The data plane (:mod:`repro_torch.api.shm`): operands and large worker
partials cross as ``ShmBlockRef`` descriptors over POSIX shared memory
instead of pickled bytes.  A block on the card is copied to the host into
its segment once (the arena caches exports by identity), and every unit
copies its operands from the segment to the card in the worker; a partial
returns through the worker's reply segment and the driver puts it back on
the plan's device before the fold.  The driver owns segment lifecycle:
reply segments are unlinked the moment a partial is consumed (or discarded
as stale), a dead worker's undelivered reply segments are swept by name
prefix, and :meth:`close` unlinks everything.  When shared memory is
unavailable (or ``shm=False``), every payload falls back to pickled bytes
and spill files.

Flow control: the parent keeps at most ONE un-replied *send* in flight per
worker.  The drain sweep stages ready units per target and flushes each
worker's staging queue as a single batched ``send_bytes``; a batch is only
flushed to a worker with an empty window, so every send targets a worker
parked in ``recv`` — the ~64KB-pipe deadlock guard.

Fault tolerance (the Chunks-and-Tasks deterministic-replay model):

* workers heartbeat on their reply pipes; the drain loop doubles as
  supervisor, detecting death by process liveness or heartbeat staleness;
* a dead worker's in-flight units are disowned through the scheduler
  state's :meth:`~repro_torch.api.executors._SchedulerState.requeue` hook,
  their chunk pins released, and the units replayed on a surviving worker
  — task descriptors are pure, so the replay is bit-identical;
* a unit that out-lives ``max_retries`` replays poisons the run with a
  typed :class:`ClusterFailedError` naming the task key.

Elasticity (DESIGN.md §15): with ``steal=True`` an idle worker takes queued
units off an overloaded sibling when the cost model approves; with
``autoscale=True`` the pool grows *roamer* workers under backlog and
retires them when idle, through the same requeue/replay path as a death.

Peer exchange of partials (DESIGN.md §16): when a location runs several
units of one merge, their partials can stay in named shared-memory segments
(*published*) and a ``"fold"`` unit on that location's worker folds them
with the driver's own chain — on the card for a card plan — so the driver
receives one merged value per location.  ``EngineReport.p2p_bytes`` bills
the member bytes that skipped the driver, ``driver_merge_bytes`` those
that did not.  ``p2p="auto"`` gates it per execute on the observed partial
size (:func:`~repro_torch.api.autotune.should_fold_remote`).

Driver-level stages (``executor.task`` — k-NN's lookup/merge loops,
Cascade SVM's cascade) ship over the same channel as synchronous RPCs when
their function is referencable; unreferencable callables run in-process.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import multiprocessing
import os
import pickle
import time
from multiprocessing import connection
from typing import Any, Callable, Hashable

import numpy as np
import torch

from repro_torch._pytree import tree_map
from repro_torch.api import shm
from repro_torch.api.autotune import should_fold_remote, should_steal
from repro_torch.api.chunkstore import ChunkHandle, StoreManifest, chunk_stores, resolve_chunk
from repro_torch.api.executors import (
    _LIVE_POOLS,
    _PlanExecutor,
    _SchedulerState,
    _tree_nbytes,
    _Unit,
)
from repro_torch.api.fnref import encode_fn
from repro_torch.api.lowering import Capabilities, _inline, key_summary, stable_task_key
from repro_torch.api.shm import ShmBlockRef, ShmStore, shm_available
from repro_torch.core.engine import EngineReport, TaskEngine

__all__ = ["ClusterExecutor", "ClusterFailedError", "FaultPlan", "ChaosSchedule"]

#: task kinds that may execute in a worker process; everything else
#: (merge folds, driver-view callbacks) stays in the parent.
_REMOTE_KINDS = frozenset(
    {"block", "partition_scan", "partition_pallas", "partition_materialized"}
)

#: the CUDA sources of the registered partition kernels, built in the
#: parent before a card plan's first kernel unit ships, so no worker ever
#: runs ``nvcc`` inside a unit.
_PARTITION_SOURCES = ("partition_histogram", "partition_histogramdd", "partition_kmeans")


class ClusterFailedError(RuntimeError):
    """A task exhausted its replays (or the pool died under it).

    ``task_key`` names the poisoned task so operators can tell *which*
    work item keeps killing workers.  ``attempts`` is the per-attempt
    history — one ``{"worker", "error"}`` dict per failed attempt, in
    order, each carrying the worker id and a one-line cause summary
    ("process died", "hung (heartbeat stale)", or the remote exception's
    last line).  ``log_paths`` lists the involved workers' log files when
    worker logging is on (the ``log_dir`` argument, or the
    ``REPRO_CLUSTER_LOG_DIR`` environment default).
    """

    def __init__(
        self,
        message: str,
        *,
        task_key: str | None = None,
        attempts: tuple = (),
        log_paths: tuple = (),
    ):
        if attempts:
            lines = [
                f"  attempt {i + 1}: worker {a['worker']}: {a['error']}"
                for i, a in enumerate(attempts)
            ]
            message = message + "\nattempt history:\n" + "\n".join(lines)
        if log_paths:
            message += "\nworker logs: " + ", ".join(log_paths)
        super().__init__(message)
        self.task_key = task_key
        self.attempts = tuple(attempts)
        self.log_paths = tuple(log_paths)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic fault injection for tests and chip runs.

    Worker ids of the initial pool equal their location id, so
    ``FaultPlan(kill_after=((0, 2),))`` means "location 0's worker exits
    upon receiving its 2nd dispatch".  Respawned workers get fresh ids
    and never inherit a fault.

    Attributes:
      kill_after: ``((worker_id, nth_dispatch), ...)`` — ``os._exit``
        on *receiving* the nth dispatch, losing it in flight.
      kill_on_retry: worker ids that exit when handed an already-replayed
        unit (drives retry exhaustion → :class:`ClusterFailedError`).
      mute_after: ``((worker_id, nth_dispatch), ...)`` — stop heartbeats
        and hang, exercising the heartbeat-staleness detector.
      slow: ``((worker_id, seconds), ...)`` — sleep before every unit
        execution: the straggler hook.

    >>> FaultPlan(kill_after=((0, 1),)).kill_after_for(0)
    1
    >>> FaultPlan().kill_after_for(0) is None
    True
    """

    kill_after: tuple = ()
    kill_on_retry: tuple = ()
    mute_after: tuple = ()
    slow: tuple = ()

    def kill_after_for(self, worker_id: int) -> int | None:
        return dict(self.kill_after).get(worker_id)

    def mute_after_for(self, worker_id: int) -> int | None:
        return dict(self.mute_after).get(worker_id)

    def slow_for(self, worker_id: int) -> float | None:
        return dict(self.slow).get(worker_id)


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """Seeded, reproducible chaos for the elastic cluster.

    From one integer seed it derives (a) a fault plan that kills some
    initial worker mid-run and slows another into a straggler, and (b) a
    per-round grow/shrink action sequence the harness applies between
    executes.  Everything is a pure function of the constructor arguments
    (``random.Random`` seeded with ints, never wall-clock), and equal to
    the JAX package's schedule for the same arguments.

    >>> ChaosSchedule(seed=11).actions() == ChaosSchedule(seed=11).actions()
    True
    >>> ChaosSchedule(seed=11).fault_plan() == ChaosSchedule(seed=11).fault_plan()
    True
    """

    seed: int
    rounds: int = 4
    workers: tuple = (0, 1)
    kill_rate: float = 0.5
    slow_rate: float = 0.5
    slow_s: float = 0.02

    def _rng(self, salt: int):
        import random

        return random.Random((self.seed + 1) * 1_000_003 + salt)

    def fault_plan(self) -> FaultPlan:
        """Kills and stragglers for the initial pool, derived from the seed.

        At most one initial worker is killed (on a dispatch in the first
        few) and at most one *other* worker is slowed.
        """
        rng = self._rng(0)
        kills = []
        slows = []
        wids = list(self.workers)
        if wids and rng.random() < self.kill_rate:
            kills.append((rng.choice(wids), rng.randint(1, 4)))
        candidates = [w for w in wids if w not in dict(kills)]
        if candidates and rng.random() < self.slow_rate:
            slows.append((rng.choice(candidates), self.slow_s))
        return FaultPlan(kill_after=tuple(kills), slow=tuple(slows))

    def actions(self) -> tuple[str, ...]:
        """One pool action per round: ``"grow"``, ``"shrink"`` or ``"none"``.

        Shrink never outruns growth, and the first round always runs the
        un-scaled pool so every schedule covers the baseline too.
        """
        rng = self._rng(1)
        out = ["none"]
        grown = 0
        for _ in range(1, self.rounds):
            roll = rng.random()
            if roll < 0.4:
                out.append("grow")
                grown += 1
            elif roll < 0.7 and grown > 0:
                out.append("shrink")
                grown -= 1
            else:
                out.append("none")
        return tuple(out)


def _host_leaf(leaf):
    """A tensor leaf as a host value that pickles only its own elements."""
    return _inline(leaf) if isinstance(leaf, torch.Tensor) else leaf


def _on_device(tree, device: str):
    """A reply's host values as tensors on ``device`` (python values stay)."""
    dev = torch.device(device)

    def put(leaf):
        if isinstance(leaf, np.ndarray):
            return shm.to_tensor(leaf, leaf.dtype.str, dev)
        if isinstance(leaf, torch.Tensor):
            return leaf.to(dev)
        return leaf

    return tree_map(put, tree)


class _WorkerHandle:
    """Parent-side handle: process + command/reply connections + fault config.

    Each worker gets its OWN reply pipe (no shared queue): a worker killed
    mid-write can only tear its own channel, which the parent reads as
    EOF and folds into the death path.
    """

    def __init__(
        self,
        wid: int,
        location: int,
        ctx,
        *,
        heartbeat_s: float,
        fault: FaultPlan | None,
        log_dir: str | None,
        result_prefix: str | None = None,
        result_min_bytes: int = 1024,
    ):
        self.id = wid
        self.location = location
        self.log_path = os.path.join(log_dir, f"worker-{wid}.log") if log_dir else None
        # Name prefix for the worker's reply segments; the parent sweeps
        # it when the worker dies with undelivered replies.
        self.result_prefix = result_prefix
        cmd_recv, cmd_send = ctx.Pipe(duplex=False)
        rep_recv, rep_send = ctx.Pipe(duplex=False)
        self._conn = cmd_send
        self.reply = rep_recv
        from repro_torch.api import cluster_worker

        self.process = ctx.Process(
            target=cluster_worker.worker_main,
            args=(wid, location, cmd_recv, rep_send),
            kwargs=dict(
                heartbeat_s=heartbeat_s,
                kill_after=fault.kill_after_for(wid) if fault else None,
                kill_on_retry=bool(fault and wid in fault.kill_on_retry),
                mute_after=fault.mute_after_for(wid) if fault else None,
                slow_s=fault.slow_for(wid) if fault else None,
                log_path=self.log_path,
                result_prefix=result_prefix,
                result_min_bytes=result_min_bytes,
            ),
            name=f"repro-torch-cluster-w{wid}",
            daemon=True,
        )
        self.process.start()
        cmd_recv.close()  # child owns these ends now
        rep_send.close()

    def alive(self) -> bool:
        return self.process.is_alive()

    def send(self, msg) -> int:
        """Pickle + send one command; returns the exact serialized size."""
        return self.send_raw(pickle.dumps(msg))

    def send_raw(self, payload: bytes) -> int:
        self._conn.send_bytes(payload)
        return len(payload)

    def stop(self, timeout: float = 5.0) -> None:
        try:
            self.send(("stop",))
        except (OSError, ValueError):
            pass  # already dead / connection torn down
        self.process.join(timeout)
        if self.process.is_alive():
            self.process.terminate()
            self.process.join(timeout)
        for conn in (self._conn, self.reply):
            try:
                conn.close()
            except OSError:  # pragma: no cover
                pass


class _DrainContext:
    """Per-graph scheduling context, registered in the executor's
    epoch-keyed ``_contexts`` map.

    One context per in-flight TaskGraph: the synchronous ``execute`` path
    opens exactly one for the duration of its drain, while pipelined
    submissions keep one open per unresolved entry — the reply pump routes
    each unit reply to its context by epoch.
    """

    def __init__(self, state: _SchedulerState, epoch: int, report):
        self.state = state
        self.epoch = epoch
        self.report = report
        self.ready: collections.deque[_Unit] = collections.deque()
        self.replays: collections.deque[_Unit] = collections.deque()
        self.inflight: dict[int, _Unit] = {}
        self.meta: dict[int, tuple] = {}  # unit index -> (t0_send, send_seconds)
        # unit index -> the device its partial returns to (the plan's); a
        # publishing member's stays until its fold replies, which runs there
        self.devices: dict[int, str] = {}
        # unit index -> shm refs this dispatch exported: segment pins that
        # must drop on reply, requeue, or drain teardown.
        self.shm_pins: dict[int, tuple] = {}
        # unit index -> [{"worker", "error", "log"}, ...]: one entry per
        # FAILED attempt, consumed by ClusterFailedError on poison.
        self.history: dict[int, list[dict]] = {}
        # unit index -> the worker a steal took it from: its replay avoids
        # that victim (else a victim with no observed service time yet is
        # the survivor of choice, and the unit ping-pongs back to it).
        self.stolen_from: dict[int, int] = {}
        # unit index -> SegmentLease over that unit's *published* partial
        # (peer exchange).  The driver owns every published segment through
        # these: a lease is released when the sibling fold consumes it
        # (billing p2p_bytes) or — the backstop — when the context closes.
        self.leases: dict[int, shm.SegmentLease] = {}

    def record_failure(self, index: int, wid: int, error: str, log_path: str | None) -> None:
        self.history.setdefault(index, []).append(
            {"worker": wid, "error": error, "log": log_path}
        )

    def error_kwargs(self, index: int) -> dict:
        """attempts/log_paths keyword payload for a ClusterFailedError."""
        attempts = tuple(self.history.get(index, ()))
        return {
            "attempts": attempts,
            "log_paths": tuple(dict.fromkeys(a["log"] for a in attempts if a["log"])),
        }


def _unit_origin(unit: _Unit):
    """The app task a failure attributes to: a fold unit names its
    subtree's ORIGINATING task (first member), never the synthetic fold."""
    return unit.tasks[0] if unit.tasks else unit.origin


def _label(unit: _Unit) -> tuple[str, str | None]:
    """(error label, task key summary) of the app task a unit runs."""
    task = _unit_origin(unit)
    if task is None:
        label, key = f"unit {unit.index}", None
    else:
        key = key_summary(task.key)
        label = f"task {key} (blocks={task.block_ids})"
    if unit.kind == "fold":
        label = f"merge fold of {label}"
    return label, key


class ClusterExecutor(_PlanExecutor):
    """Schedule TaskGraphs over a pool of spawn-based worker processes.

    Args:
      engine: shared :class:`TaskEngine` (parent-side accounting + the task
        cache used by in-process units such as the merge).
      max_retries: replays a unit may consume across worker deaths before
        the run fails with :class:`ClusterFailedError`.
      heartbeat_s: worker heartbeat period.
      heartbeat_timeout_s: silence span after which a live-looking process
        is declared dead (hung worker); generous by default (30 s) so a
        loaded host — or a worker importing torch and creating its CUDA
        context — doesn't false-positive.
      fault_plan: injected :class:`FaultPlan` (tests / chip runs).
      log_dir: directory for per-worker log files (created if needed);
        None disables worker logging.
      poll_s: supervisor tick — reply wait quantum between liveness checks.
      shm: use the shared-memory data plane for operand and partial
        transport.  ``None`` (default) enables it when the host supports
        POSIX shared memory, honoring the ``REPRO_CLUSTER_SHM=0`` kill
        switch; ``False`` forces pickled payloads and spill files.
      shm_min_bytes: payloads below this ship inline.
      shm_segment_bytes: arena segment size of the driver's
        :class:`~repro_torch.api.shm.ShmStore`.
      shm_budget_bytes: cap on live segment bytes (default 256 MiB, or
        the ``REPRO_SHM_BUDGET`` environment variable).  Exhaustion falls
        back to inline/spill-file transport, never to an error.
      p2p: peer exchange of partials (DESIGN.md §16).  ``"auto"``
        (default) lets :func:`~repro_torch.api.autotune.should_fold_remote`
        decide per execute, fed by an observed per-merge-key partial-size
        EMA — small partials keep the driver's fold.  ``True`` folds
        worker-side whenever the plan and data plane allow; ``False`` never.
        When active, each location's multi-member group publishes its
        partials as named segments, a ``fold`` unit on the location's worker
        folds them, and the driver receives ONE value per location.
      p2p_min_bytes: the ``"auto"`` gate's floor: observed partials below
        this never leave the driver's fold.
      steal: enable work stealing: an idle worker takes queued units off an
        overloaded sibling when the cost model says remote fetch beats the
        expected wait.  Off by default.
      autoscale: grow *roamer* workers (no partition to own; fed purely by
        stealing) when queue depth outruns the live workers, and shrink
        them again — planned preemption through the requeue/replay path —
        once they idle.  Implies ``steal``.
      min_workers / max_workers: autoscaler pool bounds (defaults: 1 and
        ``os.cpu_count()``).
      scale_up_backlog: grow when queued-behind-running units exceed this
        many per live worker.
      scale_idle_ticks: consecutive idle supervisor ticks before a roamer
        is preempted.

    Elasticity accounting: successful steals bill ``EngineReport.steals``
    and append to :attr:`steal_log`; grow/shrink bill
    ``EngineReport.scale_events`` and append to :attr:`scale_log`; every
    replay billed to ``retries`` appends to :attr:`retry_log`.

    Workers spawn lazily (first dispatch needing their location) and are
    reused across ``execute`` calls; :meth:`close` is idempotent (it stops
    every worker and unlinks every shared-memory segment) and also runs
    from the shared atexit sweep.  Pipelined iteration (DESIGN.md §14):
    ``execute_async`` keeps one drain context per in-flight submission;
    all driving happens on the submitting thread.
    """

    _pipelined = True

    def __init__(
        self,
        engine: TaskEngine | None = None,
        *,
        max_retries: int = 2,
        heartbeat_s: float = 0.2,
        heartbeat_timeout_s: float = 30.0,
        fault_plan: FaultPlan | None = None,
        log_dir: str | None = None,
        poll_s: float = 0.02,
        shm: bool | None = None,
        shm_min_bytes: int = 1024,
        shm_segment_bytes: int = 4 << 20,
        shm_budget_bytes: int | None = None,
        p2p: bool | str = "auto",
        p2p_min_bytes: int = 1 << 16,
        steal: bool = False,
        autoscale: bool = False,
        min_workers: int = 1,
        max_workers: int | None = None,
        scale_up_backlog: int = 2,
        scale_idle_ticks: int = 50,
    ):
        super().__init__(engine)
        self.max_retries = max_retries
        self.heartbeat_s = heartbeat_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.fault_plan = fault_plan
        self.steal_enabled = bool(steal or autoscale)
        self.autoscale = autoscale
        self.min_workers = min_workers
        self.max_workers = max_workers if max_workers else (os.cpu_count() or 4)
        self.scale_up_backlog = scale_up_backlog
        self.scale_idle_ticks = scale_idle_ticks
        self.log_dir = log_dir or os.environ.get("REPRO_CLUSTER_LOG_DIR") or None
        self.poll_s = poll_s
        if shm is None:
            shm = os.environ.get("REPRO_CLUSTER_SHM", "1") != "0" and shm_available()
        if shm_budget_bytes is None:
            shm_budget_bytes = int(os.environ.get("REPRO_SHM_BUDGET", 256 << 20))
        self._shm = (
            ShmStore(
                budget_bytes=shm_budget_bytes,
                segment_bytes=shm_segment_bytes,
                min_bytes=shm_min_bytes,
            )
            if shm
            else None
        )
        self.shm_min_bytes = shm_min_bytes
        self.p2p = p2p
        self.p2p_min_bytes = p2p_min_bytes
        # merge key -> observed partial-size EMA (bytes): the auto gate's
        # evidence, from unit replies — an iterative app pays one execute on
        # the driver's fold before the gate can switch it to peer folds.
        self._fold_ema: dict[Hashable, float] = {}
        self._fold_refs: dict[Hashable, tuple | None] = {}
        # A parent that holds a CUDA context must never fork.
        self._ctx = multiprocessing.get_context("spawn")
        self._kernels_built = False
        self._workers: dict[int, _WorkerHandle] = {}
        self._by_location: dict[int, int] = {}
        self._used_wids: set[int] = set()
        self._next_wid = itertools.count(1000)  # respawns: fresh, fault-free ids
        self._epoch = 0
        self._last_hb: dict[int, float] = {}
        self._manifests: dict[str, Any] = {}
        self._handoff_bytes = 0  # exported by a handoff, not yet billed
        # (wid, uid) -> chunk ids already shipped: attach messages carry
        # only the manifest delta a worker has not seen.
        self._attached: dict[tuple[int, str], set] = {}
        self._call_seq = itertools.count()
        self._call_results: dict[int, tuple] = {}
        self._pending_calls: set[int] = set()  # issued, not yet resolved
        self._outstanding: dict[int, int] = {}  # wid -> un-replied commands
        # wid -> staged (attach_msgs, unit_msg, unit, ctx) entries, flushed
        # as one batched send per sweep (see _flush_outbox).
        self._outbox: dict[int, list] = {}
        # epoch -> live _DrainContext, in open order.
        self._contexts: dict[int, _DrainContext] = {}
        # -- elasticity state (DESIGN.md §15) --
        # wid -> send-ordered [(ctx, unit), ...] of un-replied unit
        # dispatches: the victim queue steal probes select from.
        self._dispatch_order: dict[int, list] = {}
        self._steal_probes: dict[int, tuple] = {}  # victim wid -> (token, wants)
        self._steal_seq = itertools.count(1)
        self._roamers: set[int] = set()            # autoscaler-grown workers
        self._idle_ticks: dict[int, int] = {}      # roamer wid -> idle streak
        self._preempting: set[int] = set()         # planned shrinks in progress
        # wid -> observed per-unit service-time EMA (and the last reply /
        # batch-send mark the next sample measures from).
        self._task_ema: dict[int, float] = {}
        self._reply_mark: dict[int, float] = {}
        # Heartbeat debounce: staleness counts only *observed* silence —
        # time the driver actually spent pumping replies (_check_workers).
        self._last_pump = time.monotonic()
        self._silence: dict[int, float] = {}
        #: event logs the report counters reconcile against exactly — one
        #: entry per billed steal / retry / scale event.
        self.steal_log: list[dict] = []
        self.retry_log: list[dict] = []
        self.scale_log: list[dict] = []
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
        _LIVE_POOLS.add(self)

    # -- capabilities ---------------------------------------------------------

    @property
    def capabilities(self) -> Capabilities:
        # remote: lowering attaches fn_refs + raw-operand builders.
        # out_of_core: lowering attaches chunk_refs, so the parent pins a
        # unit's chunks for the whole remote round-trip (and releases them
        # on completion OR requeue).
        return dataclasses.replace(
            super().capabilities,
            name=type(self).__name__,
            remote=True,
            out_of_core=True,
            exporter=self._export_block if self._shm is not None else None,
        )

    # -- pool management ------------------------------------------------------

    def workers_alive(self) -> list[int]:
        """Ids of currently-live workers (diagnostics / tests)."""
        return sorted(w.id for w in self._workers.values() if w.alive())

    def worker_pids(self) -> dict[int, int]:
        """Worker id → process id of every live worker (diagnostics)."""
        return {w.id: w.process.pid for w in self._workers.values() if w.alive()}

    def _spawn(self, wid: int, location: int) -> _WorkerHandle:
        handle = _WorkerHandle(
            wid,
            location,
            self._ctx,
            heartbeat_s=self.heartbeat_s,
            fault=self.fault_plan,
            log_dir=self.log_dir,
            # "q" separates wid from the reply sequence number, so sweeping
            # worker 5's prefix can never match worker 55's segments.
            result_prefix=f"{self._shm.prefix}w{wid}q" if self._shm is not None else None,
            result_min_bytes=self.shm_min_bytes,
        )
        self._workers[wid] = handle
        self._by_location[location] = wid
        self._last_hb[wid] = time.monotonic()
        self._silence[wid] = 0.0
        _LIVE_POOLS.add(self)  # re-register after a close()
        return handle

    def _worker_for(self, location: int) -> _WorkerHandle:
        """The live worker owning ``location`` (lazily spawned).

        The initial worker for a location takes the location id as its
        worker id — the addressing contract :class:`FaultPlan` relies on.
        Respawns after a death draw fresh ids, so an injected fault fires
        at most once.
        """
        wid = self._by_location.get(location)
        if wid is not None:
            handle = self._workers.get(wid)
            if handle is not None and handle.alive():
                return handle
            self._on_worker_death(wid)
        if location >= 0 and location not in self._used_wids:
            wid = location
        else:
            wid = next(self._next_wid)
        self._used_wids.add(wid)
        return self._spawn(wid, location)

    def _survivor(self, *, not_worker: int | None = None) -> _WorkerHandle | None:
        """A live worker, preferring one whose command window is empty.

        Among window-free workers the one with the lowest observed
        service-time EMA wins — then the one with the least already staged
        — so replayed (and stolen) units batch onto the fastest free worker.
        """
        fallback = None
        free: list[_WorkerHandle] = []
        for wid in sorted(self._workers):
            if wid == not_worker:
                continue
            handle = self._workers[wid]
            if not handle.alive():
                continue
            if self._outstanding.get(wid, 0) == 0:
                free.append(handle)
            fallback = fallback or handle
        if free:
            return min(
                free,
                key=lambda h: (
                    self._task_ema.get(h.id, 0.0),
                    len(self._outbox.get(h.id, ())),
                    h.id,
                ),
            )
        return fallback

    # -- the Executor entry points --------------------------------------------

    def _handoff_stores(self, plan) -> None:
        """Hand off chunk stores before scheduling (shm-first, incremental).

        The segments this export writes bill the ``shm_bytes`` of the
        execute that needed them, when its drain context opens: the
        execute's own report does not exist yet here.  (The JAX package
        bills them to whichever report was current — the previous call's.)
        """
        with self.engine.bind_report(EngineReport(mode="handoff")) as bill:
            for store in chunk_stores(plan.spec.inputs):
                manifest = getattr(store, "manifest", None)
                if manifest is None:
                    continue  # in-memory store: payloads ship inline/exported
                full = self._manifests.get(store.uid)
                known = frozenset(full.chunks) if full is not None else frozenset()
                delta = manifest(export=self._manifest_export(store), known=known)
                if full is None:
                    self._manifests[delta.uid] = delta
                else:
                    full.chunks.update(delta.chunks)
        self._handoff_bytes += bill.shm_bytes

    def execute(self, plan):
        self._handoff_stores(plan)
        return super().execute(plan)

    def execute_async(self, plan):
        self._handoff_stores(plan)
        return super().execute_async(plan)

    def task(self, fn: Callable, *, key: Hashable = None) -> Callable:
        """Register a driver-level task; referencable fns dispatch remotely.

        The remote path is a synchronous RPC with the same replay contract
        as plan units: a worker death mid-call re-issues the call on a
        survivor (counted in ``EngineReport.retries``).  Tensor arguments
        are rebuilt on their own device in the worker, and the result
        comes back on the first tensor argument's device (the CPU if
        there is none).  Functions the encoder rejects run in-process.
        """
        efn = encode_fn(fn)
        if efn is None:
            return self.engine.task(fn, key=key)
        fn_ref = ("fn", efn)
        key_repr = key_summary(key if key is not None else stable_task_key(fn))

        def dispatch(*args):
            return self._remote_call(fn_ref, args, key_repr)

        return dispatch

    def call_workers(self, fn: Callable, *args) -> dict[int, Any]:
        """Run referencable ``fn(*args)`` once on every live worker.

        One driver-level RPC per worker; returns ``{worker_id: result}``.
        A diagnostic hook — chip runs read the workers' kernel launch
        counters and unit timings through it — so its costs go to a report
        of its own, never to the caller's.  A worker that dies under its
        call raises :class:`ClusterFailedError` (the call is not replayed
        elsewhere: it is about that worker).
        """
        efn = encode_fn(fn)
        if efn is None:
            raise ValueError(f"call_workers needs a referencable function, got {fn!r}")
        key_repr = key_summary(stable_task_key(fn))
        with self.engine.bind_report(EngineReport(mode="call_workers")):
            return {
                wid: self._remote_call(("fn", efn), args, key_repr, target=self._workers[wid])
                for wid in self.workers_alive()
            }

    # -- the shared-memory data plane -----------------------------------------

    def _export_block(self, block):
        """``Capabilities.exporter`` hook: one operand block as a descriptor.

        Cached by object identity inside the arena, so an iterative plan
        re-dispatching the same blocks copies each one exactly once (a
        block on the card: one copy to the host); ``shm_bytes`` bills only
        genuine copies.  ``None`` (undersized block, budget exhausted)
        sends the caller down the inline path.
        """
        ref, wrote = self._shm.export(block, materialize=lambda: resolve_chunk(block))
        if wrote:
            # current_report: exports fire inside a dispatch sweep, which
            # binds the owning context's per-execute report.
            self.engine.current_report.shm_bytes += wrote
        return ref

    def _manifest_export(self, store):
        """Chunk exporter handed to ``DiskStore.manifest`` (None: shm off).

        Manifest entries outlive any single dispatch, so their segments
        are locked against eviction; no size floor.
        """
        if self._shm is None:
            return None

        def export(cid, arr):
            ref, wrote = self._shm.export(
                arr, key=("chunk", store.uid, cid), min_bytes=0, lock=True
            )
            if wrote:
                self.engine.current_report.shm_bytes += wrote
            return ref

        return export

    # -- remote dispatch ------------------------------------------------------

    def _remotable(self, unit: _Unit) -> bool:
        return (
            len(unit.tasks) == 1
            and unit.kind in _REMOTE_KINDS
            and unit.tasks[0].fn_ref is not None
            and unit.tasks[0].remote_operands is not None
        )

    def _ensure_kernels(self, spec) -> None:
        """Build the partition kernels here before a card kernel unit ships.

        ``nvcc`` then never runs inside a worker's unit: the workers load
        the finished libraries from the build directory.
        """
        if self._kernels_built or spec.fn_ref[0] != "kernel":
            return
        if torch.device(spec.device).type != "cuda":
            return
        from repro_torch.kernels import _build

        _build.build(_PARTITION_SOURCES)
        self._kernels_built = True

    # -- peer-to-peer partial exchange (DESIGN.md §16) -------------------------

    def _publish_name(self, epoch: int, index: int, attempt: int) -> str:
        """Deterministic segment name for a published partial.

        Addressed by unit identity (epoch/index/attempt), never worker id:
        a stolen or replayed unit publishes to the same place, so the
        sibling fold's ref tree stays valid however the unit was routed.
        The trailing ``z`` ends the name — sweeping attempt 1's segment can
        never match attempt 10's.
        """
        return f"{self._shm.prefix}p{epoch}x{index}a{attempt}z"

    def _fold_ref(self, merge) -> tuple | None:
        """Cached reference of a merge combine (None: not referencable)."""
        if merge.key not in self._fold_refs:
            self._fold_refs[merge.key] = encode_fn(merge.combine)
        return self._fold_refs[merge.key]

    def _note_partial_bytes(self, key: Hashable, nbytes: int) -> None:
        if nbytes <= 0:
            return
        prev = self._fold_ema.get(key)
        self._fold_ema[key] = float(nbytes) if prev is None else 0.5 * prev + 0.5 * nbytes

    def _remote_fold_plan(self, graph, units, plan):
        """Fold-plan groups whose merge chains run worker-side (the hook
        :meth:`~repro_torch.api.executors._PlanExecutor._build_units`
        consults).

        A group qualifies when it has several members, every member can
        dispatch remotely and the data plane is up; the whole mechanism
        then gates on the cost model — ``p2p=True`` forces it, ``"auto"``
        requires an observed partial-size EMA for this merge key that
        clears :func:`~repro_torch.api.autotune.should_fold_remote`.
        Selected groups' member units are marked ``publish``.
        """
        if not self.p2p or self._shm is None or graph.merge is None:
            return ()
        if self._fold_ref(graph.merge) is None:
            return ()
        groups = tuple(
            members
            for _loc, members in plan
            if len(members) > 1 and all(self._remotable(units[i]) for i in members)
        )
        if not groups:
            return ()
        if self.p2p is not True:  # "auto": the observed-size cost gate
            ema = self._fold_ema.get(graph.merge.key)
            if ema is None or not should_fold_remote(
                self._steal_model(),
                partial_bytes=int(ema),
                fan_in=max(len(m) for m in groups),
                min_bytes=self.p2p_min_bytes,
            ):
                return ()
        for members in groups:
            for i in members:
                units[i].publish = True
        return groups

    def _dispatch_fold(
        self,
        unit: _Unit,
        ctx: _DrainContext,
        *,
        prefer_survivor: bool = False,
        avoid: int | None = None,
    ) -> bool:
        """Stage one fold unit for a worker (default: its location's owner).

        The message carries the members' packed ref trees — segment
        descriptors, not partial bytes — the combine's reference and the
        plan's device; the worker attaches each published segment, stacks
        the partials on the device and runs the driver's chain.  Member
        leases stay with the driver until the fold's reply confirms
        consumption (``_on_reply``), so a death at any point leaves every
        segment owned and sweepable.  Same window discipline and
        False-means-defer contract as :meth:`_dispatch_remote`.
        """
        worker = (
            self._survivor(not_worker=avoid) if prefer_survivor else None
        ) or self._worker_for(unit.location)
        if ctx.state.errors:
            return True
        if self._outstanding.get(worker.id, 0) > 0:
            return False
        # every member was dispatched remotely and keeps the plan's device
        # until this fold replies, whether its publish landed or not
        device = ctx.devices[unit.fold_group[0]]
        # a member whose publish was declined (``/dev/shm`` full) came back
        # as values: they travel as host values in the message
        trees = tuple(
            ctx.state.results[i] if i in ctx.leases else tree_map(_host_leaf, ctx.state.results[i])
            for i in unit.fold_group
        )
        ctx.state.assign(unit, worker.id)
        ctx.devices[unit.index] = device
        attempt = ctx.state.attempts[unit.index] - 1
        msg = (
            "fold", ctx.epoch, unit.index, attempt, self._fold_ref(unit.merge),
            key_summary(unit.merge.key), trees, device,
        )
        self._outbox.setdefault(worker.id, []).append(((), msg, unit, ctx))
        return True

    def _stage_attaches(self, worker: _WorkerHandle, spec) -> list:
        """Attach messages ``worker`` needs before running ``spec``.

        Incremental: ``self._attached`` records which chunk ids each
        worker has already been sent per store, so a store that grew
        mid-session ships only its new entries.
        """
        uids = {b.store_uid for blocks in spec.data for b in blocks if isinstance(b, ChunkHandle)}
        msgs = []
        for uid in sorted(uids):
            manifest = self._manifests.get(uid)
            if manifest is None:
                raise ClusterFailedError(
                    f"no manifest for chunk store {uid}; inputs changed mid-run?"
                )
            seen = self._attached.get((worker.id, uid), frozenset())
            delta = {c: e for c, e in manifest.chunks.items() if c not in seen}
            if not delta:
                continue
            msgs.append(("attach", StoreManifest(uid, manifest.spill_dir, delta)))
            self._attached[(worker.id, uid)] = set(manifest.chunks)
        return msgs

    def _await_window(self, worker: _WorkerHandle) -> bool:
        """Pump replies until ``worker`` has no un-replied command in flight.

        The one-command-per-worker window is the deadlock guard for the
        ~64KB OS pipes.  Returns False if the worker died while we waited.
        """
        while self._outstanding.get(worker.id, 0) > 0:
            if worker.id not in self._workers or not worker.alive():
                self._on_worker_death(worker.id)
                return False
            self._pump()
        return worker.id in self._workers

    def _dispatch_remote(
        self,
        unit: _Unit,
        ctx: _DrainContext,
        *,
        prefer_survivor: bool = False,
        target: _WorkerHandle | None = None,
        avoid: int | None = None,
    ) -> bool:
        """Stage one unit for its location's worker (or any survivor).

        Staging, not sending: the unit's spec is built (operands exported
        to shared memory here), its chunks pinned and ownership assigned,
        and the message queued in ``self._outbox`` — ``_flush_outbox``
        ships each worker's queue as ONE batched send per sweep.

        Returns False — *without* blocking — when the target worker still
        has a command window in flight: the drain sweep defers the unit
        and retries after the next pump.  ``prefer_survivor`` is the replay
        path (a live worker, locality traded for liveness; ``avoid`` names
        a steal's victim, skipped while another survivor lives); ``target``
        pins the worker outright (the steal paths).
        """
        task = unit.tasks[0]
        worker = (
            target
            or (self._survivor(not_worker=avoid) if prefer_survivor else None)
            or self._worker_for(unit.location)
        )
        if ctx.state.errors:  # a death inside _worker_for poisoned the run
            return True
        if self._outstanding.get(worker.id, 0) > 0:
            return False  # window full: defer rather than queue behind it
        # Payload errors (unpicklable operand, missing manifest) propagate
        # from these with nothing pinned or assigned yet.
        spec = task.spec()
        self._ensure_kernels(spec)
        attaches = self._stage_attaches(worker, spec)
        self._acquire_unit(unit)  # pin chunks for the whole round-trip
        # Assign BEFORE the message leaves our hands: a worker death any
        # time after this leaves the unit owned, so the death sweep's
        # requeue returns it for replay instead of losing it.
        ctx.state.assign(unit, worker.id)
        ctx.devices[unit.index] = spec.device
        if self._shm is not None:
            refs = tuple(
                b for blocks in spec.data for b in blocks if isinstance(b, ShmBlockRef)
            ) + tuple(e for e in spec.extras if isinstance(e, ShmBlockRef))
            if refs:
                self._shm.pin_refs(refs)
                ctx.shm_pins[unit.index] = refs
        attempt = ctx.state.attempts[unit.index] - 1
        msg = ("unit", ctx.epoch, spec, attempt)
        if unit.publish and self._shm is not None:
            # Peer exchange: the worker leaves this unit's partial in a
            # segment at the deterministic name the sibling fold expects.
            msg = msg + (self._publish_name(ctx.epoch, unit.index, attempt),)
        self._outbox.setdefault(worker.id, []).append((attaches, msg, unit, ctx))
        return True

    def _flush_outbox(self) -> None:
        """Ship every staged queue whose target worker's window is empty.

        One ``send_bytes`` per worker carries its attach messages plus all
        units staged this sweep; ``_outstanding`` then counts one window
        slot per unit in the batch.  A batch may mix units from several
        live contexts; its serialized bytes bill to the first staged
        entry's report — deterministic, and report sums stay exact.
        """
        for wid in list(self._outbox):
            if self._outstanding.get(wid, 0) > 0:
                continue  # window busy: flush after its replies land
            worker = self._workers.get(wid)
            if worker is None or not worker.alive():
                self._on_worker_death(wid)  # staged units are assigned: replayed
                continue
            entries = self._outbox.pop(wid)
            msgs = [m for attaches, msg, _unit, _ctx in entries for m in (*attaches, msg)]
            payload = pickle.dumps(msgs[0] if len(msgs) == 1 else ("batch", msgs))
            t0 = time.perf_counter()
            try:
                sent = worker.send_raw(payload)
            except OSError:
                # Worker died between the liveness check and the send; the
                # batch's units are assigned, so the death sweep replays
                # them (and releases this dispatch's pins).
                self._on_worker_death(wid)
                continue
            send_s = time.perf_counter() - t0
            self._outstanding[wid] = self._outstanding.get(wid, 0) + len(entries)
            self._reply_mark[wid] = t0  # the batch's first service starts now
            entries[0][3].report.ipc_bytes += sent
            order = self._dispatch_order.setdefault(wid, [])
            for _attaches, _msg, unit, ectx in entries:
                ectx.meta[unit.index] = (t0, send_s)
                ectx.inflight[unit.index] = unit
                order.append((ectx, unit))  # send order = steal candidacy order

    def _open_context(self, state: _SchedulerState, report) -> _DrainContext:
        report.shm_bytes += self._handoff_bytes  # this execute's store handoff
        self._handoff_bytes = 0
        self._epoch += 1
        ctx = _DrainContext(state, self._epoch, report)
        self._contexts[ctx.epoch] = ctx
        return ctx

    def _close_context(self, ctx: _DrainContext) -> None:
        """Deregister a context; drop every pin its dispatches still hold.

        Error path included: staged-but-unflushed units and in-flight
        units both hold chunk pins and shm reference pins — release exactly
        this context's, leaving sibling contexts' staged work untouched.
        """
        for wid, entries in list(self._outbox.items()):
            keep = [e for e in entries if e[3] is not ctx]
            for _attaches, _msg, unit, ectx in entries:
                if ectx is ctx:
                    ctx.inflight.pop(unit.index, None)
                    self._release_unit(unit)
            if keep:
                self._outbox[wid] = keep
            else:
                del self._outbox[wid]
        for unit in ctx.inflight.values():
            self._release_unit(unit)
        ctx.inflight.clear()
        if self._shm is not None:
            for refs in ctx.shm_pins.values():
                self._shm.unpin_refs(refs)
        ctx.shm_pins.clear()
        for wid, order in list(self._dispatch_order.items()):
            kept = [e for e in order if e[0] is not ctx]
            if kept:
                self._dispatch_order[wid] = kept
            else:
                del self._dispatch_order[wid]
        # Unconsumed publish leases (error/abort paths): the driver owns
        # every published segment, so the context takes them down with it.
        for lease in ctx.leases.values():
            shm.unlink_segments(lease.segments)
        ctx.leases.clear()
        self._contexts.pop(ctx.epoch, None)

    def _sweep_context(self, ctx: _DrainContext) -> None:
        """One dispatch sweep: replays first (retry urgency), then fresh
        ready units.  A unit whose target worker still has a command in
        flight is deferred to the next sweep.  Runs under the context's
        report binding so operand exports and in-process dispatches bill
        per execute.
        """
        state = ctx.state
        with self.engine.bind_report(ctx.report):
            deferred: list[_Unit] = []
            while ctx.replays and not state.errors:
                unit = ctx.replays.popleft()
                if state.is_done(unit.index):
                    continue  # a salvaged duplicate reply beat the replay
                avoid = ctx.stolen_from.get(unit.index)
                route = self._dispatch_fold if unit.kind == "fold" else self._dispatch_remote
                if route(unit, ctx, prefer_survivor=True, avoid=avoid):
                    ctx.stolen_from.pop(unit.index, None)
                else:
                    deferred.append(unit)
            ctx.replays.extend(deferred)
            deferred = []
            while ctx.ready and not state.errors:
                unit = ctx.ready.popleft()
                if unit.kind == "fold":
                    # Peer-exchange merge chain: always in a worker — the
                    # in-process branch would fold descriptors.  The data
                    # plane and the combine's reference were preconditions
                    # of materializing the unit, and neither changes.
                    if not self._dispatch_fold(unit, ctx):
                        deferred.append(unit)
                elif self._remotable(unit):
                    if not self._dispatch_remote(unit, ctx):
                        # Owner busy: an idle sibling may take it now
                        # (driver-side steal) instead of waiting.
                        if not self._steal_reroute(unit, ctx):
                            deferred.append(unit)
                else:
                    # In-process unit (merge fold, driver view).  Its task()
                    # dispatches may themselves be remote RPCs, which pump
                    # this same context reentrantly.
                    ctx.ready.extend(self._run_unit(unit, state))
            ctx.ready.extend(deferred)

    def _sweep_all(self) -> None:
        """Sweep every live context, then flush the staged batches."""
        for ctx in list(self._contexts.values()):
            if ctx.ready or ctx.replays:
                self._sweep_context(ctx)
        self._flush_outbox()
        if self.steal_enabled:
            self._maybe_steal()
        if self.autoscale:
            self._autoscale()

    def _any_work(self) -> bool:
        """Anything in flight, staged, or dispatchable across all contexts."""
        if self._outbox:
            return True
        return any(c.inflight or c.ready or c.replays for c in self._contexts.values())

    def _drain(self, state: _SchedulerState) -> None:
        ctx = self._open_context(state, state.report or self.engine.current_report)
        ctx.ready.extend(state.initial_ready())
        try:
            while not state.errors:
                self._sweep_all()
                if state.done.is_set() or state.errors:
                    break
                if not self._any_work():
                    break  # nothing left to wait for (defensive)
                self._pump()
        finally:
            self._close_context(ctx)

    # -- pipelined execution (DESIGN.md §14) -----------------------------------

    def _start_entry(self, entry, prev) -> None:
        """Open a context for a pipelined submission and push what's ready."""
        ctx = self._open_context(entry.state, entry.report)
        entry.ctx = ctx

        def launch(unit, ctx=ctx):
            if not ctx.state.errors:
                ctx.ready.append(unit)

        self._gate_units(entry, prev, launch)
        self._drain_replies()  # landed replies close windows + fire gates
        self._sweep_all()

    def _drive_raw(self, entry) -> None:
        """Pump the event loop until ``entry`` reaches raw completion."""
        state = entry.state
        while not state.done.is_set():
            self._sweep_all()
            if state.done.is_set():
                break
            if not self._any_work():
                if not state.done.is_set():
                    state.fail(
                        ClusterFailedError(
                            "pipelined drain stalled: nothing in flight can "
                            f"complete execute #{entry.iteration}"
                        )
                    )
                break
            self._pump()
        ctx = entry.ctx
        if ctx is not None:
            entry.ctx = None
            self._close_context(ctx)

    # -- the reply pump / supervisor ------------------------------------------

    def _pump(self) -> None:
        """Process one reply quantum, then sweep worker liveness."""
        by_conn = {w.reply: w for w in self._workers.values()}
        try:
            ready = connection.wait(list(by_conn), timeout=self.poll_s)
        except OSError:  # a conn closed under us (stop() raced): resweep
            ready = []
        for r in ready:
            worker = by_conn.get(r)
            if worker is None or worker.id not in self._workers:
                continue  # buried while we iterated
            try:
                payload = r.recv_bytes()
            except (EOFError, OSError):
                self._on_worker_death(worker.id)
                continue
            self._on_reply(payload)
        self._check_workers()

    def _drain_replies(self) -> None:
        """Non-blocking sweep of every reply already in flight."""
        progressed = True
        while progressed:
            progressed = False
            for worker in list(self._workers.values()):
                try:
                    while worker.reply.poll(0):
                        self._on_reply(worker.reply.recv_bytes())
                        progressed = True
                except (EOFError, OSError):
                    self._on_worker_death(worker.id)

    def _on_reply(self, payload: bytes) -> None:
        msg = pickle.loads(payload)
        kind, wid = msg[0], msg[1]
        if wid in self._workers:  # never resurrect a buried worker's heartbeat
            self._last_hb[wid] = time.monotonic()
            self._silence[wid] = 0.0
        if kind in ("hb", "ready"):
            return
        if kind == "steal_ok":
            self._on_steal_grant(wid, msg[2], msg[3])
            return
        # any unit/call reply closes that worker's one-command window
        if wid in self._workers and self._outstanding.get(wid, 0) > 0:
            self._outstanding[wid] -= 1
        if kind in ("unit_done", "unit_error"):
            # Per-worker service-time EMA: replies from one batch arrive
            # back-to-back, so the gap since the previous reply (or the
            # batch send) is this unit's observed service time — what the
            # steal gate feeds on.
            mark = self._reply_mark.get(wid)
            now_pc = time.perf_counter()
            if mark is not None:
                service = max(now_pc - mark, 1e-6)
                prev = self._task_ema.get(wid)
                self._task_ema[wid] = service if prev is None else 0.5 * prev + 0.5 * service
            self._reply_mark[wid] = now_pc
        if kind in ("call_done", "call_error"):
            if msg[3] not in self._pending_calls:
                if kind == "call_done":
                    shm.discard_tree(msg[4])  # its segments, or they leak
                return  # superseded call (replayed after a death): drop it
            self.engine.current_report.ipc_bytes += len(payload)
            self._call_results[msg[3]] = msg
            return
        # unit replies route to their context by epoch; no live context of
        # that epoch (an earlier run, or one already closed) means stale
        epoch, index = msg[2], msg[3]
        order = self._dispatch_order.get(wid)
        if order:  # the replied unit is no longer stealable from this worker
            self._dispatch_order[wid] = [
                e for e in order if not (e[0].epoch == epoch and e[1].index == index)
            ]
        ctx = self._contexts.get(epoch)
        stale = ctx is None or ctx.state.errors or ctx.state.is_done(index)
        unit = None if stale else ctx.inflight.pop(index, None)
        if unit is None:
            # Stale: an earlier run, or a duplicate after replay.  A
            # dropped unit_done still owns reply segments — unlink them.
            if kind == "unit_done":
                shm.discard_tree(msg[4])
            return
        ctx.report.ipc_bytes += len(payload)
        self._release_unit(unit)
        if self._shm is not None:
            refs = ctx.shm_pins.pop(index, None)
            if refs:
                self._shm.unpin_refs(refs)
        if kind == "unit_error":
            label, key = _label(unit)
            handle = self._workers.get(wid)
            ctx.record_failure(
                index,
                wid,
                str(msg[4]).strip().splitlines()[-1] if msg[4] else "unit_error",
                handle.log_path if handle is not None else None,
            )
            ctx.state.fail(
                ClusterFailedError(
                    f"{label} failed on worker {wid}:\n{msg[4]}",
                    task_key=key,
                    **ctx.error_kwargs(index),
                )
            )
            return
        _, _, _, _, result, loaded, shm_wrote = msg
        report = ctx.report
        lease = shm.tree_lease(result) if unit.publish else None
        if lease is not None:
            # Published partial: the packed ref tree IS the unit's result —
            # the sibling fold forwards the descriptors and attaches the
            # segments in place.  The driver records the lease; nothing is
            # copied here, and the device stays for the fold.
            ctx.leases[index] = lease
            value = result
            if ctx.state.merge_key is not None:
                self._note_partial_bytes(ctx.state.merge_key, lease.nbytes)
        else:
            result, _segs = shm.unpack_tree(result)  # consume-and-unlink
            # a declined publish keeps its device for the fold, as a lease's does
            device = ctx.devices[index] if unit.publish else ctx.devices.pop(index, "cpu")
            value = _on_device(result, device)
            if ctx.state.merge_key is not None and unit.kind != "fold":
                self._note_partial_bytes(ctx.state.merge_key, _tree_nbytes(value))
        if unit.kind == "fold":
            # The worker-side chain replaces a driver merge dispatch: bill
            # the merge, credit the member bytes that never crossed the
            # driver, and release their segments — consumption is where
            # ownership ends.
            report.merges += 1
            for mi in unit.fold_group:
                ctx.devices.pop(mi, None)
                mlease = ctx.leases.pop(mi, None)
                if mlease is not None:
                    report.p2p_bytes += mlease.nbytes
                    shm.unlink_segments(mlease.segments)
        report.dispatches += 1
        report.remote_dispatches += 1
        report.bytes_loaded += loaded
        report.shm_bytes += shm_wrote
        t0, send_s = ctx.meta.get(index, (None, 0.0))
        wall = (time.perf_counter() - t0) if t0 is not None else 0.0
        self.profile.record_tasks(
            unit.tasks, kind=unit.kind, location=unit.location, dispatch_s=send_s, wall_s=wall
        )
        ctx.ready.extend(sorted(ctx.state.complete(unit, value), key=lambda u: u.index))

    def _check_workers(self) -> None:
        """Liveness sweep: bury dead processes and heartbeat-stale hangs.

        Staleness is debounced against the *driver-side* pump cadence: a
        worker's silence clock only advances by the time since the last
        check, capped at a few poll quanta.  While the driver pumps
        normally that accrues at real-time rate, so a genuinely mute
        worker still times out in ``heartbeat_timeout_s`` — but a driver
        stall contributes one capped tick instead of the whole gap.
        """
        now = time.monotonic()
        tick = min(now - self._last_pump, max(self.poll_s, self.heartbeat_s) * 4)
        self._last_pump = now
        for wid, handle in list(self._workers.items()):
            if not handle.alive():
                self._on_worker_death(wid)
                continue
            silence = self._silence.get(wid, 0.0) + tick
            self._silence[wid] = silence
            if silence > self.heartbeat_timeout_s:
                self._on_worker_death(wid)

    # -- work stealing (DESIGN.md §15) ----------------------------------------

    def _steal_model(self):
        """The fitted :class:`~repro_torch.api.autotune.CostModel`, if any
        tuner has one — the steal gate's first choice of evidence."""
        for entry in self._tuners.values():
            for item in entry if isinstance(entry, tuple) else (entry,):
                model = getattr(item, "model", None)
                if model is not None:
                    return model
        return None

    def _steal_task_s(self) -> float:
        """Fallback per-task seconds when no model is fitted: the profiled
        mean unit wall (send → reply), floored."""
        walls = [p.mean_wall_s for p in self.profile.profiles.values() if p.mean_wall_s > 0.0]
        return max(sum(walls) / len(walls), 1e-4) if walls else 1e-3

    def _steal_gate(
        self, victim_wid: int, thief_wid: int, queued_tasks: int, operand_bytes: int = 0
    ) -> bool:
        """Cost-model steal decision for ``queued_tasks`` waiting units.

        The wait side uses the victim's observed service-time EMA when one
        exists; the fetch side charges the thief's EMA for executing the
        stolen units — so a slow worker never steals work back from a fast
        one.  With the shm data plane a steal moves descriptors, not bytes.
        """
        return should_steal(
            self._steal_model(),
            queued_tasks=queued_tasks,
            operand_bytes=0 if self._shm is not None else operand_bytes,
            fallback_task_s=self._steal_task_s(),
            victim_task_s=self._task_ema.get(victim_wid),
            thief_task_s=self._task_ema.get(thief_wid, 0.0),
        )

    def _idle_workers(self) -> list[_WorkerHandle]:
        """Live workers with nothing outstanding and nothing staged."""
        return [
            self._workers[wid]
            for wid in sorted(self._workers)
            if self._workers[wid].alive()
            and self._outstanding.get(wid, 0) == 0
            and wid not in self._outbox
            and wid not in self._preempting
        ]

    def _maybe_steal(self) -> None:
        """Probe the most-loaded worker on behalf of an idle sibling.

        The probe asks for every un-replied unit; the victim grants
        whatever it has not started — the head it already popped keeps
        running, so exactly-once needs no further coordination.  At most
        one probe per victim is in flight, and the probe (a few hundred
        bytes) is exempt from the one-command window.
        """
        if not self.steal_enabled or not self._contexts:
            return
        idle = self._idle_workers()
        if not idle:
            return
        thief = min(idle, key=lambda w: (self._task_ema.get(w.id, 0.0), w.id))
        for vid in sorted(self._workers, key=lambda w: -self._outstanding.get(w, 0)):
            if vid in self._steal_probes or vid in self._preempting:
                continue
            queue = self._dispatch_order.get(vid, ())
            backlog = self._outstanding.get(vid, 0) - 1
            if backlog < 1 or not queue:
                continue
            cand = [(c, u) for c, u in queue if not c.state.is_done(u.index)]
            if not cand or not self._steal_gate(vid, thief.id, backlog):
                continue
            victim = self._workers.get(vid)
            if victim is None or not victim.alive():
                continue
            token = next(self._steal_seq)
            wants = tuple((c.epoch, u.index) for c, u in cand)
            try:
                sent = victim.send(("steal", token, wants))
            except OSError:
                self._on_worker_death(vid)
                continue
            cand[0][0].report.ipc_bytes += sent
            self._steal_probes[vid] = (token, wants)
            return  # one probe per pump round bounds control traffic

    def _on_steal_grant(self, wid: int, token: int, granted: tuple) -> None:
        """Fold a ``steal_ok`` reply in: void the victim's claim on every
        granted unit and requeue it for an idle survivor.

        Each granted unit was removed from the victim's local queue before
        execution, so its reply will never come: its window slot is
        released here, its dispatch pins dropped, its attempt refunded via
        :meth:`_SchedulerState.release` (a steal is not a failure), and the
        unit lands in its context's replay queue.  A grant that raced a
        completed unit is dropped harmlessly.
        """
        probe = self._steal_probes.pop(wid, None)
        if probe is not None and probe[0] != token:  # superseded probe
            self._steal_probes[wid] = probe
        if wid in self._workers and granted:
            self._outstanding[wid] = max(0, self._outstanding.get(wid, 0) - len(granted))
        order = self._dispatch_order.get(wid)
        if order and granted:
            taken = set(granted)
            self._dispatch_order[wid] = [
                e for e in order if (e[0].epoch, e[1].index) not in taken
            ]
        for epoch, index in granted:
            ctx = self._contexts.get(epoch)
            if ctx is None or ctx.state.errors:
                continue
            unit = ctx.inflight.pop(index, None)
            if unit is None or ctx.state.is_done(index):
                continue
            self._release_unit(unit)
            if self._shm is not None:
                refs = ctx.shm_pins.pop(index, None)
                if refs:
                    self._shm.unpin_refs(refs)
                if unit.publish:
                    # The victim never started the granted unit, but its
                    # voided attempt's publish name is swept all the same.
                    shm.sweep_segments(
                        self._publish_name(epoch, index, ctx.state.attempts[index] - 1)
                    )
            if not ctx.state.release(unit):
                continue  # completed under the victim after all: stale grant
            ctx.report.steals += 1
            self.steal_log.append({"unit": index, "epoch": epoch, "victim": wid, "kind": "probe"})
            ctx.stolen_from[index] = wid
            ctx.replays.append(unit)

    def _steal_reroute(self, unit: _Unit, ctx: _DrainContext) -> bool:
        """Driver-side steal: a ready unit whose location owner is busy
        goes straight to an idle sibling when the cost gate approves."""
        if not self.steal_enabled:
            return False
        owner_wid = self._by_location.get(unit.location)
        if owner_wid is None:
            return False
        idle = [
            w for w in self._idle_workers()
            if w.id != owner_wid and w.location != unit.location
        ]
        if not idle:
            return False
        thief = min(idle, key=lambda w: (self._task_ema.get(w.id, 0.0), w.id))
        backlog = self._outstanding.get(owner_wid, 0)
        if not self._steal_gate(owner_wid, thief.id, backlog):
            return False
        if not self._dispatch_remote(unit, ctx, target=thief):
            return False
        ctx.report.steals += 1
        self.steal_log.append(
            {"unit": unit.index, "epoch": ctx.epoch, "victim": owner_wid, "kind": "reroute"}
        )
        return True

    # -- elasticity: grow / shrink (DESIGN.md §15) -----------------------------

    def _scale_report(self):
        """Where a scale event bills: the oldest live context's report when
        a run is in flight, else the engine's current report."""
        for ctx in self._contexts.values():
            return ctx.report
        return self.engine.current_report

    def grow(self) -> int | None:
        """Add one roamer worker (autoscaler hook; also a manual knob).

        Roamers own no partition — they are fed exclusively by the steal
        paths.  Respects ``max_workers``; bills one ``scale_events``.
        """
        if len([w for w in self._workers.values() if w.alive()]) >= self.max_workers:
            return None
        wid = next(self._next_wid)
        self._used_wids.add(wid)
        self._roamers.add(wid)
        # Synthetic negative location: unique, never routed to by
        # _worker_for, so the only way work reaches a roamer is a steal.
        self._spawn(wid, -wid)
        self._scale_report().scale_events += 1
        self.scale_log.append({"event": "grow", "worker": wid})
        return wid

    def shrink(self, wid: int | None = None) -> int | None:
        """Preempt one worker — planned scale-down as deliberate death.

        The drain IS the fault path: the preempted worker's queued and
        in-flight units go through the requeue/replay machinery a kill
        exercises, except the voided attempts are refunded and nothing
        bills ``retries``.  Default victim: the idlest roamer, else the
        highest-wid live worker.  Bills one ``scale_events``.
        """
        if wid is None:
            candidates = sorted(
                (w for w in self._roamers if w in self._workers),
                key=lambda w: -self._idle_ticks.get(w, 0),
            ) or sorted(self._workers, reverse=True)
            wid = candidates[0] if candidates else None
        if wid is None or wid not in self._workers:
            return None
        self._preempting.add(wid)
        self._scale_report().scale_events += 1
        self.scale_log.append({"event": "shrink", "worker": wid})
        self._on_worker_death(wid)
        return wid

    def _autoscale(self) -> None:
        """One autoscaler tick: grow on queue depth, retire idle roamers."""
        if not self.autoscale:
            return
        live = [wid for wid, w in self._workers.items() if w.alive()]
        if not live:
            return
        backlog = sum(max(0, self._outstanding.get(wid, 0) - 1) for wid in live) + sum(
            len(c.ready) + len(c.replays) for c in self._contexts.values()
        )
        if backlog >= self.scale_up_backlog * len(live) and len(live) < self.max_workers:
            self.grow()
            return
        for wid in sorted(self._roamers & set(self._workers)):
            if (
                self._outstanding.get(wid, 0) == 0
                and wid not in self._outbox
                and wid not in self._preempting
            ):
                streak = self._idle_ticks.get(wid, 0) + 1
                self._idle_ticks[wid] = streak
                if (
                    streak >= self.scale_idle_ticks
                    and len([w for w in self._workers.values() if w.alive()]) > self.min_workers
                ):
                    self.shrink(wid)
            else:
                self._idle_ticks[wid] = 0

    def _on_worker_death(self, wid: int) -> None:
        """Supervisor: bury a dead/hung worker and replay its units."""
        handle = self._workers.pop(wid, None)
        if handle is None:
            return
        if self._by_location.get(handle.location) == wid:
            del self._by_location[handle.location]
        self._attached = {k: v for k, v in self._attached.items() if k[0] != wid}
        self._last_hb.pop(wid, None)
        self._silence.pop(wid, None)
        self._outstanding.pop(wid, None)
        self._outbox.pop(wid, None)  # staged units are assigned: requeued below
        self._steal_probes.pop(wid, None)
        self._dispatch_order.pop(wid, None)
        self._idle_ticks.pop(wid, None)
        self._task_ema.pop(wid, None)
        self._reply_mark.pop(wid, None)
        self._roamers.discard(wid)
        # Planned preemption (scale-down) drains through this very path,
        # but bills scale_events (already done by shrink()), not retries,
        # and refunds the voided attempts.
        preempted = wid in self._preempting
        self._preempting.discard(wid)
        cause = (
            "preempted (scale-down)"
            if preempted
            else "hung (heartbeat stale)" if handle.alive() else "process died"
        )
        if handle.alive():  # hung or preempted, not dead: put it down
            handle.process.terminate()
        handle.process.join(1.0)
        # Salvage completed work: replies that landed before the death are
        # still intact on the worker's own pipe.
        try:
            while handle.reply.poll(0):
                self._on_reply(handle.reply.recv_bytes())
        except (EOFError, OSError):
            pass  # torn end of the pipe: nothing more to salvage
        finally:
            for conn in (handle._conn, handle.reply):
                try:
                    conn.close()
                except OSError:
                    pass
        # Undelivered replies died with the worker; their segments did not.
        if handle.result_prefix:
            shm.sweep_segments(handle.result_prefix)
        # Requeue the dead worker's units across EVERY live context.
        for ctx in list(self._contexts.values()):
            lost = ctx.state.requeue(wid)
            for unit in lost:
                if ctx.state.errors:
                    break  # poisoned: _close_context releases the rest
                ctx.inflight.pop(unit.index, None)
                # Release-on-requeue: the dead dispatch's pins must not
                # outlive it.  The replay's own dispatch re-pins.
                self._release_unit(unit)
                if self._shm is not None:
                    refs = ctx.shm_pins.pop(unit.index, None)
                    if refs:
                        self._shm.unpin_refs(refs)
                    if unit.publish:
                        # The dead worker may have published this attempt's
                        # partial without delivering the reply; the replay
                        # publishes under a fresh attempt name.
                        shm.sweep_segments(
                            self._publish_name(
                                ctx.epoch, unit.index, ctx.state.attempts[unit.index] - 1
                            )
                        )
                if preempted:
                    ctx.state.refund_attempt(unit.index)
                    ctx.replays.append(unit)
                    continue
                label, key = _label(unit)
                ctx.record_failure(unit.index, wid, cause, handle.log_path)
                if ctx.state.attempts[unit.index] > self.max_retries:
                    ctx.state.fail(
                        ClusterFailedError(
                            f"{label} poisoned: {ctx.state.attempts[unit.index]} "
                            f"attempts died with their workers "
                            f"(max_retries={self.max_retries})",
                            task_key=key,
                            **ctx.error_kwargs(unit.index),
                        )
                    )
                    break
                ctx.report.retries += 1
                self.retry_log.append(
                    {"unit": unit.index, "epoch": ctx.epoch, "worker": wid, "cause": cause}
                )
                # Enqueue, don't dispatch: this may run deep inside a _pump.
                ctx.replays.append(unit)

    # -- driver-level remote calls --------------------------------------------

    def _remote_call(
        self, fn_ref: tuple, args: tuple, key_repr: str, *, target: _WorkerHandle | None = None
    ):
        """One driver-level RPC: export big tensor args, pin them, run it.

        Tensor args export through the arena's identity cache, so an
        iterative driver loop passing the same tensors every call copies
        them into shared memory once and ships descriptors thereafter.
        The pins span the whole call including replays.
        """
        report = self.engine.current_report
        arg_refs: list[ShmBlockRef] = []
        payload_args = []
        devices = []
        for a in args:
            if not isinstance(a, torch.Tensor):
                payload_args.append(a)  # plain python values ship as themselves
                devices.append("")
                continue
            devices.append(str(a.device))
            ref, wrote = self._shm.export(a) if self._shm is not None else (None, 0)
            if ref is not None:
                report.shm_bytes += wrote
                arg_refs.append(ref)
                payload_args.append(ref)
            else:
                payload_args.append(_inline(a))
        result_device = next((d for d in devices if d), "cpu")
        if arg_refs:
            self._shm.pin_refs(arg_refs)
        try:
            result = self._remote_call_loop(
                fn_ref, (tuple(payload_args), tuple(devices)), key_repr, target
            )
        finally:
            if arg_refs:
                self._shm.unpin_refs(arg_refs)
        return _on_device(result, result_device)

    def _remote_call_loop(self, fn_ref: tuple, payload: tuple, key_repr: str, target=None):
        report = self.engine.current_report
        failures = 0
        history: list[dict] = []

        def poisoned(message: str) -> ClusterFailedError:
            return ClusterFailedError(
                message,
                task_key=key_repr,
                attempts=tuple(history),
                log_paths=tuple(dict.fromkeys(a["log"] for a in history if a["log"])),
            )

        def died(worker, error: str) -> None:
            nonlocal failures
            history.append({"worker": worker.id, "error": error, "log": worker.log_path})
            failures += 1
            if target is not None or failures > self.max_retries:
                raise poisoned(
                    f"call {key_repr} poisoned: {failures} workers died "
                    f"under it (max_retries={self.max_retries})"
                )
            report.retries += 1

        args, devices = payload
        while True:
            # Pending batches first: the window invariant (send only to
            # a worker parked in recv) must hold for THIS send too.
            self._flush_outbox()
            worker = target or self._survivor() or self._worker_for(0)
            if not self._await_window(worker):
                if target is not None:
                    died(worker, "process died")
                continue  # died while we waited for its window: re-resolve
            call_id = next(self._call_seq)
            blob = pickle.dumps(
                ("call", self._epoch, call_id, fn_ref, args, devices, key_repr)
            )
            try:
                report.ipc_bytes += worker.send_raw(blob)
            except OSError:
                self._on_worker_death(worker.id)
                died(worker, "process died")
                continue
            self._pending_calls.add(call_id)
            self._outstanding[worker.id] = self._outstanding.get(worker.id, 0) + 1
            while call_id not in self._call_results:
                if worker.id not in self._workers or not worker.alive():
                    # Collect any reply that landed before the death so a
                    # completed call is not replayed needlessly.
                    self._on_worker_death(worker.id)
                    self._drain_replies()
                    break
                self._pump()
            msg = self._call_results.pop(call_id, None)
            self._pending_calls.discard(call_id)  # resolved or abandoned: done
            if msg is None:  # worker died mid-call: replay on a survivor
                died(worker, "process died mid-call")
                continue
            if msg[0] == "call_error":
                handle = self._workers.get(msg[1])
                history.append(
                    {
                        "worker": msg[1],
                        "error": str(msg[4]).strip().splitlines()[-1] if msg[4] else "call_error",
                        "log": handle.log_path if handle is not None else None,
                    }
                )
                raise poisoned(f"call {key_repr} failed on worker {msg[1]}:\n{msg[4]}")
            report.dispatches += 1
            report.remote_dispatches += 1
            result, _segs = shm.unpack_tree(msg[4])  # consume-and-unlink
            report.shm_bytes += msg[5]
            return result

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        """Stop the worker pool (idempotent; workers respawn on next use).

        Shared-memory teardown happens AFTER the workers are down: unlink
        the arena, then sweep the whole name prefix — which also reaps any
        reply segment a worker packed but whose message was never consumed
        — so no ``/dev/shm`` entry outlives the executor.
        """
        # In-flight pipelined submissions drain first (while the pool is
        # still up); their outcomes stay on their futures.
        self._drain_pipeline()
        self._contexts.clear()
        workers = list(self._workers.values())
        self._workers.clear()
        self._by_location.clear()
        self._attached.clear()
        self._last_hb.clear()
        self._manifests.clear()
        self._call_results.clear()
        self._pending_calls.clear()
        self._outstanding.clear()
        self._outbox.clear()
        self._dispatch_order.clear()
        self._steal_probes.clear()
        self._roamers.clear()
        self._idle_ticks.clear()
        self._preempting.clear()
        self._task_ema.clear()
        self._reply_mark.clear()
        self._silence.clear()
        for w in workers:
            w.stop()
        if self._shm is not None:
            self._shm.close()
            shm.sweep_segments(self._shm.prefix)
        super().close()
