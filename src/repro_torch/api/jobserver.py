"""JobServer — multi-tenant engine-as-a-service over the execution layer.

Everything below the plan boundary so far serves ONE program running one
plan at a time; this module (DESIGN.md §12) turns the engine into a
long-lived *service*: many concurrent clients submit
:class:`~repro_torch.api.plan.ExecutionPlan`\\ s, the server multiplexes them
onto a shared executor pool at **unit granularity**, and job state is
durable — a killed server restarts and resumes in-flight jobs from its
write-ahead journal instead of recomputing them.  The exemplar shapes are
Flux's journaled ``ExecutionContext`` (replay-from-journal) and
Chunks-and-Tasks' separation of work *submission* from work *placement*.

Architecture (one sentence per layer):

* **admission** — a bounded count of open jobs; past it, ``submit`` raises
  the typed :class:`JobRejected` instead of queueing unboundedly;
* **scheduling** — one scheduler thread interleaves READY UNITS from every
  open job, picking the next tenant by stride (virtual-time) weighted
  fairness: tenant ``t``'s pass advances by ``1/weight`` per unit, lowest
  pass runs next — a 2× weight tenant gets 2× the unit slots, and no
  tenant starves (its pass eventually undercuts every busier one);
* **execution** — units run through the pooled executor's shared core
  (:meth:`~repro_torch.api.executors._PlanExecutor._run_unit`) with the
  engine's report swapped to the job's own segment around every unit, so
  per-job accounting survives multiplexing on one
  :class:`~repro_torch.core.engine.TaskEngine`;
* **shared assets** — ONE :class:`~repro_torch.api.executors.SharedAssets`
  (prepare cache, profiles, autotuners) serves every tenant: geometry-based
  keys (:func:`~repro_torch.api.lowering.inputs_signature`) mean tenant B's
  ``SplIter("auto")`` starts from the granularity tenant A's probes found;
* **durability** — every accepted job appends its fingerprint + replay
  payload to a :class:`~repro_torch.api.journal.JobJournal`; every
  completed unit appends its key + a host copy of its partial result;
  scheduler state (tenant passes, per-job cumulative reports) snapshots
  periodically via :class:`~repro_torch.checkpoint.checkpointer.Checkpointer`
  (atomic COMMITTED-marker layout).  Restart = full journal replay + newest
  committed snapshot: unfinished durable jobs re-lower under their
  journaled resolved policy, journaled units restore as completed
  (``Job.restored_units``), and only the remainder recomputes
  (``Job.recomputed_units``) — bit-identically, because unit partials are
  exact host copies and the merge folds them in plan order either way.

Lifecycle events stream per job:
``queued → preparing → running(k/n units) → merged → done | failed``
(plus ``resumed`` after a restart), each a :class:`JobEvent` in
``Job.events`` and the server-wide ``event_log``.

Devices.  Units launch their kernels asynchronously; the host copy of a
completed unit's partial (``.cpu()``, journaled servers only) waits for
the unit's queued kernels, and that wait is the durability point.  A
durable job's payload records each input's and extra argument's device
type; on restart the blocks go back onto it — a CUDA plan onto the current
CUDA device, and an error where there is none — so a resumed job runs its
kernels where it first ran them, never silently on the CPU, and its
journaled partials are restored onto the same device.  A job that had
finished before the restart returns its journaled value on the host.
"""

from __future__ import annotations

import collections
import itertools
import os
import pickle
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch._pytree import tree_map
from repro_torch.api.executors import (
    ComputeResult,
    SharedAssets,
    _PlanExecutor,
    _default_local,
)
from repro_torch.api.fnref import decode_fn, encode_fn
from repro_torch.api.futures import Deferred
from repro_torch.api.journal import JobJournal
from repro_torch.api.lowering import key_summary, lower, plan_fingerprint
from repro_torch.api.plan import ExecutionPlan, MapReduceSpec
from repro_torch.api.policy import SplIter
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.blocked import BlockedArray, resolve_device
from repro_torch.core.engine import EngineReport

__all__ = ["JobServer", "Job", "JobEvent", "JobRejected", "JobFailedError"]


def _to_host(x: Any) -> Any:
    """A tensor's host copy: a numpy array (a CPU tensor for bf16, which
    numpy lacks); anything else unchanged.  ``.cpu()`` waits for the
    tensor's queued kernels."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return x


def _on_device(tree: Any, device: torch.device) -> Any:
    """A host tree's arrays as tensors on ``device``."""

    def put(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x).to(device)
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return x

    return tree_map(put, tree)


def _device_of(x: Any) -> str | None:
    return x.device.type if isinstance(x, torch.Tensor) else None


def _rebuild_device(device_type: str) -> torch.device:
    """The device a journaled input goes back onto: the current CUDA device
    for a CUDA plan (an error on a host without one), else the CPU."""
    try:
        return resolve_device(device_type)
    except RuntimeError as e:
        raise RuntimeError(
            f"a journaled job's inputs were on {device_type!r} and this host has no "
            f"such device: {e}"
        ) from e


class JobRejected(RuntimeError):
    """Typed admission-control rejection (``reason``: why, machine-readable).

    Raised synchronously by :meth:`JobServer.submit` — a rejected plan was
    never journaled and owns no server state; the client may back off and
    resubmit.  ``reason`` is ``"queue_full"`` or ``"closed"``.
    """

    def __init__(self, message: str, *, reason: str):
        super().__init__(message)
        self.reason = reason


class JobFailedError(RuntimeError):
    """A waited-on job finished ``failed``; carries the job id + summary."""

    def __init__(self, job_id: str, error: str):
        super().__init__(f"{job_id} failed: {error}")
        self.job_id = job_id
        self.error = error


class JobEvent:
    """One lifecycle event: ``(job_id, kind, detail, completed/total)``."""

    __slots__ = ("job_id", "kind", "detail", "completed", "total", "time")

    def __init__(self, job_id, kind, detail="", completed=0, total=0):
        self.job_id = job_id
        self.kind = kind
        self.detail = detail
        self.completed = completed
        self.total = total
        self.time = time.time()

    def __repr__(self):
        frac = f" {self.completed}/{self.total}" if self.total else ""
        detail = f" ({self.detail})" if self.detail else ""
        return f"<JobEvent {self.job_id} {self.kind}{frac}{detail}>"


class Job:
    """Server-side state of one submission (also the client's handle).

    Scheduling internals (unit deques, scheduler state) are owned by the
    server's scheduler thread; clients read the public fields — ``status``,
    ``events``, ``result`` / ``report`` / ``error`` after ``done`` — and
    the resume counters ``restored_units`` (journal-restored completions)
    vs ``recomputed_units`` (units this incarnation actually ran).
    """

    def __init__(self, job_id, tenant, weight, spec, fingerprint, payload):
        self.id = job_id
        self.tenant = tenant
        self.weight = weight
        self.spec: MapReduceSpec | None = spec
        self.fingerprint = fingerprint
        self.payload = payload            # durable replay bytes, or None
        self.status = "queued"
        self.result: Any = None
        self.report: EngineReport | None = None
        self.error: str | None = None
        self.events: list[JobEvent] = []
        self.done = threading.Event()
        self.total_units = 0
        self.restored_units = 0
        self.recomputed_units = 0
        # resume bookkeeping (populated by journal replay)
        self.completed_keys: dict[str, bytes] = {}
        self.resolved_policy = None
        self.prior_report: EngineReport | None = None
        # scheduler-thread internals
        self._segment: EngineReport | None = None
        self._units = None
        self._state = None
        self._merge = None
        self._graph = None
        self._tuner = None
        self._ready: collections.deque = collections.deque()
        self._t0 = 0.0

    @property
    def durable(self) -> bool:
        return self.payload is not None

    @property
    def open(self) -> bool:
        return self.status in ("queued", "preparing", "running")


class JobServer:
    """Long-lived, multi-tenant, durable front-end over one executor pool.

    Args:
      root: durability directory (journal + snapshots).  ``None`` runs the
        server in-memory: full multiplexing/fairness, no resume.
      executor: the pooled backend (any ``_PlanExecutor`` — Local,
        Threaded, Mesh, Stream).  Defaults to a server-owned
        :class:`~repro_torch.api.executors.LocalExecutor`.  The server adopts ONE
        :class:`SharedAssets` into it, making its caches cross-tenant.
      max_pending: admission bound — maximum simultaneously OPEN jobs
        (queued/preparing/running); the next ``submit`` past it raises
        :class:`JobRejected`.
      snapshot_every: scheduler-state snapshot period, in completed units.
      fsync: journal write-ahead durability (tests may relax it).
      autostart: spawn the scheduler thread immediately (tests that drive
        recovery state inspection may delay with ``autostart=False`` and
        call :meth:`start`).
    """

    def __init__(
        self,
        *,
        root: str | None = None,
        executor: _PlanExecutor | None = None,
        max_pending: int = 16,
        snapshot_every: int = 8,
        fsync: bool = True,
        autostart: bool = True,
    ):
        self.root = root
        self._owns_executor = executor is None
        self.executor = executor if executor is not None else _default_local()
        self.assets = SharedAssets()
        self.executor.adopt_shared_assets(self.assets)
        self.max_pending = max_pending
        self.snapshot_every = snapshot_every
        self.journal: JobJournal | None = None
        self.checkpointer: Checkpointer | None = None
        self._jobs: dict[str, Job] = {}
        self._order: list[str] = []
        self._tenant_pass: dict[str, float] = {}
        self._seq = itertools.count()
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._closed = False
        self.event_log: list[JobEvent] = []
        self._completions_total = 0
        self._units_since_snapshot = 0
        self.resumed_jobs = 0
        if root is not None:
            os.makedirs(root, exist_ok=True)
            self.checkpointer = Checkpointer(os.path.join(root, "snapshots"))
            self._recover(os.path.join(root, "journal.bin"))
            self.journal = JobJournal(os.path.join(root, "journal.bin"), fsync=fsync)
        self._thread = threading.Thread(
            target=self._loop, name="repro-torch-jobserver", daemon=True
        )
        if autostart:
            self._thread.start()

    def start(self) -> None:
        if not self._thread.is_alive():
            self._thread.start()

    # ------------------------------------------------------------ submit --

    def submit(self, plan: ExecutionPlan, *, tenant="default", weight=1) -> Job:
        """Admit one plan; returns its :class:`Job` handle (non-blocking).

        Admission is checked and the submission journaled BEFORE the
        scheduler sees the job — write-ahead: a crash right after
        ``submit`` returns still resumes the job (when its plan is
        durable, i.e. fn/combine referencable and inputs resident).  An
        in-memory server (``root=None``) encodes no replay payload, unlike
        the JAX package's: nothing could replay it, and encoding copies
        every input block to the host on every submission.
        """
        spec = plan.spec
        with self._cond:
            if self._closed or self._stop.is_set():
                raise JobRejected("server is closed", reason="closed")
            pending = sum(1 for j in self._jobs.values() if j.open)
            if pending >= self.max_pending:
                raise JobRejected(
                    f"admission queue full ({pending}/{self.max_pending} "
                    f"open jobs)",
                    reason="queue_full",
                )
            job_id = f"job-{next(self._seq):04d}"
            fingerprint = plan_fingerprint(spec)
            payload = self._encode_payload(spec) if self.journal is not None else None
            if self.journal is not None:
                self.journal.append(
                    ("job", job_id, tenant, weight, fingerprint, payload)
                )
            job = Job(job_id, tenant, weight, spec, fingerprint, payload)
            self._jobs[job_id] = job
            self._order.append(job_id)
            self._emit(job, "queued", detail=f"tenant={tenant} weight={weight}")
            self._cond.notify_all()
        return job

    def wait(self, job: Job, timeout: float | None = None) -> ComputeResult:
        """Block until ``job`` finishes; raise :class:`JobFailedError` on
        failure.  The report is a fresh copy (channel semantics)."""
        if not job.done.wait(timeout):
            raise TimeoutError(f"{job.id} still {job.status} after {timeout}s")
        if job.status == "failed":
            raise JobFailedError(job.id, job.error or "unknown error")
        return ComputeResult(
            value=job.result, report=EngineReport.from_json(job.report.to_json())
        )

    def jobs(self) -> list[Job]:
        with self._cond:
            return [self._jobs[j] for j in self._order]

    # -------------------------------------------------- durable payloads --

    @staticmethod
    def _encode_payload(spec: MapReduceSpec) -> bytes | None:
        """The replay payload: everything needed to rebuild ``spec`` in a
        fresh process — or None when the plan is not durably encodable
        (unreferencable callables, chunk-backed inputs, a ``Deferred``
        extra).  Non-durable jobs still RUN normally; they just cannot
        survive a restart.  Blocks and extras travel as host copies beside
        their device type."""
        fn_ref = encode_fn(spec.fn)
        if fn_ref is None:
            return None
        combine_ref = None
        if spec.combine is not None:
            combine_ref = encode_fn(spec.combine)
            if combine_ref is None:
                return None
        inputs = []
        for a in spec.inputs:
            if a.is_chunked:
                return None
            inputs.append(
                (
                    tuple(_to_host(b) for b in a.blocks),
                    np.asarray(a.placements),
                    int(a.num_locations),
                    a.device.type,
                )
            )
        if any(isinstance(e, Deferred) for e in spec.extra_args):
            return None
        try:
            return pickle.dumps(
                {
                    "kind": spec.kind,
                    "policy": spec.policy,
                    "fn": fn_ref,
                    "combine": combine_ref,
                    "extra_args": tuple(
                        (_to_host(e), _device_of(e)) for e in spec.extra_args
                    ),
                    "inputs": tuple(inputs),
                }
            )
        except Exception:
            return None

    @staticmethod
    def _decode_payload(payload: bytes) -> MapReduceSpec:
        d = pickle.loads(payload)
        inputs = tuple(
            BlockedArray.from_blocks(
                blocks, placements, nloc, device=_rebuild_device(device_type)
            )
            for blocks, placements, nloc, device_type in d["inputs"]
        )
        extras = tuple(
            e if device_type is None else _on_device(e, _rebuild_device(device_type))
            for e, device_type in d["extra_args"]
        )
        return MapReduceSpec(
            inputs=inputs,
            policy=d["policy"],
            kind=d["kind"],
            fn=decode_fn(d["fn"]),
            extra_args=extras,
            combine=decode_fn(d["combine"]) if d["combine"] is not None else None,
        )

    # ----------------------------------------------------------- recover --

    def _recover(self, journal_path: str) -> None:
        """Rebuild job state from the journal + newest committed snapshot."""
        max_seq = -1
        for rec in JobJournal.replay(journal_path):
            kind = rec[0]
            if kind == "job":
                _, job_id, tenant, weight, fingerprint, payload = rec
                job = Job(job_id, tenant, weight, None, fingerprint, payload)
                self._jobs[job_id] = job
                self._order.append(job_id)
                max_seq = max(max_seq, int(job_id.split("-")[1]))
            elif kind == "start":
                _, job_id, pol_bytes = rec
                if job_id in self._jobs:
                    self._jobs[job_id].resolved_policy = pickle.loads(pol_bytes)
            elif kind == "unit":
                _, job_id, ukey, value_bytes = rec
                if job_id in self._jobs:
                    self._jobs[job_id].completed_keys[ukey] = value_bytes
            elif kind in ("done", "failed"):
                _, job_id, detail = rec
                job = self._jobs.get(job_id)
                if job is None:
                    continue
                job.status = kind
                if kind == "done":
                    job.report = EngineReport.from_json(detail)
                    # The value itself is the merge unit's journaled
                    # partial; surface it (on the host) for post-restart
                    # wait() calls.
                    for key, blob in job.completed_keys.items():
                        if key.startswith("merge:"):
                            job.result = _on_device(
                                pickle.loads(blob), torch.device("cpu")
                            )
                else:
                    job.error = detail
                job.done.set()
        self._seq = itertools.count(max_seq + 1)

        extras: dict = {}
        if self.checkpointer is not None:
            try:
                manifest, _step = self.checkpointer.load_manifest()
                extras = manifest.get("extras", {})
            except FileNotFoundError:
                pass
        self._tenant_pass.update(extras.get("tenant_pass", {}))
        reports = extras.get("job_reports", {})

        for job in self._jobs.values():
            if not job.open:
                continue
            if job.payload is None:
                job.status = "failed"
                job.error = "job was not durable (unreferencable plan); lost at restart"
                job.done.set()
                self._emit(job, "failed", detail=job.error)
                continue
            job.spec = self._decode_payload(job.payload)
            if job.id in reports:
                job.prior_report = EngineReport.from_json(reports[job.id])
            job.status = "queued"
            self.resumed_jobs += 1
            self._emit(
                job,
                "resumed",
                detail=f"{len(job.completed_keys)} journaled units",
            )

    # --------------------------------------------------------- scheduler --

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                job = self._next_runnable()
                if job is None:
                    if self._closed and not any(
                        j.open for j in self._jobs.values()
                    ):
                        return
                    self._cond.wait(0.05)
                    continue
                tenant = job.tenant
                base = min(self._tenant_pass.values(), default=0.0)
                self._tenant_pass.setdefault(tenant, base)
                self._tenant_pass[tenant] += 1.0 / max(job.weight, 1)
            try:
                if self._stop.is_set():
                    return
                if job.status == "queued":
                    self._prepare(job)
                else:
                    self._step_unit(job)
            except BaseException as e:  # noqa: BLE001 — job-scoped failure
                self._fail(job, e)

    def _next_runnable(self) -> Job | None:
        """Earliest runnable job of the lowest-pass tenant (stride pick)."""
        candidates: dict[str, Job] = {}
        for jid in self._order:
            job = self._jobs[jid]
            if job.status == "queued" or (job.status == "running" and job._ready):
                candidates.setdefault(job.tenant, job)
        if not candidates:
            return None
        tenant = min(
            candidates, key=lambda t: (self._tenant_pass.get(t, 0.0), t)
        )
        return candidates[tenant]

    def _bind_report(self, job: Job) -> None:
        """Point the shared engine at this job's report segment.

        The multiplexing contract: ONE TaskEngine serves every job, so
        before each unit the engine's current report AND its trace mark
        swap to the job's segment — ``traces_total - segment.traces``
        reproduces exactly the mark a dedicated executor would hold, so
        trace deltas land on the job that paid them.
        """
        engine = self.executor.engine
        engine.report = job._segment
        engine._trace_mark = engine.traces_total - job._segment.traces

    def _prepare(self, job: Job) -> None:
        job.status = "preparing"
        self._emit(job, "preparing")
        ex = self.executor
        spec = job.spec
        job._t0 = time.perf_counter()
        if job.resolved_policy is not None:
            policy, tuner = job.resolved_policy, None
        else:
            policy, tuner = ex._resolve_policy(spec)
            job.resolved_policy = policy
            if self.journal is not None:
                # Journal the RESOLVED policy: a SplIter("auto") resume
                # must re-lower at the granularity the units were keyed
                # under, not whatever a fresh tuner would propose.
                self.journal.append(("start", job.id, pickle.dumps(policy)))
        job._tuner = tuner
        job._segment = EngineReport(mode=policy.mode_name)
        self._bind_report(job)
        prepared = ex._prepare(spec.inputs, policy, job._segment)
        graph = lower(spec, prepared.arrays, prepared.groups, ex.capabilities)
        units, state, merge_unit = ex._build_units(graph)
        job._units, job._state, job._merge, job._graph = (
            units, state, merge_unit, graph,
        )
        job.total_units = len(units)

        # Restore journaled completions BEFORE computing the ready set:
        # restored units never re-run, and a fully-restored dependency set
        # (e.g. every task unit of a killed-at-the-merge job) releases its
        # dependents immediately.
        ukeys = {u.index: self._unit_key(u) for u in units}
        job._ukeys = ukeys
        device = spec.inputs[0].device  # restored partials join the live ones
        for u in units:
            blob = job.completed_keys.get(ukeys[u.index])
            if blob is not None:
                state.complete(u, _on_device(pickle.loads(blob), device))
                job.restored_units += 1
        job._ready = collections.deque(
            u
            for u in units
            if not state.is_done(u.index)
            and all(state.is_done(d) for d in u.deps)
        )
        job.status = "running"
        self._emit(
            job,
            "running",
            detail=f"policy={policy.mode_name}",
            completed=job.restored_units,
            total=job.total_units,
        )
        if state.done.is_set():  # everything restored: straight to finish
            self._finish(job)

    @staticmethod
    def _unit_key(unit) -> str:
        """Restart-stable identity of one unit within its job.

        Same plan + same resolved policy re-lower to the same unit list in
        the same order, so the index disambiguates units sharing a task
        key (one jit key covers every block group of a map fn) and the
        address-free :func:`key_summary` + block ids pin the content.
        """
        if not unit.tasks:
            return f"merge:{unit.index}"
        blocks = ",".join(
            str(b) for task in unit.tasks for b in task.block_ids
        )
        return f"u{unit.index}:{key_summary(unit.tasks[0].key)}:{blocks}"

    def _step_unit(self, job: Job) -> None:
        unit = job._ready.popleft()
        self._bind_report(job)
        t0 = time.perf_counter()
        newly = self.executor._run_unit(unit, job._state)
        job._segment.wall_s += time.perf_counter() - t0
        if job._state.errors:
            self._fail(job, job._state.errors[0])
            return
        job._ready.extend(newly)
        job.recomputed_units += 1
        if self.journal is not None:
            # the durability point: the host copy waits for the unit's kernels
            host = tree_map(_to_host, job._state.results[unit.index])
            self.journal.append(
                ("unit", job.id, job._ukeys[unit.index], pickle.dumps(host))
            )
        completed = job.restored_units + job.recomputed_units
        if unit.kind == "merge":
            self._emit(job, "merged", completed=completed, total=job.total_units)
        else:
            self._emit(job, "running", completed=completed, total=job.total_units)
        with self._cond:
            self._completions_total += 1
            self._units_since_snapshot += 1
            want_snapshot = (
                self.checkpointer is not None
                and self._units_since_snapshot >= self.snapshot_every
            )
        if want_snapshot:
            self._snapshot()
        if job._state.done.is_set():
            self._finish(job)

    def _finish(self, job: Job) -> None:
        state, merge_unit = job._state, job._merge
        value = (
            state.results[merge_unit.index]
            if merge_unit is not None
            else list(state.results)
        )
        policy = job.resolved_policy
        if isinstance(policy, SplIter):
            job._segment.granularity = policy.partitions_per_location
        dt = time.perf_counter() - job._t0
        if job._tuner is not None:
            self.executor._feed_tuner(
                job._tuner, policy, job._graph, dt,
                traced=job._segment.traces > 0,
            )
        job.report = (
            job.prior_report.merge(job._segment)
            if job.prior_report is not None
            else job._segment
        )
        job.result = value
        job.status = "done"
        if self.journal is not None:
            self.journal.append(("done", job.id, job.report.to_json()))
        self._emit(
            job,
            "done",
            completed=job.restored_units + job.recomputed_units,
            total=job.total_units,
        )
        job.done.set()
        with self._cond:
            self._cond.notify_all()

    def _fail(self, job: Job, exc: BaseException) -> None:
        job.error = f"{type(exc).__name__}: {exc}"
        job.status = "failed"
        if self.journal is not None:
            self.journal.append(("failed", job.id, job.error))
        self._emit(job, "failed", detail=job.error)
        job.done.set()
        with self._cond:
            self._cond.notify_all()

    # ---------------------------------------------------------- snapshot --

    def _snapshot(self) -> None:
        """Periodic scheduler-state snapshot (COMMITTED-marker layout).

        Pure-JSON extras, zero array leaves: the journal owns unit
        results; the snapshot carries what full replay alone cannot
        reconstruct — tenant fairness passes and each open job's
        cumulative report (pre-crash segments merged in), read back
        template-free via :meth:`Checkpointer.load_manifest`.
        """
        with self._cond:
            self._units_since_snapshot = 0
            extras = {
                "tenant_pass": dict(self._tenant_pass),
                "tuners": [
                    tuner.describe()
                    for _inputs, tuner in self.assets.tuners.values()
                ],
                "job_reports": {
                    job.id: (
                        job.prior_report.merge(job._segment)
                        if job.prior_report is not None
                        else job._segment
                    ).to_json()
                    for job in self._jobs.values()
                    if job.open and job._segment is not None
                },
            }
        self.checkpointer.save(self._completions_total, {}, extras=extras)
        self.checkpointer.keep_last(3)

    # ---------------------------------------------------------- lifecycle --

    def _emit(self, job: Job, kind: str, detail="", completed=0, total=0) -> None:
        ev = JobEvent(job.id, kind, detail, completed, total)
        job.events.append(ev)
        self.event_log.append(ev)

    def kill(self) -> None:
        """Crash simulation: stop scheduling NOW, mid-job, no terminal
        records.  Disk state (journal + snapshots) is left exactly as a
        SIGKILL would — the restart/resume tests drive this hook."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)
        if self.journal is not None:
            self.journal.close()

    def close(self, *, drain: bool = True, timeout: float | None = 60.0) -> None:
        """Graceful shutdown: refuse new work, optionally drain open jobs."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if drain and self._thread.is_alive():
            deadline = None if timeout is None else time.monotonic() + timeout
            for job in self.jobs():
                left = None if deadline is None else max(deadline - time.monotonic(), 0)
                job.done.wait(left)
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)
        if self.journal is not None:
            self.journal.close()
        if self._owns_executor:
            self.executor.close()

    def __enter__(self):
        """``with engine("server") as srv:`` — exit is a draining close."""
        return self

    def __exit__(self, *exc):
        self.close()
        return False
