"""JobClient — the Executor-shaped front door to a JobServer.

A :class:`JobClient` satisfies the :class:`~repro_torch.api.executors.Executor`
protocol (``execute`` / ``task`` / ``report`` / ``scope``), so application
code is tenant-agnostic: ``kmeans(x, executor=client)`` runs unchanged,
each ``compute`` becoming one server submission multiplexed against every
other tenant's work.  The report crosses the client channel by value —
serialized with :meth:`~repro_torch.core.engine.EngineReport.to_json` and
rebuilt client-side — so client-held reports never alias server state
(the contract a future socket transport inherits unchanged).

Out-of-plan stages (``client.task`` — k-NN's lookup/merge loops) register
against a client-LOCAL :class:`~repro_torch.core.engine.TaskEngine`: they run in
the client's process by definition (the server only schedules plans), and
``scope`` accumulates both local dispatches and returned job reports into
one window, mirroring executor semantics.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Hashable

from repro_torch.api.executors import ComputeResult
from repro_torch.api.futures import ComputeFuture
from repro_torch.api.jobserver import Job, JobFailedError, JobServer
from repro_torch.api.plan import ExecutionPlan
from repro_torch.core.engine import EngineReport, TaskEngine

__all__ = ["JobClient", "JobFailedError"]


class JobClient:
    """One tenant's handle on a :class:`~repro_torch.api.jobserver.JobServer`.

    Args:
      server: the (in-process) server to submit against.
      tenant: fair-share identity — all of a tenant's jobs draw from one
        stride pass, weighted by ``weight``.
      weight: relative unit-slot share (2 ⇒ twice the units per round).
    """

    def __init__(self, server: JobServer, *, tenant: str = "default", weight: int = 1):
        self.server = server
        self.tenant = tenant
        self.weight = weight
        self._engine = TaskEngine()
        self._scope_depth = 0

    # -- async surface ------------------------------------------------------

    def submit(self, plan: ExecutionPlan) -> Job:
        """Fire-and-return: admit the plan, keep the :class:`Job` handle."""
        return self.server.submit(plan, tenant=self.tenant, weight=self.weight)

    def wait(self, job: Job, timeout: float | None = None) -> ComputeResult:
        """Join a submitted job; the report arrives as a channel copy."""
        res = self.server.wait(job, timeout)
        report = EngineReport.from_json(res.report.to_json())
        if self._scope_depth:
            self._engine.report += report
        return ComputeResult(value=res.value, report=report)

    def events(self, job: Job) -> list:
        """Snapshot of the job's lifecycle events so far."""
        return list(job.events)

    # -- the Executor protocol ----------------------------------------------

    def execute(self, plan: ExecutionPlan) -> ComputeResult:
        """Synchronous submit+wait — what ``Collection.compute`` calls."""
        return self.wait(self.submit(plan))

    def execute_async(self, plan: ExecutionPlan) -> ComputeFuture:
        """Executor-protocol parity: submit+wait wrapped in a done future.

        Tenant-side pipelining is the server's scheduler's business (jobs
        from many tenants already interleave at unit granularity), so the
        client keeps ``execute_async`` synchronous — application code
        written against the future surface runs unchanged through a
        JobServer.
        """
        try:
            result = self.execute(plan)
        except BaseException as e:  # noqa: BLE001 — surfaced via the future
            return ComputeFuture.failed(e)
        return ComputeFuture.completed(result)

    def task(self, fn: Callable, *, key: Hashable = None) -> Callable:
        return self._engine.task(fn, key=key)

    @property
    def report(self) -> EngineReport:
        return self._engine.report

    @contextlib.contextmanager
    def scope(self, mode: str):
        """Accumulate job reports + local dispatches into one window."""
        report = self._engine.new_report(mode)
        self._scope_depth += 1
        t0 = time.perf_counter()
        try:
            yield report
        finally:
            self._scope_depth -= 1
            report.wall_s = time.perf_counter() - t0
