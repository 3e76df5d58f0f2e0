"""Futures for pipelined (asynchronous) plan execution — DESIGN.md §14.

``Executor.execute_async(plan)`` returns a :class:`ComputeFuture` instead of
draining the plan on the calling thread.  On a pipelined backend
(``Capabilities.pipelined``: :class:`~repro_torch.api.executors.ThreadedExecutor`)
consecutive ``execute_async`` submissions *overlap*: iteration *k+1*'s
units launch the moment their same-partition iteration-*k* predecessors
(and, when a :class:`Deferred` operand ties them, the *k* merge fold)
complete — no global per-execute barrier.  ``LocalExecutor`` executes each
submission at once and returns a completed future.

Completion is two-phase, and the split is what makes overlap deterministic:

* **raw completion** — every unit of the plan's TaskGraph (merge included)
  has run; the merged value is available to *dependent* iterations through
  :meth:`ComputeFuture.raw_value` / :class:`Deferred` operands.  Cross-
  iteration launches key off this phase.
* **finalization** — :meth:`ComputeFuture.result` performs, exactly once,
  the per-execute bookkeeping the synchronous path does behind its barrier
  (device sync, chunk-store window deltas, tuner feedback, ``wall_s``), and
  returns the sealed :class:`~repro_torch.api.executors.ComputeResult`.  Reports
  stay *exact* per execute: every dispatch/trace/merge is billed to the
  submission that caused it, never to whichever report happened to be
  current.

:class:`Deferred` is the loop-carried-value half of the contract: the next
iteration's operand *is* the previous iteration's merged value, lazily.
``fut.map(fn)`` defers ``fn`` over the raw merged value; the result is
usable anywhere a plan operand (``extra_args``) is.  Resolution is
single-flight and cached, so every task of the next iteration shares ONE
computed array — bit-identical to the synchronous loop, which also computes
the carried value once per iteration.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

__all__ = [
    "ComputeFuture",
    "Deferred",
    "PipelineBrokenError",
    "resolve_deferred",
]


class PipelineBrokenError(RuntimeError):
    """A pipelined execute was aborted by an earlier iteration's failure.

    Raised from the *dependent* iteration's future (and from any
    :class:`Deferred` resolved against the failed one), so overlap never
    blurs attribution: ``iteration`` is the executor-lifetime submit index
    of the execute that originally failed, and ``__cause__`` carries its
    exception.  The originating iteration's own future raises the original
    error untouched.
    """

    def __init__(self, message: str, *, iteration: int | None = None):
        super().__init__(message)
        self.iteration = iteration


class ComputeFuture:
    """Handle on an asynchronously executing plan (one pipelined iteration).

    Backends fill in the private hooks; applications use :meth:`result`,
    :meth:`done` and :meth:`map`:

    * ``result()`` blocks until the execute completes, finalizes it
      (exactly once), and returns its ``ComputeResult`` — or raises the
      failure (:class:`PipelineBrokenError` when the failure originated in
      an earlier overlapped iteration).
    * ``map(fn)`` returns a :class:`Deferred` of ``fn(raw merged value)``,
      usable as the next iteration's operand without waiting.
    """

    def __init__(self, *, iteration: int = 0):
        self.iteration = iteration
        self._raw = threading.Event()
        self._raw_value: Any = None
        self._error: BaseException | None = None
        self._result: Any = None
        # Set by the owning executor: finalization thunk (runs the deferred
        # half of execute()), and — on cooperative backends whose caller
        # pumps the event loop (ClusterExecutor, StreamExecutor) — a drive
        # thunk that makes progress until raw completion.
        self._finalize: Callable[[], Any] | None = None
        self._drive: Callable[[], None] | None = None
        self._lock = threading.Lock()

    @classmethod
    def completed(cls, result, *, iteration: int = 0) -> "ComputeFuture":
        """An already-finished future (the non-pipelined fallback path)."""
        fut = cls(iteration=iteration)
        fut._result = result
        fut._set_raw(result.value)
        return fut

    @classmethod
    def failed(cls, error: BaseException, *, iteration: int = 0) -> "ComputeFuture":
        """An already-failed future (the non-pipelined fallback path)."""
        fut = cls(iteration=iteration)
        fut._set_error(error)
        return fut

    # -- completion signalling (executor-side) --------------------------------

    def _set_raw(self, value: Any) -> None:
        self._raw_value = value
        self._raw.set()

    def _set_error(self, error: BaseException) -> None:
        self._error = error
        self._raw.set()

    # -- the application surface ----------------------------------------------

    def done(self) -> bool:
        """True once the plan's units all completed (or failed) — raw phase."""
        return self._raw.is_set()

    def raw_value(self) -> Any:
        """The merged value, pre-finalization (what :class:`Deferred` reads).

        Blocks until raw completion — on cooperative backends by driving
        the executor's pump.  Raises the execute's failure, if any.
        """
        if not self._raw.is_set():
            drive = self._drive
            if drive is not None:
                drive()
            self._raw.wait()
        if self._error is not None:
            raise self._error
        return self._raw_value

    def result(self):
        """Block until complete, finalize once, return the ComputeResult."""
        with self._lock:
            if self._result is not None:
                return self._result
            fin, self._finalize = self._finalize, None
            if fin is not None:
                self._result = fin()  # raises on failure, after teardown
                return self._result
        # No finalizer: a sync-completed/failed future, or a repeat call
        # after a finalization that raised — surface the stored outcome.
        self.raw_value()
        return self._result

    def map(self, fn: Callable[[Any], Any]) -> "Deferred":
        """Defer ``fn`` over the raw merged value (single-flight, cached)."""
        return Deferred(self, fn)


class Deferred:
    """A lazily-computed view of a future's value, usable as a plan operand.

    The pipelined-iteration carrier: ``centers = fut.map(recompute)`` makes
    the *next* plan's ``extra_args`` entry without waiting for ``fut``.
    The lowering layer resolves deferred operands at dispatch time (see
    :func:`resolve_deferred`) — by which point cross-iteration dependency
    edges guarantee the source execute's raw value exists, so resolution
    never blocks on the scheduler's own pipeline.

    ``resolve()`` is single-flight: the mapped function runs once and every
    consumer shares the cached value, exactly as the synchronous loop
    computes its carried value once per iteration — the bit-identity
    contract.  Deferreds chain: ``d.map(g)`` defers ``g`` over ``d``.
    """

    def __init__(self, source: "ComputeFuture | Deferred", fn: Callable[[Any], Any]):
        self._source = source
        self._fn = fn
        self._lock = threading.Lock()
        self._has_value = False
        self._value: Any = None

    @property
    def future(self) -> ComputeFuture:
        """The root :class:`ComputeFuture` this deferred chain hangs off."""
        src = self._source
        return src.future if isinstance(src, Deferred) else src

    def resolve(self) -> Any:
        if self._has_value:
            return self._value
        with self._lock:
            if not self._has_value:
                src = self._source
                try:
                    raw = src.resolve() if isinstance(src, Deferred) else src.raw_value()
                except PipelineBrokenError:
                    raise
                except BaseException as e:
                    fut = self.future
                    raise PipelineBrokenError(
                        f"deferred operand's source execute (iteration "
                        f"#{fut.iteration}) failed: {e}",
                        iteration=fut.iteration,
                    ) from e
                self._value = self._fn(raw)
                self._has_value = True
        return self._value

    def map(self, fn: Callable[[Any], Any]) -> "Deferred":
        return Deferred(self, fn)


def resolve_deferred(x: Any) -> Any:
    """Resolve ``x`` when it is a deferred/future operand; identity otherwise.

    The hook operand builders call on every ``extra_args`` entry — plain
    arrays pass through untouched, so non-pipelined plans pay one
    ``isinstance`` check and nothing else.
    """
    if isinstance(x, Deferred):
        return x.resolve()
    if isinstance(x, ComputeFuture):
        return x.raw_value()
    return x
