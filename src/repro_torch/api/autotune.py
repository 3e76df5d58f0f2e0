"""Cost-model autotuner — the *model → retune* half of adaptive granularity.

``SplIter(partitions_per_location="auto")`` removes the last hand-picked
granularity knob: instead of the user guessing how many partitions per
location fit the computing environment (the very tuning problem the paper
set out to remove for block sizes), the executor measures each iteration,
fits a granularity cost model, and proposes the ``partitions_per_location``
(*ppl*) for the next iteration.  Retuning is *logical regrouping only*:
the executors' prepare cache re-derives partition groups from the
already-split blocks (see ``repro_torch.api.executors``), so a retune moves zero
bytes — the paper's "no transfers nor data rearrangement" claim extends to
granularity changes.

The model is the Tiny-Tasks granularity trade-off (Bora et al.,
arXiv:2202.11464) specialized to this runtime: per-iteration wall time

    w(p) ≈ c0 + c1 · n_tasks(p) + c2 · span(p)

where ``n_tasks(p) = Σ_loc min(p, blocks_loc)`` is the dispatch count
(each task pays a fixed host overhead → ``c1`` ≈ the per-task overhead
``o``), and ``span(p) = max_loc ceil(blocks_loc / p)`` is the largest
per-task block count (the straggler / pipeline-depth term: fewer, bigger
tasks stack more blocks per dispatch and serialize more compute behind one
launch).  ``c0`` absorbs the granularity-independent compute floor.

The tuning *schedule* is deterministic and seedable (Worksharing-Tasks
style: the runtime adapts, the program does not):

1. **probe** — execute the first iterations at a fixed ladder of candidate
   ppls (powers of two up to the largest per-location block count, at most
   ``probe_limit`` entries, rotation chosen by ``seed``), one iteration
   each;
2. **fit** — least-squares fit of (c0, c1, c2) on the probed samples
   (fewer than 3 distinct samples: fall back to the measured argmin);
3. **retune** — propose the predicted-argmin ppl over the *full* ladder
   (the model extrapolates to granularities never probed).

After probing, the model keeps **refitting** as steady-state evidence
arrives: a granularity's first visit pays one-time costs (task
registration, kernel builds and allocator growth), and revisits supersede those polluted samples, so the
incumbent's sample self-corrects.  A move away from the incumbent needs a
clear predicted win (``hysteresis``, default 5%) — noise must not bounce
the granularity around.  A *retune* is a proposal change between
consecutive iterations; at most ``max_retunes`` (default 3) ever happen —
the budget's exhaustion freezes the schedule — so convergence is
structural, not statistical.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

__all__ = [
    "CostModel",
    "fit_cost_model",
    "granularity_features",
    "steal_cost_estimate",
    "should_steal",
    "fold_cost_estimate",
    "should_fold_remote",
    "Autotuner",
]


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------


def granularity_features(block_counts: Sequence[int], ppl: int) -> tuple[int, int]:
    """``(n_tasks, span)`` a ppl would produce over per-location block counts.

    Mirrors the prepare/lowering pipeline: each location with ``b`` blocks
    contributes ``min(ppl, b)`` partitions, the largest of which holds
    ``ceil(b / min(ppl, b))`` blocks.  Ragged same-shape runs can add a few
    extra dispatches on top of ``n_tasks``; the model treats those as noise.
    """
    n_tasks = 0
    span = 0
    for b in block_counts:
        if b <= 0:
            continue
        k = min(ppl, b)
        n_tasks += k
        span = max(span, math.ceil(b / k))
    return n_tasks, span


@dataclasses.dataclass(frozen=True)
class CostModel:
    """ŵ(p) = c0 + c1·n_tasks(p) + c2·span(p)  (seconds)."""

    c0: float
    c1: float  # per-task (dispatch) overhead
    c2: float  # per-span (task size / straggler) cost

    def predict(self, n_tasks: int, span: int) -> float:
        return self.c0 + self.c1 * n_tasks + self.c2 * span


def fit_cost_model(
    samples: Sequence[tuple[int, int, float]],
    *,
    overhead_hint_s: float = 0.0,
) -> CostModel | None:
    """Least-squares fit of :class:`CostModel` on ``(n_tasks, span, wall_s)``.

    Needs ≥3 samples with ≥2 distinct ``n_tasks`` values; otherwise returns
    a degenerate model built from ``overhead_hint_s`` (the profiled mean
    per-task dispatch overhead) when available, else ``None``.  Negative
    fitted coefficients are clamped to 0 — noise must not make the model
    predict that infinite tasks (or infinite spans) are free.
    """
    if len(samples) >= 3 and len({n for n, _, _ in samples}) >= 2:
        x = np.array([[1.0, n, s] for n, s, _ in samples], np.float64)
        y = np.array([w for _, _, w in samples], np.float64)
        coef, *_ = np.linalg.lstsq(x, y, rcond=None)
        c0, c1, c2 = (max(float(c), 0.0) for c in coef)
        return CostModel(c0=c0, c1=c1, c2=c2)
    if overhead_hint_s > 0.0 and samples:
        # One/two samples: anchor the compute floor at the best sample and
        # extrapolate with the measured dispatch overhead alone.
        n0, s0, w0 = min(samples, key=lambda t: t[2])
        return CostModel(c0=max(w0 - overhead_hint_s * n0, 0.0),
                         c1=overhead_hint_s, c2=0.0)
    return None


def steal_cost_estimate(
    model: CostModel | None,
    *,
    queued_tasks: int,
    span: int = 1,
    operand_bytes: int = 0,
    fallback_task_s: float = 1e-3,
    pipe_bytes_per_s: float = 256e6,
    victim_task_s: float | None = None,
    thief_task_s: float = 0.0,
) -> tuple[float, float]:
    """(expected_wait_s, fetch_cost_s) for stealing a victim's queued units.

    ``expected_wait_s`` is what the queued work would cost if left on the
    overloaded victim: ``queued_tasks`` × the victim's per-task cost.
    That cost is ``victim_task_s`` when the caller has observed it (the
    executor's per-worker service-time EMA — what actually distinguishes
    a straggler from a merely busy sibling), else the model's *marginal*
    per-task cost (``c1 + c2·span`` — the fixed ``c0`` is paid either
    way, so it cancels out of the comparison).  ``fetch_cost_s`` is what
    moving it costs: one extra dispatch (``c1``), operand transport, and
    the thief's own execution of the stolen units (``queued_tasks`` ×
    ``thief_task_s``) — charging the thief's service time is what stops a
    slow worker from stealing work *back* from a fast one.  With the
    shared-memory data plane a steal moves *descriptors*, not bytes —
    callers pass ``operand_bytes=0`` and transport is just the dispatch
    overhead; with shm off, the operands re-cross the pipe at
    ``pipe_bytes_per_s``.

    Without a fitted model (early iterations), ``fallback_task_s`` — the
    profiled mean task wall when the caller has one — stands in for the
    marginal cost, and the dispatch overhead is taken as free; an unknown
    thief defaults to free execution.  Both optimistic, which is the
    right bias while there is no evidence either way.

    >>> m = CostModel(c0=0.1, c1=0.01, c2=0.0)
    >>> steal_cost_estimate(m, queued_tasks=4)
    (0.04, 0.01)
    """
    if victim_task_s is not None:
        per_task = victim_task_s
        dispatch_s = model.c1 if model is not None else 0.0
    elif model is not None and (model.c1 > 0.0 or model.c2 > 0.0):
        per_task = model.c1 + model.c2 * max(span, 1)
        dispatch_s = model.c1
    else:
        per_task = fallback_task_s
        dispatch_s = 0.0
    wait_s = queued_tasks * per_task
    fetch_s = (
        dispatch_s
        + (operand_bytes / pipe_bytes_per_s if operand_bytes else 0.0)
        + queued_tasks * thief_task_s
    )
    return wait_s, fetch_s


def should_steal(
    model: CostModel | None,
    *,
    queued_tasks: int,
    span: int = 1,
    operand_bytes: int = 0,
    fallback_task_s: float = 1e-3,
    pipe_bytes_per_s: float = 256e6,
    victim_task_s: float | None = None,
    thief_task_s: float = 0.0,
) -> bool:
    """The steal gate: True iff remote-fetch cost < expected wait.

    The locality-awareness contract of the elastic cluster (DESIGN.md §15):
    an idle worker may take a queued unit from an overloaded sibling only
    when this predicts the move pays for itself.  Deterministic in its
    inputs, so tests can pin the decision with crafted models.

    >>> should_steal(CostModel(0.0, 0.001, 0.0), queued_tasks=3)
    True
    >>> should_steal(  # huge operands over a slow pipe: stay put
    ...     CostModel(0.0, 0.001, 0.0), queued_tasks=1,
    ...     operand_bytes=1 << 30, pipe_bytes_per_s=64e6)
    False
    >>> should_steal(  # a straggler must not steal back from a fast sibling
    ...     None, queued_tasks=3, victim_task_s=0.002, thief_task_s=0.05)
    False
    >>> should_steal(  # ...while the fast sibling raids the straggler
    ...     None, queued_tasks=3, victim_task_s=0.05, thief_task_s=0.002)
    True
    """
    if queued_tasks < 1:
        return False
    wait_s, fetch_s = steal_cost_estimate(
        model,
        queued_tasks=queued_tasks,
        span=span,
        operand_bytes=operand_bytes,
        fallback_task_s=fallback_task_s,
        pipe_bytes_per_s=pipe_bytes_per_s,
        victim_task_s=victim_task_s,
        thief_task_s=thief_task_s,
    )
    return fetch_s < wait_s


def fold_cost_estimate(
    model: CostModel | None,
    *,
    partial_bytes: int,
    fan_in: int,
    pipe_bytes_per_s: float = 256e6,
) -> tuple[float, float]:
    """(driver_fold_s, remote_fold_s) for one location's merge chain.

    ``driver_fold_s`` is what the pinned path costs the driver: ``fan_in``
    partials of ``partial_bytes`` each crossing the reply channel before
    the driver can fold them.  ``remote_fold_s`` is the peer-exchange
    alternative (DESIGN.md §16): the partials stay in shared memory where
    the workers wrote them, one extra fold dispatch (the model's per-task
    overhead ``c1``) runs worker-side, and exactly ONE merged partial
    crosses back.  Deterministic in its inputs, like
    :func:`steal_cost_estimate`, so tests pin decisions with crafted
    models.

    >>> fold_cost_estimate(CostModel(0.0, 0.01, 0.0), partial_bytes=256_000_000, fan_in=4)
    (4.0, 1.01)
    """
    pipe = max(float(pipe_bytes_per_s), 1.0)
    driver_s = fan_in * partial_bytes / pipe
    remote_s = (model.c1 if model is not None else 0.0) + partial_bytes / pipe
    return driver_s, remote_s


def should_fold_remote(
    model: CostModel | None,
    *,
    partial_bytes: int,
    fan_in: int,
    min_bytes: int = 1 << 16,
    pipe_bytes_per_s: float = 256e6,
) -> bool:
    """The peer-exchange gate: fold worker-side iff it beats the driver pipe.

    Tiny partials keep the old path — below ``min_bytes`` the fold is
    cheaper than the extra dispatch it would take to avoid it, whatever
    the model says (the Tiny-Tasks regime: overhead dominates).  With at
    least two partials per location and partials worth moving, the gate
    compares the driver-pipe cost of shipping every partial against one
    worker-side fold dispatch plus one merged reply.

    >>> should_fold_remote(None, partial_bytes=1 << 20, fan_in=4)
    True
    >>> should_fold_remote(None, partial_bytes=512, fan_in=4)  # tiny: old path
    False
    >>> should_fold_remote(  # dispatch overhead outweighs the pipe saving
    ...     CostModel(0.0, 1.0, 0.0), partial_bytes=1 << 20, fan_in=2)
    False
    """
    if fan_in < 2 or partial_bytes < min_bytes:
        return False
    driver_s, remote_s = fold_cost_estimate(
        model,
        partial_bytes=partial_bytes,
        fan_in=fan_in,
        pipe_bytes_per_s=pipe_bytes_per_s,
    )
    return remote_s < driver_s


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Sample:
    wall_s: float
    n_tasks: int
    span: int
    traced: bool  # first visit recompiles; superseded by steady-state visits


class Autotuner:
    """Deterministic measure → model → retune schedule for one workload.

    One instance per (inputs, task) pair, owned by the executor.  The
    executor calls :meth:`propose` before each execution and
    :meth:`observe` after it with the measured wall time; the tuner never
    changes its proposal more than ``max_retunes`` times.

    The schedule is deterministic — same block counts + seed, same probes:

    >>> from repro_torch.api import Autotuner
    >>> tuner = Autotuner([8, 8], seed=0)   # two locations, 8 blocks each
    >>> tuner.ladder                         # candidate ppls
    [1, 2, 4, 8]
    >>> tuner.propose()                      # first probe
    1
    >>> tuner.observe(1, wall_s=0.5)
    >>> tuner.propose()                      # schedule advances to probe 2
    2
    >>> tuner.probing
    True
    """

    def __init__(
        self,
        block_counts: Sequence[int],
        *,
        seed: int = 0,
        max_retunes: int = 3,
        probe_limit: int = 3,
        hysteresis: float = 0.05,
    ):
        self.block_counts = tuple(int(b) for b in block_counts)
        self.max_blocks = max(self.block_counts, default=1)
        self.ladder = self._ladder(self.max_blocks)
        # Deterministic, seedable probe order: rotate the (short) probe
        # prefix of the ladder so different seeds visit it in a different
        # order but always visit the same set.
        probes = self.ladder[: max(1, min(probe_limit, len(self.ladder)))]
        r = seed % len(probes)
        self.probe_plan = probes[r:] + probes[:r]
        self.max_retunes = max_retunes
        self.hysteresis = hysteresis
        self.samples: dict[int, _Sample] = {}
        self.model: CostModel | None = None
        self.retunes = 0
        self.frozen = False        # retune budget exhausted: proposal is final
        self.last_ppl: int | None = None
        self._proposal = self.probe_plan[0]
        self.overhead_hint_s = 0.0

    @staticmethod
    def _ladder(max_blocks: int) -> list[int]:
        """Candidate ppls: powers of two up to the largest local block count."""
        out = []
        p = 1
        while p < max_blocks:
            out.append(p)
            p *= 2
        out.append(max_blocks)
        return sorted(set(out))

    # -- the schedule ---------------------------------------------------------

    def propose(self) -> int:
        """The ppl to use for the next execution."""
        return self._proposal

    def describe(self) -> dict:
        """JSON-able schedule summary (diagnostics / JobServer snapshots).

        Shared-asset pools snapshot this per tuner so an operator can see
        what granularity each (geometry, task, policy) workload converged
        to across tenants; it is informational — resume never replays
        tuner state (a resumed job's policy is pinned in its journal).
        """
        return {
            "proposal": self._proposal,
            "last_ppl": self.last_ppl,
            "retunes": self.retunes,
            "frozen": self.frozen,
            "probing": self.probing,
            "samples": {str(k): v.wall_s for k, v in self.samples.items()},
        }

    @property
    def probing(self) -> bool:
        """True while probe-ladder candidates remain unmeasured (the window
        during which executors enable per-unit profile synchronization).
        A frozen schedule is never probing — a retune budget exhausted
        mid-ladder must not pin the executors' sync window open forever."""
        return not self.frozen and any(
            p not in self.samples for p in self.probe_plan
        )

    def observe(
        self,
        ppl: int,
        wall_s: float,
        *,
        n_tasks: int | None = None,
        span: int | None = None,
        traced: bool = False,
        overhead_s: float | None = None,
    ) -> None:
        """Feed one measured execution back; may advance the schedule."""
        if overhead_s is not None and overhead_s > 0.0:
            self.overhead_hint_s = overhead_s
        fn, fs = granularity_features(self.block_counts, ppl)
        sample = _Sample(
            wall_s=wall_s,
            n_tasks=n_tasks if n_tasks is not None else fn,
            span=span if span is not None else fs,
            traced=traced,
        )
        prev = self.samples.get(ppl)
        # Untraced beats traced; within the same tracedness the LATEST
        # sample wins — keeping a historical minimum would pin the tuner to
        # a phantom-fast measurement that later honest revisits could never
        # correct upward.
        if prev is None or not (sample.traced and not prev.traced):
            self.samples[ppl] = sample
        self.last_ppl = ppl
        if not self.frozen:
            self._advance()

    def _advance(self) -> None:
        for candidate in self.probe_plan:
            if candidate not in self.samples:
                self._retarget(candidate)
                return
        # Probing complete: (re)fit on everything observed so far —
        # steady-state revisits keep correcting trace-polluted probe
        # samples — and move to the predicted argmin only when it beats
        # the incumbent's prediction by the hysteresis margin.
        self.model = fit_cost_model(
            [(s.n_tasks, s.span, s.wall_s) for s in self.samples.values()],
            overhead_hint_s=self.overhead_hint_s,
        )
        best = self._argmin()
        if best == self._proposal:
            return
        if self.model is not None and self._proposal in self.samples:
            cur = self.model.predict(
                *granularity_features(self.block_counts, self._proposal)
            )
            cand = self.model.predict(
                *granularity_features(self.block_counts, best)
            )
            if cand > (1.0 - self.hysteresis) * cur:
                return  # not a clear enough win to spend a retune on
        self._retarget(best)

    def _argmin(self) -> int:
        if self.model is not None:
            scored = [
                (self.model.predict(*granularity_features(self.block_counts, p)), p)
                for p in self.ladder
            ]
        else:  # no model fit possible: measured argmin over the probes
            scored = [(s.wall_s, p) for p, s in self.samples.items()]
        # Deterministic tie-break: lowest predicted wall, then smallest ppl
        # (fewer tasks = less dispatch pressure at equal predicted cost).
        return min(scored)[1]

    def _retarget(self, ppl: int) -> None:
        if ppl != self._proposal and self.retunes >= self.max_retunes:
            self.frozen = True
            return
        if ppl != self._proposal:
            self.retunes += 1
        self._proposal = ppl
