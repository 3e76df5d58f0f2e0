"""Typed execution policies — the replacement for the stringly ``mode`` flag.

The seed API threaded ``mode: str`` through every app, benchmark, and
example; each app re-implemented the mode plumbing by hand (and e.g.
k-means duplicated the rechunk-once special case).  A policy is now a small
frozen dataclass that says *how task granularity is derived from the
blocked collection*:

:class:`Baseline`
    One task per block (paper Listing 4).  The granularity coupling the
    paper attacks: dispatch count scales with the blocking.
:class:`SplIter`
    The paper's contribution (Listing 5): one task per locality
    *partition*, iterating the partition's local blocks inside the task.
    ``partitions_per_location`` adapts granularity to the computing
    capability; ``materialize=True`` is the paper-§7 variant that locally
    concatenates each partition into one contiguous buffer.
    ``partitions_per_location="auto"`` hands the choice to the executor's
    cost-model autotuner (:mod:`repro_torch.api.autotune`): the granularity is
    measured, modelled and retuned across iterations instead of hand-picked
    — the knob the paper set out to remove ("finding the optimal block size
    ... requires inner knowledge of the computing environment").
:class:`Rechunk`
    The materializing competitor (paper §3.2.1): re-block the dataset —
    by default at one block per location — paying inter-location traffic,
    then run per-(big-)block tasks.

Policies are frozen and hashable, so executors can cache the prepared
form of ``(inputs, policy)`` — this is what makes the "split/rechunk cost
is paid once and diluted across iterations" behaviour (paper §6.3.1) a
property of the execution layer instead of app-level special casing.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ExecutionPolicy", "Baseline", "SplIter", "Rechunk", "as_policy"]


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """Base class for execution policies.  See module docstring."""

    # Subclasses provide ``mode_name`` (class attr or property) — the
    # report label, kept identical to the seed's mode strings so saved
    # benchmark tables stay comparable across the API transition.
    mode_name = "?"


@dataclasses.dataclass(frozen=True)
class Baseline(ExecutionPolicy):
    """One task per block + one merge task (paper Listing 4)."""

    mode_name = "baseline"


@dataclasses.dataclass(frozen=True)
class SplIter(ExecutionPolicy):
    """One task per locality partition (paper Listing 5, §4).

    Attributes:
      partitions_per_location: number of partitions each location is split
        into — the paper's adaptation to computing capability (nodes ×
        cores) — or the string ``"auto"``, which defers the choice to the
        executor's autotuner (measure → model → retune, with logical
        regrouping only between retunes: zero data movement).
      materialize: locally concatenate each partition's blocks into one
        contiguous buffer before the task consumes it (paper §7; recovers
        the rechunk advantage for compute-bound apps with zero
        inter-location traffic).
      fusion: how the per-partition iteration is fused by the lowering pass
        (DESIGN.md §5.2): ``"scan"`` forces the generic per-partition fold
        over the blocks; ``"pallas"`` requests the registered hand-written
        partition kernel (one CUDA launch per same-shape run; the name is
        kept so one policy object means the same thing in the JAX
        package), falling back to the fold when no kernel is registered
        or the shapes are rejected; ``"auto"`` lets the backend
        capabilities decide (the kernel when a GPU is present, the fold
        elsewhere).
      autotune_seed: seed of the autotuner's deterministic probe schedule
        (only meaningful with ``partitions_per_location="auto"``); two runs
        with the same seed probe the same granularity ladder in the same
        order.

    Policies are frozen values — construct, compare, hash, done:

    >>> SplIter(partitions_per_location=2).mode_name
    'spliter'
    >>> SplIter(materialize=True).mode_name
    'spliter_mat'
    >>> SplIter(partitions_per_location="auto").autotuned
    True
    >>> SplIter() == SplIter(partitions_per_location=1)
    True
    """

    partitions_per_location: int | str = 1
    materialize: bool = False
    fusion: str = "auto"
    autotune_seed: int = 0

    def __post_init__(self):
        ppl = self.partitions_per_location
        assert ppl == "auto" or (isinstance(ppl, int) and ppl >= 1), ppl
        assert self.fusion in ("auto", "scan", "pallas"), self.fusion

    @property
    def autotuned(self) -> bool:
        return self.partitions_per_location == "auto"

    @property
    def mode_name(self) -> str:
        name = "spliter_mat" if self.materialize else "spliter"
        return name + "_auto" if self.autotuned else name


@dataclasses.dataclass(frozen=True)
class Rechunk(ExecutionPolicy):
    """Materialize at a new block size, then per-block tasks (paper §3.2.1).

    ``target_rows=None`` re-blocks at one block per location — the
    competitor configuration benchmarked by the paper.
    """

    target_rows: int | None = None

    mode_name = "rechunk"

    def __post_init__(self):
        assert self.target_rows is None or self.target_rows >= 1, self.target_rows


_BY_NAME = {
    "baseline": lambda ppl: Baseline(),
    "spliter": lambda ppl: SplIter(partitions_per_location=ppl),
    "spliter_mat": lambda ppl: SplIter(partitions_per_location=ppl, materialize=True),
    "spliter_auto": lambda ppl: SplIter(partitions_per_location="auto"),
    "rechunk": lambda ppl: Rechunk(),
}


def as_policy(
    policy: ExecutionPolicy | str,
    *,
    partitions_per_location: int = 1,
) -> ExecutionPolicy:
    """Coerce a policy object or legacy mode string into a policy.

    The string form exists for the deprecated ``run_map_reduce`` shim and
    for transitional callers; new code should construct policy objects.

    >>> as_policy("spliter", partitions_per_location=4)
    SplIter(partitions_per_location=4, materialize=False, fusion='auto', autotune_seed=0)
    >>> as_policy(Baseline()) == Baseline()
    True
    """
    if isinstance(policy, ExecutionPolicy):
        return policy
    if isinstance(policy, str):
        try:
            return _BY_NAME[policy](partitions_per_location)
        except KeyError:
            raise ValueError(
                f"unknown execution mode {policy!r}; expected one of {sorted(_BY_NAME)}"
            ) from None
    raise TypeError(f"expected ExecutionPolicy or str, got {type(policy).__name__}")
