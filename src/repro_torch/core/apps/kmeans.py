"""k-means / Lloyd's algorithm (paper §5.2) — iterative, memory-bound.

Per block: pairwise distances → per-centroid partial sums and counts
(``_partial_sum`` in dislib).  Merge: elementwise sum, then mean
(``_recompute_centers``).

The iterative outer loop re-uses one persistent executor: task definitions
are registered once, and the executor's prepare cache applies the split (or
the rechunk, with its traffic bill) exactly once — paper §6.3.1 "this cost
is only payed once, not for every iteration".  Centroids travel as
``extra_args`` so every iteration re-dispatches the same task.

A fused partition kernel
(:func:`repro_torch.kernels.partition_reduce.partition_kmeans`, CUDA C++) is
registered for :func:`partial_sum_block`.  The kernel drops the ``|x|²``
term of the distance and the block function keeps it, as in the JAX
package; each is held to its own reference.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._threefry import uniform
from repro_torch.api import Collection, Executor, ExecutionPolicy, SplIter, as_policy
from repro_torch.api.executors import _default_local
from repro_torch.api.kernels import PartitionKernel, register_partition_kernel
from repro_torch.core.blocked import BlockedArray
from repro_torch.core.engine import EngineReport
from repro_torch.kernels.partition_reduce import partition_kmeans

__all__ = ["kmeans", "partial_sum_block", "KMeansResult"]


def partial_sum_block(block: torch.Tensor, centers: torch.Tensor):
    """One Lloyd E+partial-M step on a ``(rows, d)`` block.

    Returns ``(sums (k,d), counts (k,))`` — the associative partial state.
    """
    d2 = (
        torch.sum(block * block, dim=1)[:, None]
        - 2.0 * block @ centers.T
        + torch.sum(centers * centers, dim=1)[None, :]
    )                                                        # (rows, k)
    assign = torch.argmin(d2, dim=1)                         # (rows,)
    k = centers.shape[0]
    one_hot = torch.nn.functional.one_hot(assign, k).to(block.dtype)  # (rows, k)
    sums = one_hot.T @ block                                 # (k, d)
    counts = torch.sum(one_hot, dim=0)                       # (k,)
    return sums, counts


def _combine(a, b):
    return a[0] + b[0], a[1] + b[1]


def _centers_of(partials):
    """Recompute centers from merged ``(sums, counts)`` partials."""
    sums, counts = partials
    return sums / torch.clamp(counts, min=1.0)[:, None]


def _init_centers(
    seed: int, k: int, d: int, dtype: torch.dtype, device: torch.device
) -> torch.Tensor:
    """The initial centers: uniform in ``[0, 1)^d``, drawn from ``seed`` on
    ``device`` with the reference's bits (``jax.random.uniform``)."""
    return uniform(seed, (k, d), dtype, device=device)


def _kmeans_kernel_factory(args: tuple, kwargs: dict) -> PartitionKernel | None:
    """Fused-kernel factory: bare ``partial_sum_block`` (centers via extra_args)."""
    if args or kwargs:
        return None
    return PartitionKernel(
        name="partition_kmeans",
        key=("kmeans_partial",),
        fn=partition_kmeans,
        supports=lambda stacked_shape, extra_args: len(extra_args) == 1,
    )


register_partition_kernel(partial_sum_block, _kmeans_kernel_factory)


@dataclasses.dataclass
class KMeansResult:
    centers: torch.Tensor
    iterations: int
    reports: list[EngineReport]

    @property
    def total_dispatches(self) -> int:
        return sum(r.dispatches for r in self.reports)

    @property
    def total_wall_s(self) -> float:
        return sum(r.wall_s for r in self.reports)

    @property
    def total_bytes_moved(self) -> int:
        return sum(r.bytes_moved for r in self.reports)

    @property
    def total_retunes(self) -> int:
        return sum(r.retunes for r in self.reports)

    @property
    def granularity_trajectory(self) -> list[int]:
        """partitions_per_location per iteration (0 for non-SplIter runs)."""
        return [r.granularity for r in self.reports]


def kmeans(
    x: BlockedArray,
    *,
    k: int = 8,
    iters: int = 10,
    seed: int = 0,
    policy: ExecutionPolicy | str = SplIter(),
    executor: Executor | None = None,
    pipeline: bool = False,
) -> KMeansResult:
    """Run ``iters`` Lloyd iterations from seeded initial centers.

    ``pipeline=True`` submits each iteration with ``compute_async`` and
    carries the centers as a lazy ``Deferred``: a pipelined backend
    (``ThreadedExecutor``) starts iteration *k+1* on a partition once
    iteration *k*'s merge is done, and a barriered one (``LocalExecutor``)
    runs each submission at once.  Both compute the barriered loop's bits.
    """
    d = x.row_shape[0]
    centers = _init_centers(seed, k, d, x.dtype, x.device)
    pol = as_policy(policy)
    ex = executor if executor is not None else _default_local()
    data = Collection.from_blocked(x).split(pol)

    reports: list[EngineReport] = []

    if pipeline:
        centers_op = centers
        futs = []
        for _ in range(iters):
            fut = (
                data.map_blocks(partial_sum_block, extra_args=(centers_op,))
                .reduce(_combine)
                .compute_async(executor=ex)
            )
            futs.append(fut)
            centers_op = fut.map(_centers_of)
        centers = centers_op.resolve() if futs else centers
        reports = [f.result().report for f in futs]
        return KMeansResult(centers=centers, iterations=iters, reports=reports)

    for _ in range(iters):
        res = (
            data.map_blocks(partial_sum_block, extra_args=(centers,))
            .reduce(_combine)
            .compute(executor=ex)
        )
        sums, counts = res.value
        centers = _centers_of((sums, counts))
        reports.append(res.report)

    return KMeansResult(centers=centers, iterations=iters, reports=reports)
