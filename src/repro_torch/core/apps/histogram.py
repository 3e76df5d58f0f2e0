"""n-dimensional Histogram (paper §5.1) — embarrassingly parallel, memory-bound.

Per block: ``histogramdd``; merge: summation.  The SplIter version performs
the first summation inside the fused per-partition task (locality
guaranteed), the final merge is a single reduction task — exactly paper
Listings 4/5, expressed as one plan on the :mod:`repro_torch.api` layer.

A fused partition kernel
(:func:`repro_torch.kernels.partition_reduce.partition_histogramdd`, CUDA
C++) is registered for :func:`histogramdd_block`, so
``SplIter(fusion="pallas")`` — or ``"auto"`` on a card — lowers each
partition to ONE kernel launch that reads its blocks where they lie.
"""

from __future__ import annotations

from functools import partial

import torch

from repro_torch.api import Collection, Executor, ExecutionPolicy, SplIter, as_policy
from repro_torch.api.kernels import PartitionKernel, register_partition_kernel
from repro_torch.core.blocked import BlockedArray
from repro_torch.core.engine import EngineReport
from repro_torch.kernels.partition_reduce import digitize_cells, partition_histogramdd

__all__ = ["histogram", "histogramdd_block"]


def histogramdd_block(block: torch.Tensor, *, bins: int, lo: float, hi: float) -> torch.Tensor:
    """d-dimensional histogram of one ``(rows, d)`` block → ``(bins,)*d`` counts.

    The analogue of ``np.histogramdd`` with shared uniform bin edges: each
    row is digitized per dimension (outliers clamped into the edge bins)
    and counted into the flat grid.
    """
    d = block.shape[1]
    flat = digitize_cells(block, bins=bins, lo=lo, hi=hi)
    counts = torch.zeros(bins**d, dtype=torch.int32, device=block.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return counts.reshape((bins,) * d)


def _histogram_kernel_factory(args: tuple, kwargs: dict) -> PartitionKernel | None:
    """Fused-kernel factory: partial(histogramdd_block, bins=, lo=, hi=)."""
    if args or set(kwargs) != {"bins", "lo", "hi"}:
        return None
    bins, lo, hi = kwargs["bins"], kwargs["lo"], kwargs["hi"]

    def supports(stacked_shape: tuple, extra_args: tuple) -> bool:
        # flat grid of bins**d cells, at most 2**20 (4 MiB of int32)
        d = stacked_shape[-1]
        return not extra_args and bins**d <= 1 << 20

    return PartitionKernel(
        name="partition_histogramdd",
        key=("hist_dd", bins, lo, hi),
        fn=lambda blocks: partition_histogramdd(blocks, bins=bins, lo=lo, hi=hi),
        supports=supports,
    )


register_partition_kernel(histogramdd_block, _histogram_kernel_factory)


def histogram(
    x: BlockedArray,
    *,
    bins: int = 8,
    lo: float = 0.0,
    hi: float = 1.0,
    policy: ExecutionPolicy | str = SplIter(),
    executor: Executor | None = None,
) -> tuple[torch.Tensor, EngineReport]:
    block_fn = partial(histogramdd_block, bins=bins, lo=lo, hi=hi)
    res = (
        Collection.from_blocked(x)
        .split(as_policy(policy))
        .map_blocks(block_fn)
        .reduce(lambda a, b: a + b)
        .compute(executor=executor)
    )
    return res.value, res.report
