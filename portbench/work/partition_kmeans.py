"""Work of ``partition_kmeans`` in one Lloyd iteration.

Each of the iteration's partitions (one per location) reads its rows once and
the ``(k, d)`` centers once, and writes its ``(k, d)`` sums and ``(k,)``
counts once.  The distances take ``2·n·d·k`` operations (a multiply and an
add per row, dimension and center) and the sums ``n·d`` additions.  A copy of
the rows made before the kernel runs is not work.
"""

from __future__ import annotations

KERNELS = ("kmeans_partial", "kmeans_reduce")
PRECISION = "float32"


def work(cfg: dict, traffic: dict) -> tuple[float, float]:
    n, d, k = cfg["rows"], cfg["d"], cfg["k"]
    partitions = cfg["locations"]
    flops = 2.0 * n * d * k + 1.0 * n * d
    nbytes = 4.0 * n * d + partitions * 4.0 * (k * d + k * d + k)
    return flops, nbytes
