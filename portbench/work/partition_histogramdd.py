"""Work of ``partition_histogramdd`` in one histogram pass.

Each of the pass's partitions (one per location) reads its rows once and
writes its ``bins**d`` int32 counts once.  A row's digitizing takes a
subtraction and a multiplication per value; the cell index and the count are
integer work and are not counted.
"""

from __future__ import annotations

KERNELS = ("histdd_kernel",)
PRECISION = "float32"


def work(cfg: dict, traffic: dict) -> tuple[float, float]:
    n, d, bins = cfg["rows"], cfg["d"], cfg["bins"]
    partitions = cfg["locations"]
    flops = 2.0 * n * d
    nbytes = 4.0 * n * d + partitions * 4.0 * bins**d
    return flops, nbytes
