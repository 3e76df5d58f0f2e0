"""repro_torch.core — the paper's contribution: SplIter over blocked collections.

Public surface:

* :class:`BlockedArray` — blocked dataset with explicit placement.
* :func:`spliter` / :func:`split` — locality partitions (zero movement).
* :class:`Partition` — logical block group; ``get_indexes`` /
  ``get_item_indexes`` / ``materialize``.
* :func:`rechunk` — the materializing competitor, with traffic accounting.
* :class:`TaskEngine`, :class:`EngineReport` — cached task registration
  with dispatch/trace/bytes accounting.
* :func:`run_map_reduce` — DEPRECATED stringly-typed shim; execution lives
  in the plan-based ``repro_torch.api`` layer.
* ``repro_torch.core.apps`` — the paper's histogram and k-means apps.
"""

from repro_torch.core.blocked import (
    BlockedArray,
    contiguous_placement,
    resolve_device,
    round_robin_placement,
)
from repro_torch.core.engine import MODES, EngineReport, TaskEngine, run_map_reduce
from repro_torch.core.rechunk import RechunkStats, rechunk
from repro_torch.core.spliter import Partition, split, spliter

__all__ = [
    "BlockedArray",
    "contiguous_placement",
    "resolve_device",
    "round_robin_placement",
    "EngineReport",
    "TaskEngine",
    "run_map_reduce",
    "MODES",
    "RechunkStats",
    "rechunk",
    "Partition",
    "split",
    "spliter",
]
