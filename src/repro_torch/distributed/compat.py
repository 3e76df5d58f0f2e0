"""``shard_map`` and ``axis_size`` under the JAX package's names.

Port of ``repro/distributed/compat.py``, which bridges JAX versions: the
port has one implementation of each (:mod:`repro_torch.distributed.spmd`),
re-exported here so that call sites read as the reference's do.
"""

from __future__ import annotations

from repro_torch.distributed.spmd import axis_size, shard_map

__all__ = ["shard_map", "axis_size"]
