"""Distribution substrate: logical-axis sharding rules, single-controller
``shard_map`` with in-body collectives, pod-aware reductions, GPipe.

Port of ``repro/distributed``.  One process drives every rank of a mesh,
and a rank is a position that may repeat a device
(:mod:`repro_torch.distributed.spmd` says why and how).
"""

from repro_torch.distributed.collectives import (
    compressed_psum_pod,
    hierarchical_psum,
    psum_pod_hierarchical,
)
from repro_torch.distributed.pipeline_par import gpipe
from repro_torch.distributed.sharding import (
    ShardingRules,
    cache_shardings,
    decode_rules,
    decode_rules_headsharded,
    long_decode_rules,
    param_pspec,
    params_shardings,
    shard,
    train_rules,
    train_rules_sp,
    use_rules,
)
from repro_torch.distributed.spmd import (
    Mesh,
    NamedSharding,
    P,
    PartitionSpec,
    ShardedTensor,
    all_gather,
    axis_index,
    axis_size,
    data_parallel_gradients,
    device_put,
    ppermute,
    psum,
    psum_scatter,
    pmax,
    pvary,
    shard_map,
    sharded_decode_step,
    sharded_prefill,
    sharded_train_step,
    tensor_parallel,
    tensor_parallel_gradients,
)

__all__ = [
    "Mesh", "NamedSharding", "P", "PartitionSpec", "ShardedTensor", "device_put",
    "shard_map", "psum", "pmax", "pvary", "psum_scatter", "all_gather", "ppermute",
    "axis_index", "axis_size", "data_parallel_gradients", "sharded_train_step",
    "tensor_parallel_gradients", "sharded_prefill", "sharded_decode_step", "tensor_parallel",
    "hierarchical_psum", "psum_pod_hierarchical", "compressed_psum_pod", "gpipe",
    "ShardingRules", "use_rules", "shard", "param_pspec", "params_shardings",
    "cache_shardings", "train_rules", "train_rules_sp", "decode_rules",
    "decode_rules_headsharded", "long_decode_rules",
]
