"""Pod-aware collectives: hierarchical reductions and compressed cross-pod
hops, expressed with ``shard_map`` so the schedule is explicit.

Port of ``repro/distributed/collectives.py`` over the port's single-
controller primitives (:mod:`repro_torch.distributed.spmd`).  On a
2×16×16 mesh the ``pod`` axis is the slow (DCN) dimension.  A flat
all-reduce over (pod, data) pays the slow link for the full gradient; the
hierarchical schedule reduce-scatters within the pod rows first, sends only
1/16th of the bytes across pods, then all-gathers back.

``compressed_psum_pod`` additionally int8-quantizes the shard before the
cross-pod hop (4× fewer DCN bytes); error feedback lives in the optimizer
(``repro_torch.optim.compression``) because it is stateful.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch._pytree import tree_map
from repro_torch.distributed.compat import axis_size, shard_map
from repro_torch.distributed.spmd import Mesh, P, all_gather, psum, psum_scatter
from repro_torch.optim.compression import int8_compress

__all__ = [
    "hierarchical_psum",
    "psum_pod_hierarchical",
    "compressed_psum_pod",
]


def hierarchical_psum(x: torch.Tensor, *, fast_axis: str, slow_axis: str) -> torch.Tensor:
    """Two-level all-reduce for use INSIDE shard_map: RS(fast) → AR(slow) →
    AG(fast).  Equivalent to ``psum(x, (fast, slow))`` with 2/W of the flat
    schedule's slow-link bytes (W = fast-axis size)."""
    w = axis_size(fast_axis)
    n = x.shape[0]
    if n % w:  # ragged leading dim: fall back to the flat schedule
        return psum(x, (fast_axis, slow_axis))
    # reduce-scatter along the leading dim within the fast axis
    shard = psum_scatter(
        x.reshape(w, n // w, *x.shape[1:]), fast_axis, scatter_dimension=0, tiled=False
    )
    # slow-link hop carries only the 1/w shard
    shard = psum(shard, slow_axis)
    # all-gather back within the fast axis
    return all_gather(shard, fast_axis, axis=0, tiled=False).reshape(x.shape)


def psum_pod_hierarchical(tree: Any, mesh: Mesh) -> Any:
    """Hierarchically all-reduce a tree over (pod, data).

    Leaves enter replicated over (pod, data) per-shard values (e.g. local
    gradient contributions: :class:`~repro_torch.distributed.spmd.ShardedTensor`
    leaves of spec ``P()`` whose ranks hold different values, as
    :func:`~repro_torch.distributed.spmd.data_parallel_gradients` builds
    them) and exit fully reduced, as global tensors.
    """
    axes = mesh.axis_names
    if "pod" not in axes or "data" not in axes:
        raise ValueError(f"psum_pod_hierarchical needs 'pod' and 'data' axes, not {axes}")

    def inner(t):
        return tree_map(lambda x: hierarchical_psum(x, fast_axis="data", slow_axis="pod"), t)

    specs = tree_map(lambda _: P(), tree)
    return shard_map(
        inner,
        mesh=mesh,
        in_specs=(specs,),
        out_specs=specs,
        check_vma=False,
    )(tree)


def compressed_psum_pod(x: torch.Tensor, *, fast_axis: str, slow_axis: str) -> torch.Tensor:
    """Hierarchical psum whose cross-pod hop is int8-quantized.

    For use INSIDE shard_map.  The within-pod reduction stays exact; the
    slow link carries each pod's shard as (int8 values, fp32 per-row
    scales), and the sum of the dequantized shards is exact *given the
    quantization* (each pod keeps its own scale; pair with error feedback
    in the optimizer for the quantization residual).
    """
    w = axis_size(fast_axis)
    n = x.shape[0]
    if n % w:
        return psum(x, (fast_axis, slow_axis))
    shard = psum_scatter(
        x.reshape(w, n // w, *x.shape[1:]), fast_axis, scatter_dimension=0, tiled=False
    )
    flat = shard.reshape(max(shard.shape[0], 1), -1)
    q, s = int8_compress(flat)
    # slow-link hop: gather every pod's (q, s); int8 dominates the volume
    qg = all_gather(q, slow_axis, axis=0, tiled=False)   # (P, r, c) int8
    sg = all_gather(s, slow_axis, axis=0, tiled=False)   # (P, r, 1) fp32
    deq = torch.sum(qg.to(torch.float32) * sg, dim=0)    # exact Σ pods
    shard = deq.reshape(shard.shape).to(shard.dtype)
    return all_gather(shard, fast_axis, axis=0, tiled=False).reshape(x.shape)
