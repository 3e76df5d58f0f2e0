"""Pipeline parallelism: a GPipe-style stage executor over a ``pipe`` mesh
axis, built on ``shard_map`` + ``ppermute``.

Port of ``repro/distributed/pipeline_par.py``.  Layers split into S
stages, each stage owned by one pipe rank.  Microbatches stream through;
stage s computes microbatch m at tick t = s + m, and activations hop
s→s+1 via ``ppermute``.  Fill/drain bubbles cost (S−1)/(T+S−1) of the
ticks.  The reference's ``lax.scan`` over ticks is a loop here and its
``lax.cond`` a branch; as in its scan, every rank runs its stage at every
tick (on zeros before its first microbatch arrives and after its last).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch._pytree import tree_map
from repro_torch.distributed.compat import shard_map
from repro_torch.distributed.spmd import Mesh, P, axis_index, ppermute, psum

__all__ = ["gpipe"]


def gpipe(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,            # tree; leaves (S, ...) — one slice per stage
    x_micro: torch.Tensor,        # (T, mb, ...) microbatch blocks
    *,
    mesh: Mesh,
    axis: str = "pipe",
) -> torch.Tensor:
    """Run T microbatches through S pipeline stages; returns (T, mb, ...).

    ``stage_fn(params_s, x) -> y`` must be shape-preserving (a trunk
    segment).  Stage s's params live on pipe rank s (leading dim sharded
    over ``axis``); microbatches stream via ppermute with a fill/drain
    schedule of T + S − 1 ticks.
    """
    s_count = mesh.shape[axis]
    t_count = x_micro.shape[0]

    p_specs = tree_map(lambda _: P(axis), stage_params)

    def run(params, xs):
        my = axis_index(axis)
        params = tree_map(lambda p: p[0], params)  # (1, ...) → (...)
        mb_shape = xs.shape[1:]
        fwd_perm = [(i, i + 1) for i in range(s_count - 1)]
        state = torch.zeros(mb_shape, dtype=xs.dtype, device=xs.device)
        outs = torch.zeros((t_count,) + tuple(mb_shape), dtype=xs.dtype, device=xs.device)
        for t in range(t_count + s_count - 1):
            # stage 0 injects microbatch t (when in range); others use the
            # activation that arrived from the previous stage
            x_in = xs[t if t < t_count else 0] if my == 0 else state
            y = stage_fn(params, x_in)
            # last stage records its result at tick t - (S-1) → microbatch id
            out_idx = t - (s_count - 1)
            if my == s_count - 1 and out_idx >= 0:
                outs[out_idx] = y
            # hop s → s+1 for the next tick
            state = ppermute(y, axis, fwd_perm)
        # every rank returns outs; only the last stage wrote into its copy
        # (the rest are zeros), so a psum broadcasts it — making
        # out_specs=P(None) truthful
        return psum(outs, axis)

    return shard_map(
        run,
        mesh=mesh,
        in_specs=(p_specs, P(None)),  # every rank sees the full block stream
        out_specs=P(None),
        check_vma=False,
    )(stage_params, x_micro)
