"""Gradient accumulation = the SplIter applied to the training batch (L2).

Port of ``repro/optim/grad_accum.py``.  The global batch arrives as a
*blocked collection* of microbatches, and the paper's three execution modes
map onto it:

``per_block`` (baseline, paper Listing 4)
    one call per microbatch block, returning to the host after each; the
    trainer drives it (``Trainer.train_step``) — N + 1 dispatches per step.

``spliter`` (paper Listing 5)
    ONE call per optimizer step: a loop over the local blocks on the
    device, the loss and the f32 gradient sum kept there, never read back
    to the host between blocks — the partition-local first reduction.  The
    reference scans the blocks with ``lax.scan``; eager PyTorch runs the
    same loop, so ``spliter_unrolled`` (the reference's Python loop for its
    roofline probes) computes the same values by the same route.

``materialized`` (paper §7 / rechunk-equivalent on-device)
    the local blocks concatenated into one microbatch and one
    forward/backward: scan-factor× more activation memory.

Gradients are ``torch.autograd.grad`` of ``loss_fn`` with respect to
detached copies of the (possibly hoisted) leaves, so the caller's params
never require a gradient and the optimizer may update them in place.  All
three modes give the same gradients up to float reassociation.  In a rank
of a ``shard_map`` body the backward runs in segments, the collectives'
transposes called between them
(``repro_torch.distributed.spmd.backward_segments``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch._pytree import tree_leaves, tree_map
from repro_torch.distributed.spmd import backward_segments

LossFn = Callable[[Any, dict[str, torch.Tensor]], torch.Tensor]


def hoist_params_bf16(params: Any, constraint: Callable[[Any], Any] | None) -> Any:
    """Cast the matmul weights (floating leaves of ``ndim >= 2``) to bf16
    once, before the block loop (the reference's FSDP gather hoisting; on
    one card it saves the per-block casts).  Scalars and vectors stay as
    they are; ``constraint`` is applied to the cast tree as given."""
    casted = tree_map(
        lambda p: p.to(torch.bfloat16)
        if isinstance(p, torch.Tensor) and p.ndim >= 2 and p.is_floating_point()
        else p,
        params,
    )
    return constraint(casted) if constraint is not None else casted


def value_and_grad(loss_fn: LossFn, params: Any, batch: dict[str, torch.Tensor]):
    """``(loss, grads)`` of ``loss_fn(params, batch)``: the loss detached,
    the gradients a tree like ``params`` in each leaf's type (zeros where
    the loss does not reach a leaf, as ``jax.grad`` gives)."""
    diff = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
    with backward_segments() as tape:
        loss = loss_fn(diff, batch)
    leaves = [p for p in tree_leaves(diff) if p.requires_grad]
    if tape is not None:  # a shard_map rank: the backward in segments, in its thread
        grads = iter(tape.backward([loss], None, leaves))
    else:
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad_of(p):
        if not p.requires_grad:
            return torch.zeros_like(p)
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    return loss.detach(), tree_map(grad_of, diff)


def accumulate_gradients(
    loss_fn: LossFn,
    params: Any,
    blocks: dict[str, torch.Tensor],   # leaves (nblocks, mb, ...) — stacked blocks
    *,
    mode: str = "spliter",
    hoist: bool = False,
    hoist_constraint: Callable[[Any], Any] | None = None,
) -> tuple[torch.Tensor, Any]:
    """Mean loss + mean f32 gradients over the blocked batch, on the device.

    ``hoist=True`` applies :func:`hoist_params_bf16` before the loop and
    differentiates with respect to the cast tree (bf16 cotangents are
    summed into the f32 gradient carry).
    """
    nb = tree_leaves(blocks)[0].shape[0]
    work = hoist_params_bf16(params, hoist_constraint) if hoist else params

    if mode == "materialized":
        merged = {k: v.reshape((v.shape[0] * v.shape[1],) + tuple(v.shape[2:]))
                  for k, v in blocks.items()}
        loss, g = value_and_grad(loss_fn, work, merged)
        return loss, tree_map(lambda gg: gg.to(torch.float32), g)

    if mode == "per_block":
        # Baseline: the caller dispatches once per block (see Trainer).
        raise ValueError(
            "per_block accumulation is driven by the Trainer loop; "
            "use Trainer.train_step with accum_mode='per_block'"
        )

    if mode not in ("spliter", "spliter_unrolled"):
        raise ValueError(f"unknown accumulation mode {mode!r}")
    device = tree_leaves(params)[0].device
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    grad_sum = tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params
    )
    for i in range(nb):
        mb = {k: v[i] for k, v in blocks.items()}
        loss, g = value_and_grad(loss_fn, work, mb)
        loss_sum = loss_sum + loss
        tree_map(lambda a, gg: a.add_(gg.to(torch.float32)), grad_sum, g)
        del g  # free the block's gradients before the next block's backward
    inv = 1.0 / nb
    return loss_sum * inv, tree_map(lambda g: g.mul_(inv), grad_sum)
