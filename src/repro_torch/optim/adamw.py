"""AdamW with decoupled weight decay and global-norm clipping.

Port of ``repro/optim/adamw.py``: state = (step, m, v), moments in f32
whatever the params' type, the update computed in f32 and cast back to each
leaf's type, with the reference's order of operations.  ``AdamWState`` is a
dataclass registered as a tree node (:mod:`repro_torch._pytree`), so it
flattens as the reference's registered dataclass does: ``step``, then
``m``'s leaves, then ``v``'s, and the checkpointer names them ``.step``,
``.m/<key>…`` and ``.v/<key>…``.

``adamw_update`` writes the new params and moments into the tensors passed
in and returns those tensors (what the reference's ``donate_argnums`` lets
XLA do): the values returned are the reference's, and the caller must not
read the old params or moments after the call.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch._pytree import register_dataclass, tree_leaves, tree_map


@register_dataclass
@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor   # () int32
    m: Any               # tree like params, f32
    v: Any               # tree like params, f32


def adamw_init(params: Any) -> AdamWState:
    """Zero moments in f32 and a zero int32 step, on the params' device (a
    template of ``meta`` params gives a template state that holds no
    memory, as ``jax.eval_shape`` does)."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(
        sum(torch.sum(torch.square(leaf.to(torch.float32))) for leaf in tree_leaves(tree))
    )


@torch.no_grad()
def adamw_update(
    params: Any,
    grads: Any,
    state: AdamWState,
    *,
    lr: torch.Tensor | float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
) -> tuple[Any, AdamWState]:
    step = state.step + 1
    gnorm = global_norm(grads)
    # a tensor numerator: torch computes ``scalar / tensor`` as a reciprocal
    # times the scalar, which rounds differently from the reference's division
    clip = torch.full_like(gnorm, clip_norm)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    sf = step.to(torch.float32)
    c1 = 1 - b1 ** sf
    c2 = 1 - b2 ** sf
    new_m, new_v = [], []

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        mhat = m2 / c1
        vhat = v2 / c2
        pf = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * pf
        new_m.append(m.copy_(m2))
        new_v.append(v.copy_(v2))
        return p.copy_((pf - lr * delta).to(p.dtype))

    new_params = tree_map(upd, params, grads, state.m, state.v)
    ms, vs = iter(new_m), iter(new_v)
    return new_params, AdamWState(
        step=step,
        m=tree_map(lambda _: next(ms), params),
        v=tree_map(lambda _: next(vs), params),
    )
