"""A plain per-expert MoE MLP: the second algorithm ``moe_mlp`` is held to.

Written apart from :mod:`repro_torch.models.moe`, with none of its
one-hot products, for the card's checks (``chip_smoke.py``'s ``moe``
phase, ``tests/test_torch_cuda_models.py``) and tested against the JAX
package on the CPU (``tests/test_torch_moe.py``).  It computes the same
function as the onehot path, another way:

* the top-k is ``k`` rounds of ``argmax`` (the first maximal index) with the
  picked experts masked out: ``lax.top_k``'s order, lower index first
  among equal values;
* a choice's slot is its rank among the group's choices of the same
  (virtual) expert in choice-major order (every first choice of the group,
  then every second choice), read off a stable sort by expert;
* a choice whose slot is ``>= capacity`` is dropped;
* each expert gathers its kept rows, runs its MLP on them and adds them,
  gate-weighted, into the output rows they came from.

Returns the output, the real experts each token chose ``(B, L, k)`` in
choice order, and which of those choices were dropped.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, mlp

__all__ = ["moe_plain"]


def _argmax_top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    vals, idxs = [], []
    work = probs.clone()
    for _ in range(k):
        i = torch.argmax(work, dim=-1, keepdim=True)  # the first maximal index
        vals.append(torch.gather(probs, -1, i))
        idxs.append(i)
        work.scatter_(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idxs, -1)


def _slots(experts: torch.Tensor, n_experts: int) -> torch.Tensor:
    """experts (g, k) → each choice's rank among the group's choices of the
    same expert, in choice-major order."""
    g, k = experts.shape
    flat = experts.t().reshape(-1)                      # choice-major
    order = torch.sort(flat, stable=True).indices       # grouped by expert
    sizes = torch.bincount(flat, minlength=n_experts)
    starts = torch.cumsum(sizes, 0) - sizes
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(flat.numel(), device=flat.device) - starts[flat[order]]
    return rank.reshape(k, g).t()


def moe_plain(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """x (B, L, D) → (out (B, L, D), experts (B, L, k), dropped (B, L, k))."""
    dt = x.dtype
    b, l, d = x.shape
    e, k, vs = cfg.moe_experts, cfg.moe_top_k, cfg.moe_virtual_split
    t = b * l
    g = min(cfg.moe_group, t)
    while t % g:
        g //= 2
    cap = min(max(int(math.ceil(g * k / e * cfg.moe_capacity_factor)), 1), g)

    xt = x.reshape(t, d)
    logits = (xt @ p["router"].to(dt)).to(torch.float32)
    gates, experts = _argmax_top_k(torch.softmax(logits, -1), k)
    gates = (gates / gates.sum(-1, keepdim=True)).to(dt)
    # a token's choices are distinct experts, so every slice of a virtual
    # split takes the same slot: rank the real experts
    slots = torch.cat([_slots(experts[i:i + g], e) for i in range(0, t, g)])
    dropped = slots >= cap

    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for ex in range(e):
        tok, choice = torch.nonzero((experts == ex) & ~dropped, as_tuple=True)
        if tok.numel() == 0:
            continue
        rows = xt[tok]
        y = torch.zeros((tok.numel(), d), dtype=torch.float32, device=x.device)
        for j in range(vs):
            v = ex * vs + j
            h = F.silu(rows @ p["experts_gate"][v].to(dt)) * (rows @ p["experts_up"][v].to(dt))
            y += (h @ p["experts_down"][v].to(dt)).to(torch.float32)
        out.index_add_(0, tok, y.to(dt).to(torch.float32) * gates[tok, choice, None])
    out = out.to(dt).reshape(b, l, d)
    if "shared" in p:
        out = out + mlp(p["shared"], x)
    return out, experts.reshape(b, l, k), dropped.reshape(b, l, k)
