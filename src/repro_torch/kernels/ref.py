"""Plain PyTorch oracles for the kernels (the ``assert_close`` targets).

Ports of the JAX package's ``repro/kernels/ref.py``, operation for
operation.  ``attention_ref`` keeps the reference's materialized softmax:
on a query row that no key reaches it averages ``v``, where the kernel and
its plain version (``flash_attention_ref``) give 0.  The k-means oracle is
``partition_reduce.partition_kmeans_ref``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.partition_reduce import digitize_cells
from repro_torch.models.ssm import ssd_reference

__all__ = ["attention_ref", "histogram_ref", "ssd_ref"]


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """GQA attention, materialized scores (B,Lq,H,D)."""
    b, lq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, lq, hkv, h // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32) / math.sqrt(d)
    qpos = torch.arange(lq, device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    m = torch.ones((lq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        m &= kpos <= qpos
    if window:
        m &= kpos > qpos - window
    s = torch.where(m, s, -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return o.reshape(b, lq, h, d)


def histogram_ref(stacked: torch.Tensor, *, bins: int, lo: float, hi: float) -> torch.Tensor:
    """Value histogram over all elements of the stacked partition → (bins,) f32,
    by truncating digitization (the reference's ``clip(int(...))``)."""
    idx = digitize_cells(stacked.reshape(-1, 1), bins=bins, lo=lo, hi=hi)
    return torch.bincount(idx, minlength=bins).to(torch.float32)


def ssd_ref(x, dt, a, bm, cm):
    """Sequential SSD recurrence → (y, final_state)."""
    return ssd_reference(x, dt, a, bm, cm)
