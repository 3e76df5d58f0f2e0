"""Plain Lloyd's algorithm: the reference of the k-means cells.

Each iteration assigns every row to its nearest center by squared Euclidean
distance (the first center wins a tie), then moves each center to the mean of
its rows; a center with no row goes to 0 (its sums over a count clamped to 1).
Distances and the per-block sums are float32 products with TF32 off, taken
``rows_per_block`` rows at a time; the blocks' sums add up in float64 and the
counts are exact int64.

``tf32=True`` is the control: every product's operands are rounded to TF32
(10 mantissa bits, to nearest even) before the float32 product, which is what
a TF32 matrix product computes.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["lloyd", "to_tf32"]


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32's 10 mantissa bits, to nearest even."""
    i = t.contiguous().view(torch.int32)
    i = (i + (0x0FFF + ((i >> 13) & 1))) & ~0x1FFF
    return i.view(torch.float32)


@contextlib.contextmanager
def _full_f32_products():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def lloyd(
    x: torch.Tensor,
    centers: torch.Tensor,
    iters: int,
    *,
    rows_per_block: int = 1 << 23,
    tf32: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``iters`` Lloyd iterations over ``x`` ``(n, d)`` from ``centers`` ``(k, d)``.

    Returns the final centers (float32) and the last iteration's counts
    (int64).
    """
    rnd = to_tf32 if tf32 else (lambda t: t)
    k, d = centers.shape
    c = centers.to(torch.float32)
    counts = torch.zeros(k, dtype=torch.int64, device=x.device)
    ids = torch.arange(k, device=x.device)
    with _full_f32_products():
        for _ in range(iters):
            cc = (c * c).sum(dim=1)
            ct = rnd(c).T.contiguous()
            sums = torch.zeros((k, d), dtype=torch.float64, device=x.device)
            counts = torch.zeros(k, dtype=torch.int64, device=x.device)
            for xb in x.split(rows_per_block):
                xb = xb.to(torch.float32)
                xr = rnd(xb)
                d2 = (xb * xb).sum(dim=1, keepdim=True) - 2.0 * (xr @ ct) + cc
                assign = torch.argmin(d2, dim=1)
                onehot = (assign[:, None] == ids).to(torch.float32)
                sums += (onehot.T @ xr).double()
                counts += torch.bincount(assign, minlength=k)
            c = (sums / counts.clamp(min=1)[:, None].double()).to(torch.float32)
    return c, counts
