"""Plain d-dimensional histogram: the reference of the histogram cells.

Row ``r`` counts in the cell whose index along dimension ``j`` is
``floor((x[r, j] - lo) / (hi - lo) * bins)``, clipped to ``[0, bins - 1]``;
cells are numbered row-major, so the result is the flat ``bins**d`` grid.
Rows are taken ``rows_per_block`` at a time and the counts are exact int64.

``dtype`` is the precision the digitizing runs in: float32 is the reference,
bfloat16 the control that a comparison must reject.
"""

from __future__ import annotations

import torch

__all__ = ["histogram_counts"]


def histogram_counts(
    x: torch.Tensor,
    *,
    bins: int,
    lo: float,
    hi: float,
    rows_per_block: int = 1 << 24,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Counts ``(bins**d,)`` int64 of the rows of ``x`` ``(n, d)``."""
    n, d = x.shape
    counts = torch.zeros(bins**d, dtype=torch.int64, device=x.device)
    scale = torch.tensor(bins, dtype=dtype, device=x.device)
    span = torch.tensor(hi - lo, dtype=dtype, device=x.device)
    for xb in x.split(rows_per_block):
        scaled = (xb.to(dtype) - lo) / span * scale
        idx = torch.floor(scaled).clamp(0, bins - 1).to(torch.int64)
        flat = torch.zeros(xb.shape[0], dtype=torch.int64, device=x.device)
        for j in range(d):
            flat = flat * bins + idx[:, j]
        counts += torch.bincount(flat, minlength=bins**d)
    return counts
