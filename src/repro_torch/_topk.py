"""``lax.top_k``'s order in PyTorch.

``lax.top_k`` returns the ``k`` largest values in descending order and puts
the lower index first among equal values; ``torch.topk`` promises no order
among equals.  A stable descending sort gives ``lax.top_k``'s order on the
CPU and on the card.  Used where ties decide a result: kNN's neighbors,
cascade SVM's support vectors, and MoE routing, whose router probabilities
tie often once the logits are rounded to bf16.
"""

from __future__ import annotations

import torch

__all__ = ["top_k"]


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, the lower index first among equal values."""
    values, positions = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], positions[..., :k]
