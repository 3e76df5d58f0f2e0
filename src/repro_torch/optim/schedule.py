"""Learning-rate schedules (pure functions of the step).

Port of ``repro/optim/schedule.py``: computed in f32 with the reference's
order of operations, on the step's device, so a step held on the card (the
optimizer state's ``step``) gives the learning rate there without a trip
to the host.
"""

from __future__ import annotations

import math

import torch


def cosine_schedule(
    step,
    *,
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    min_ratio: float = 0.1,
) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then cosine decay to
    ``min_ratio · peak_lr``; a 0-d f32 tensor.

    >>> float(cosine_schedule(0, peak_lr=1e-3, warmup_steps=2, total_steps=10))
    0.0
    """
    step = torch.as_tensor(step).to(torch.float32)
    # divisors as tensors: CUDA divides by a host scalar through its
    # reciprocal, which rounds differently from the reference's division
    warm = peak_lr * step / torch.full_like(step, max(warmup_steps, 1))
    frac = torch.clamp(
        (step - warmup_steps) / torch.full_like(step, max(total_steps - warmup_steps, 1)),
        0.0, 1.0,
    )
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)
