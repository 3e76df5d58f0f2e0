"""Optimizer substrate: AdamW, LR schedules, SplIter-fused accumulation,
gradient compression.  Port of ``repro/optim`` (the same ``__all__``)."""

from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.optim.grad_accum import accumulate_gradients

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "accumulate_gradients",
]
