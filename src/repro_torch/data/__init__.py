"""Data substrate: deterministic blocked token pipeline with resumable state.

Port of ``repro/data``: plain numpy, copied (the port imports nothing of
the JAX package), so the batches equal the reference's byte for byte.
"""

from repro_torch.data.pipeline import BlockedBatchPipeline, PipelineState
from repro_torch.data.datasets import synthetic_lm_batch, SyntheticTextDataset

__all__ = [
    "BlockedBatchPipeline",
    "PipelineState",
    "synthetic_lm_batch",
    "SyntheticTextDataset",
]
