"""command-r-35b [dense] — GQA kv=8, no bias, parallel attn+FFN block,
LayerNorm. [hf:CohereForAI/c4ai-command-r-v01; unverified]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    source="[hf:CohereForAI/c4ai-command-r-v01; unverified]",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    parallel_block=True,
    norm="layernorm",
    rope_theta=8e6,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        vocab_pad_multiple=32,
    )
