"""qwen3-32b [dense] — GQA kv=8, qk_norm (per-head RMSNorm on q,k).
[hf:Qwen/Qwen3-8B; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    source="[hf:Qwen/Qwen3-8B; hf]",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,  # explicit (not d_model//heads), per Qwen3 HF config
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        vocab_pad_multiple=32,
    )
