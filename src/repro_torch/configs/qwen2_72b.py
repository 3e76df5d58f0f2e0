"""qwen2-72b [dense] — GQA kv=8, QKV bias. [arXiv:2407.10671; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    source="[arXiv:2407.10671; hf]",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
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
