"""deepseek-7b [dense] — llama-arch, GQA kv=32 (i.e. MHA). [arXiv:2401.02954; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    source="[arXiv:2401.02954; hf]",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
    rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        vocab_pad_multiple=32,
    )
