"""mamba2-1.3b [ssm] — SSD (state-space duality), attn-free.
[arXiv:2405.21060; unverified]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    source="[arXiv:2405.21060; unverified]",
    num_layers=48,
    d_model=2048,
    num_heads=0,          # attn-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,               # no MLP; Mamba block carries the capacity
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=2,
        d_model=64,
        vocab_size=256,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=16,
        vocab_pad_multiple=32,
    )
