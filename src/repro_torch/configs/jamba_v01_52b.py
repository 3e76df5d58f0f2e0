"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave (period 8, attn at
index 4), MoE 16e top-2 on every other sublayer. [arXiv:2403.19887; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="[arXiv:2403.19887; hf]",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    moe_experts=16,
    moe_top_k=2,
    moe_d_ff=14336,
    moe_period=2,         # MoE on odd sublayers within the period
    attn_period=8,        # 1 attention layer per 8 (1:7)
    attn_index=4,
    ssm_state=16,         # jamba uses Mamba-1-style state 16
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=8,     # one full period
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        moe_experts=4,
        moe_top_k=2,
        moe_d_ff=96,
        moe_capacity_factor=2.0,  # = E/k: no drops -> exact at smoke scale
        ssm_state=8,
        ssm_head_dim=16,
        ssm_chunk=16,
        vocab_pad_multiple=32,
    )
