"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6,
first layer dense. [arXiv:2405.04434; hf]

Spec gives the per-expert hidden (d_ff=1536); the leading dense layer uses
the model's dense intermediate size (12288 per the HF config) — noted in
DESIGN.md as a config-completion beyond the assigned line.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    source="[arXiv:2405.04434; hf]",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,  # MLA: kv heads == q heads after decompression
    head_dim=128,
    d_ff=1536,          # per-expert hidden
    vocab_size=102400,
    mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    moe_experts=160,
    moe_top_k=6,
    moe_shared_experts=2,
    moe_d_ff=1536,
    moe_first_dense=1,
    dense_d_ff=12288,
    rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=64,
        vocab_size=256,
        kv_lora_rank=32,
        q_lora_rank=48,
        rope_head_dim=8,
        moe_experts=8,
        moe_top_k=2,
        moe_capacity_factor=4.0,  # = E/k: no drops -> exact at smoke scale
        moe_shared_experts=1,
        moe_d_ff=64,
        moe_first_dense=1,
        dense_d_ff=128,
        vocab_pad_multiple=32,
    )
