"""mixtral-8x7b [moe] — 8 experts top-2, SWA window 4096. [arXiv:2401.04088; hf]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    source="[arXiv:2401.04088; hf]",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,          # per-expert hidden
    vocab_size=32000,
    sliding_window=4096,
    moe_experts=8,
    moe_top_k=2,
    moe_d_ff=14336,
    moe_virtual_split=2,  # 8 experts -> 16 virtual half-width experts (exact
                          # F-split) so the expert dim shards over 16-way TP
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
        d_ff=96,
        vocab_size=256,
        sliding_window=32,
        moe_experts=4,
        moe_top_k=2,
        moe_d_ff=96,
        moe_virtual_split=1,
        moe_capacity_factor=2.0,  # = E/k: no drops -> exact at smoke scale
        vocab_pad_multiple=32,
    )
