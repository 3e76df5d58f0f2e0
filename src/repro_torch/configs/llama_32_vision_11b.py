"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5th layer;
patch-embedding frontend STUB (input_specs provides (B, 1600, 4096) image
embeddings). [hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_period=5,   # 8 cross-attn layers in 40
    image_tokens=1600,
    image_embed_dim=4096,
    rope_theta=5e5,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        num_layers=5,      # one full period
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        image_tokens=12,
        image_embed_dim=48,
        vocab_pad_multiple=32,
    )
