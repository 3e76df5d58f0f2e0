"""whisper-tiny [audio] — enc-dec, conv frontend STUB (input_specs provides
precomputed (B, 1500, 384) frame embeddings). [arXiv:2212.04356; unverified]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    source="[arXiv:2212.04356; unverified]",
    num_layers=4,            # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    encoder_layers=4,
    encoder_seq=1500,
    norm="layernorm",
    rope_theta=1e4,          # whisper uses learned/sinusoidal; RoPE stands in
    tie_embeddings=True,
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
        encoder_layers=2,
        encoder_seq=24,
        vocab_pad_multiple=32,
    )
