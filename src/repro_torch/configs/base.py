"""Model/run configuration system.

A :class:`ModelConfig` fully describes an architecture as a sequence of
*segments*; each segment is a repeated *period* of :class:`LayerSpec`s.
Homogeneous stacks (most LMs) are one segment with a 1-layer period scanned
``num_layers`` times; heterogeneous stacks (jamba's 1:7 attn:mamba periods,
deepseek-v2's first dense layer, llama-vision's cross-attn interleave) use
multi-layer periods and/or multiple segments.  The scanned-period design
keeps full-size HLO small (DESIGN.md §6).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Mixer = Literal["attn", "mla", "mamba2", "cross_attn", "enc_attn"]
Mlp = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One sublayer: a sequence mixer followed by an MLP (either optional)."""

    mixer: Mixer = "attn"
    mlp: Mlp = "dense"


@dataclasses.dataclass(frozen=True)
class Segment:
    """``repeats`` × ``period`` layers, scanned over ``repeats``."""

    period: tuple[LayerSpec, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.period) * self.repeats


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # -- identity ------------------------------------------------------------
    name: str
    family: str  # dense | moe | audio | hybrid | ssm | vlm
    source: str  # provenance note "[arXiv:...; tier]"

    # -- trunk ---------------------------------------------------------------
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0          # 0 -> d_model // num_heads

    # -- attention flags -------------------------------------------------------
    qkv_bias: bool = False       # qwen2
    qk_norm: bool = False        # qwen3
    parallel_block: bool = False # command-r: attn and FFN in parallel
    norm: str = "rmsnorm"        # "rmsnorm" | "layernorm"
    rope_theta: float = 1e6
    sliding_window: int = 0      # mixtral SWA; 0 = full attention

    # -- MoE -------------------------------------------------------------------
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_d_ff: int = 0            # per-expert hidden
    moe_period: int = 1          # MoE every k-th layer (jamba: 2)
    moe_first_dense: int = 0     # deepseek-v2: first k layers use dense MLP
    dense_d_ff: int = 0          # hidden of those dense layers (0 -> d_ff)
    moe_impl: str = "onehot"     # "onehot" (GSPMD-partitionable, capacity) |
                                 # "ragged" (sort-based dropless; 1-device ref)
    moe_capacity_factor: float = 1.25  # onehot: per-expert buffer slack
    moe_group: int = 1024        # onehot: tokens per dispatch group
    moe_virtual_split: int = 1   # split each expert into n half-width virtual
                                 # experts (exact) so E·n divides the TP axis
                                 # (mixtral: 8 experts × 2 = 16)

    # -- MLA (deepseek-v2) -------------------------------------------------------
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0       # decoupled RoPE dims (shared across heads)

    # -- SSM (mamba2 / jamba) -----------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256         # SSD chunk length
    attn_period: int = 0         # hybrid: 1 attn layer every k layers (jamba: 8)
    attn_index: int = 4          # position of the attn layer inside the period

    # -- encoder-decoder (whisper) -------------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0         # stubbed frame-embedding count (whisper: 1500)

    # -- VLM (llama-3.2-vision) ------------------------------------------------------
    cross_attn_period: int = 0   # 1 cross-attn layer every k layers (5)
    image_tokens: int = 0        # stubbed patch-embedding count
    image_embed_dim: int = 0

    # -- training / numerics ----------------------------------------------------------
    dtype: str = "bfloat16"      # activation/compute dtype
    param_dtype: str = "float32"
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 256  # Megatron-style padded vocab for TP
    remat: str = "full"         # "none" | "dots" | "full" — per-layer checkpoint policy
    attn_impl: str = "ref"       # "ref" (plain PyTorch) | "flash" (CUDA kernel)
    unroll_layers: bool = False  # roofline probes: unroll instead of scan
                                 # (cost_analysis counts scan bodies once)

    # -- derived ------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def is_seq_subquadratic(self) -> bool:
        """Eligible for long_500k: SSM/hybrid state or bounded-window attn."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper is enc-dec)

    def segments(self) -> tuple[Segment, ...]:
        """Decoder-trunk segment list (encoder handled separately)."""
        segs = self._segments_impl()
        if self.unroll_layers:  # flatten: one period of all layers, no scan
            segs = tuple(Segment(s.period * s.repeats, 1) for s in segs)
        return segs

    def _segments_impl(self) -> tuple[Segment, ...]:
        if self.family == "audio":
            # whisper decoder block: self-attn, cross-attn to encoder, MLP
            period = (LayerSpec("attn", "none"), LayerSpec("cross_attn", "dense"))
            return (Segment(period, self.num_layers),)

        if self.family == "ssm":
            spec = LayerSpec(mixer="mamba2", mlp="none")
            return (Segment((spec,), self.num_layers),)

        if self.family == "hybrid":  # jamba: period of attn_period sublayers
            period = []
            for i in range(self.attn_period):
                mixer = "attn" if i == self.attn_index else "mamba2"
                mlp = "moe" if (self.moe_experts and i % self.moe_period == 1) else "dense"
                period.append(LayerSpec(mixer=mixer, mlp=mlp))
            reps = self.num_layers // self.attn_period
            return (Segment(tuple(period), reps),)

        if self.family == "vlm":  # 4 self-attn + 1 cross-attn per period
            p = self.cross_attn_period
            period = [LayerSpec("attn", "dense")] * (p - 1) + [
                LayerSpec("cross_attn", "dense")
            ]
            return (Segment(tuple(period), self.num_layers // p),)

        mlp: Mlp = "moe" if self.moe_experts else "dense"
        if self.moe_first_dense:  # deepseek-v2: leading dense layers
            mixer: Mixer = "mla" if self.mla else "attn"
            return (
                Segment((LayerSpec(mixer, "dense"),), self.moe_first_dense),
                Segment(
                    (LayerSpec(mixer, "moe"),),
                    self.num_layers - self.moe_first_dense,
                ),
            )
        mixer = "mla" if self.mla else "attn"
        return (Segment((LayerSpec(mixer, mlp),), self.num_layers),)

    def encoder_segments(self) -> tuple[Segment, ...]:
        if not self.encoder_layers:
            return ()
        seg = Segment((LayerSpec("enc_attn", "dense"),), self.encoder_layers)
        if self.unroll_layers:
            seg = Segment(seg.period * seg.repeats, 1)
        return (seg,)

    # -- parameter counting (for roofline MODEL_FLOPS) ------------------------------------
    def param_counts(self) -> dict[str, float]:
        """Analytic parameter counts: total and *active* (MoE top-k only)."""
        d, dh = self.d_model, self.resolved_head_dim
        h, hkv = self.num_heads, self.num_kv_heads

        def attn_params() -> float:
            if self.mla:
                q = (
                    d * self.q_lora_rank
                    + self.q_lora_rank * h * (dh + self.rope_head_dim)
                    if self.q_lora_rank
                    else d * h * (dh + self.rope_head_dim)
                )
                kv = d * (self.kv_lora_rank + self.rope_head_dim)
                up = self.kv_lora_rank * h * (dh + dh)  # k_nope + v
                o = h * dh * d
                return q + kv + up + o
            qkv = d * (h + 2 * hkv) * dh
            if self.qkv_bias:
                qkv += (h + 2 * hkv) * dh
            return qkv + h * dh * d

        def dense_mlp(ff: int) -> float:
            return 3 * d * ff  # gate/up/down

        def moe_mlp() -> tuple[float, float]:
            total = self.moe_experts * 3 * d * self.moe_d_ff + d * self.moe_experts
            total += self.moe_shared_experts * 3 * d * self.moe_d_ff
            active = (self.moe_top_k + self.moe_shared_experts) * 3 * d * self.moe_d_ff
            active += d * self.moe_experts
            return total, active

        def mamba_params() -> float:
            din = self.ssm_expand * d
            nh = din // self.ssm_head_dim
            in_proj = d * (2 * din + 2 * self.ssm_state + nh)  # z,x,B,C,dt
            conv = self.ssm_conv_width * (din + 2 * self.ssm_state)
            return in_proj + conv + 3 * nh + din + din * d  # A,D,dt_bias,norm,out

        total = active = 0.0
        for seg in self.segments():
            for spec in seg.period:
                t = a = 0.0
                if spec.mixer in ("attn", "cross_attn", "enc_attn"):
                    t = a = attn_params()
                elif spec.mixer == "mla":
                    t = a = attn_params()
                elif spec.mixer == "mamba2":
                    t = a = mamba_params()
                if spec.mlp == "dense":
                    ff = self.dense_d_ff or self.d_ff
                    t += dense_mlp(ff)
                    a += dense_mlp(ff)
                elif spec.mlp == "moe":
                    mt, ma = moe_mlp()
                    t += mt
                    a += ma
                total += t * seg.repeats
                active += a * seg.repeats
        for seg in self.encoder_segments():
            n = seg.num_layers
            total += n * (attn_params() + dense_mlp(self.d_ff))
            active += n * (attn_params() + dense_mlp(self.d_ff))
        emb = self.padded_vocab * d
        total += emb * (1 if self.tie_embeddings else 2)
        active += emb * (1 if self.tie_embeddings else 2)
        return {"total": total, "active": active}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell of the dry-run matrix."""

    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}
