"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

Port of ``repro/models/mla.py``.  KV is compressed into a rank-
``kv_lora_rank`` latent c_kv plus a small decoupled-RoPE key shared across
heads; per-head K/V are up-projected from the latent.  The decode cache
stores ONLY (c_kv, k_rope), and the decode path uses the *absorbed*
formulation (W^UK folded into q, W^UV applied after attending in latent
space), so a step costs O(S·(kv_lora+rope)) per head.

Shapes:  q_nope (B,L,H,Dh), q_rope (B,L,H,Rh), c_kv (B,L,Kr), k_rope (B,L,Rh).

The reference attends with its own products, not with its flash kernel,
and so does the port: this module launches no kernel.  What differs from
the reference, not in value: no sharding annotations (the port's values
are global tensors); the decode step writes its one latent and rope row in
place through :func:`repro_torch.models.layers.cache_write`, so the active
rules' ``cache_impl`` selects that write (``"sharded_dus"``: on the rank
that owns the slot, in a ``shard_map``), as in the reference;
the prefill fills the caller's cache in place; the query chunks of a long
prefill (the reference's ``lax.scan``) are a loop.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    Params,
    apply_rope,
    cache_write,
    draw_normal,
    rms_norm,
    rope_cos_sin,
)

__all__ = ["init_mla", "mla_attention"]

#: prefill query chunk, and the length from which the prefill is chunked
_Q_CHUNK, _CHUNK_FROM = 512, 2048


def init_mla(cfg: ModelConfig, *, generator: torch.Generator, device,
             dtype: torch.dtype) -> Params:
    """The reference's distributions; the projections are drawn in
    ``dtype`` (every use casts them to it), the two norm weights in f32."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    h, kr, rh, qr = cfg.num_heads, cfg.kv_lora_rank, cfg.rope_head_dim, cfg.q_lora_rank

    def normal(shape, fan_in):
        return draw_normal(shape, 1.0 / math.sqrt(fan_in), dtype, device, generator)

    p: Params = {}
    if qr:
        p["wq_a"] = normal((d, qr), d)
        p["q_norm_a"] = torch.zeros((qr,), dtype=torch.float32, device=device)
        p["wq_b"] = normal((qr, h, dh + rh), qr)
    else:
        p["wq_b"] = normal((d, h, dh + rh), d)
    p["wkv_a"] = normal((d, kr + rh), d)
    p["kv_norm_a"] = torch.zeros((kr,), dtype=torch.float32, device=device)
    p["wk_b"] = normal((kr, h, dh), kr)
    p["wv_b"] = normal((kr, h, dh), kr)
    p["wo"] = normal((h, dh, d), h * dh)
    return p


def _project_q(p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    dt = x.dtype
    dh, rh = cfg.resolved_head_dim, cfg.rope_head_dim
    if "wq_a" in p:
        qa = x @ p["wq_a"].to(dt)
        qa = rms_norm(qa, p["q_norm_a"])
        q = torch.einsum("blr,rhk->blhk", qa, p["wq_b"].to(dt))
    else:
        q = torch.einsum("bld,dhk->blhk", x, p["wq_b"].to(dt))
    q_nope, q_rope = q[..., :dh], q[..., dh:]
    cos, sin = rope_cos_sin(positions, rh, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    return q_nope, q_rope


def _project_kv_latent(p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    dt = x.dtype
    kr, rh = cfg.kv_lora_rank, cfg.rope_head_dim
    kv = x @ p["wkv_a"].to(dt)                            # (B, L, Kr+Rh)
    c_kv = rms_norm(kv[..., :kr], p["kv_norm_a"])
    k_rope = kv[..., kr:][:, :, None, :]                  # (B, L, 1, Rh)
    cos, sin = rope_cos_sin(positions, rh, cfg.rope_theta)
    k_rope = apply_rope(k_rope, cos, sin)[:, :, 0]        # shared across heads
    return c_kv, k_rope


def _q_chunk_attn(qn, qr, q_off: int, k_nope, k_rope, v, scale: float) -> torch.Tensor:
    """One query chunk (its first row at ``q_off``) vs. the full decompressed
    K/V: live scores O(c·L)."""
    l = k_nope.shape[1]
    s_nope = torch.einsum("blhk,bshk->bhls", qn, k_nope)
    s_rope = torch.einsum("blhk,bsk->bhls", qr, k_rope)
    scores = (s_nope + s_rope).to(torch.float32) * scale
    qpos = torch.arange(qn.shape[1], device=qn.device)[:, None] + q_off
    kpos = torch.arange(l, device=qn.device)[None, :]
    scores = torch.where((kpos <= qpos)[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(qn.dtype)
    return torch.einsum("bhls,bshk->blhk", probs, v)


def mla_attention(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    cache: Params | None = None,   # {"ckv": (B,S,Kr), "krope": (B,S,Rh)}
    cache_pos: int | None = None,
) -> tuple[torch.Tensor, Params | None]:
    """Returns (out (B,L,D), the cache or None); a cache is updated in place."""
    dt = x.dtype
    dh = cfg.resolved_head_dim
    scale = 1.0 / np.sqrt(dh + cfg.rope_head_dim)

    q_nope, q_rope = _project_q(p, cfg, x, positions)

    if cache is not None and x.shape[1] == 1:
        # ---------------- absorbed decode ----------------
        c_new, kr_new = _project_kv_latent(p, cfg, x, positions)
        ckv, krope = cache["ckv"], cache["krope"]
        cache_write(ckv, c_new, cache_pos)
        cache_write(krope, kr_new, cache_pos)
        # absorb W^UK into q:  q_lat (B,1,H,Kr)
        q_lat = torch.einsum("blhk,rhk->blhr", q_nope, p["wk_b"].to(dt))
        s_nope = torch.einsum("blhr,bsr->bhls", q_lat, ckv.to(dt))
        s_rope = torch.einsum("blhk,bsk->bhls", q_rope, krope.to(dt))
        scores = (s_nope + s_rope).to(torch.float32) * scale
        kpos = torch.arange(ckv.shape[1], device=x.device)[None, None, None]
        scores = torch.where(kpos <= cache_pos, scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(dt)
        # attend in latent space, then absorb W^UV on the way out
        o_lat = torch.einsum("bhls,bsr->blhr", probs, ckv.to(dt))
        o = torch.einsum("blhr,rhk->blhk", o_lat, p["wv_b"].to(dt))
        out = torch.einsum("blhk,hkd->bld", o, p["wo"].to(dt))
        return out, cache

    # ---------------- train / prefill (decompressed) ----------------
    c_kv, k_rope = _project_kv_latent(p, cfg, x, positions)
    k_nope = torch.einsum("blr,rhk->blhk", c_kv, p["wk_b"].to(dt))
    v = torch.einsum("blr,rhk->blhk", c_kv, p["wv_b"].to(dt))
    l = x.shape[1]
    kv = (k_nope, k_rope, v)
    if l >= _CHUNK_FROM and l % _Q_CHUNK == 0:
        o = torch.cat([_q_chunk_attn(q_nope[:, i:i + _Q_CHUNK], q_rope[:, i:i + _Q_CHUNK], i,
                                     *kv, scale)
                       for i in range(0, l, _Q_CHUNK)], dim=1)
    else:
        o = _q_chunk_attn(q_nope, q_rope, 0, *kv, scale)
    out = torch.einsum("blhk,hkd->bld", o, p["wo"].to(dt))

    if cache is not None:  # prefill into the compressed cache
        cache["ckv"][:, :l] = c_kv.to(cache["ckv"].dtype)
        cache["krope"][:, :l] = k_rope.to(cache["krope"].dtype)
    return out, cache
