"""Transformer building blocks: norms, RoPE, GQA attention, SwiGLU MLP.

Ports of ``repro/models/layers.py``, function for function, over an explicit
params dict with the JAX package's names and layouts (attention weights
``(d, heads, head_dim)``, activations ``(B, L, H, Dh)``).  What differs:

* no sharding annotations: the reference's ``shard(...)`` constraints
  change no value, and the port's values are global tensors (the rules and
  ``shard`` are ported, :mod:`repro_torch.distributed.sharding`); what the
  active rules select here is the decode path, by ``cache_impl``:
  ``"sharded_dus"`` writes the cache row in a ``shard_map`` on the rank
  that owns the slot, ``"decomposed"`` attends to the old cache and the new
  token before writing (:func:`cache_write`, :func:`attention`);
* the decode cache is updated in place: a one-row write at the slot into the
  caller's cache tensors, where the reference's masked select reads and
  rewrites the whole cache every step.  The values are the same;
* with ``cfg.attn_impl == "flash"`` attention over a whole prompt runs the
  hand-written kernel (``repro_torch.kernels.ops.flash_attention``): causal
  self-attention, the encoder's bidirectional self-attention, and
  cross-attention from the prompt to the memory (``causal=False``).  With
  ``"ref"`` they run the plain :func:`_sdpa_auto` (the reference's cross
  branch calls :func:`_sdpa`, which computes the same values).  Decode (one
  query row against the cache or the memory) is plain PyTorch on both
  routes;
* **the route under autograd:** where autograd records the attention (grad
  mode on and q, k or v requiring a gradient, as in ``Model.loss``), it
  runs :func:`_sdpa_auto` whatever ``attn_impl`` says.  The kernel has no
  backward (nor has the JAX package's), and its wrapper raises rather than
  return an output without a ``grad_fn``.  The reference's model never
  calls its Pallas kernel (``attn_impl`` is read nowhere in its
  ``models/``), so its loss and gradient are those of the plain attention,
  as the port's are.  The entry point chooses the route, never a failure;
* cross-attention's operands are cast to their promoted type before each
  product (``torch.promote_types``), where ``jnp.einsum`` promotes mixed
  types itself: a bf16 model decoding with f32 ``image_embeds`` computes
  the cross layer, and the residual stream after it, in f32, as the
  reference does.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import active_rules
from repro_torch.distributed.spmd import P, axis_index, shard_map
from repro_torch.kernels import ops

Params = dict[str, Any]

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w)).to(dt)


def layer_norm(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (((x - mu) * torch.rsqrt(var + eps)) * (1.0 + w) + b).to(dt)


def apply_norm(x: torch.Tensor, p: Params, name: str, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p[name], p[name + "_b"])
    return rms_norm(x, p[name])


def init_norm(cfg: ModelConfig, *, device) -> Params:
    d = cfg.d_model
    out = {"w": torch.zeros((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        out["b"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return out


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions (..., L) -> cos/sin (..., L, dim/2) in fp32."""
    freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    freq = torch.from_numpy(freq.astype(np.float32)).to(positions.device)
    ang = positions.to(torch.float32)[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, L, H, Dh); cos/sin (B, L, Dh/2) — rotate-half convention."""
    dt = x.dtype
    x = x.to(torch.float32)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(dt)


def cache_write(cache: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """Write ``new`` (B, 1, ...) into ``cache`` (B, S, ...) at row ``pos``, in place.

    One row is written.  The reference's baseline path selects with a
    one-hot mask instead, reading and rewriting the whole cache every step
    (``repro/models/layers.py:113-115``); the values are the same.

    Under active rules whose ``cache_impl`` says ``"sharded_dus"``, the
    write runs as the reference's does: a ``shard_map`` over the cache laid
    out by the rules (batch over ``batch``, the sequence over ``kv_seq``) in
    which only the rank that owns slot ``pos`` writes its one local row,
    into its view of the caller's cache (:func:`_cache_write_sharded`).
    ``"heads_dus"`` (a head-sharded cache, the sequence whole on every rank)
    is the one-row write.
    """
    r = active_rules()
    if r is not None and "sharded_dus" in r.cache_impl and _cache_write_sharded(
        cache, new, pos, r
    ):
        return
    cache[:, pos] = new[:, 0].to(cache.dtype)


def _cache_write_sharded(cache: torch.Tensor, new: torch.Tensor, pos: int, rules) -> bool:
    """The one-row write on the rank owning the slot (see :func:`cache_write`).

    Returns False, writing nothing, when the layout does not qualify (the
    seq axis unsharded or not dividing the cache's length, as the
    reference's returns None) or when a rank's device does not hold the
    cache (its shard would be a copy, and the write would not land); the
    caller then writes the row itself.
    """
    seq_ax = rules.logical.get("kv_seq")
    if not seq_ax:
        return False
    mesh = rules.mesh
    n_seq = mesh.axis_size(seq_ax)
    if n_seq <= 1 or cache.shape[1] % n_seq:
        return False
    if any(d != cache.device for d in mesh.device_list):
        return False
    batch_ax = rules.logical.get("batch")
    if batch_ax and cache.shape[0] % mesh.axis_size(batch_ax):
        batch_ax = None
    trail = (None,) * (cache.ndim - 2)

    def body(c, n):
        local = pos - axis_index(seq_ax) * c.shape[1]
        if 0 <= local < c.shape[1]:
            c[:, local] = n[:, 0]
        return ()

    shard_map(
        body,
        mesh=mesh,
        in_specs=(P(batch_ax, seq_ax, *trail), P(batch_ax, None, *trail)),
        out_specs=(),
        check_vma=False,
    )(cache, new.to(cache.dtype))
    return True


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def draw_normal(shape, scale: float, dtype, device, generator) -> torch.Tensor:
    """N(0, 1) * scale, drawn on ``device`` directly in ``dtype``."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=device).mul_(scale)


def init_attention(
    cfg: ModelConfig, *, generator: torch.Generator, device, dtype: torch.dtype,
    cross: bool = False,
) -> Params:
    """Self- or cross-attention weights from the reference's distributions;
    the projections (and a cross layer's ``gate``) are stored in ``dtype``
    (every use casts them to it), the biases in it too, the qk-norm weights
    in f32.  A cross layer projects the memory with ``wk_mem``/``wv_mem``,
    from ``image_embed_dim`` for the vlm family and ``d_model`` otherwise,
    has no QKV bias, and scales its output by ``tanh(gate)``, with ``gate``
    0 as the reference draws it."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    f32 = torch.float32
    mem_d = cfg.image_embed_dim if (cross and cfg.family == "vlm") else d
    kname, vname = ("wk_mem", "wv_mem") if cross else ("wk", "wv")
    p: Params = {
        "wq": draw_normal((d, h, dh), 1.0 / np.sqrt(d), dtype, device, generator),
        "wo": draw_normal((h, dh, d), 1.0 / np.sqrt(h * dh), dtype, device, generator),
        kname: draw_normal((mem_d, hkv, dh), 1.0 / np.sqrt(mem_d), dtype, device, generator),
        vname: draw_normal((mem_d, hkv, dh), 1.0 / np.sqrt(mem_d), dtype, device, generator),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((h, dh), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv, dh), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv, dh), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((dh,), dtype=f32, device=device)
        p["k_norm"] = torch.zeros((dh,), dtype=f32, device=device)
    if cross:
        p["gate"] = torch.zeros((), dtype=dtype, device=device)  # llama-vision tanh gate
    return p


def _sdpa(
    q: torch.Tensor,  # (B, Lq, H, Dh)
    k: torch.Tensor,  # (B, Lk, Hkv, Dh)
    v: torch.Tensor,  # (B, Lk, Hkv, Dh)
    *,
    causal: bool,
    q_offset: int = 0,
    window: int = 0,
    kv_len: int | None = None,
) -> torch.Tensor:
    """Grouped-query scaled dot-product attention (reference path).

    Never materializes repeated KV heads: q is reshaped to (B, Lq, Hkv, G,
    Dh) and scores are computed per kv-head group.  ``q_offset`` is the
    absolute position of q's first row (decode: current position).
    ``kv_len`` masks cache tails beyond the valid length.
    """
    b, lq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, lq, hkv, g, dh)
    scale = 1.0 / np.sqrt(dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32) * scale

    qpos = torch.arange(lq, device=q.device)[:, None] + q_offset  # (Lq, 1) absolute
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]     # (1, Lk)
    mask = torch.ones((lq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    if kv_len is not None:
        mask &= kpos < kv_len
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, lq, h, dh)


def _sdpa_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: int = 0,
    kv_len: int | None = None,
    q_chunk: int = 512,
) -> torch.Tensor:
    """Query-chunked attention: O(bq·Lk) live scores instead of O(Lq·Lk).

    A loop over query chunks (the reference's ``lax.scan``); K/V stay whole.
    """
    b, lq, h, dh = q.shape
    c = min(q_chunk, lq)
    if lq % c:
        return _sdpa(q, k, v, causal=causal, window=window, kv_len=kv_len)
    outs = [
        _sdpa(q[:, i:i + c], k, v, causal=causal, q_offset=i, window=window, kv_len=kv_len)
        for i in range(0, lq, c)
    ]
    return torch.cat(outs, dim=1)


_CHUNK_THRESHOLD = 2048


def _sdpa_auto(q, k, v, *, causal, window=0, kv_len=None):
    if q.shape[1] >= _CHUNK_THRESHOLD:
        return _sdpa_chunked(q, k, v, causal=causal, window=window, kv_len=kv_len)
    return _sdpa(q, k, v, causal=causal, window=window, kv_len=kv_len)


def _sdpa_decode_decomposed(
    q: torch.Tensor,    # (B, 1, H, Dh)
    kc: torch.Tensor,   # (B, S, Hkv, Dh) cache BEFORE this token's write
    vc: torch.Tensor,
    kn: torch.Tensor,   # (B, 1, Hkv, Dh) this token's k/v
    vn: torch.Tensor,
    *,
    valid_len: int,     # number of valid cache rows (= pos, or window fill)
    slot: int,          # ring slot this token will occupy (masked out)
) -> torch.Tensor:
    """Decode attention over (old cache ⊕ new token) with a joint softmax.

    Mathematically identical to write-then-attend, but nothing reads the
    *updated* cache.  The ring ``slot`` is masked from the old cache (it
    holds the evicted token once the window wraps).  The caller writes the
    new row after this returns: with the port's in-place cache, writing
    first would count the new token twice.
    """
    b, lq, h, dh = q.shape
    hkv = kc.shape[2]
    g = h // hkv
    qg = q.reshape(b, lq, hkv, g, dh)
    scale = 1.0 / np.sqrt(dh)
    s_old = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc).to(torch.float32) * scale
    kpos = torch.arange(kc.shape[1], device=q.device)
    mask = (kpos < valid_len) & (kpos != slot)
    s_old = torch.where(mask, s_old, -1e30)
    s_new = torch.einsum("bqhgd,bkhd->bhgqk", qg, kn).to(torch.float32) * scale
    probs = torch.softmax(torch.cat([s_old, s_new], -1), dim=-1)
    p_old = probs[..., :-1].to(vc.dtype)
    p_new = probs[..., -1:].to(vn.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p_old, vc) + torch.einsum(
        "bhgqk,bkhd->bqhgd", p_new, vn
    )
    return out.reshape(b, lq, h, dh)


def _prefill_attention(q, k, v, *, causal: bool, window: int, cfg: ModelConfig) -> torch.Tensor:
    """Attention of a whole prompt over itself or over the memory: the
    kernel under ``attn_impl="flash"``, unless autograd records it (the
    module's docstring: the kernel has no backward)."""
    if cfg.attn_impl == "flash" and not ops.records_grad(q, k, v):
        return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=causal, window=window)
    return _sdpa_auto(q, k, v, causal=causal, window=window)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` on both operands cast to their promoted type, as
    ``jnp.einsum`` promotes mixed types (``torch.einsum`` rejects them)."""
    t = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(t), b.to(t))


def cross_attention(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                     # (B, L, D)
    *,
    cache: Params | None = None,         # {"k_mem","v_mem"} (B, M, Hkv, Dh)
    memory: torch.Tensor | None = None,  # (B, M, Dm)
) -> tuple[torch.Tensor, Params | None]:
    """Attention from ``x`` to a static memory (the reference's cross branch).

    With ``memory`` its projections are computed and, into a cache, written
    in place (prefill; a vlm decode step re-projects and rewrites them, as
    the reference does); without it they are read from the cache (decode).
    qk-norm applies to q and the projected memory; there is no RoPE; the
    output is scaled by ``tanh(gate)``.
    """
    dt = x.dtype
    q = torch.einsum("bld,dhk->blhk", x, p["wq"].to(dt))
    if memory is not None:
        kk = _einsum("bmd,dhk->bmhk", memory, p["wk_mem"].to(dt))
        vv = _einsum("bmd,dhk->bmhk", memory, p["wv_mem"].to(dt))
        if cache is not None:
            for name, t in (("k_mem", kk), ("v_mem", vv)):
                if cache[name].shape != t.shape:
                    raise ValueError(f"cross_attention: memory gives {name} {tuple(t.shape)}, "
                                     f"the cache holds {tuple(cache[name].shape)}")
                cache[name].copy_(t)
    else:
        kk, vv = cache["k_mem"].to(dt), cache["v_mem"].to(dt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        kk = rms_norm(kk, p["k_norm"])
    t = torch.promote_types(q.dtype, kk.dtype)
    q, kk, vv = q.to(t), kk.to(t), vv.to(t)
    if q.shape[1] == 1 and cache is not None:  # decode: one row against the memory
        out = _sdpa(q, kk, vv, causal=False)
    else:
        out = _prefill_attention(q, kk, vv, causal=False, window=0, cfg=cfg)
    out = _einsum("blhk,hkd->bld", out, p["wo"].to(dt))
    return torch.tanh(p["gate"].to(dt)) * out, cache


def attention(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                 # (B, L, D)
    *,
    positions: torch.Tensor,         # (B, L) absolute positions
    causal: bool = True,
    cache: Params | None = None,     # {"k","v"} (B, S, Hkv, Dh) ring/linear
    cache_pos: int | None = None,    # #tokens already cached
    memory: torch.Tensor | None = None,
) -> tuple[torch.Tensor, Params | None]:
    """Self/cross attention.  Returns (out (B,L,D), the cache or None).

    Modes:
      * train/prefill: ``cache is None`` → full self-attention; prefill into
        a cache writes k/v into ``cache`` (in place) with ``cache_pos=0``.
      * decode: L == 1, ``cache_pos`` = current length; k/v written in place
        at ``cache_pos`` (ring position for SWA).
      * cross: ``memory``, or a cache holding ``k_mem``, supplies K/V
        (:func:`cross_attention`).
    """
    if memory is not None or (cache is not None and "k_mem" in cache):
        return cross_attention(p, cfg, x, cache=cache, memory=memory)
    dh = cfg.resolved_head_dim
    dt = x.dtype
    q = torch.einsum("bld,dhk->blhk", x, p["wq"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
    k = torch.einsum("bld,dhk->blhk", x, p["wk"].to(dt))
    v = torch.einsum("bld,dhk->blhk", x, p["wv"].to(dt))
    if "bk" in p:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])

    cos, sin = rope_cos_sin(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is None:
        out = _prefill_attention(q, k, v, causal=causal, window=cfg.sliding_window, cfg=cfg)
    else:
        ck, cv = cache["k"], cache["v"]
        s_max = ck.shape[1]
        if q.shape[1] == 1:  # -------- decode step --------
            # ring index under SWA, linear otherwise; one row written in place
            slot = cache_pos % s_max if cfg.sliding_window else cache_pos
            r = active_rules()
            if r is not None and "decomposed" in r.cache_impl:
                # attend (old cache ⊕ new token), then write: the updated
                # cache is only written, never read
                valid = min(cache_pos, s_max) if cfg.sliding_window else cache_pos
                out = _sdpa_decode_decomposed(q, ck, cv, k, v, valid_len=valid, slot=slot)
                cache_write(ck, k, slot)
                cache_write(cv, v, slot)
            else:
                cache_write(ck, k, slot)
                cache_write(cv, v, slot)
                # under SWA every live slot is in-window; mask only unwritten rows
                valid = min(cache_pos + 1, s_max) if cfg.sliding_window else cache_pos + 1
                out = _sdpa(q, ck, cv, causal=False, kv_len=valid)
        else:  # -------- prefill into cache --------
            lq = q.shape[1]
            if cfg.sliding_window and lq > s_max:
                # Only the last window survives; place token t at slot
                # t % s_max so later decode writes stay consistent.
                ck.copy_(torch.roll(k[:, -s_max:], lq % s_max, dims=1).to(ck.dtype))
                cv.copy_(torch.roll(v[:, -s_max:], lq % s_max, dims=1).to(cv.dtype))
            else:
                ck[:, :lq] = k.to(ck.dtype)
                cv[:, :lq] = v.to(cv.dtype)
            out = _prefill_attention(q, k, v, causal=causal, window=cfg.sliding_window, cfg=cfg)

    out = torch.einsum("blhk,hkd->bld", out, p["wo"].to(dt))
    return out, cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(
    cfg: ModelConfig, d_ff: int, *, generator: torch.Generator, device, dtype: torch.dtype
) -> Params:
    d = cfg.d_model
    return {
        "w_gate": draw_normal((d, d_ff), 1.0 / math.sqrt(d), dtype, device, generator),
        "w_up": draw_normal((d, d_ff), 1.0 / math.sqrt(d), dtype, device, generator),
        "w_down": draw_normal((d_ff, d), 1.0 / math.sqrt(d_ff), dtype, device, generator),
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    return h @ p["w_down"].to(dt)
