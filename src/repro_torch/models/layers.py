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
* **tensor parallelism:** inside the body of
  ``repro_torch.distributed.spmd.sharded_prefill``, ``sharded_decode_step``
  or the tensor-parallel train step (``spmd.model_parallel()`` is set) a
  rank holds its shards of the params, and :func:`attention` and
  :func:`mlp` compute on them with the ``model`` collectives where the
  reference's GSPMD partition puts them: a ``psum`` after the row-split
  ``wo`` and ``w_down`` products (:func:`_attention_tp`, the sliding
  window's ring included).  Under autograd the residual stream entering
  the rank's heads or columns, and the params every rank holds alike that
  it uses for its share (``q_norm``, ``k_norm``, a replicated ``wk``/``wv``
  and their biases), pass through ``spmd.pvary``, whose cotangent is summed
  over ``model``.
  :func:`cross_attention` splits its q heads and ``wo`` the same way and
  projects the memory whole into the cache (:func:`_cross_attention_tp`).
  Outside such a body nothing here calls a collective, as the reference's
  ``shard(...)`` is the identity outside a rules context;
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
from repro_torch.distributed.spmd import (
    MODEL_AXIS,
    P,
    all_gather,
    axis_index,
    axis_size,
    model_parallel,
    pmax,
    psum,
    pvary,
    recording_tape,
    shard_map,
)
from repro_torch.kernels import ops

Params = dict[str, Any]

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
             axis: str | None = None) -> torch.Tensor:
    """RMS norm over the last dim.  With ``axis`` (a tensor-parallel rank)
    ``x`` and ``w`` hold the rank's block of that dim, split evenly over the
    mesh axis ``axis``: the f32 sum of squares is summed over it.  That sum,
    which every rank holds alike, then scales the rank's own channels, so
    under autograd it passes through ``pvary``: its cotangent is summed over
    ``axis`` before the ``psum``'s transpose hands it to each rank's
    squares.  In a rank whose backward runs in segments ``x`` is cut first
    (``spmd.recording_tape``), so that the cotangents of both its uses, the
    scaled channels and the squares, meet there and the backward runs
    through ``x``'s graph once."""
    dt = x.dtype
    tape = recording_tape() if axis is not None else None
    if tape is not None:
        x = tape.boundary(x)
    x = x.to(torch.float32)
    if axis is None:
        ms = torch.mean(x * x, dim=-1, keepdim=True)
    else:
        total = pvary(psum(torch.sum(x * x, dim=-1, keepdim=True), axis), axis)
        ms = total / (x.shape[-1] * axis_size(axis))
    return (x * torch.rsqrt(ms + eps) * (1.0 + w)).to(dt)


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


def plain_route(*tensors) -> bool:
    """Whether a layer takes its plain PyTorch route, not a kernel: where
    autograd records the operands (the kernels have no backward), and in a
    rank's training forward whose backward runs in segments
    (``spmd.recording_tape``), whose recomputed periods first run without
    autograd and then with it: both passes compute alike, as the
    reference's training step runs its plain functions."""
    return ops.records_grad(*tensors) or recording_tape() is not None


def _prefill_attention(q, k, v, *, causal: bool, window: int, cfg: ModelConfig) -> torch.Tensor:
    """Attention of a whole prompt over itself or over the memory: the
    kernel under ``attn_impl="flash"``, unless the layer trains
    (:func:`plain_route`; the module's docstring: the kernel has no
    backward)."""
    if cfg.attn_impl == "flash" and not plain_route(q, k, v):
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
    output is scaled by ``tanh(gate)``.  On a rank of a tensor-parallel
    body: :func:`_cross_attention_tp`.
    """
    if model_parallel() is not None:
        return _cross_attention_tp(p, cfg, x, cache=cache, memory=memory), cache
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


def _project(p: Params, cfg: ModelConfig, x: torch.Tensor, w: str, cos: torch.Tensor,
             sin: torch.Tensor) -> torch.Tensor:
    """``x`` (B, L, D) through the projection ``w`` (``"wq"``, ``"wk"`` or
    ``"wv"``) onto whatever heads ``p[w]`` holds, with its bias; q and k
    also take the qk-norm and RoPE at ``cos``/``sin`` (B, L, Dh/2)."""
    dt = x.dtype
    t = torch.einsum("bld,dhk->blhk", x, p[w].to(dt))
    bias = "b" + w[1:]
    if bias in p:
        t = t + p[bias].to(dt)
    if w == "wv":
        return t
    if cfg.qk_norm:
        t = rms_norm(t, p["q_norm" if w == "wq" else "k_norm"])
    return apply_rope(t, cos, sin)


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
    dt = x.dtype
    cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    tp = model_parallel()
    if tp is not None:
        return _attention_tp(p, cfg, x, tp, cos, sin, causal=causal, cache=cache,
                             cache_pos=cache_pos), cache
    q, k, v = (_project(p, cfg, x, w, cos, sin) for w in ("wq", "wk", "wv"))

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


def mlp(p: Params, x: torch.Tensor, *, d_ff: int | None = None) -> torch.Tensor:
    """SwiGLU.  In a tensor-parallel body a rank holding its columns of
    ``w_gate``/``w_up`` and rows of ``w_down`` (fewer than ``d_ff``) sums
    its partial output over the model axis; under autograd the input's
    cotangent is summed over it (:func:`~repro_torch.distributed.spmd.pvary`)."""
    tp = model_parallel()
    if tp is not None and d_ff is None:
        raise ValueError("mlp in a tensor-parallel body needs the global d_ff")
    split = tp is not None and p["w_down"].shape[0] != d_ff
    if split:  # the residual stream enters the rank's columns (Megatron's f)
        x = pvary(x, MODEL_AXIS)
    dt = x.dtype
    h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    out = h @ p["w_down"].to(dt)
    return psum(out, MODEL_AXIS) if split else out


# ---------------------------------------------------------------------------
# attention on a rank of a tensor-parallel body
# ---------------------------------------------------------------------------


def _kv_for_heads(t: torch.Tensor, q0: int, hq: int, group: int) -> torch.Tensor:
    """The kv heads that q heads ``[q0, q0 + hq)`` read (q head ``i`` reads
    kv head ``i // group``), of ``t`` (B, L, Hkv, Dh) holding every kv head:
    a slice where those q heads form whole groups or lie in one, else one kv
    head per q head."""
    if hq % group == 0 or group % hq == 0:
        return t[:, :, q0 // group:(q0 + hq - 1) // group + 1]
    return t.index_select(2, torch.arange(q0, q0 + hq, device=t.device) // group)


def combine_context_parallel(s: torch.Tensor, mask: torch.Tensor, value,
                             axis: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The softmax of scores whose keys are split over the mesh axis
    ``axis`` (the cache's sequence axis), from this rank's f32 scores ``s``
    (keys last) of its own keys, attended where ``mask``: each rank keeps
    its row maximum, its sum of exponentials and its unnormalised output
    ``value(p)`` for its weights ``p``; the ranks take the maximum
    (``pmax``) and sum the sums and outputs rescaled to it (one ``psum``).
    Returns (the sum, the output, the maximum), each keeping the keys' dim
    as 1."""
    s = torch.where(mask, s, -1e30)
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - mx).masked_fill(~mask, 0.0)
    total = pmax(mx, axis)
    rescale = torch.exp(mx - total)
    lsum, o = psum((p.sum(dim=-1, keepdim=True) * rescale, value(p) * rescale), axis)
    return lsum, o, total


def sequence_parallel(f, *ts: torch.Tensor) -> torch.Tensor:
    """``f(*ts)`` for a function ``f`` that maps tensors (B, L, ...) row by
    row, on a rank of a tensor-parallel body: the rank maps its share of
    the L rows (equal shares, the last padded) and the ranks all-gather
    them; one rank maps them all."""
    n, rank = axis_size(MODEL_AXIS), axis_index(MODEL_AXIS)
    if n == 1:
        return f(*ts)
    l = ts[0].shape[1]
    chunk = -(-l // n)
    lo, hi = min(rank * chunk, l), min((rank + 1) * chunk, l)
    t = f(*(u[:, lo:hi] for u in ts))
    pad = t.new_zeros((t.shape[0], chunk - (hi - lo), *t.shape[2:]))
    return all_gather(torch.cat([t, pad], 1), MODEL_AXIS, axis=1, tiled=True)[:, :l]


def _sdpa_context_parallel(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor, *, rows0: int,
                           kv_len: int, axis: str,
                           new: tuple[torch.Tensor, torch.Tensor] | None = None,
                           slot: int = -1) -> torch.Tensor:
    """Decode attention of ``q`` (B, 1, H, Dh) over a cache whose rows are
    split over the mesh axis ``axis``: this rank's block ``kc``/``vc`` (B, S_l,
    Hkv, Dh) holds global rows ``[rows0, rows0 + S_l)``, of which rows below
    ``kv_len`` but row ``slot`` are attended, their softmax partials
    combined by :func:`combine_context_parallel` (f32).  ``new``, the new
    token's k/v row (B, 1, Hkv, Dh) not yet in the cache (the
    ``"decomposed"`` cache, which passes the ring ``slot`` the row will
    take: it holds the evicted token once a window wraps), then joins the
    softmax on every rank, as the reference's replicated score of the new
    token does."""
    b, lq, h, dh = q.shape
    hkv = kc.shape[2]
    qg = q.reshape(b, lq, hkv, h // hkv, dh)
    scale = 1.0 / np.sqrt(dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc).to(torch.float32) * scale
    rows = torch.arange(rows0, rows0 + kc.shape[1], device=q.device)
    mask = rows < kv_len
    if slot >= 0:
        mask &= rows != slot
    lsum, o, total = combine_context_parallel(
        s, mask, lambda w: torch.einsum("bhgqk,bkhd->bhgqd", w, vc.to(torch.float32)), axis)
    if new is not None:
        s_new = torch.einsum("bqhgd,bkhd->bhgqk", qg, new[0]).to(torch.float32) * scale
        top = torch.maximum(total, s_new)
        old, fresh = torch.exp(total - top), torch.exp(s_new - top)
        lsum = lsum * old + fresh
        o = o * old + torch.einsum("bhgqk,bkhd->bhgqd", fresh, new[1].to(torch.float32))
    out = (o / lsum).permute(0, 3, 1, 2, 4)                    # (B, 1, Hkv, G, Dh)
    return out.reshape(b, lq, h, dh).to(q.dtype)


def _attention_tp(p: Params, cfg: ModelConfig, x: torch.Tensor, tp, cos: torch.Tensor,
                  sin: torch.Tensor, *, causal: bool, cache: Params | None,
                  cache_pos: int | None) -> torch.Tensor:
    """:func:`attention` on a rank of a tensor-parallel serving body
    (``repro_torch.distributed.spmd.serving_body``), on the rank's shards,
    with RoPE at ``cos``/``sin``.

    The rank's q heads come from its slice of ``wq`` (its part of the
    heads, the weight's shape says which), and ``wo``'s matching rows give
    a partial output that is summed over the model axis.  Its kv heads:
    with ``wk``/``wv`` split, its own; replicated (the kv heads do not
    divide the axis), the slice its q heads read.  A replicated ``wk``/``wv``
    projects the prompt's rows sequence-parallel: each rank projects its
    share of the rows (the rows of its cache block under the ``seq``
    layout) with every kv head, and the ranks all-gather them.

    The cache (``tp.kv_seq_axis``: the rank's rows, split over that axis,
    every kv head; ``tp.kv_heads_split``: every row, the rank's kv heads;
    neither: the whole cache) is written in place, the rank's block only.
    Decode with the sequence split is context-parallel: the new row's kv
    heads are all-gathered (the cache holds every kv head), the rank whose
    block holds the slot writes the row, every rank attends to its own
    rows, and the ranks combine their softmax partials over the sequence's
    axis (:func:`_sdpa_context_parallel`).  Over ``model`` (the ``seq``
    layout of ``decode_rules``) every rank's rows need every head: the q
    heads are all-gathered first and the rank keeps its heads of the
    output.  Over ``data`` (``long_decode_rules``: a batch of one, its
    cache's sequence over ``data``, the heads over ``model``) the rank
    attends with its own q heads to the kv heads they read; the ``data``
    ranks combine, and ``wo``'s partial is summed over ``model`` as
    everywhere.  Under a ``"decomposed"`` ``cache_impl`` decode attends to
    the old rows and joins the new one, then writes, as :func:`attention`
    does.

    With a sliding window the cache is the ring :func:`attention` keeps
    (``S = min(max_len, window)`` slots, token *t* in slot ``t % S``): a
    prompt longer than the ring writes its last ``S`` tokens rolled into
    place, each rank its block of the ring; a decode step writes slot
    ``pos % S`` on the rank whose block holds it and attends to every
    written slot (the decomposed step to every one but that slot).  A
    prompt that wraps the ring projects its k/v rows sequence-parallel in
    equal shares of the prompt, not by cache block.  Under
    ``long_decode_rules`` the prompt is every ``data`` rank's (the batch is
    replicated): each computes its heads' attention over the whole prompt
    and writes its block of the rows (of the ring, rolled, where the prompt
    wraps it).
    """
    heads, kv_heads = cfg.num_heads, cfg.num_kv_heads
    group = heads // kv_heads
    n, rank = axis_size(MODEL_AXIS), axis_index(MODEL_AXIS)
    hq = p["wq"].shape[1]
    q_split, kv_split = hq != heads, p["wk"].shape[1] != kv_heads
    o_split = p["wo"].shape[0] != heads
    if q_split != o_split or (kv_split and not q_split) or (tp.kv_heads_split and not kv_split):
        raise ValueError(f"attention: wq {tuple(p['wq'].shape)}, wk {tuple(p['wk'].shape)}, "
                         f"wo {tuple(p['wo'].shape)} and the cache's heads are split unlike "
                         f"params_shardings and cache_shardings split them")
    q0 = rank * hq if q_split else 0
    if q_split:  # what every rank holds alike enters the rank's share of the heads
        alike = ("q_norm", "k_norm") + (() if kv_split else ("wk", "wv", "bk", "bv"))
        x = pvary(x, MODEL_AXIS)
        p = {k: pvary(v, MODEL_AXIS) if k in alike else v for k, v in p.items()}
    window = cfg.sliding_window
    seq_ax = tp.kv_seq_axis  # the axis the cache's rows are split over, or None

    def project(w: str, rows: slice = slice(None)) -> torch.Tensor:
        return _project(p, cfg, x[:, rows], w, cos[:, rows], sin[:, rows])

    def all_heads(t: torch.Tensor) -> torch.Tensor:
        return all_gather(t, MODEL_AXIS, axis=2, tiled=True) if kv_split else t

    def mine(t: torch.Tensor) -> torch.Tensor:
        return t if tp.kv_heads_split else _kv_for_heads(t, q0, hq, group)

    q = project("wq")
    lq = x.shape[1]
    ck, cv = (None, None) if cache is None else (cache["k"], cache["v"])
    if ck is not None:  # the rank's block: global slots [rows0, rows0 + ck.shape[1])
        slots = ck.shape[1] * (axis_size(seq_ax) if seq_ax else 1)
        rows0 = axis_index(seq_ax) * ck.shape[1] if seq_ax else 0
    if lq == 1 and cache is not None:  # -------- decode step --------
        r = active_rules()
        decomposed = r is not None and "decomposed" in r.cache_impl
        k, v = project("wk"), project("wv")
        if not tp.kv_heads_split:
            k, v = all_heads(k), all_heads(v)
        slot = cache_pos % slots if window else cache_pos
        row = slot - rows0
        owner = 0 <= row < ck.shape[1]  # the rank whose block holds the slot writes the row
        # the written slots attended: under a window every live one
        valid = cache_pos + (not decomposed)
        if window:
            valid = min(valid, slots)

        def write():
            if owner:
                ck[:, row] = k[:, 0].to(ck.dtype)
                cv[:, row] = v[:, 0].to(cv.dtype)

        if not decomposed:
            write()
        if seq_ax == MODEL_AXIS:  # every head over the rank's rows; its heads kept
            q_all = all_gather(q, MODEL_AXIS, axis=2, tiled=True) if q_split else q
            out = _sdpa_context_parallel(
                q_all, ck, cv, rows0=rows0, kv_len=valid, axis=seq_ax,
                new=(k, v) if decomposed else None, slot=slot if decomposed else -1
            )[:, :, q0:q0 + hq]
        elif seq_ax is not None:  # the rank's heads over its rows
            out = _sdpa_context_parallel(
                q, mine(ck), mine(cv), rows0=rows0, kv_len=valid, axis=seq_ax,
                new=(mine(k), mine(v)) if decomposed else None, slot=slot if decomposed else -1)
        elif decomposed:
            out = _sdpa_decode_decomposed(q, mine(ck), mine(cv), mine(k), mine(v),
                                          valid_len=valid, slot=slot)
        else:
            out = _sdpa(q, mine(ck), mine(cv), causal=False, kv_len=valid)
        if decomposed:
            write()
    else:  # -------- a prompt, into the cache if there is one --------

        def write_ring(kw: torch.Tensor, vw: torch.Tensor) -> None:
            """The rank's block of the cache from every prompt row ``kw``/``vw``."""
            if window and lq > slots:  # the last window, token t at slot t % slots
                kw, vw = (torch.roll(t[:, -slots:], lq % slots, dims=1) for t in (kw, vw))
            hi = min(rows0 + ck.shape[1], kw.shape[1])
            ck[:, :max(hi - rows0, 0)] = kw[:, rows0:hi].to(ck.dtype)
            cv[:, :max(hi - rows0, 0)] = vw[:, rows0:hi].to(cv.dtype)

        if kv_split or n == 1:
            k, v = project("wk"), project("wv")
            if ck is not None:
                write_ring(*((k, v) if tp.kv_heads_split else (all_heads(k), all_heads(v))))
        else:  # sequence-parallel projection of every kv head, then gathered
            # the rows of the rank's cache block, where they are prompt rows [rows0, ..)
            by_block = ck is not None and seq_ax == MODEL_AXIS and not (window and lq > slots)
            chunk = ck.shape[1] if by_block else -(-lq // n)
            lo, hi = min(rank * chunk, lq), min((rank + 1) * chunk, lq)
            kr, vr = project("wk", slice(lo, hi)), project("wv", slice(lo, hi))
            if by_block:
                ck[:, :hi - lo] = kr.to(ck.dtype)
                cv[:, :hi - lo] = vr.to(cv.dtype)
            k, v = (all_gather(F.pad(t, (0, 0, 0, 0, 0, chunk - (hi - lo))), MODEL_AXIS, axis=1,
                               tiled=True)[:, :lq] for t in (kr, vr))
            if ck is not None and not by_block:
                write_ring(k, v)
            k, v = _kv_for_heads(k, q0, hq, group), _kv_for_heads(v, q0, hq, group)
        out = _prefill_attention(q, k, v, causal=causal, window=window, cfg=cfg)
    out = torch.einsum("blhk,hkd->bld", out, p["wo"].to(x.dtype))
    return psum(out, MODEL_AXIS) if o_split else out


def _cross_attention_tp(p: Params, cfg: ModelConfig, x: torch.Tensor, *, cache: Params | None,
                        memory: torch.Tensor | None) -> torch.Tensor:
    """:func:`cross_attention` on a rank of a tensor-parallel serving body,
    on the rank's shards.

    The rank's q heads come from its slice of ``wq``, and ``wo``'s matching
    rows give a partial output that is summed over the model axis, then
    scaled by ``tanh(gate)``.  The cache's ``k_mem``/``v_mem`` hold every
    head of the rank's batch rows (``cache_shardings`` splits them over the
    batch only), so a projection of ``memory`` (a prompt's, or a vlm decode
    step's ``image_embeds``) is made whole: ``wk_mem``/``wv_mem`` split by
    kv heads project the rank's heads, which the ranks all-gather; kept
    whole (the kv heads do not divide the axis), they project the rank's
    share of the memory rows (:func:`sequence_parallel`).  The rank then attends with its q heads to the kv heads they
    read (:func:`_kv_for_heads`), flash on a prompt."""
    heads, kv_heads = cfg.num_heads, cfg.num_kv_heads
    group = heads // kv_heads
    hq = p["wq"].shape[1]
    q_split, kv_split = hq != heads, p["wk_mem"].shape[1] != kv_heads
    o_split = p["wo"].shape[0] != heads
    if q_split != o_split or (kv_split and not q_split):
        raise ValueError(f"cross_attention: wq {tuple(p['wq'].shape)}, wk_mem "
                         f"{tuple(p['wk_mem'].shape)} and wo {tuple(p['wo'].shape)} are split "
                         f"unlike params_shardings splits them")
    q0 = axis_index(MODEL_AXIS) * hq if q_split else 0
    dt = x.dtype
    q = torch.einsum("bld,dhk->blhk", x, p["wq"].to(dt))
    if memory is not None:

        def project(w: str) -> torch.Tensor:
            proj = lambda m: _einsum("bmd,dhk->bmhk", m, p[w].to(dt))  # noqa: E731
            if kv_split:
                return all_gather(proj(memory), MODEL_AXIS, axis=2, tiled=True)
            return sequence_parallel(proj, memory)

        kk, vv = project("wk_mem"), project("wv_mem")
        if cache is not None:
            for name, t in (("k_mem", kk), ("v_mem", vv)):
                if cache[name].shape != t.shape:
                    raise ValueError(f"cross_attention: memory gives {name} {tuple(t.shape)}, "
                                     f"the rank's cache block holds {tuple(cache[name].shape)}")
                cache[name].copy_(t)
    else:
        kk, vv = cache["k_mem"].to(dt), cache["v_mem"].to(dt)
    kk, vv = _kv_for_heads(kk, q0, hq, group), _kv_for_heads(vv, q0, hq, group)
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
    if o_split:
        out = psum(out, MODEL_AXIS)
    return torch.tanh(p["gate"].to(dt)) * out
