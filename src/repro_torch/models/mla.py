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

**Tensor parallelism** (inside a tensor-parallel serving body,
``repro_torch.distributed.spmd.serving_body``): :func:`_mla_tp`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.spmd import (
    MODEL_AXIS,
    all_gather,
    axis_index,
    model_parallel,
    pvary,
)
from repro_torch.models.layers import (
    Params,
    apply_rope,
    cache_write,
    combine_context_parallel,
    draw_normal,
    gather_rows,
    into_split,
    into_whole,
    out_of_split,
    out_of_whole,
    own_rows,
    rms_norm,
    rope_cos_sin,
    sequence_parallel,
    stream_rows,
)

__all__ = ["init_mla", "mla_attention"]

#: prefill query chunk, and the length from which the prefill is chunked
_Q_CHUNK, _CHUNK_FROM = 512, 2048
#: the low-rank down-projections and their norms, which every rank holds whole
_DOWN = ("wq_a", "q_norm_a", "wkv_a", "kv_norm_a")


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


def _by_rows(f, *ts: torch.Tensor) -> torch.Tensor:
    """``f(*ts)`` of tensors (B, L, ...) that ``f`` maps row by row."""
    return f(*ts)


def _own_rows_gathered(f, *ts: torch.Tensor) -> torch.Tensor:
    """``f`` over the rank's rows of the stream (``ts[0]``, the rank's own
    under ``train_rules_sp``) and of the rest (every rank holds them whole),
    the ranks' rows all-gathered along the sequence."""
    return gather_rows(f(ts[0], *(own_rows(t) for t in ts[1:])))


def _project_q(p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
               rows=_by_rows):
    """The heads ``wq_b`` holds: ``q_nope`` and ``q_rope`` with RoPE.
    ``rows`` maps the low-rank ``wq_a`` down-projection and its norm over
    the rows (:func:`_by_rows`, or
    :func:`~repro_torch.models.layers.sequence_parallel` on a rank)."""
    dt = x.dtype
    dh, rh = cfg.resolved_head_dim, cfg.rope_head_dim
    if "wq_a" in p:
        qa = rows(lambda t: rms_norm(t @ p["wq_a"].to(dt), p["q_norm_a"]), x)
        q = torch.einsum("blr,rhk->blhk", qa, p["wq_b"].to(dt))
    else:
        q = torch.einsum("bld,dhk->blhk", x, p["wq_b"].to(dt))
    q_nope, q_rope = q[..., :dh], q[..., dh:]
    cos, sin = rope_cos_sin(positions, rh, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    return q_nope, q_rope


def _project_kv_latent(p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                       rows=_by_rows):
    """The latent ``c_kv`` (B, L, Kr) and the rope key ``k_rope`` (B, L,
    Rh), mapped over the rows by ``rows`` as in :func:`_project_q`."""
    dt = x.dtype
    kr, rh = cfg.kv_lora_rank, cfg.rope_head_dim

    def latent(xs: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        kv = xs @ p["wkv_a"].to(dt)                       # (B, L, Kr+Rh)
        c_kv = rms_norm(kv[..., :kr], p["kv_norm_a"])
        k_rope = kv[..., kr:][:, :, None, :]              # (B, L, 1, Rh)
        cos, sin = rope_cos_sin(pos, rh, cfg.rope_theta)
        k_rope = apply_rope(k_rope, cos, sin)[:, :, 0]    # shared across heads
        return torch.cat([c_kv, k_rope], -1)

    both = rows(latent, x, positions)
    return both[..., :kr], both[..., kr:]


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


def _attend_latent(q_lat, q_rope, ckv, krope, cache_pos: int, scale: float) -> torch.Tensor:
    """Absorbed decode attention of ``q_lat`` (B, 1, H, Kr) and ``q_rope``
    (B, 1, H, Rh) over the cache rows ``<= cache_pos`` of ``ckv`` (B, S, Kr)
    and ``krope`` (B, S, Rh), in latent space: ``o_lat`` (B, 1, H, Kr)."""
    dt = q_lat.dtype
    s_nope = torch.einsum("blhr,bsr->bhls", q_lat, ckv.to(dt))
    s_rope = torch.einsum("blhk,bsk->bhls", q_rope, krope.to(dt))
    scores = (s_nope + s_rope).to(torch.float32) * scale
    kpos = torch.arange(ckv.shape[1], device=ckv.device)[None, None, None]
    scores = torch.where(kpos <= cache_pos, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dt)
    return torch.einsum("bhls,bsr->blhr", probs, ckv.to(dt))


def _attend_prompt(q_nope, q_rope, k_nope, k_rope, v, scale: float) -> torch.Tensor:
    """Causal attention of a whole prompt over its decompressed K/V, in
    query chunks from :data:`_CHUNK_FROM` tokens."""
    l = q_nope.shape[1]
    kv = (k_nope, k_rope, v)
    if l >= _CHUNK_FROM and l % _Q_CHUNK == 0:
        return torch.cat([_q_chunk_attn(q_nope[:, i:i + _Q_CHUNK], q_rope[:, i:i + _Q_CHUNK], i,
                                        *kv, scale)
                          for i in range(0, l, _Q_CHUNK)], dim=1)
    return _q_chunk_attn(q_nope, q_rope, 0, *kv, scale)


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
    tp = model_parallel()
    if tp is not None:
        return _mla_tp(p, cfg, x, tp, positions=positions, cache=cache, cache_pos=cache_pos), cache
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
        # attend in latent space, then absorb W^UV on the way out
        o_lat = _attend_latent(q_lat, q_rope, ckv, krope, cache_pos, scale)
        o = torch.einsum("blhr,rhk->blhk", o_lat, p["wv_b"].to(dt))
        out = torch.einsum("blhk,hkd->bld", o, p["wo"].to(dt))
        return out, cache

    # ---------------- train / prefill (decompressed) ----------------
    c_kv, k_rope = _project_kv_latent(p, cfg, x, positions)
    k_nope = torch.einsum("blr,rhk->blhk", c_kv, p["wk_b"].to(dt))
    v = torch.einsum("blr,rhk->blhk", c_kv, p["wv_b"].to(dt))
    l = x.shape[1]
    o = _attend_prompt(q_nope, q_rope, k_nope, k_rope, v, scale)
    out = torch.einsum("blhk,hkd->bld", o, p["wo"].to(dt))

    if cache is not None:  # prefill into the compressed cache
        cache["ckv"][:, :l] = c_kv.to(cache["ckv"].dtype)
        cache["krope"][:, :l] = k_rope.to(cache["krope"].dtype)
    return out, cache


def _mla_tp(p: Params, cfg: ModelConfig, x: torch.Tensor, tp, *, positions: torch.Tensor,
            cache: Params | None, cache_pos: int | None) -> torch.Tensor:
    """:func:`mla_attention` on a rank of a tensor-parallel serving body,
    on the rank's shards: its heads of ``wq_b``, ``wk_b``, ``wv_b`` and
    ``wo`` (``params_shardings`` splits them over ``model``; every rank
    holds them whole where the axis does not divide the heads), and
    ``wq_a``, ``wkv_a`` and the two norms whole.  ``wo``'s partial output
    is summed over the model axis.

    **Prefill:** the low-rank down-projections run sequence-parallel, as
    the reference's partition runs them: each rank projects its share of
    the prompt's rows through ``wq_a`` (and its norm) and through
    ``wkv_a`` (the latent's norm, the rope key's RoPE), and the ranks
    all-gather the rows (two all-gathers), so that every rank holds the
    latent ``c_kv`` and ``k_rope`` of every token of its batch rows.  The
    rank's heads attend to the K/V they decompress from the latent.  It
    writes its block of the cache: its rows where the sequence is split
    (``tp.kv_seq_axis``: over ``model`` under the ``seq`` layout, over
    ``data`` under ``long_decode_rules``, whose batch of one every rank
    holds), its latent and rope columns under ``heads``
    (``tp.latent_split``), all of it where neither splits.

    **Decode:** the rank projects its heads' ``q_lat`` (``W^UK`` absorbed)
    and ``q_rope``.  Where the sequence is split the rank whose rows hold
    the slot writes the new latent row, each rank attends in latent space
    to its own rows, and the ranks combine their softmax partials over the
    sequence's axis (:func:`combine_context_parallel`: a ``pmax`` and a
    ``psum`` of ``(B, H, 1, Kr + 1)`` f32 values over the heads attended):
    under ``seq`` (over ``model``) it all-gathers the heads first, attends
    with every head and keeps its heads of ``o_lat``; under
    ``long_decode_rules`` (over ``data``) it attends with its own heads.
    Under ``heads`` each rank writes its columns of the new row and
    all-gathers the latent: the scores sum over the latent and
    rope dims, and gathering them (each rank receives the other ranks'
    ``(n - 1) / n`` of its rows' ``B·S·(Kr + Rh)`` cache elements a layer
    and step: 8 × 528 × 576 × 15/16 bf16 values, 4.6 MB, at deepseek-v2's
    widths on a (1, 16) mesh) was chosen over summing partial scores (a
    ``psum`` of ``B·H·S`` f32 scores and an all-gather of ``o_lat``'s
    ``B·H·Kr``, every rank's softmax over every head).  The rank then
    attends with its heads over the whole latent, as :func:`mla_attention`
    does.  Either way the rank applies its ``wv_b`` heads and its ``wo``
    rows.  The row is written on the rank itself, never through
    :func:`~repro_torch.models.layers.cache_write`, whose ``"sharded_dus"``
    write would open a ``shard_map`` inside the rank.

    **Training** (no cache, in the tensor-parallel train step, under
    autograd and the backward in segments): the down-projections stay
    sequence-parallel, as in a prompt.  Every rank would otherwise compute
    the same ``B·L·D·(Q + Kr + Rh)`` products (deepseek-v2: 10.8 M
    multiply-adds a token a layer, beside the 9.4 M of ``wq_b`` on a
    rank's quarter of the heads), while the two gathers of ``(B, L, Q)`` and
    ``(B, L, Kr + Rh)`` move less than one layer's ``psum`` of ``(B, L, D)``
    at D = 5120; and the gradient of the whole-run down-projections would
    need the same ``psum`` over ``model`` (the rank's heads give a partial
    cotangent of the latent) that the split one needs.  The gathers'
    transpose (a ``psum_scatter``) sums the cotangents of the rank's rows
    from every rank's heads, so the gradients of ``wq_a``, ``q_norm_a``,
    ``wkv_a`` and ``kv_norm_a``, and ``x``'s, cover the rank's rows only:
    they enter through ``pvary``, whose transpose sums them over ``model``.
    Where the heads do not divide the axis the rank computes the layer
    whole, the down-projections too: nothing is split, and a gather's
    transpose would sum the ranks' identical cotangents.  Under
    ``train_rules_sp`` the rank holds its rows of the stream: they feed the
    down-projections as they are (no gather of ``x``, unless q comes
    straight from it, without ``wq_a``), the ``q_a`` and latent gathers
    stay, and ``wo``'s partial is reduce-scattered back to the rank's rows;
    the heads undivided, the layer runs whole on the gathered rows
    (:func:`~repro_torch.models.layers.into_whole`)."""
    dt = x.dtype
    heads, dh, rh = cfg.num_heads, cfg.resolved_head_dim, cfg.rope_head_dim
    rank = axis_index(MODEL_AXIS)
    hq = p["wq_b"].shape[1]
    split = hq != heads
    if any((p[w].shape[1] != heads) != split for w in ("wk_b", "wv_b")) or (
            p["wo"].shape[0] != heads) != split:
        raise ValueError(f"mla: wq_b {tuple(p['wq_b'].shape)}, wk_b {tuple(p['wk_b'].shape)}, "
                         f"wv_b {tuple(p['wv_b'].shape)} and wo {tuple(p['wo'].shape)} are split "
                         f"unlike params_shardings splits them")
    q0 = rank * hq if split else 0
    scale = 1.0 / np.sqrt(dh + rh)
    l = positions.shape[1]
    # a prompt's down-projections by rows; a decode step's whole on every rank,
    # and a training step's where the heads are not split
    rows = sequence_parallel if l > 1 and (split or cache is not None) else _by_rows
    down = x  # what the down-projections take
    if split and stream_rows() == "split":  # the rank's own rows
        p = {k: pvary(v, MODEL_AXIS) if k in _DOWN else v for k, v in p.items()}
        rows = _own_rows_gathered
        if "wq_a" not in p:  # q straight from x needs every row
            x = gather_rows(x)
    else:  # what every rank holds alike enters the rank's rows or heads
        x, p = into_split(x, p, _DOWN) if split else into_whole(x, p)
        down = x
    q_nope, q_rope = _project_q(p, cfg, x, positions, rows)  # the rank's heads
    c_kv, k_rope = _project_kv_latent(p, cfg, down, positions, rows)
    if cache is not None:
        ckv, krope = cache["ckv"], cache["krope"]
        # the rank's block: rows [rows0, rows0 + ckv.shape[1]), columns from c0 and r0
        seq_ax = tp.kv_seq_axis
        rows0 = axis_index(seq_ax) * ckv.shape[1] if seq_ax else 0
        c0, r0 = (rank * ckv.shape[2], rank * krope.shape[2]) if tp.latent_split else (0, 0)

        def write(src_c: torch.Tensor, src_r: torch.Tensor, at: int) -> None:
            """Rows ``[at, at + len)`` of the latent, the rank's block of them."""
            lo, hi = max(at, rows0), min(at + src_c.shape[1], rows0 + ckv.shape[1])
            if lo < hi:
                ckv[:, lo - rows0:hi - rows0] = src_c[:, lo - at:hi - at,
                                                      c0:c0 + ckv.shape[2]].to(ckv.dtype)
                krope[:, lo - rows0:hi - rows0] = src_r[:, lo - at:hi - at,
                                                        r0:r0 + krope.shape[2]].to(krope.dtype)

    if cache is not None and l == 1:  # -------- absorbed decode --------
        write(c_kv, k_rope, cache_pos)
        q_lat = torch.einsum("blhk,rhk->blhr", q_nope, p["wk_b"].to(dt))
        if seq_ax is not None:
            every_head = split and seq_ax == MODEL_AXIS  # every rank's rows need every head
            if every_head:
                q_lat, q_rope = (all_gather(t, MODEL_AXIS, axis=2, tiled=True)
                                 for t in (q_lat, q_rope))
            s = (torch.einsum("blhr,bsr->bhls", q_lat, ckv.to(dt))
                 + torch.einsum("blhk,bsk->bhls", q_rope, krope.to(dt))).to(torch.float32)
            kpos = torch.arange(rows0, rows0 + ckv.shape[1], device=x.device)
            lsum, o, _ = combine_context_parallel(
                s * scale, kpos <= cache_pos,
                lambda w: torch.einsum("bhls,bsr->bhlr", w, ckv.to(torch.float32)), seq_ax)
            o_lat = (o / lsum).permute(0, 2, 1, 3)
            o_lat = (o_lat[:, :, q0:q0 + hq] if every_head else o_lat).to(dt)
        else:
            if tp.latent_split:
                ckv, krope = (all_gather(t, MODEL_AXIS, axis=2, tiled=True) for t in (ckv, krope))
            o_lat = _attend_latent(q_lat, q_rope, ckv, krope, cache_pos, scale)
        o = torch.einsum("blhr,rhk->blhk", o_lat, p["wv_b"].to(dt))
    else:  # -------- a prompt, into the cache if there is one --------
        k_nope = torch.einsum("blr,rhk->blhk", c_kv, p["wk_b"].to(dt))
        v = torch.einsum("blr,rhk->blhk", c_kv, p["wv_b"].to(dt))
        o = _attend_prompt(q_nope, q_rope, k_nope, k_rope, v, scale)
        if cache is not None:
            write(c_kv, k_rope, 0)
    out = torch.einsum("blhk,hkd->bld", o, p["wo"].to(dt))
    return out_of_split(out) if split else out_of_whole(out)
