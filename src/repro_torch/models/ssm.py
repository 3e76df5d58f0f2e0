"""Mamba2 block — SSD (state-space duality) chunked form (arXiv:2405.21060).

Recurrence (per head h, head_dim P, state N):
    H_t = exp(dt_t·A_h) · H_{t-1} + dt_t · x_t ⊗ B_t          H ∈ (P, N)
    y_t = H_t · C_t + D_h · x_t

Port of ``repro/models/ssm.py``.  The chunked algorithm (``ssd_chunked``) is
the plain version of the hand-written kernel and lives beside it in
``repro_torch.kernels.ssd_scan``; the block's chunked route calls
``repro_torch.kernels.ops.ssd_scan``, which launches the kernel for CUDA
tensors and runs ``ssd_chunked`` for CPU tensors.  Where autograd records
the block (grad mode on and an SSD operand requiring a gradient, as in
``Model.loss``), the chunked route calls ``ssd_chunked`` directly: the
kernel has no backward (nor has the JAX package's), its wrapper raises
rather than return an output without a ``grad_fn``, and the reference's
block runs the jnp ``ssd_chunked`` on every route, so its gradient is that
of the plain function, as the port's is.  So does a training rank's
forward whose backward runs in segments, the forward-only pass of a
recomputed period too (``layers.plain_route``).  :func:`ssd_reference` is
the naive sequential recurrence.  The block's cache is updated in place.

**Tensor parallelism.**  Inside a tensor-parallel serving body
(``repro_torch.distributed.spmd.serving_body``) a rank holds its heads of
``w_in_z``, ``w_in_x``, ``w_in_dt``, ``conv_x``, ``A_log``, ``ssm_D``,
``dt_bias`` and ``ssm_norm`` and its rows of ``w_out`` (as
``params_shardings`` splits them), ``w_in_b``, ``w_in_c``, ``conv_b`` and
``conv_c`` whole, and its block of the cache (:func:`_mamba_block_tp`).
The tensor-parallel train step (``spmd.tensor_parallel_gradients``) runs
the same rank program under autograd, without a cache.

Single B/C group (n_groups=1), as in the assigned configs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.spmd import (
    MODEL_AXIS,
    all_gather,
    axis_index,
    axis_size,
    model_parallel,
    psum,
    pvary,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.models.layers import Params, draw_normal, plain_route, rms_norm

__all__ = [
    "init_mamba",
    "mamba_block",
    "ssd_chunked",
    "ssd_decode_step",
    "ssd_reference",
]


# ---------------------------------------------------------------------------
# SSD core (both forms operate on per-head inputs)
#   x  (B, L, NH, P)   dt (B, L, NH)   A (NH,)  negative
#   Bm (B, L, N)       Cm (B, L, N)
# ---------------------------------------------------------------------------


def ssd_decode_step(h, x_t, dt_t, a, b_t, c_t):
    """One-token recurrence for serving.  h (B,NH,P,N) → (y_t, h)."""
    decay = torch.exp(dt_t * a)[..., None, None]
    h = h * decay + (dt_t[..., None, None] * x_t[..., None]) * b_t[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, c_t)
    return y, h


def ssd_reference(x, dt, a, bm, cm):
    """Naive sequential recurrence — the oracle."""
    b, l, nh, p = x.shape
    n = bm.shape[-1]
    h = torch.zeros((b, nh, p, n), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(l):
        y, h = ssd_decode_step(h, x[:, t], dt[:, t], a, bm[:, t], cm[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), h               # (B,L,NH,P), final state


# ---------------------------------------------------------------------------
# the full Mamba2 block (proj → conv → SSD → gated norm → out proj)
# ---------------------------------------------------------------------------


def init_mamba(
    cfg: ModelConfig, *, generator: torch.Generator, device, dtype: torch.dtype
) -> Params:
    """Weights from the reference's distributions; projections, conv weights
    and ``ssm_D`` in ``dtype`` (every use casts them to it), the rest in f32."""
    d = cfg.d_model
    din = cfg.ssm_expand * d
    nh = din // cfg.ssm_head_dim
    n = cfg.ssm_state
    w = cfg.ssm_conv_width
    sd = 1.0 / math.sqrt(d)
    f32 = torch.float32

    def normal(shape, scale):
        return draw_normal(shape, scale, dtype, device, generator)

    return {
        "w_in_z": normal((d, din), sd),
        "w_in_x": normal((d, din), sd),
        "w_in_b": normal((d, n), sd),
        "w_in_c": normal((d, n), sd),
        "w_in_dt": normal((d, nh), sd),
        "conv_x": normal((w, din), 1.0 / math.sqrt(w)),
        "conv_b": normal((w, n), 1.0 / math.sqrt(w)),
        "conv_c": normal((w, n), 1.0 / math.sqrt(w)),
        "A_log": torch.zeros((nh,), dtype=f32, device=device),   # A = -exp(A_log) = -1
        "ssm_D": torch.ones((nh,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((nh,), dtype=f32, device=device),
        "ssm_norm": torch.zeros((din,), dtype=f32, device=device),
        "w_out": normal((din, d), 1.0 / math.sqrt(din)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv, width W.  x (B,L,C), w (W,C).

    With ``state`` (B,W-1,C) the conv continues a stream (decode); returns
    (out, new_state) where new_state holds the last W-1 inputs.
    """
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # (B, L+W-1, C)
    out = xp[:, 0:x.shape[1], :] * w[0][None, None, :]
    for i in range(1, width):
        out = out + xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
    new_state = xp[:, -(width - 1):, :]
    return F.silu(out), new_state


def _ssd_prompt(cfg: ModelConfig, xh, dt, a, bm, cm, use_chunked: bool):
    """The SSD over a prompt at whatever heads ``xh`` holds: the chunked
    route (the kernel, or ``ssd_chunked`` where the layer trains,
    ``layers.plain_route``) where the prompt tiles into more than one
    chunk, else the sequential recurrence."""
    l = xh.shape[1]
    if use_chunked and l % cfg.ssm_chunk == 0 and l > cfg.ssm_chunk:
        ssd = ssd_chunked if plain_route(xh, dt, a, bm, cm) else ops.ssd_scan
        return ssd(xh.contiguous(), dt.contiguous(), a, bm.contiguous(), cm.contiguous(),
                   chunk=cfg.ssm_chunk)
    return ssd_reference(xh, dt, a, bm, cm)


def _mamba_in(p: Params, x: torch.Tensor):
    """The block's input projections at whatever width ``p`` holds: the gate
    ``z``, the conv input ``[x | B | C]`` and ``dt`` before its softplus."""
    dt_ = x.dtype
    conv_in = torch.cat([x @ p[k].to(dt_) for k in ("w_in_x", "w_in_b", "w_in_c")], dim=-1)
    return x @ p["w_in_z"].to(dt_), conv_in, x @ p["w_in_dt"].to(dt_)


def _mamba_mix(p: Params, cfg: ModelConfig, z, conv_in, dt, conv_state, h, use_chunked: bool):
    """Conv, SSD, D skip and gate at the heads ``p`` holds (``conv_in``'s
    ``x`` channels): with ``h`` (the SSD state) one decode step, else the
    prompt's route.  Returns the gated ``y`` (B, L, heads·P) for the norm,
    the conv's new state and the SSD's final state."""
    dt_ = conv_in.dtype
    ph, n = cfg.ssm_head_dim, cfg.ssm_state
    b, l, c = conv_in.shape
    dl = c - 2 * n
    conv_w = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], dim=-1).to(dt_)
    conv_out, new_conv = _causal_conv(conv_in, conv_w, conv_state)
    xin, bm, cm = torch.split(conv_out, [dl, n, n], dim=-1)

    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"]).to(dt_)
    a = (-torch.exp(p["A_log"])).to(dt_)              # (NH,)
    xh = xin.reshape(b, l, dl // ph, ph)
    if h is not None:
        y, h = ssd_decode_step(h.to(dt_), xh[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0])
        y = y[:, None]                                # (B,1,NH,P)
    else:
        y, h = _ssd_prompt(cfg, xh, dt, a, bm, cm, use_chunked)
    y = y + p["ssm_D"].to(dt_)[None, None, :, None] * xh
    return y.reshape(b, l, dl) * F.silu(z), new_conv, h


def mamba_block(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                      # (B, L, D)
    *,
    cache: Params | None = None,          # {"conv": (B,W-1,Cin), "h": (B,NH,P,N)}
    use_chunked: bool = True,
) -> tuple[torch.Tensor, Params | None]:
    if model_parallel() is not None:
        return _mamba_block_tp(p, cfg, x, cache=cache, use_chunked=use_chunked), cache
    z, conv_in, dt = _mamba_in(p, x)
    decode = cache is not None and x.shape[1] == 1
    y, new_conv, h = _mamba_mix(p, cfg, z, conv_in, dt,
                                cache["conv"] if cache is not None else None,
                                cache["h"] if decode else None, use_chunked)
    out = rms_norm(y, p["ssm_norm"]) @ p["w_out"].to(x.dtype)

    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h)
    return out, cache


#: the leaves a tensor-parallel rank holds whole and uses for its own heads
_ALIKE = frozenset({"w_in_b", "w_in_c", "conv_b", "conv_c"})


def _mamba_block_tp(p: Params, cfg: ModelConfig, x: torch.Tensor, *, cache: Params | None,
                    use_chunked: bool) -> torch.Tensor:
    """:func:`mamba_block` on a rank of a tensor-parallel serving body, on
    the rank's shards (the module's docstring); the cache block is written
    in place.

    The rank's heads are contiguous: its ``dl`` channels of ``w_in_x`` are
    heads ``[h0, h0 + dl / P)``, the ones its ``w_in_dt`` columns give.  It
    projects them and the whole ``B``/``C`` rows, runs the conv and the
    SSD (``ops.ssd_scan`` at its heads) on them, and the gated norm's f32
    sum of squares and ``w_out``'s partial output are summed over the model
    axis.  The conv cache ``(B, W-1, din + 2N)`` holds the concatenated
    ``[x | B | C]`` channels, and ``cache_shardings`` splits that last dim
    in equal blocks that are not the rank's ``x`` channels: so each rank
    all-gathers its cache block with its last ``W-1`` ``x`` inputs (one
    ``all_gather``), takes the old state of its channels from the whole,
    and writes its block of the new state.  A dim the model axis does not
    divide is whole on every rank (``param_pspec``, ``cache_shardings``),
    and the rank computes it whole.

    Under autograd (the tensor-parallel train step, ``cache=None``) the
    residual stream and the leaves every rank holds whole for its heads'
    share (``w_in_b``, ``w_in_c``, ``conv_b``, ``conv_c``) enter through
    ``pvary``, whose cotangent sums the ranks' partials over the model
    axis, as :func:`~repro_torch.models.layers._attention_tp`'s do; the
    gated norm's sum of squares is ``pvary``'d after its ``psum``
    (:func:`~repro_torch.models.layers.rms_norm`)."""
    dt_ = x.dtype
    din = cfg.ssm_expand * cfg.d_model
    ph, n, w1 = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv_width - 1
    b, l, _ = x.shape
    m, rank = axis_size(MODEL_AXIS), axis_index(MODEL_AXIS)
    dl, nhl = p["w_in_x"].shape[1], p["w_in_dt"].shape[1]
    split = dl != din
    channels = {k: p[k].shape[-1] for k in ("w_in_z", "conv_x", "ssm_norm")}
    channels["w_out"] = p["w_out"].shape[0]
    heads = {k: p[k].shape[0] for k in ("A_log", "ssm_D", "dt_bias")}
    if cache is not None:
        heads["h"] = cache["h"].shape[1]
    if nhl * ph != dl or set(channels.values()) != {dl} or set(heads.values()) != {nhl}:
        raise ValueError(f"mamba2: the rank holds {dl} x channels of w_in_x, {nhl} heads of "
                         f"w_in_dt, {channels} and {heads}: split unlike params_shardings and "
                         f"cache_shardings split them")
    x0 = rank * dl if split else 0
    if split:  # what every rank holds alike enters the rank's share of the heads
        x = pvary(x, MODEL_AXIS)
        p = {k: pvary(v, MODEL_AXIS) if k in _ALIKE else v for k, v in p.items()}

    z, conv_in, dt = _mamba_in(p, x)                    # conv_in (B, L, dl + 2N)
    state = None
    if cache is not None:
        block = cache["conv"]                            # (B, W-1, Cb) of C = din + 2N
        cb, c = block.shape[-1], din + 2 * n
        tail = min(l, w1)                                # new x rows the new state keeps
        x_tail = F.pad(conv_in[:, l - tail:, :dl], (0, 0, w1 - tail, 0)).to(block.dtype)
        if split or cb != c:  # every rank's block and x tail, in one gather
            both = all_gather(torch.cat([block, x_tail], -1), MODEL_AXIS, axis=2, tiled=True)
            both = both.reshape(b, w1, m, cb + dl)
            old = both[..., :cb].reshape(b, w1, m * cb) if cb != c else block
            x_tail = both[..., cb:].reshape(b, w1, m * dl) if split else x_tail
        else:
            old = block
        state = torch.cat([old[..., x0:x0 + dl], old[..., din:]], -1)
        new_in = torch.cat([x_tail[:, w1 - tail:].to(dt_), conv_in[:, l - tail:, dl:]], -1)
        new_state = torch.cat([old.to(dt_), new_in], 1)[:, -w1:]  # (B, W-1, C)
        c0 = rank * cb if cb != c else 0
    decode = cache is not None and l == 1
    y, _, h = _mamba_mix(p, cfg, z, conv_in, dt, state, cache["h"] if decode else None,
                         use_chunked)
    # rms_norm over the whole din: the squares summed over the ranks
    y = rms_norm(y, p["ssm_norm"], axis=MODEL_AXIS if split else None)
    out = y @ p["w_out"].to(dt_)
    if cache is not None:
        cache["conv"].copy_(new_state[..., c0:c0 + cb])
        cache["h"].copy_(h)
    return psum(out, MODEL_AXIS) if split else out
