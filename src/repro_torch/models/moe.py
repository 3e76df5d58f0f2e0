"""Mixture-of-Experts MLP: top-k routing, shared experts, two dispatch paths.

Port of ``repro/models/moe.py`` over an explicit params dict with the JAX
package's names and layouts (``router (D, E)``, ``experts_gate``/``_up``
``(E·vs, D, F/vs)``, ``experts_down (E·vs, F/vs, D)``, ``shared`` a dense
MLP of width ``s·F``).

``moe_impl="onehot"`` (default, the served path)
    GShard-style capacity-bucketed dispatch: tokens are reshaped into
    fixed-size *groups*, each expert gets a ``capacity``-slot buffer per
    group, and dispatch/combine are one-hot products.  Slots are given in
    choice-major order (every token's first choice in a group before any
    second choice); a choice whose slot is ``>= capacity`` is dropped.

``moe_impl="ragged"``
    Sort-based *dropless* dispatch: tokens sorted by expert, one product per
    expert over its contiguous rows (the reference's ``lax.ragged_dot``),
    unsorted by a scatter-add.  The single-device reference the onehot path
    is tested against; not on the served path.

**Virtual expert splitting** (mixtral): each expert is split into
``moe_virtual_split`` slices of the hidden dim and a token goes to every
slice of its chosen expert with the same gate.  Exact, because
``down(act(gate)·up)`` sums over F.

What differs from the reference, not in value:

* no sharding annotations: the reference's ``shard(...)`` constraints
  (expert and group axes) change no value, and the port's values are
  global tensors (:mod:`repro_torch.distributed.sharding`);
* the onehot path runs the dispatch, the experts and the combine one group
  at a time: groups are independent (the reference's products are batched
  over them), and one group's buffers (``(E·vs, capacity, D)``) are all
  that is live at once;
* ``jax.nn.one_hot`` gives an all-zero row for a dropped choice's slot
  (``>= capacity``), where ``torch.nn.functional.one_hot`` raises; the slot
  is clamped first, and the row is multiplied by the drop mask (0) as in
  the reference, so the result is the same;
* the top-k is a stable descending sort (:func:`repro_torch._topk.top_k`),
  which orders ties as ``lax.top_k`` does: lower expert first.

The router's product feeds that top-k and the dispatch products must carry
values exactly, so no product here may run in TF32: PyTorch's default
(``torch.backends.cuda.matmul.allow_tf32`` False) is what this module needs.

**Tensor parallelism** (the onehot path inside a tensor-parallel serving
body, ``repro_torch.distributed.spmd.serving_body``): a rank holds its
contiguous slice of the ``E·vs`` (virtual) experts, as
``params_shardings`` splits ``experts_*`` over ``model``, and the router
whole.  The tokens are replicated over ``model``, so no token moves: every
rank routes every token of its groups, computes the capacity slots over
all experts as above, dispatches to its own experts' columns only, and the
ranks sum their partial combines (a ``psum``).  The groups are the
reference's: ``jax.jit`` groups the tokens of the whole batch, so where a
rank's batch rows do not tile whole groups it all-gathers the token rows
over the batch's data axes first and keeps its own rows of the output.
Under ``long_decode_rules`` the batch of one is replicated (its axes are
none): every rank's rows are the whole batch, grouped as they are.  The
tensor-parallel train step (``spmd.tensor_parallel_gradients``) runs the
same rank program under autograd: the tokens entering the rank's experts
and the router pass through ``pvary``, since every rank routes the whole
group alike but only its own experts' gates reach its combine, so their
cotangents are partials summed over ``model``; the token gather's
transpose reduce-scatters the rows' cotangents back over the data axes.
Under ``train_rules_sp`` the rank's rows of the residual stream are first
gathered along the sequence over ``model`` (whose transpose sums their
cotangents, so the tokens take no ``pvary``), the groups stay the whole
batch's, and the partial combine is reduce-scattered back to the rank's
rows.

Routes can be recorded: with :attr:`moe_mlp.routes` set to a list (it is
``None``, off, by default), every call appends
``{"experts": (B, L, k) int64, "dropped": (B, L, k) bool}`` — the real
experts each token chose, in choice order, and which choices the capacity
dropped (a virtual split's slices drop together).  The tensors stay on the
device.  A forward records once: the recomputation of a rematerialized
period in the backward runs inside :func:`routes_paused`, and of the
ranks of a tensor-parallel body one records the whole batch's routes.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from repro_torch._topk import top_k
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.spmd import (
    MODEL_AXIS,
    all_gather,
    axis_index,
    axis_size,
    first_rank,
    pvary,
    tensor_parallel,
)
from repro_torch.models.layers import (
    Params,
    draw_normal,
    gather_rows,
    init_mlp,
    into_whole,
    mlp,
    out_of_split,
    out_of_whole,
    stream_rows,
)

__all__ = ["init_moe", "moe_mlp", "routes_paused"]


def init_moe(cfg: ModelConfig, *, generator: torch.Generator, device,
             dtype: torch.dtype) -> Params:
    """The reference's distributions, every leaf drawn in ``dtype`` (each
    use casts it to the compute type)."""
    d, e = cfg.d_model, cfg.moe_experts
    vs = cfg.moe_virtual_split
    ev, fv = e * vs, cfg.moe_d_ff // vs
    assert cfg.moe_d_ff % vs == 0, (cfg.moe_d_ff, vs)
    p: Params = {
        "router": draw_normal((d, e), 1.0 / math.sqrt(d), dtype, device, generator),
        "experts_gate": draw_normal((ev, d, fv), 1.0 / math.sqrt(d), dtype, device, generator),
        "experts_up": draw_normal((ev, d, fv), 1.0 / math.sqrt(d), dtype, device, generator),
        "experts_down": draw_normal((ev, fv, d), 1.0 / math.sqrt(cfg.moe_d_ff), dtype, device,
                                    generator),
    }
    if cfg.moe_shared_experts:
        # shared experts fused into one dense MLP of width s·F
        p["shared"] = init_mlp(cfg, cfg.moe_shared_experts * cfg.moe_d_ff,
                               generator=generator, device=device, dtype=dtype)
    return p


def _route(p: Params, cfg: ModelConfig, xt: torch.Tensor):
    """Router logits → renormalized top-k gates.  xt: (..., T, D)."""
    dt = xt.dtype
    logits = (xt @ p["router"].to(dt)).to(torch.float32)
    gates, expert_idx = top_k(torch.softmax(logits, -1), cfg.moe_top_k)
    gates = gates / torch.sum(gates, -1, keepdim=True)
    return gates.to(dt), expert_idx


def _recording() -> bool:
    """Whether this thread records routes: the recorder is on and no
    recomputation in it is paused (:func:`routes_paused`)."""
    return moe_mlp.routes is not None and not getattr(_PAUSED, "on", False)


def _record(shape, experts: torch.Tensor, dropped: torch.Tensor) -> None:
    if _recording():
        moe_mlp.routes.append({"experts": experts.reshape(*shape, -1),
                               "dropped": dropped.reshape(*shape, -1)})


def _groups(cfg: ModelConfig, t: int) -> tuple[int, int]:
    """(group size, per-expert capacity) of the onehot dispatch over ``t``
    tokens."""
    g = min(cfg.moe_group, t)
    while t % g:  # groups must tile the token axis exactly
        g //= 2
    cap = max(int(math.ceil(g * cfg.moe_top_k / cfg.moe_experts * cfg.moe_capacity_factor)), 1)
    return g, min(cap, g)  # an expert can never hold more than the whole group


# ---------------------------------------------------------------------------
# onehot path (capacity-bucketed; virtual splitting)
# ---------------------------------------------------------------------------


def _moe_onehot(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    e, k, vs = cfg.moe_experts, cfg.moe_top_k, cfg.moe_virtual_split
    ev = e * vs
    held = p["experts_gate"].shape[0]  # the rank's experts: [e0, e0 + held)
    split = held != ev
    rows = stream_rows()
    if not split:  # every rank computes every expert, on the gathered rows of its stream
        x, p = into_whole(x, p)
    elif rows == "split":  # the rank's rows of the stream, gathered along the sequence
        x = gather_rows(x)
    b, l, d = x.shape
    tp = tensor_parallel()
    dp = () if tp is None else tp.batch_axes  # replicated under long_decode_rules: none
    ndp = axis_size(dp) if dp else 1
    g, cap = _groups(cfg, b * l * ndp)  # the whole batch's groups
    gather = (b * l) % g != 0  # the rank's rows are not whole groups: route the batch's
    xs = all_gather(x, dp, axis=0, tiled=True) if gather else x
    n = xs.shape[0] * l // g
    e0 = axis_index(MODEL_AXIS) * held if split else 0
    if split:  # every rank routes alike, but only its own experts' gates reach its combine
        if rows == "whole":  # the gathered rows' transpose already sums their cotangents
            xs = pvary(xs, MODEL_AXIS)
        p = dict(p, router=pvary(p["router"], MODEL_AXIS))

    xg = xs.reshape(n, g, d)
    gates, idx = _route(p, cfg, xg)                       # (n,g,k) ×2
    experts = idx

    # -- virtual expansion: choice (i, j) = split j of real choice i --------
    if vs > 1:
        idx = (idx[..., None] * vs + torch.arange(vs, device=x.device)).reshape(n, g, k * vs)
        gates = torch.repeat_interleave(gates, vs, dim=-1)  # same gate per slice
        k = k * vs

    # -- choice-priority positions within each expert's capacity buffer ----
    m = F.one_hot(idx, ev)                                # (n,g,k,ev) int64
    mt = m.transpose(1, 2).reshape(n, k * g, ev)          # choice-major
    pos = torch.cumsum(mt, dim=1) - mt                    # 0-based slots
    pos = pos.reshape(n, k, g, ev).transpose(1, 2)        # (n,g,k,ev)
    pos_of = torch.sum(pos * m, dim=-1)                   # (n,g,k)
    kept = pos_of < cap                                   # capacity drop mask
    keep = kept.to(dt)
    if _recording():
        _record_routes(tp, dp, ndp, gather, l, experts, ~kept.reshape(n, g, k // vs, vs)[..., 0])

    oh_e = m[..., e0:e0 + held].to(dt)                    # (n,g,k,held)
    oh_c = F.one_hot(pos_of.clamp(max=cap - 1), cap).to(dt)  # (n,g,k,cap)
    wg, wu, wd = (p[name].to(dt) for name in ("experts_gate", "experts_up", "experts_down"))
    # the tokens returned: the rank's own [lo, hi) of the batch's routed ones
    lo = axis_index(dp) * b * l if gather else 0
    hi = lo + b * l
    out = torch.empty((b * l, d), dtype=x.dtype, device=x.device)
    for i in range(n):  # one group's buffers live at a time
        r0, r1 = max(lo, i * g), min(hi, (i + 1) * g)
        if r0 >= r1:
            continue
        disp = torch.einsum("gke,gkc->gec", oh_e[i], oh_c[i] * keep[i, ..., None])
        comb = torch.einsum("gke,gkc->gec", oh_e[i], oh_c[i] * (gates[i] * keep[i])[..., None])
        xin = torch.einsum("gec,gd->ecd", disp, xg[i])   # (held,cap,d)
        h = torch.bmm(xin, wg)
        u = torch.bmm(xin, wu)
        y = torch.bmm(F.silu(h) * u, wd)                 # (held,cap,d)
        # gate-weighted return
        out[r0 - lo:r1 - lo] = torch.einsum("gec,ecd->gd", comb[r0 - i * g:r1 - i * g], y)
    out = out.reshape(b, l, d)
    return out_of_split(out) if split else out_of_whole(out)


def _record_routes(tp, dp: tuple[str, ...], ndp: int, gathered: bool, l: int,
                   experts: torch.Tensor, dropped: torch.Tensor) -> None:
    """Record one call's routes (``(n, g, k)`` over the tokens routed); in
    a tensor-parallel body once for the whole batch: the ranks' rows are
    all-gathered over the data axes if they were routed apart, and the
    mesh's first rank records (every rank holds the whole batch's routes)."""
    if tp is not None and ndp > 1 and not gathered:
        experts, dropped = (all_gather(t, dp, axis=0, tiled=True) for t in (experts, dropped))
    if tp is None or first_rank():
        _record((experts.shape[0] * experts.shape[1] // l, l), experts, dropped)


# ---------------------------------------------------------------------------
# ragged path (dropless single-device reference)
# ---------------------------------------------------------------------------


def _ragged_dot(x: torch.Tensor, w: torch.Tensor, sizes: list[int]) -> torch.Tensor:
    """``lax.ragged_dot``: rows ``[off_i, off_i + sizes[i])`` of ``x`` times ``w[i]``."""
    out = torch.zeros((x.shape[0], w.shape[-1]), dtype=x.dtype, device=x.device)
    start = 0
    for i, size in enumerate(sizes):
        if size:
            out[start:start + size] = x[start:start + size] @ w[i]
        start += size
    return out


def _moe_ragged(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    assert cfg.moe_virtual_split == 1, (
        "ragged dispatch is the vs=1 reference; use onehot for virtual splits"
    )
    dt = x.dtype
    b, l, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    xt = x.reshape(b * l, d)
    t = xt.shape[0]

    gates, expert_idx = _route(p, cfg, xt)                # (T,k) ×2
    _record((b, l), expert_idx, torch.zeros_like(expert_idx, dtype=torch.bool))

    # ---- sort-based dropless dispatch -------------------------------------
    flat_expert = expert_idx.reshape(-1)                  # (T·k,)
    order = torch.argsort(flat_expert, stable=True)
    token_of = order // k                                 # source token id
    xs = xt[token_of]                                     # (T·k, D) grouped
    sizes = torch.bincount(flat_expert, minlength=e).tolist()

    h = _ragged_dot(xs, p["experts_gate"].to(dt), sizes)
    u = _ragged_dot(xs, p["experts_up"].to(dt), sizes)
    h = F.silu(h) * u                                     # (T·k, F)
    y = _ragged_dot(h, p["experts_down"].to(dt), sizes)

    # ---- unsort + gate-weighted combine -----------------------------------
    gate_of = gates.reshape(-1)[order]                    # (T·k,)
    y = y * gate_of[:, None]
    out = torch.zeros((t, d), dtype=dt, device=x.device).index_add_(0, token_of, y)
    return out.reshape(b, l, d)


def moe_mlp(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, L, D) → (B, L, D).  Top-k routed experts + shared experts."""
    if cfg.moe_impl == "onehot":
        out = _moe_onehot(p, cfg, x)
    elif cfg.moe_impl == "ragged":
        out = _moe_ragged(p, cfg, x)
    else:  # pragma: no cover
        raise ValueError(cfg.moe_impl)

    if "shared" in p:  # shared experts: dense path (B,L,D)
        out = out + mlp(p["shared"], x, d_ff=cfg.moe_shared_experts * cfg.moe_d_ff)
    return out


#: route recorder: ``None`` (off) or a list each call appends to
moe_mlp.routes = None


_PAUSED = threading.local()


@contextlib.contextmanager
def routes_paused():
    """Record no routes in the calling thread inside the block: a
    rematerialized period's recomputation in the backward (``models/lm.py``:
    ``torch.utils.checkpoint``'s, or a rank's tape's) routes the same tokens
    again, and a forward records its routes once.  Per thread, since the
    ranks of a tensor-parallel body recompute in their own threads, taking
    turns."""
    saved, _PAUSED.on = getattr(_PAUSED, "on", False), True
    try:
        yield
    finally:
        _PAUSED.on = saved
