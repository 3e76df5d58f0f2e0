"""Model assembly: LayerSpec segments → init / forward / prefill / decode_step.

Port of ``repro/models/lm.py`` for every family: attention, multi-head
latent attention, Mamba2 and cross-attention mixers, dense and MoE MLPs,
in one segment or several (deepseek-v2's dense first layer), and the
audio family's encoder (whisper), whose output is the decoder's
cross-attention memory; the vlm family attends to stubbed image
embeddings.  The parameter tree has the JAX package's names and layout: a
segment of ``repeats > 1`` periods holds each leaf stacked as
``(repeats, ...)``.  Where the reference scans a segment with ``lax.scan``,
the port loops over the repeats and indexes views of the same stacked
tensors; the decode cache keeps the same stacked layout and each layer
updates its views of it in place.

Entry points:

* ``model.init(generator, device=..., master=False)`` → params (random, on
  ``device``)
* ``params_from_numpy(tree, cfg, device=..., master=False)`` → params from
  the JAX package's tree as numpy arrays
* ``model.forward(params, batch, remat=False)`` → logits (B, S, Vp)
* ``model.loss(params, batch)``             → mean next-token cross-entropy
* ``model.init_cache(batch, max_len, ...)`` → cache (decode state)
* ``model.prefill(params, batch, cache)``   → (last_logits, cache)
* ``model.decode_step(params, cache, token, pos, memory=None)`` → (logits, cache)
* ``model.input_specs(shape)``             → ``meta`` inputs of a dry-run cell

``batch`` holds ``tokens`` and, for the audio family, ``frames`` (B,
encoder_seq, d_model), for the vlm family ``image_embeds`` (B, image_tokens,
image_embed_dim): the stubbed frontends' outputs, as in the reference.

**Storage.**  For serving, the leaves in :data:`CAST_LEAVES` are stored in
``cfg.dtype`` (every use casts them to it) and the rest in f32.  For
training, ``master=True`` stores every leaf in ``cfg.param_dtype`` (f32,
the reference's storage): the model still computes in ``cfg.dtype``, the
casts at each use carry the gradient back to the f32 leaf, and AdamW
updates f32 master weights, where a bf16 leaf would round every update.

**Tensor parallelism.**  Inside the serving body of
``repro_torch.distributed.spmd.sharded_prefill`` and ``sharded_decode_step``
(for the models ``Model.tensor_parallel_refusal`` admits: every config
of the repo with the onehot MoE) a rank looks its tokens up in its rows of
a vocabulary-split ``embed`` and sums the embeddings over ``model``, and
computes the logits of its vocabulary columns (a tied head's are its rows
of ``embed``), the padding masked by global column; ``layers.py`` splits
the attention heads (the encoder's and cross-attention's too) and the MLP
(``dense_d_ff`` for deepseek-v2's dense first layer), ``mla.py`` MLA's
heads and latent cache, ``ssm.py`` the SSM heads, ``moe.py`` the experts.
Whisper's encoder runs in the body: its layers sum their partials over
``model``, so every rank ends with the whole memory of its batch rows.
In the tensor-parallel train step (every config of the repo with the
onehot MoE, :meth:`Model.tensor_parallel_training_refusal`) ``loss`` takes the
log-probabilities from the rank's vocabulary block without gathering it
(:func:`_vocab_parallel_log_likelihood`), and a tied head's gradient on
the rank's rows of ``embed`` sums the lookup's and the head's.  Under
``train_rules_sp`` (``spmd.TensorParallel.seq_res``) a rank holds the
residual stream between blocks as its rows of the sequence, where the
model axis divides its length (the decoder's tokens and the encoder's
frames decided apart, as the reference's ``shard`` drops an axis that
does not divide the dim): the embedding's sum is reduce-scattered to
them, every norm and residual add runs on them (the norms' weights
through ``pvary``, their cotangents covering the rank's rows only), each
layer gathers them for its split work and reduce-scatters its partial
back (``layers.into_split``; command-r's parallel block once for both
halves), the final norm runs on them before the head's gather, and the
encoder's normed rows are gathered into the memory every rank holds
alike.  Outside such a body nothing changes.

**Recomputation.**  ``forward(..., remat=True)`` (which ``loss`` uses, as
the reference's does) checkpoints each period of the decoder's segments by
``cfg.remat``: ``"none"`` keeps every activation; ``"full"`` keeps only the
period's input (``torch.utils.checkpoint``, non-reentrant) and runs the
period again in the backward; ``"dots"`` keeps the outputs of the matrix
products without batch dimensions (the reference's
``dots_with_no_batch_dims_saveable``) and recomputes the rest.  The values
are the same under all three; only memory differs.  The recomputation does
not record MoE routes a second time (``moe_mlp.routes``), and it launches no
kernel: under autograd the model takes the plain attention and SSD routes
(``layers.py``, ``ssm.py``).  In a rank whose backward runs in segments
(``spmd.backward_segments``) each layer is a segment, and under ``"full"``
the tape recomputes a period, its collectives included, in the rank's
thread (its first, forward-only pass takes the plain routes too,
``layers.plain_route``, and launches no kernel); ``"dots"`` keeps the
period's graph there (more memory than the reference's policy keeps, the
same values).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch._pytree import tree_map
from repro_torch.configs.base import LayerSpec, ModelConfig, Segment, ShapeCell
from repro_torch.core.blocked import resolve_device
from repro_torch.distributed.spmd import (
    MODEL_AXIS,
    all_gather,
    axis_index,
    axis_size,
    model_parallel,
    pmax,
    psum,
    psum_scatter,
    pvary,
    recording_tape,
    tensor_parallel_scope,
)
from repro_torch.models import layers as L
from repro_torch.models.mla import init_mla, mla_attention
from repro_torch.models.moe import init_moe, moe_mlp, routes_paused
from repro_torch.models.ssm import init_mamba, mamba_block

Params = dict[str, Any]

#: Leaves whose every use casts them to ``cfg.dtype``: stored in it.
CAST_LEAVES = frozenset({
    "embed", "lm_head", "wq", "wk", "wv", "wo", "bq", "bk", "bv",
    "w_gate", "w_up", "w_down",
    "w_in_z", "w_in_x", "w_in_b", "w_in_c", "w_in_dt", "conv_x", "conv_b", "conv_c",
    "ssm_D", "w_out",
    "router", "experts_gate", "experts_up", "experts_down",
    "wq_a", "wq_b", "wkv_a", "wk_b", "wv_b",
    "wk_mem", "wv_mem", "gate",
})


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------


def _init_layer(spec: LayerSpec, cfg: ModelConfig, *, generator, device, dtype) -> Params:
    p: Params = {}
    norm = L.init_norm(cfg, device=device)
    p["ln1"] = norm["w"]
    if "b" in norm:
        p["ln1_b"] = norm["b"]
    if spec.mixer in ("attn", "enc_attn", "cross_attn"):
        p["mixer"] = L.init_attention(cfg, generator=generator, device=device, dtype=dtype,
                                      cross=spec.mixer == "cross_attn")
    elif spec.mixer == "mla":
        p["mixer"] = init_mla(cfg, generator=generator, device=device, dtype=dtype)
    elif spec.mixer == "mamba2":
        p["mixer"] = init_mamba(cfg, generator=generator, device=device, dtype=dtype)
    else:  # pragma: no cover
        raise ValueError(spec.mixer)
    if spec.mlp != "none" and not cfg.parallel_block:
        p["ln2"] = L.init_norm(cfg, device=device)["w"]
        if cfg.norm == "layernorm":
            p["ln2_b"] = L.init_norm(cfg, device=device)["b"]
    if spec.mlp == "dense":
        ff = cfg.dense_d_ff or cfg.d_ff
        p["mlp"] = L.init_mlp(cfg, ff, generator=generator, device=device, dtype=dtype)
    elif spec.mlp == "moe":
        p["mlp"] = init_moe(cfg, generator=generator, device=device, dtype=dtype)
    return p


def _mlp(p: Params, spec: LayerSpec, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if spec.mlp == "dense":
        return L.mlp(p, x, d_ff=cfg.dense_d_ff or cfg.d_ff)
    return moe_mlp(p, cfg, x)


def _norm(x: torch.Tensor, p: Params, name: str, cfg: ModelConfig, rows: str) -> torch.Tensor:
    """``cfg``'s norm by ``p[name]`` (and its bias).  On the rank's rows of
    the stream (``rows == "split"``) the weights' cotangents cover those
    rows only: they pass through ``pvary``, whose transpose sums them over
    the ranks, once a use, in the segment that computes them."""
    if rows == "split":
        p = {k: pvary(p[k], MODEL_AXIS) for k in (name, name + "_b") if k in p}
    return L.apply_norm(x, p, name, cfg)


def _apply_layer(
    p: Params,
    spec: LayerSpec,
    cfg: ModelConfig,
    x: torch.Tensor,
    ctx: dict[str, Any],
    cache: Params | None,
) -> torch.Tensor:
    """Pre-norm residual block; command-r runs attn ∥ mlp off one norm.
    A layer's cache (views into the stacked cache) is updated in place.
    On a tensor-parallel rank ``ctx["rows"]`` says how ``x`` lies
    (``spmd.TensorParallel.rows``), which the layer's sublayers read."""
    tp = model_parallel()
    if tp is None:
        return _block(p, spec, cfg, x, ctx, cache)
    with tensor_parallel_scope(dataclasses.replace(tp, rows=ctx.get("rows", "whole"))):
        return _block(p, spec, cfg, x, ctx, cache)


def _gathers_once(p: Params, spec: LayerSpec, cfg: ModelConfig) -> bool:
    """Whether a parallel block splits both its attention heads and its MLP
    columns over ``model``, so that one gather of the rank's normed rows
    feeds both and one reduce-scatter returns the sum of their partials."""
    return (spec.mixer == "attn" and p["mixer"]["wq"].shape[1] != cfg.num_heads
            and spec.mlp == "dense"
            and p["mlp"]["w_down"].shape[0] != (cfg.dense_d_ff or cfg.d_ff))


def _mixer(p: Params, spec: LayerSpec, cfg: ModelConfig, h: torch.Tensor, ctx: dict[str, Any],
           cache: Params | None) -> torch.Tensor:
    if spec.mixer in ("attn", "enc_attn"):
        mix, _ = L.attention(
            p["mixer"], cfg, h,
            positions=ctx["positions"], causal=spec.mixer == "attn", cache=cache,
            cache_pos=ctx.get("cache_pos"),
        )
    elif spec.mixer == "cross_attn":
        mix, _ = L.cross_attention(p["mixer"], cfg, h, cache=cache, memory=ctx.get("memory"))
    elif spec.mixer == "mla":
        mix, _ = mla_attention(
            p["mixer"], cfg, h,
            positions=ctx["positions"], cache=cache, cache_pos=ctx.get("cache_pos"),
        )
    elif spec.mixer == "mamba2":
        mix, _ = mamba_block(p["mixer"], cfg, h, cache=cache)
    else:  # pragma: no cover
        raise ValueError(spec.mixer)
    return mix


def _block(p: Params, spec: LayerSpec, cfg: ModelConfig, x: torch.Tensor, ctx: dict[str, Any],
           cache: Params | None) -> torch.Tensor:
    rows = L.stream_rows()
    h = _norm(x, p, "ln1", cfg, rows)
    if cfg.parallel_block and spec.mlp != "none":
        # command-r: x + attn(norm(x)) + mlp(norm(x))
        if rows == "split" and _gathers_once(p, spec, cfg):
            tp = model_parallel()
            h = L.gather_rows(h)
            with tensor_parallel_scope(dataclasses.replace(tp, rows="gathered")):
                both = _mixer(p, spec, cfg, h, ctx, cache) + _mlp(p["mlp"], spec, cfg, h)
            return x + psum_scatter(both, tp.seq_res, scatter_dimension=1, tiled=True)
        return x + _mixer(p, spec, cfg, h, ctx, cache) + _mlp(p["mlp"], spec, cfg, h)

    x = x + _mixer(p, spec, cfg, h, ctx, cache)
    if spec.mlp != "none":
        h2 = _norm(x, p, "ln2", cfg, rows)
        x = x + _mlp(p["mlp"], spec, cfg, h2)
    return x


# ---------------------------------------------------------------------------
# per-layer cache construction
# ---------------------------------------------------------------------------


def _init_layer_cache(
    spec: LayerSpec, cfg: ModelConfig, batch: int, max_len: int, dtype, device, lead=()
) -> Params | None:
    """One layer's zeroed cache; ``lead`` prepends the segment's repeats.  A
    cross layer's holds the projected memory, ``(B, M, Hkv, Dh)`` with M the
    encoder's frames or the image tokens, whatever ``max_len``."""
    if spec.mixer in ("attn", "enc_attn"):
        dh = cfg.resolved_head_dim
        s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
        shp = (*lead, batch, s, cfg.num_kv_heads, dh)
        return {"k": torch.zeros(shp, dtype=dtype, device=device),
                "v": torch.zeros(shp, dtype=dtype, device=device)}
    if spec.mixer == "cross_attn":
        m = cfg.encoder_seq if cfg.family == "audio" else cfg.image_tokens
        shp = (*lead, batch, m, cfg.num_kv_heads, cfg.resolved_head_dim)
        return {"k_mem": torch.zeros(shp, dtype=dtype, device=device),
                "v_mem": torch.zeros(shp, dtype=dtype, device=device)}
    if spec.mixer == "mla":
        return {
            "ckv": torch.zeros((*lead, batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                               device=device),
            "krope": torch.zeros((*lead, batch, max_len, cfg.rope_head_dim), dtype=dtype,
                                 device=device),
        }
    if spec.mixer == "mamba2":
        din = cfg.ssm_expand * cfg.d_model
        nh = din // cfg.ssm_head_dim
        conv_c = din + 2 * cfg.ssm_state
        return {
            "conv": torch.zeros((*lead, batch, cfg.ssm_conv_width - 1, conv_c),
                                dtype=dtype, device=device),
            # SSM state accumulates across the whole context: keep fp32
            "h": torch.zeros((*lead, batch, nh, cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=torch.float32, device=device),
        }
    raise ValueError(spec.mixer)  # pragma: no cover


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _leaf_dtype(name: str, cfg: ModelConfig, master: bool = False) -> torch.dtype:
    if master:
        return getattr(torch, cfg.param_dtype)
    return getattr(torch, cfg.dtype) if name in CAST_LEAVES else torch.float32


def params_from_numpy(
    tree: Any, cfg: ModelConfig, *, device: str | torch.device = "cuda", master: bool = False
) -> Params:
    """The JAX package's parameter tree (numpy leaves, same names, stacked
    ``(repeats, ...)`` segment leaves) as the port's params on ``device``.

    Leaves in :data:`CAST_LEAVES` are stored in ``cfg.dtype`` — every use
    casts them to it, so the values the model computes with are the same
    and the memory is halved; the others (norm weights, ``q_norm``,
    ``k_norm``, MLA's ``q_norm_a`` and ``kv_norm_a``, ``A_log``, ``dt_bias``)
    stay f32.  ``master=True`` stores every leaf in ``cfg.param_dtype``
    instead: the master weights a trainer updates.
    """
    dev = resolve_device(device)

    def convert(node, name):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(convert(v, name) for v in node)
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(
            device=dev, dtype=_leaf_dtype(name, cfg, master)
        )

    return convert(tree, "")


def _saves_dots(ctx, op, *args, **kwargs):
    """``"dots"``: keep the outputs of matrix products without batch
    dimensions (``mm``, ``addmm``, and the batch-1 ``bmm`` that ``einsum``
    makes of a projection), recompute everything else."""
    plain = op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
        op is torch.ops.aten.bmm.default and args[0].shape[0] == 1
    )
    return CheckpointPolicy.MUST_SAVE if plain else CheckpointPolicy.PREFER_RECOMPUTE


def _recorded_once(body):
    """``body`` whose calls after the first run with the MoE route recorder
    paused: the recomputation of a period in the backward routes the same
    tokens again, and a forward records its routes once."""
    ran = False

    def run(x):
        nonlocal ran
        if ran:
            with routes_paused():
                return body(x)
        ran = True
        return body(x)

    return run


def _rematerialized(body, policy: str):
    """``body(x)`` under ``torch.utils.checkpoint`` by ``policy`` (``"full"``
    or ``"dots"``), its recomputation recording no routes
    (:func:`_recorded_once`)."""
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _saves_dots)
    run = _recorded_once(body)
    return lambda x: checkpoint(run, x, use_reentrant=False, preserve_rng_state=False, **kw)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def tensor_parallel_refusal(self) -> str | None:
        """Why the tensor-parallel serving body
        (``repro_torch.distributed.spmd.sharded_prefill``) does not run this
        model, or None where it does: every layer's mixer self-attention
        (windowed or not, with or without qk-norm; the encoder's), MLA,
        cross-attention or Mamba2, and its MLP SwiGLU, capacity-bucketed MoE
        (``moe_impl="onehot"``) or none, the head tied or not."""
        return self._refusal("tensor-parallel serving runs")

    def tensor_parallel_training_refusal(self) -> str | None:
        """Why the tensor-parallel train step
        (``repro_torch.distributed.spmd.tensor_parallel_gradients``) does not
        run this model, or None where it does: the models
        :meth:`tensor_parallel_refusal` admits, every config of the repo
        with the onehot MoE."""
        return self._refusal("tensor-parallel training runs")

    def _refusal(self, program: str) -> str | None:
        cfg = self.cfg
        runs = (f"{program} attention (windowed or not, the encoder's), mla, cross_attn and "
                f"mamba2 mixers with SwiGLU, onehot MoE or no MLPs")
        for seg in (*cfg.segments(), *cfg.encoder_segments()):
            for s in seg.period:
                if s.mixer not in ("attn", "enc_attn", "mla", "cross_attn", "mamba2"):
                    return f"{runs}; {s.mixer} layers are not ported"
                if s.mlp == "moe" and cfg.moe_impl != "onehot":
                    return (f"{runs}; moe_impl={cfg.moe_impl!r} is the data-parallel "
                            f"dropless reference, not ported over the model axis")
                if s.mlp not in ("dense", "moe", "none"):
                    return f"{runs}; {s.mlp} MLPs are not ported"
        return None

    # ---------------- init ----------------

    def init(self, generator: torch.Generator, *, device: str | torch.device = "cuda",
             master: bool = False) -> Params:
        """Random weights from the reference's distributions, drawn on
        ``device`` (where ``generator`` lives) each leaf directly in the type
        it is stored in (:data:`CAST_LEAVES` in ``cfg.dtype``; with
        ``master=True`` every leaf in ``cfg.param_dtype``)."""
        cfg = self.cfg
        dev = resolve_device(device)
        dtype = getattr(torch, cfg.param_dtype if master else cfg.dtype)
        params: Params = {
            "embed": L.draw_normal((cfg.padded_vocab, cfg.d_model), 1.0 / math.sqrt(cfg.d_model),
                               dtype, dev, generator)
        }
        for si, seg in enumerate(cfg.segments()):
            params[f"seg{si}"] = self._init_segment(seg, generator, dev, dtype)
        if cfg.encoder_layers:
            params["enc_seg0"] = self._init_segment(cfg.encoder_segments()[0], generator, dev,
                                                    dtype)
            params["enc_final_norm"] = L.init_norm(cfg, device=dev)["w"]
            if cfg.norm == "layernorm":
                params["enc_final_norm_b"] = L.init_norm(cfg, device=dev)["b"]
        params["final_norm"] = L.init_norm(cfg, device=dev)["w"]
        if cfg.norm == "layernorm":
            params["final_norm_b"] = L.init_norm(cfg, device=dev)["b"]
        if not cfg.tie_embeddings:
            params["lm_head"] = L.draw_normal((cfg.d_model, cfg.padded_vocab),
                                          1.0 / math.sqrt(cfg.d_model), dtype, dev, generator)
        return params

    def _init_segment(self, seg: Segment, generator, device, dtype) -> Any:
        def init_period():
            return tuple(
                _init_layer(spec, self.cfg, generator=generator, device=device, dtype=dtype)
                for spec in seg.period
            )

        if seg.repeats == 1:
            return init_period()
        if seg.repeats == 0:  # the reference's vmap over no keys: every leaf (0, ...), no draw
            shapes = tuple(_init_layer(spec, self.cfg, generator=None, device="meta", dtype=dtype)
                           for spec in seg.period)
            return tree_map(lambda l: torch.empty((0, *l.shape), dtype=l.dtype, device=device),
                            shapes)
        # leaves stacked (repeats, ...): allocate once, fill repeat by repeat
        first = init_period()
        stacked = tree_map(
            lambda l: torch.empty((seg.repeats, *l.shape), dtype=l.dtype, device=l.device), first
        )
        tree_map(lambda s, l: s[0].copy_(l), stacked, first)
        del first
        for r in range(1, seg.repeats):
            tree_map(lambda s, l, r=r: s[r].copy_(l), stacked, init_period())
        return stacked

    # ---------------- trunk ----------------

    def _run_segment(self, seg_params: Any, seg: Segment, x, ctx, caches, *,
                     remat: bool = False) -> torch.Tensor:
        cfg = self.cfg

        def period_body(x, period_params, period_caches):
            for i, spec in enumerate(seg.period):
                tape = recording_tape()
                if i and tape is not None:  # each layer a segment of a rank's backward
                    x = tape.boundary(x)
                c = None if period_caches is None else period_caches[i]
                x = _apply_layer(period_params[i], spec, cfg, x, ctx, c)
            return x

        def run_period(x, period_params, period_caches):
            body = functools.partial(period_body, period_params=period_params,
                                     period_caches=period_caches)
            tape = recording_tape()
            if tape is not None and caches is None:  # a rank's backward in segments
                recompute = remat and cfg.remat == "full"
                return tape.period(_recorded_once(body) if recompute else body, x,
                                   recompute=recompute)
            if remat and cfg.remat != "none":
                return _rematerialized(body, cfg.remat)(x)
            return body(x)

        if seg.repeats == 1:
            return run_period(x, seg_params, caches)
        for r in range(seg.repeats):  # the reference's lax.scan over stacked leaves
            pick = lambda l, r=r: l[r]  # noqa: E731
            period_caches = None if caches is None else tree_map(pick, caches)
            x = run_period(x, tree_map(pick, seg_params), period_caches)
        return x

    def _encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """Whisper encoder over stubbed frame embeddings (B, M, D):
        bidirectional self-attention, no cache.  On the rank of a
        sequence-parallel train step whose axis divides the M frames the
        rank runs its rows of them and the ranks' normed rows are gathered
        into the memory every rank holds alike (its cotangent too, so the
        gather's transpose keeps the rank's rows of it)."""
        cfg = self.cfg
        b, m, _ = frames.shape
        rows = self._stream_rows(m)
        x = frames.to(getattr(torch, cfg.dtype))
        if rows == "split":
            x = L.own_rows(x)
        ctx = {"positions": torch.arange(m, device=frames.device).expand(b, m), "rows": rows}
        x = self._run_segment(params["enc_seg0"], cfg.encoder_segments()[0], x, ctx, None)
        x = _norm(x, params, "enc_final_norm", cfg, rows)
        if rows == "split":
            x = all_gather(x, model_parallel().seq_res, axis=1, tiled=True, invariant=True)
        return x

    def _memory(self, params: Params, batch: dict[str, torch.Tensor]) -> torch.Tensor | None:
        """Cross-attention's memory: the encoder's output over ``frames``
        (audio), ``image_embeds`` in ``cfg.dtype`` (vlm), else None."""
        cfg = self.cfg
        if cfg.family == "audio":
            return self._encode(params, batch["frames"])
        if cfg.family == "vlm":
            return batch["image_embeds"].to(getattr(torch, cfg.dtype))
        return None

    def _trunk(self, params: Params, x, ctx, caches, *, remat: bool = False) -> torch.Tensor:
        for si, seg in enumerate(self.cfg.segments()):
            c = None if caches is None else caches[f"seg{si}"]
            x = self._run_segment(params[f"seg{si}"], seg, x, ctx, c, remat=remat)
        return x

    def _logits(self, params: Params, x: torch.Tensor, rows: str = "whole") -> torch.Tensor:
        """The logits of the stream ``x`` (on a tensor-parallel rank, its
        vocabulary block's; of the rank's rows of the stream under
        ``rows == "split"``, normed there and then gathered)."""
        cfg = self.cfg
        x = _norm(x, params, "final_norm", cfg, rows)
        head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"]).to(x.dtype)
        first, head = self._vocab_block(head)
        if rows == "split":  # every row enters the rank's columns; the gather's transpose sums
            x = L.gather_rows(x)
        elif head.shape[1] != cfg.padded_vocab:  # the normed stream enters the rank's columns
            x = pvary(x, MODEL_AXIS)
        logits = x @ head
        # mask Megatron-style vocab padding (global column indices)
        if cfg.padded_vocab != cfg.vocab_size:
            valid = torch.arange(first, first + head.shape[1], device=x.device) < cfg.vocab_size
            logits = torch.where(valid, logits, -1e30)
        return logits

    def _vocab_block(self, head: torch.Tensor) -> tuple[int, torch.Tensor]:
        """(the first vocabulary column, the head's columns) this rank
        computes: every column outside a tensor-parallel body; in one, the
        rank's block over the model axis (the columns of a split head, or
        its part of a replicated one, as ``P(dp, "model")`` places the
        logits)."""
        if model_parallel() is None:
            return 0, head
        n, rank = axis_size(MODEL_AXIS), axis_index(MODEL_AXIS)
        held = head.shape[1]
        if held != self.cfg.padded_vocab:
            return rank * held, head
        if held % n:
            raise ValueError(f"{held} vocabulary columns over {n} ranks")
        width = held // n
        head = pvary(head, MODEL_AXIS)  # each rank's gradient covers its columns only
        return rank * width, head[:, rank * width:(rank + 1) * width]

    def _embed(self, params: Params, tokens: torch.Tensor, rows: str = "whole") -> torch.Tensor:
        """The token embeddings in ``cfg.dtype``.  In a tensor-parallel body
        a rank holding its rows of a split table looks up the tokens that
        fall in them, zero elsewhere, and the ranks sum over the model axis:
        a ``psum``, or under ``rows == "split"`` (the rank keeps its rows of
        the sequence) a reduce-scatter along the sequence.  A table held
        whole gives the rank's rows of the sequence only, its gradient then
        summed over the ranks (``pvary``)."""
        table, dt = params["embed"], getattr(torch, self.cfg.dtype)
        if model_parallel() is None:
            return table[tokens].to(dt)
        if table.shape[0] == self.cfg.padded_vocab:
            if rows == "split":
                return pvary(table, MODEL_AXIS)[L.own_rows(tokens)].to(dt)
            return table[tokens].to(dt)
        held = table.shape[0]
        local = tokens - axis_index(MODEL_AXIS) * held
        inside = (local >= 0) & (local < held)
        found = table[local.clamp(0, held - 1)].to(dt)
        zero = torch.zeros((), dtype=dt, device=found.device)
        part = torch.where(inside[..., None], found, zero)
        if rows == "split":
            return psum_scatter(part, model_parallel().seq_res, scatter_dimension=1, tiled=True)
        return psum(part, MODEL_AXIS)

    def _stream_rows(self, length: int) -> str:
        """How the residual stream of ``length`` positions lies on the
        calling rank (``spmd.TensorParallel.rows``): ``"split"`` in the
        sequence-parallel train step (``train_rules_sp``) where its axis
        divides the length, as the reference's ``shard`` drops an axis that
        does not divide the dim; ``"whole"`` elsewhere."""
        tp = model_parallel()
        if tp is None or tp.seq_res is None or length % axis_size(tp.seq_res):
            return "whole"
        return "split"

    # ---------------- entry points ----------------

    def forward(self, params: Params, batch: dict[str, torch.Tensor], *,
                remat: bool = False) -> torch.Tensor:
        """Training/scoring forward → logits (B, S, Vp).  ``remat``
        checkpoints each decoder period by ``cfg.remat`` (the module's
        docstring); the encoder is never rematerialized, as in the
        reference."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        rows = self._stream_rows(s)
        x = self._embed(params, tokens, rows)
        ctx = {"positions": torch.arange(s, device=tokens.device).expand(b, s),
               "memory": self._memory(params, batch), "rows": rows}
        return self._logits(params, self._trunk(params, x, ctx, None, remat=remat), rows)

    def loss(self, params: Params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy over the ``labels >= 0`` positions,
        in f32, with the forward rematerialized (``remat=True``) as the
        reference's loss is."""
        logits = self.forward(params, batch, remat=True).to(torch.float32)
        labels = batch["labels"]
        mask = labels >= 0
        lab = labels.clamp(min=0).to(torch.int64)
        if model_parallel() is not None and logits.shape[-1] != self.cfg.padded_vocab:
            ll = _vocab_parallel_log_likelihood(logits, lab)
        else:
            logp = torch.log_softmax(logits, dim=-1)
            ll = torch.gather(logp, -1, lab[..., None])[..., 0]
        return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, *,
                   device: str | torch.device = "cuda") -> Params:
        dev = resolve_device(device)
        caches: Params = {}
        for si, seg in enumerate(self.cfg.segments()):
            lead = () if seg.repeats == 1 else (seg.repeats,)
            caches[f"seg{si}"] = tuple(
                _init_layer_cache(spec, self.cfg, batch, max_len, dtype, dev, lead)
                for spec in seg.period
            )
        return caches

    def prefill(
        self, params: Params, batch: dict[str, torch.Tensor], cache: Params
    ) -> tuple[torch.Tensor, Params]:
        """Run the full prompt, fill the cache in place, return last-position logits."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed(params, tokens)
        ctx = {"positions": torch.arange(s, device=tokens.device).expand(b, s), "cache_pos": 0,
               "memory": self._memory(params, batch)}
        x = self._trunk(params, x, ctx, cache)
        return self._logits(params, x[:, -1:, :])[:, 0], cache

    def decode_step(
        self,
        params: Params,
        cache: Params,
        token: torch.Tensor,  # (B, 1) int
        pos: int,             # #tokens already in cache
        memory: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, Params]:
        """One token for every sequence; the cache is updated in place.
        Cross layers read the memory the prefill projected into the cache,
        or, given ``memory`` (as the reference's server passes a vlm's
        ``image_embeds`` every step, uncast), project it again and rewrite
        the cache with it."""
        b = token.shape[0]
        x = self._embed(params, token)
        ctx = {"positions": torch.full((b, 1), pos, dtype=torch.int64, device=token.device),
               "cache_pos": int(pos), "memory": memory}
        x = self._trunk(params, x, ctx, cache)
        return self._logits(params, x)[:, 0], cache

    # ---------------- dry-run input specs ----------------

    def input_specs(self, shape: ShapeCell) -> dict[str, torch.Tensor]:
        """``meta`` stand-ins for every model input of this cell (the
        reference's ``ShapeDtypeStruct``s: same shapes, same types).

        Modality frontends are stubbed as in the reference: whisper gets
        precomputed frame embeddings, the VLM patch embeddings.
        """
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def spec(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        if shape.kind == "train":
            specs = {"tokens": spec(b, s), "labels": spec(b, s)}
        elif shape.kind == "prefill":
            specs = {"tokens": spec(b, s)}
        else:  # decode: one new token against a cache of length s
            specs = {"token": spec(b, 1)}
        f = getattr(torch, cfg.dtype)
        if cfg.family == "audio" and shape.kind != "decode":
            specs["frames"] = spec(b, cfg.encoder_seq, cfg.d_model, dtype=f)
        if cfg.family == "vlm" and shape.kind != "decode":
            specs["image_embeds"] = spec(b, cfg.image_tokens, cfg.image_embed_dim, dtype=f)
        return specs


def _vocab_parallel_log_likelihood(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The log-probability of each label from a tensor-parallel rank's f32
    logits ``(B, S, V/n)``, its block of the vocabulary's columns (the
    padding masked), without gathering the vocabulary: the row maximum by
    ``pmax`` (a shift that carries no gradient), then one ``psum`` of the
    sum of exponentials and of the label's logit from the rank whose block
    holds it.  The same value as ``log_softmax`` at the label."""
    width = logits.shape[-1]
    top = pmax(logits.amax(dim=-1, keepdim=True), MODEL_AXIS)
    local = labels - axis_index(MODEL_AXIS) * width
    inside = (local >= 0) & (local < width)
    picked = torch.gather(logits, -1, local.clamp(0, width - 1)[..., None])[..., 0]
    total, label = psum((torch.exp(logits - top).sum(dim=-1),
                         torch.where(inside, picked, torch.zeros((), device=picked.device))),
                        MODEL_AXIS)
    return label - top[..., 0] - torch.log(total)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
