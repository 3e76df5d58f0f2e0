"""Dry-run library: trace every (arch × shape × mesh) cell on ``meta``.

Port of ``repro/launch/dryrun_lib.py``.  The reference lowers and compiles
each cell's step with XLA and reads ``memory_analysis``, ``cost_analysis``
and the partitioned HLO text; PyTorch has none of the three, nor GSPMD, so
here the step is a *rank program* traced on ``meta`` tensors (shape-only by
design, as the reference's ``jax.eval_shape``: nothing is allocated), and
each record says what it counts.  The record keys are the reference's, so
``repro_torch.analysis.roofline.analyze`` reads the port's records and the
reference's alike.

**The rank program** (:func:`lower_cell`).  A rank holds its shards of
the params, the optimizer state, the cache and the batch as the reference
places them (``params_shardings``, ``cache_shardings``, the batch over
``(pod, data)``) and runs the port's step on its share of the batch.  The
serving cells of the models ``Model.tensor_parallel_refusal`` admits
(every config with the onehot MoE) run the tensor-parallel rank program
of ``spmd.sharded_prefill`` and ``sharded_decode_step``
(``spmd.serving_body``): the rank keeps its heads (MLA's, the encoder's
and cross-attention's too), SSM heads, MLP columns, experts and
vocabulary rows split over ``model`` and its own cache block, gathers
only the ``fsdp`` dims, and the layers call the ``model`` collectives.
The ``long_500k`` cells (a batch of one under ``long_decode_rules``) run
it too: the cache's rows over ``data`` (``cache_shardings(
long_context=True)``), so a decode step's attention combines its
softmax partials over ``data`` beside the ``model`` psums and the new
row's gather of kv heads over ``model``.  Every other cell is
data-parallel: the rank gathers with ``all_gather`` what the port's
model needs whole.

* train — the dense, SSM, hybrid and MoE families
  (``Model.tensor_parallel_training_refusal``) under ``train_rules`` run
  the tensor-parallel train program (``spmd.training_step_body``): the
  ``fsdp`` dims gathered, the rank's ``model`` shards kept (heads, SSM
  heads, MLP columns, experts, vocabulary rows),
  :func:`~repro_torch.optim.accumulate_gradients` on its rows with the
  backward in segments, the gradients reduce-scattered over the ``fsdp``
  dims and summed over the rest of ``(pod, data)``, AdamW on the shards
  (``COST_BASIS["tensor_parallel_train"]``).  The other families (MLA,
  cross-attention, the encoder), and ``train_rules_sp``, run the
  data-parallel one (an MoE model's ranks in segments where they gather
  the batch's token rows, ``spmd.data_parallel_scope``): the params
  gathered, :func:`~repro_torch.optim.accumulate_gradients` (SplIter over
  the microbatch blocks) on the rank's rows, the loss and gradients summed
  over ``(pod, data)`` (hierarchically where the mesh has both) and divided
  by their count, then AdamW on the rank's own shards (the clip factor from
  the whole gradient's norm, which every rank holds);
* prefill — ``Model.prefill`` of the rank's prompts under ``decode_rules``
  (data-parallel: params and cache gathered, the cache's batch rows local);
* decode — one ``Model.decode_step`` at the cache's last slot under the
  cell's rules and ``cache_impl`` (the tensor-parallel body writes the row
  on the rank whose block holds it, whether ``cache_impl`` says
  ``"masked"`` or ``"sharded_dus"``; ``"decomposed"`` attends before the
  write there too); the ``long_500k`` cell's under ``long_decode_rules``,
  its batch of one and its logits ``P(None, "model")`` on every rank.

The production meshes are one ``meta`` device over 256 or 512 positions
(``make_production_mesh(devices=(torch.device("meta"),))``); on such a mesh
``shard_map``'s ranks are shape-only (``repro_torch.distributed.spmd``):
rank 0 runs in the caller's thread and its collectives return their
results' shapes without a rendezvous.  Every figure is one rank's.

**Per cell** (:func:`run_cell`):

* ``memory`` — per-rank ``argument_bytes`` and ``output_bytes`` from the
  shard shapes of the arguments and outputs as the reference places them,
  ``alias_bytes`` the donated arguments (params and optimizer state in
  training, the cache in serving).  Nothing counts temporaries:
  ``temp_bytes`` is 0 and ``temp_bytes_counted`` False, so
  ``peak_live_bytes`` (arguments + outputs − aliases) is a lower bound.
* ``cost`` — :func:`count_cost` over the rank program: matrix products by
  ``torch.utils.flop_counter``'s formulas (FlopCounterMode's), the two LM
  kernels by their own formulas (``flash_cost``, ``ssd_cost``), and
  ``bytes_accessed`` as every operation's operands read once and results
  written once, unfused, as eager PyTorch runs them (XLA counts its fused
  HLO).  Elementwise operations and reductions add bytes and no FLOPs.
  :func:`run_cell` traces each repeated body once, as ``cost_analysis``
  counts the reference's scanned module: one period of every layer
  segment (``probe_config(cfg, 1)``) and one microbatch block.
* ``collectives`` — the census of the collectives rank 0's program calls
  (``spmd.collective_census``, read into a
  :class:`~repro_torch.analysis.hlo.CollectiveStats`): in a tensor-parallel
  cell the ``model`` all-reduces and all-gathers the layers call, in a
  data-parallel one the gathers the port needs where GSPMD would insert
  tensor-parallel all-reduces.
* ``cost_basis`` and ``collectives_basis`` say which rank program the cell
  ran (:data:`COST_BASIS`, :data:`COLLECTIVES_BASIS`, keyed by
  ``Lowered.rank_program``).

**Probes** (:func:`probe_cell`): the cell at two unrolled depths and the
linear fit to the full depth, as in the reference.  The counter sees every
operation it runs, so ``_probe_metrics`` of the full unrolled depth would
count it directly, at the cost of tracing every layer.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch._pytree import tree_leaves, tree_map
from repro_torch.analysis.hlo import CollectiveStats
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.distributed.collectives import hierarchical_psum
from repro_torch.distributed.sharding import (
    cache_shardings,
    decode_rules,
    decode_rules_headsharded,
    long_decode_rules,
    params_shardings,
    train_rules,
    train_rules_sp,
    use_rules,
)
from repro_torch.distributed.spmd import (
    MODEL_AXIS,
    Mesh,
    NamedSharding,
    P,
    axis_index,
    axis_size,
    collective_census,
    data_parallel_scope,
    gathered,
    psum,
    serving_body,
    shard_map,
    tensor_parallel_scope,
    training_step_body,
)
from repro_torch.kernels._build import recording_costs
from repro_torch.models import build_model
from repro_torch.optim import accumulate_gradients, adamw_init, adamw_update
from repro_torch.optim.adamw import global_norm

_COUNTS = (
    "flops: matrix products by torch.utils.flop_counter's formulas plus the flash and SSD "
    "kernels' formulas (no elementwise or reduction flops); bytes_accessed: every "
    "operation's operands and results once, unfused eager traffic"
)
COST_BASIS = {
    "data_parallel": (
        "one rank's program at its shard shapes (data-parallel: the batch split over "
        "(pod, data), params and cache gathered whole; no tensor parallelism over model); "
        + _COUNTS),
    "tensor_parallel": (
        "one rank's tensor-parallel program at its shard shapes (the batch split over "
        "(pod, data), or a batch of one on every rank under long_decode_rules, its cache rows "
        "over data and a prompt's attention whole on every data rank; heads, SSM heads, MLP "
        "columns, experts and vocabulary rows split over "
        "model as params_shardings places them, only fsdp dims gathered; the rank's own cache "
        "block; the SSD kernel's formula at the rank's heads; the mamba2 B/C projections and "
        "C·Bᵀ, the MoE router and a decode step's MLA down-projections whole on every rank; "
        "a prompt's MLA down-projections and replicated k/v or memory projections by "
        "sequence rows; MLA's K/V decompressed at the rank's heads); " + _COUNTS),
}
COST_BASIS["tensor_parallel_train"] = (
    "one rank's tensor-parallel train program at its shard shapes (the batch split over "
    "(pod, data); heads, kv heads where they divide model, SSM heads, MLP columns, experts "
    "and vocabulary rows split over model as params_shardings places them, only fsdp dims "
    "gathered; replicated k/v projections by sequence rows; the mamba2 B/C projections and "
    "C·Bᵀ and the MoE router whole on every rank; the loss from the rank's vocabulary block; "
    "the backward in segments, a recomputed period's forward counted again under "
    "remat='full'; AdamW on the rank's shards); " + _COUNTS)
COLLECTIVES_BASIS = {
    "data_parallel": (
        "census of the collectives rank 0's program calls (the params' and cache's gathers, "
        "the gradients' sum); lacks the all-reduces GSPMD inserts for tensor parallelism"),
    "tensor_parallel": (
        "census of the collectives rank 0's program calls: the model all-reduces after the "
        "row-split products (attention output, MLP down, mamba2 w_out, the experts' partial "
        "combine), of the mamba2 gated norm's sum of squares and of the vocabulary-split "
        "embedding, the all-gathers of the kv rows or heads (the memory's too), of a prompt's "
        "MLA latent rows and of the mamba2 conv cache blocks with the ranks' last x inputs, "
        "the MoE token rows' all-gather over the data axes where a rank's rows are not whole "
        "dispatch groups, in decode the context-parallel combine (a max and a sum) over the "
        "cache rows' axis, model (after the q heads' all-gather; MLA: q_lat and q_rope) or "
        "data under long_decode_rules (the rank's own heads), or the MLA latent's all-gather "
        "under the heads layout; the fsdp gathers"),
}
COLLECTIVES_BASIS["tensor_parallel_train"] = (
    "census of the collectives rank 0's program calls: the fsdp gathers once a step; per "
    "microbatch block the forward's model all-reduces (the vocabulary-split embedding, after "
    "wo, w_down, mamba2's w_out and the experts' partial combine, the mamba2 gated norm's "
    "sum of squares, the loss's row max, sum of exponentials and label logit) and "
    "all-gathers (a replicated kv head's rows, the MoE token rows over the data axes where a "
    "rank's rows are not whole dispatch groups), again in a recomputed period, and the "
    "backward's transposes (an all-reduce over model for each value every rank holds alike "
    "that enters split work: the attention's, MLP's, mamba2 mixer's and experts' input, "
    "qk-norm, replicated k/v weights, mamba2's B/C weights, the router, the gated norm's sum "
    "of squares, the head's input; a reduce-scatter for each all-gather); then the loss's and "
    "gradients' sum over the data-parallel axes (a reduce-scatter per fsdp dim, the rest "
    "hierarchical over (pod, data) or one all-reduce) and the clip norm's all-reduce")
MEMORY_BASIS = (
    "per-rank shard shapes of the arguments and outputs as the reference places them; "
    "temporaries are not counted, so peak_live_bytes is a lower bound"
)


# Shape-cell applicability (DESIGN.md §Arch-applicability):
# long_500k only for sub-quadratic archs; reason recorded in the result.
def cell_skip_reason(cfg: ModelConfig, shape: ShapeCell) -> str | None:
    if shape.name == "long_500k" and not cfg.is_seq_subquadratic:
        return (
            "pure full-attention stack: 524k-token decode needs sub-quadratic "
            "attention/state (run for ssm/hybrid/SWA archs only)"
        )
    return None


def _dp_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(n for n in mesh.axis_names if n in ("pod", "data"))


def _bf16_like(tree):
    return tree_map(
        lambda l: torch.empty(l.shape, dtype=torch.bfloat16 if l.is_floating_point() else l.dtype,
                              device="meta"),
        tree,
    )


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
#: operations that move no bytes: allocations without a fill, and views the
#: schema does not mark as aliasing
_NO_BYTES = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten._unsafe_view.default,
    _aten.lift_fresh.default,
}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _Counter(TorchDispatchMode):
    """Counts matrix-product FLOPs and unfused bytes of every operation it
    sees (the module's docstring, ``cost``); the thread's own operations
    only."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if func.is_view or func in _NO_BYTES:
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


@dataclasses.dataclass
class Cost:
    """What :func:`count_cost` counted: ``flops`` and ``bytes_accessed`` in
    all, the kernels' share of both by kernel (``kernels``: name →
    ``{"calls", "flops", "bytes"}``) and the operations dispatched."""

    flops: int
    bytes_accessed: int
    kernels: dict[str, dict[str, int]]
    ops: int


def count_cost(fn: Callable, *args, **kwargs) -> tuple[Any, Cost]:
    """``fn(*args, **kwargs)`` and its :class:`Cost`: the operations this
    thread dispatches (matrix-product FLOPs by FlopCounterMode's formulas,
    every operation's operand and result bytes) plus each hand-written
    kernel's own formula for its launches on the card or its calls on
    ``meta`` (``repro_torch.kernels._build.recording_costs``).  The same
    work counts the same on ``meta`` and on a card."""
    counter = _Counter()
    with recording_costs() as sink, counter:
        out = fn(*args, **kwargs)
    kernels: dict[str, dict[str, int]] = {}
    for name, flops, nbytes in sink:
        k = kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
    return out, Cost(
        flops=counter.flops + sum(k["flops"] for k in kernels.values()),
        bytes_accessed=counter.bytes + sum(k["bytes"] for k in kernels.values()),
        kernels=kernels,
        ops=counter.ops,
    )


# ---------------------------------------------------------------------------
# the rank programs
# ---------------------------------------------------------------------------


def _shard_bytes(tree, shardings) -> int:
    """Per-rank bytes of ``tree``'s leaves laid out by ``shardings``."""
    return sum(math.prod(s.shard_shape(tuple(l.shape))) * l.element_size()
               for l, s in zip(tree_leaves(tree), tree_leaves(shardings)))


def _memory(args, out, donated) -> dict[str, Any]:
    """The reference's ``memory_analysis`` keys from ``(tree, shardings)``
    pairs: ``args`` and ``out`` all arguments and outputs, ``donated`` the
    arguments whose buffers the outputs reuse."""
    arg = sum(_shard_bytes(t, s) for t, s in args)
    res = sum(_shard_bytes(t, s) for t, s in out)
    alias = sum(_shard_bytes(t, s) for t, s in donated)
    return {"argument_bytes": arg, "output_bytes": res, "temp_bytes": 0,
            "temp_bytes_counted": False, "alias_bytes": alias,
            "peak_live_bytes": arg + res - alias, "peak_live_bytes_is_lower_bound": True}


def _specs(shardings):
    return tree_map(lambda s: s.spec, shardings)


def _shard_of(x: torch.Tensor, spec) -> torch.Tensor:
    """This rank's block of a whole tensor laid out by ``spec`` (a view;
    inside a rank program)."""
    for d, e in enumerate(spec):
        if e is not None:
            n = x.shape[d] // axis_size(e)
            x = x.narrow(d, axis_index(e) * n, n)
    return x


@dataclasses.dataclass
class Lowered:
    """A cell's rank program on ``meta`` and its memory record: the
    counterpart of the reference's lowered step."""

    program: Callable[[], Any]
    memory: dict[str, Any]
    #: the key of :data:`COST_BASIS` and :data:`COLLECTIVES_BASIS`
    rank_program: str = "data_parallel"

    def trace(self) -> dict[str, Any]:
        """Run the program once on ``meta``: its ``cost`` and
        ``collectives`` (the module's docstring)."""
        with collective_census() as census:
            _, cost = count_cost(self.program)
        return {"cost": {"flops": float(cost.flops), "bytes_accessed": float(cost.bytes_accessed),
                         "kernels": cost.kernels, "ops": cost.ops},
                "collectives": CollectiveStats(**census).as_dict()}


def _rank_program(mesh: Mesh, body: Callable, args: tuple, in_specs: tuple, out_specs: tuple
                  ) -> Callable[[], Any]:
    """``body`` as a ``shard_map`` over ``args``: on a mesh of ``meta``
    positions, one shape-only rank in the caller's thread."""
    if not mesh.shape_only:
        raise ValueError(f"the dry-run traces on a mesh of meta positions, not {mesh}")
    run = shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False)
    return lambda: run(*args)


def _dp_mean(tree, dp: tuple[str, ...]):
    """The mean over the data-parallel ranks: summed hierarchically (pod,
    then data) where the mesh has both axes, else one ``psum``."""
    n = axis_size(dp)
    if "pod" in dp and "data" in dp:
        total = tree_map(lambda x: hierarchical_psum(x.reshape(-1), fast_axis="data",
                                                     slow_axis="pod").reshape(x.shape), tree)
    else:
        total = psum(tree, dp)
    return tree_map(lambda t: t / n, total)


def _lower_train(
    cfg: ModelConfig,
    mesh: Mesh,
    shape: ShapeCell,
    num_blocks: int = 4,
    accum_mode: str = "spliter",
    sp: bool = False,
    hoist: bool = False,
    traced_blocks: int | None = None,
) -> Lowered:
    """``traced_blocks`` cuts the traced blocks (each ``global_batch //
    num_blocks`` rows) below ``num_blocks``; the memory is the whole step's.
    The models ``Model.tensor_parallel_training_refusal`` admits (the
    dense, SSM, hybrid and MoE families) run the tensor-parallel train
    program under ``train_rules`` (``spmd.training_step_body``); ``sp``
    (``train_rules_sp``, not ported) and the other families the
    data-parallel one."""
    model = build_model(cfg)
    dp = _dp_axes(mesh)
    params = model.init(None, device="meta", master=True)
    opt = adamw_init(params)
    specs = model.input_specs(shape)
    mb = shape.global_batch // num_blocks

    def blocks_of(n):
        return {k: torch.empty((n, mb) + tuple(v.shape[1:]), dtype=v.dtype, device="meta")
                for k, v in specs.items()}

    blocks = blocks_of(num_blocks)
    p_sh = params_shardings(params, mesh, fsdp_axis="data")
    o_sh = dataclasses.replace(params_shardings(opt, mesh, fsdp_axis="data"),
                               step=NamedSharding(mesh, P()))
    b_sh = {k: NamedSharding(mesh, P(None, dp, *(None,) * (v.ndim - 2)))
            for k, v in blocks.items()}
    loss_sh = NamedSharding(mesh, P())
    memory = _memory(args=[(params, p_sh), (opt, o_sh), (blocks, b_sh)],
                     out=[(params, p_sh), (opt, o_sh), (torch.empty((), device="meta"), loss_sh)],
                     donated=[(params, p_sh), (opt, o_sh)])
    p_specs, o_specs = _specs(p_sh), _specs(o_sh)
    rules = train_rules_sp(mesh) if sp else train_rules(mesh)
    traced = blocks if traced_blocks is None else blocks_of(traced_blocks)
    in_specs, out_specs = (p_specs, o_specs, _specs(b_sh)), (p_specs, o_specs, P())
    if not sp and model.tensor_parallel_training_refusal() is None:
        body = training_step_body(model, mesh, params, p_specs, rules, lr=1e-4,
                                  accum_mode=accum_mode, hoist=hoist)
        return Lowered(_rank_program(mesh, body, (params, opt, traced), in_specs, out_specs),
                       memory, "tensor_parallel_train")
    tp = data_parallel_scope(model.loss, dp, mesh.axis_size(dp))  # the whole batch's MoE groups

    def body(params_l, opt_l, blocks_l):
        full = tree_map(gathered, params_l, p_specs)
        with use_rules(rules), tensor_parallel_scope(tp):
            loss, grads = accumulate_gradients(model.loss, full, blocks_l, mode=accum_mode,
                                               hoist=hoist)
        loss, grads = _dp_mean((loss, grads), dp)
        gnorm = global_norm(grads)
        scale = torch.clamp(torch.full_like(gnorm, 1.0) / torch.clamp(gnorm, min=1e-12), max=1.0)
        local = tree_map(lambda g, spec: _shard_of(g, spec) * scale, grads, p_specs)
        new_p, new_opt = adamw_update(params_l, local, opt_l, lr=1e-4, clip_norm=math.inf)
        return new_p, new_opt, loss

    return Lowered(_rank_program(mesh, body, (params, opt, traced), in_specs, out_specs), memory)


def _serving_fsdp(cfg: ModelConfig) -> Any:
    """Serving keeps bf16 weights TP-only when they fit; else ZeRO over data."""
    bf16_bytes = cfg.param_counts()["total"] * 2
    return "data" if bf16_bytes / 16 > 12e9 else None


def _batch_dims(model, cache):
    """The batch dim of every cache leaf: 1 under a stacked segment, else 0."""
    return {f"seg{i}": tree_map(lambda _, lead=int(seg.repeats > 1): lead, cache[f"seg{i}"])
            for i, seg in enumerate(model.cfg.segments())}


def _serve_program(model, mesh: Mesh, params, p_sh, batch, b_sh, cache, c_sh, step: Callable,
                   rules, batch_axes, memory: dict, tensor_parallel: bool) -> Lowered:
    """The serving cell lowered.  With ``tensor_parallel``
    (``Model.tensor_parallel_refusal`` is None; under ``decode_rules``,
    ``decode_rules_headsharded`` or ``long_decode_rules``):
    ``spmd.serving_body``, the rank's shards of the params (gathered over
    ``fsdp`` only) and its block of the cache, the logits of its rows
    (``batch_axes``: None, every rank's, under ``long_decode_rules``) and
    vocabulary columns.  Otherwise
    data-parallel: params gathered, the cache gathered but for its batch
    rows (over ``batch_axes``), ``step(params, batch, cache)`` under
    ``rules``, the logits of the rank's rows and its blocks of the cache
    returned."""
    p_specs, c_specs = _specs(p_sh), _specs(c_sh)
    in_specs = (p_specs, _specs(b_sh), c_specs)
    if tensor_parallel:
        body = serving_body(model, mesh, params, p_specs, cache, c_specs, step, rules)
        return Lowered(_rank_program(mesh, body, (params, batch, cache), in_specs,
                                     (P(batch_axes, MODEL_AXIS), c_specs)),
                       memory, "tensor_parallel")
    gather_specs = tree_map(lambda sh, b: P(*(None if d == b else e
                                             for d, e in enumerate(sh.spec))),
                            c_sh, _batch_dims(model, cache))

    def body(params_l, batch_l, cache_l):
        full = tree_map(gathered, params_l, p_specs)
        whole_rows = tree_map(gathered, cache_l, gather_specs)
        with use_rules(rules):
            logits, new_cache = step(full, batch_l, whole_rows)
        return logits, tree_map(lambda c, spec: _shard_of(c, spec), new_cache, gather_specs)

    return Lowered(_rank_program(mesh, body, (params, batch, cache), in_specs,
                                 (P(batch_axes), c_specs)), memory)


def _lower_prefill(cfg: ModelConfig, mesh: Mesh, shape: ShapeCell) -> Lowered:
    model = build_model(cfg)
    dp = _dp_axes(mesh)
    params = _bf16_like(model.init(None, device="meta"))
    specs = model.input_specs(shape)
    cache = model.init_cache(shape.global_batch, shape.seq_len, torch.bfloat16, device="meta")
    p_sh = params_shardings(params, mesh, fsdp_axis=_serving_fsdp(cfg))
    b_sh = {k: NamedSharding(mesh, P(dp, *(None,) * (v.ndim - 1))) for k, v in specs.items()}
    c_sh = cache_shardings(cache, mesh)
    logits = torch.empty((shape.global_batch, cfg.padded_vocab), dtype=getattr(torch, cfg.dtype),
                         device="meta")
    memory = _memory(args=[(params, p_sh), (specs, b_sh), (cache, c_sh)],
                     out=[(logits, NamedSharding(mesh, P(dp, "model"))), (cache, c_sh)],
                     donated=[(cache, c_sh)])
    return _serve_program(model, mesh, params, p_sh, specs, b_sh, cache, c_sh, model.prefill,
                          decode_rules(mesh), dp, memory,
                          model.tensor_parallel_refusal() is None)


def _lower_decode(
    cfg: ModelConfig, mesh: Mesh, shape: ShapeCell, cache_impl: str = "masked"
) -> Lowered:
    model = build_model(cfg)
    long_ctx = shape.global_batch == 1
    dp = _dp_axes(mesh)
    params = _bf16_like(model.init(None, device="meta"))
    cache = model.init_cache(shape.global_batch, shape.seq_len, torch.bfloat16, device="meta")
    token = {"token": model.input_specs(shape)["token"]}
    pos = torch.empty((), dtype=torch.int32, device="meta")
    p_sh = params_shardings(params, mesh, fsdp_axis=_serving_fsdp(cfg))
    c_sh = cache_shardings(
        cache, mesh, long_context=long_ctx,
        layout="heads" if "heads_dus" in cache_impl else "seq",
    )
    batch_ax = None if long_ctx else dp
    t_sh = {"token": NamedSharding(mesh, P(batch_ax, None))}
    if long_ctx:
        rules = long_decode_rules(mesh)
    elif "heads_dus" in cache_impl:
        rules = decode_rules_headsharded(mesh)
    else:
        rules = decode_rules(mesh)
    rules = dataclasses.replace(rules, cache_impl=cache_impl)
    logits = torch.empty((shape.global_batch, cfg.padded_vocab), dtype=getattr(torch, cfg.dtype),
                         device="meta")
    memory = _memory(
        args=[(params, p_sh), (cache, c_sh), (token, t_sh), (pos, NamedSharding(mesh, P()))],
        out=[(logits, NamedSharding(mesh, P(batch_ax, "model"))), (cache, c_sh)],
        donated=[(cache, c_sh)])
    last = shape.seq_len - 1  # the new token's slot: the whole cache is attended

    def step(p, batch, c):
        return model.decode_step(p, c, batch["token"], last)

    return _serve_program(model, mesh, params, p_sh, token, t_sh, cache, c_sh, step, rules,
                          batch_ax, memory, model.tensor_parallel_refusal() is None)


def lower_cell(
    cfg: ModelConfig,
    mesh: Mesh,
    shape: ShapeCell,
    *,
    num_blocks: int = 4,
    sp: bool = False,
    cache_impl: str = "masked",
    hoist: bool = False,
) -> Lowered:
    if shape.kind == "train":
        return _lower_train(
            cfg, mesh, shape, num_blocks=num_blocks, sp=sp, hoist=hoist
        )
    if shape.kind == "prefill":
        return _lower_prefill(cfg, mesh, shape)
    return _lower_decode(cfg, mesh, shape, cache_impl=cache_impl)


# ---------------------------------------------------------------------------
# analysis capture
# ---------------------------------------------------------------------------


def _scan_bodies(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with every layer segment cut to one period: the layers the
    reference's ``cost_analysis`` counts of its scanned module."""
    return dataclasses.replace(probe_config(cfg, 1)[0], unroll_layers=False)


def _header(arch: str, shape_name: str, mesh: Mesh, mesh_label: str) -> dict[str, Any]:
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_label,
        "devices": mesh.size,
    }


def run_cell(
    arch: str,
    shape_name: str,
    mesh: Mesh,
    *,
    mesh_label: str,
    overrides: dict[str, Any] | None = None,
    num_blocks: int = 4,
    sp: bool = False,
    cache_impl: str = "masked",
    hoist: bool = False,
) -> dict[str, Any]:
    """Lower + trace + analyze one cell.  Returns a JSON-able record: the
    whole step's ``memory``, and the ``cost`` and ``collectives`` of its
    rank program with each repeated body once (the module's docstring)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    rec = _header(arch, shape_name, mesh, mesh_label)
    skip = cell_skip_reason(cfg, shape)
    if skip:
        rec["status"] = "SKIP"
        rec["reason"] = skip
        return rec
    t0 = time.perf_counter()
    kw = dict(num_blocks=num_blocks, sp=sp, cache_impl=cache_impl, hoist=hoist)
    whole = lower_cell(cfg, mesh, shape, **kw)
    bodies = (_lower_train(_scan_bodies(cfg), mesh, shape, num_blocks=num_blocks, sp=sp,
                           hoist=hoist, traced_blocks=1)
              if shape.kind == "train" else lower_cell(_scan_bodies(cfg), mesh, shape, **kw))
    t_lower = time.perf_counter() - t0
    t0 = time.perf_counter()
    traced = bodies.trace()
    t_trace = time.perf_counter() - t0
    rec.update(
        status="OK",
        lower_s=round(t_lower, 2),
        compile_s=round(t_trace, 2),
        memory=whole.memory,
        **traced,
        cost_basis=COST_BASIS[bodies.rank_program] + "; each repeated body once: one period "
                                                     "of every layer segment and one "
                                                     "microbatch block",
        collectives_basis=COLLECTIVES_BASIS[bodies.rank_program],
        memory_basis=MEMORY_BASIS,
    )
    return rec


# ---------------------------------------------------------------------------
# roofline probes: unrolled-depth traces → linear extrapolation
# ---------------------------------------------------------------------------
#
# The reference compiles each cell at two small unrolled depths, because
# ``cost_analysis`` counts a ``while`` (scan) body once, and fits
# cost(k) = a + b·k to the real depth R.  The port's counter sees every
# operation it runs, so the full unrolled depth could be counted directly;
# the fit is kept for the reference's keys and its tracing time.


def probe_config(cfg: ModelConfig, k: int) -> tuple[ModelConfig, int]:
    """Clamp the repeated-segment depth to ``k`` periods; return (cfg_k, R).

    R is the full-config repeat count of the scaled segment(s) — the
    extrapolation target.  Encoder segments (whisper) scale together with
    the decoder (their full repeats are equal; asserted).
    """
    f = cfg.family
    if f == "hybrid":
        n, R = cfg.attn_period * k, cfg.num_layers // cfg.attn_period
        cfg_k = dataclasses.replace(cfg, num_layers=n)
    elif f == "vlm":
        n, R = cfg.cross_attn_period * k, cfg.num_layers // cfg.cross_attn_period
        cfg_k = dataclasses.replace(cfg, num_layers=n)
    elif f == "audio":
        assert cfg.encoder_layers == cfg.num_layers, (
            "audio probe assumes enc/dec repeats are equal"
        )
        R = cfg.num_layers
        cfg_k = dataclasses.replace(cfg, num_layers=k, encoder_layers=k)
    elif cfg.moe_first_dense:
        R = cfg.num_layers - cfg.moe_first_dense
        cfg_k = dataclasses.replace(cfg, num_layers=cfg.moe_first_dense + k)
    else:
        R = cfg.num_layers
        cfg_k = dataclasses.replace(cfg, num_layers=k)
    cfg_k = dataclasses.replace(cfg_k, unroll_layers=True)
    # exactly one depth-scaled segment family (the fit slope is per-k of it)
    return cfg_k, R


def _probe_lowered(
    cfg: ModelConfig,
    mesh: Mesh,
    shape: ShapeCell,
    *,
    sp: bool = False,
    cache_impl: str = "masked",
    hoist: bool = False,
    probe_blocks: int = 1,
) -> Lowered:
    if shape.kind == "train":
        return _lower_train(
            cfg, mesh, shape,
            num_blocks=probe_blocks,
            accum_mode="materialized" if probe_blocks == 1 else "spliter_unrolled",
            sp=sp,
            hoist=hoist,
        )
    if shape.kind == "prefill":
        return _lower_prefill(cfg, mesh, shape)
    return _lower_decode(cfg, mesh, shape, cache_impl=cache_impl)


def _metrics(lowered: Lowered) -> dict[str, float]:
    traced = lowered.trace()
    coll = traced["collectives"]
    return {
        "flops": traced["cost"]["flops"],
        "bytes_accessed": traced["cost"]["bytes_accessed"],
        "collective_bytes": float(coll["total_operand_bytes"]),
        "collective_by_kind": {k: float(v) for k, v in coll["operand_bytes"].items()},
    }


def _probe_metrics(cfg: ModelConfig, mesh: Mesh, shape: ShapeCell, **kw) -> dict[str, float]:
    return _metrics(_probe_lowered(cfg, mesh, shape, **kw))


def probe_cell(
    arch: str,
    shape_name: str,
    mesh: Mesh,
    *,
    mesh_label: str,
    depths: tuple[int, int] = (1, 2),
    overrides: dict[str, Any] | None = None,
    sp: bool = False,
    cache_impl: str = "masked",
    hoist: bool = False,
    probe_blocks: int = 1,
) -> dict[str, Any]:
    """Two unrolled-depth traces → per-rank cost extrapolated to full depth."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    rec = _header(arch, shape_name, mesh, mesh_label)
    skip = cell_skip_reason(cfg, shape)
    if skip:
        rec["status"] = "SKIP"
        rec["reason"] = skip
        return rec
    k1, k2 = depths
    t0 = time.perf_counter()
    cfg1, R = probe_config(cfg, k1)
    cfg2, _ = probe_config(cfg, k2)
    kw = dict(sp=sp, cache_impl=cache_impl, hoist=hoist, probe_blocks=probe_blocks)
    low1 = _probe_lowered(cfg1, mesh, shape, **kw)
    m1, m2 = _metrics(low1), _probe_metrics(cfg2, mesh, shape, **kw)

    def fit(v1: float, v2: float) -> float:
        slope = max((v2 - v1) / (k2 - k1), 0.0)
        return v1 + slope * (R - k1)

    kinds = set(m1["collective_by_kind"]) | set(m2["collective_by_kind"])
    rec.update(
        status="OK",
        depths={str(k1): m1, str(k2): m2},
        repeats=R,
        extrapolated={
            "flops": fit(m1["flops"], m2["flops"]),
            "bytes_accessed": fit(m1["bytes_accessed"], m2["bytes_accessed"]),
            "collective_bytes": fit(m1["collective_bytes"], m2["collective_bytes"]),
            "collective_by_kind": {
                k: fit(m1["collective_by_kind"].get(k, 0.0),
                       m2["collective_by_kind"].get(k, 0.0))
                for k in sorted(kinds)
            },
        },
        cost_basis=COST_BASIS[low1.rank_program],
        collectives_basis=COLLECTIVES_BASIS[low1.rank_program],
    )
    rec["probe_s"] = round(time.perf_counter() - t0, 2)
    return rec


def _failed(arch: str, shape_name: str, mesh_label: str, e: Exception) -> dict[str, Any]:
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_label,
        "status": "FAIL",
        "error": f"{type(e).__name__}: {e}",
    }


def _save(results: list, out_path: str | None) -> None:
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)


def run_probe_matrix(
    arches: list[str],
    shapes: list[str],
    meshes: list[tuple[str, Mesh]],
    out_path: str | None = None,
    *,
    verbose: bool = True,
) -> list[dict[str, Any]]:
    results = []
    for mesh_label, mesh in meshes:
        for arch in arches:
            for shape_name in shapes:
                try:
                    rec = probe_cell(arch, shape_name, mesh, mesh_label=mesh_label)
                except Exception as e:  # a failed cell is a bug — record it
                    rec = _failed(arch, shape_name, mesh_label, e)
                results.append(rec)
                if verbose:
                    s = rec["status"]
                    extra = ""
                    if s == "OK":
                        ex = rec["extrapolated"]
                        extra = (f" flops={ex['flops']:.3g}"
                                 f" bytes={ex['bytes_accessed']:.3g}"
                                 f" coll={ex['collective_bytes']:.3g}"
                                 f" ({rec['probe_s']}s)")
                    elif s == "FAIL":
                        extra = " " + rec["error"][:140]
                    print(f"[probe:{mesh_label}] {arch:22s} {shape_name:12s} {s}{extra}",
                          flush=True)
                _save(results, out_path)
    return results


def run_matrix(
    arches: list[str],
    shapes: list[str],
    meshes: list[tuple[str, Mesh]],
    out_path: str | None = None,
    *,
    verbose: bool = True,
) -> list[dict[str, Any]]:
    results = []
    for mesh_label, mesh in meshes:
        for arch in arches:
            for shape_name in shapes:
                try:
                    rec = run_cell(arch, shape_name, mesh, mesh_label=mesh_label)
                except Exception as e:  # a failed cell is a bug — record it
                    rec = _failed(arch, shape_name, mesh_label, e)
                results.append(rec)
                if verbose:
                    s = rec["status"]
                    extra = ""
                    if s == "OK":
                        gb = rec["memory"]["peak_live_bytes"] / 1e9
                        extra = (f" peak={gb:.2f}GB/dev lower={rec['lower_s']}s "
                                 f"trace={rec['compile_s']}s")
                    elif s == "FAIL":
                        extra = " " + rec["error"][:120]
                    print(f"[{mesh_label}] {arch:22s} {shape_name:12s} {s}{extra}", flush=True)
                _save(results, out_path)
    return results
