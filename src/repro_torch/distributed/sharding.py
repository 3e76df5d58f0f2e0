"""Logical-axis sharding: rules map logical dims → mesh axes.

Port of ``repro/distributed/sharding.py``, verbatim in logic over the
port's :class:`~repro_torch.distributed.spmd.Mesh`,
:class:`~repro_torch.distributed.spmd.PartitionSpec` and
:class:`~repro_torch.distributed.spmd.NamedSharding`.  A
:class:`ShardingRules` context maps logical axis names to mesh axes;
outside a rules context :func:`shard` is the identity.

What the port does with them:

* :func:`params_shardings` and :func:`cache_shardings` give the layouts
  :func:`~repro_torch.distributed.spmd.device_put` places trees by (the
  data-parallel train step gathers params from them; a checkpoint restores
  onto them).
* ``cache_impl`` selects the decode cache's write and attention
  (``repro_torch.models.layers.cache_write`` and ``attention``).
* :func:`shard` checks the rank and resolves the spec (:func:`shard_spec`),
  and returns ``x`` unchanged: the port's values are global tensors, and
  no compiler partitions them, so there is nothing to constrain.  The
  port's model does not call it.

Rule presets (the reference's DESIGN.md §5):

* ``train_rules``   — DP over (pod, data); TP heads/ffn/experts/vocab over model.
* ``train_rules_sp``— + sequence-parallel residual stream.
* ``decode_rules``  — batch over (pod, data); heads/vocab over model; the KV
                      sequence over model (context parallelism).
* ``decode_rules_headsharded`` — heads over model, the KV sequence whole
                      (``cache_impl="heads_dus"``).
* ``long_decode_rules`` — B=1: KV/state sequence over data, heads over model.

The active rules are a process-wide stack, as in the reference: the rank
threads of a ``shard_map`` see the rules its caller entered.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Callable

import torch

from repro_torch._pytree import dataclass_fields
from repro_torch.distributed.spmd import Mesh, NamedSharding, P, PartitionSpec

__all__ = [
    "ShardingRules",
    "use_rules",
    "shard",
    "param_pspec",
    "params_shardings",
    "cache_shardings",
    "train_rules",
    "train_rules_sp",
    "decode_rules",
    "long_decode_rules",
]

_ACTIVE: list["ShardingRules"] = []


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Mesh
    logical: dict[str, Any]  # logical axis name -> mesh axis (str/tuple/None)
    # decode cache write: "masked" | "sharded_dus" | "heads_dus" | "decomposed"
    cache_impl: str = "masked"

    def spec(self, *names: str | None) -> PartitionSpec:
        return P(*(self.logical.get(n) if n else None for n in names))


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    if rules is None:
        yield
        return
    _ACTIVE.append(rules)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_rules() -> ShardingRules | None:
    return _ACTIVE[-1] if _ACTIVE else None


def _axis_size(mesh: Mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= mesh.shape[a]
        return out
    return mesh.shape[axis]


def shard_spec(x: torch.Tensor, *names: str | None) -> PartitionSpec | None:
    """The active rules' spec for ``x`` with logical ``names`` (None outside
    a rules context).  Axes whose mesh extent does not divide the dim are
    dropped (replicated) — e.g. whisper's 6 heads on a 16-way model axis."""
    r = active_rules()
    if r is None:
        return None
    if x.ndim != len(names):
        raise ValueError(f"shard: {tuple(x.shape)} has {x.ndim} dims, names {names}")
    spec = []
    for dim, name in zip(x.shape, names):
        ax = r.logical.get(name) if name else None
        spec.append(ax if ax and dim % _axis_size(r.mesh, ax) == 0 else None)
    return P(*spec)


def shard(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """The reference's sharding constraint: the identity outside a rules
    context; inside one, the rank is checked and the spec resolved
    (:func:`shard_spec`), and ``x`` is returned unchanged (the module's
    docstring: the port's values stay global)."""
    shard_spec(x, *names)
    return x


# ---------------------------------------------------------------------------
# Rule presets.  `dp` = the data-parallel submesh (("pod","data") or ("data",)).
# ---------------------------------------------------------------------------

def _dp(mesh: Mesh) -> tuple[str, ...]:
    return tuple(n for n in mesh.axis_names if n in ("pod", "data"))


def train_rules(mesh: Mesh) -> ShardingRules:
    dp = _dp(mesh)
    return ShardingRules(
        mesh,
        {
            "batch": dp,
            "seq": None,
            "seq_res": None,   # residual stream between blocks (SP shards it)
            "embed": None,
            "heads": "model",
            "kv_heads": "model",
            "head_dim": None,
            "mlp": "model",
            "expert": "model",
            "vocab": "model",
            "kv_seq": None,
            "state": None,
        },
    )


def train_rules_sp(mesh: Mesh) -> ShardingRules:
    """Sequence-parallel residual stream: seq sharded over model between
    blocks (cuts activation bytes)."""
    r = train_rules(mesh)
    logical = dict(r.logical)
    logical["seq_res"] = "model"  # Megatron-style sequence parallelism
    return ShardingRules(mesh, logical)


def decode_rules(mesh: Mesh) -> ShardingRules:
    """Decode: context parallelism.  The KV cache sequence shards over
    `model` (GQA kv-heads rarely divide a 16-way TP axis), so attention
    heads stay UNSHARDED; MLP/vocab stay tensor-parallel."""
    dp = _dp(mesh)
    return ShardingRules(
        mesh,
        {
            "batch": dp,
            "seq": None,
            "seq_res": None,
            "embed": None,
            "heads": None,
            "kv_heads": None,
            "head_dim": None,
            "mlp": "model",
            "expert": "model",
            "vocab": "model",
            "kv_seq": "model",
            "state": None,
        },
    )


def decode_rules_headsharded(mesh: Mesh) -> ShardingRules:
    """Decode for archs whose kv-head count divides the model axis
    (deepseek-7b: 32 kv heads on 16-way TP): shard heads, keep the cache
    sequence dim UNSHARDED so the per-token cache update is a one-row
    write (``cache_impl="heads_dus"``)."""
    dp = _dp(mesh)
    return ShardingRules(
        mesh,
        {
            "batch": dp,
            "seq": None,
            "seq_res": None,
            "embed": None,
            "heads": "model",
            "kv_heads": "model",
            "head_dim": None,
            "mlp": "model",
            "expert": "model",
            "vocab": "model",
            "kv_seq": None,
            "state": None,
        },
        cache_impl="heads_dus",
    )


def long_decode_rules(mesh: Mesh) -> ShardingRules:
    """B=1 long-context decode: context parallelism — the KV/conv/SSM state
    sequence dim shards over data; batch replicates."""
    return ShardingRules(
        mesh,
        {
            "batch": None,
            "seq": None,
            "seq_res": None,
            "embed": None,
            "heads": "model",
            "kv_heads": "model",
            "head_dim": None,
            "mlp": "model",
            "expert": "model",
            "vocab": "model",
            "kv_seq": "data",
            "state": "data",
        },
    )


# ---------------------------------------------------------------------------
# Parameter placement (name-based rules, MaxText-style).
# ---------------------------------------------------------------------------

# (regex on the joined param path, per-dim sharding) — "model" is tensor
# parallelism, "fsdp" is the ZeRO-3 dimension (resolved to the data axis).
# Leaves inside stacked segments carry a leading layer-stack dim.
_PARAM_RULES: list[tuple[str, tuple[Any, ...]]] = [
    # attention projections: (D, H, Dh) -> heads over model, D over fsdp
    (r"/(wq|wk|wv|wk_mem|wv_mem)$", ("fsdp", "model", None)),
    (r"/(wq_b|wk_b|wv_b)$", ("fsdp", "model", None)),
    (r"/(bq|bk|bv)$", ("model", None)),
    # output projection: (H, Dh, D) -> heads over model, D over fsdp
    (r"/wo$", ("model", None, "fsdp")),
    # MLA low-rank downs
    (r"/(wq_a|wkv_a)$", ("fsdp", None)),
    # dense mlp: (D, F) / (F, D)
    (r"/(w_gate|w_up)$", ("fsdp", "model")),
    (r"/w_down$", ("model", "fsdp")),
    # moe experts: (E, D, F) / (E, F, D) -> expert-parallel over model
    (r"/(experts_gate|experts_up)$", ("model", "fsdp", None)),
    (r"/experts_down$", ("model", None, "fsdp")),
    (r"/router$", (None, None)),
    # mamba: shard the inner (head) dim over model, D over fsdp
    (r"/(w_in_z|w_in_x)$", ("fsdp", "model")),
    (r"/(w_in_b|w_in_c)$", ("fsdp", None)),
    (r"/w_in_dt$", ("fsdp", "model")),
    (r"/w_out$", ("model", "fsdp")),
    (r"/(conv_x)$", (None, "model")),
    (r"/(conv_b|conv_c)$", (None, None)),
    (r"/(A_log|ssm_D|dt_bias)$", ("model",)),
    (r"/ssm_norm$", ("model",)),
    # embeddings / head: vocab over model, embed over fsdp
    (r"/embed$", ("model", "fsdp")),
    (r"/lm_head$", ("fsdp", "model")),
    # norms, gates, scalars: replicated
    (r"/(ln1|ln2|ln1_b|ln2_b|final_norm|final_norm_b|enc_final_norm|enc_final_norm_b|q_norm|k_norm|q_norm_a|kv_norm_a|gate)$", ()),
]


def param_pspec(
    path: str,
    shape: tuple[int, ...],
    mesh: Mesh,
    *,
    fsdp_axis: Any = "data",
) -> PartitionSpec:
    """PartitionSpec for a parameter leaf by path name.

    A leaf under a stacked segment carries a leading layer-stack dim (never
    sharded); it is detected *by rank*: every non-empty rule's spec length
    equals the parameter's base rank, so ``ndim == len(rule)+1`` ⇔ stacked.
    Dims not divisible by their axis extent are replicated.
    ``fsdp_axis=None`` disables ZeRO sharding.
    """
    chosen: tuple[Any, ...] | None = None
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            chosen = spec
            break
    if chosen is None or len(chosen) == 0:
        return P(*((None,) * len(shape)))  # unmatched or norms/scalars: replicate
    if len(shape) == len(chosen) + 1:
        stacked = True
    elif len(shape) == len(chosen):
        stacked = False
    else:  # rank mismatch (e.g. scalar variants): replicate, never crash
        return P(*((None,) * len(shape)))
    base_shape = shape[1:] if stacked else shape
    out = []
    for i, dim in enumerate(base_shape):
        ax = chosen[i]
        if ax == "fsdp":
            ax = fsdp_axis
        if ax is None or dim % _axis_size(mesh, ax) != 0:
            ax = None
        out.append(ax)
    return P(*(((None,) if stacked else ()) + tuple(out)))


def _map_with_path(fn: Callable[[tuple, Any], Any], tree: Any, path: tuple = ()) -> Any:
    """``jax.tree_util.tree_map_with_path`` over the port's trees: a dict
    key and a sequence index are path elements as given, a registered
    dataclass's field ``.<name>``."""
    names = dataclass_fields(tree)
    if names is not None:
        return type(tree)(**{n: _map_with_path(fn, getattr(tree, n), path + (f".{n}",))
                             for n in names})
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def params_shardings(params: Any, mesh: Mesh, *, fsdp_axis: Any = "data") -> Any:
    """Map a params tree to NamedShardings (path-name rules); the path of
    ``params["seg0"][0]["mixer"]["wq"]`` is ``/seg0/0/mixer/wq``."""

    def one(path, leaf):
        pstr = "/" + "/".join(str(k) for k in path)
        return NamedSharding(
            mesh,
            param_pspec(pstr, tuple(leaf.shape), mesh, fsdp_axis=fsdp_axis),
        )

    return _map_with_path(one, params)


# ---------------------------------------------------------------------------
# decode-cache placement
# ---------------------------------------------------------------------------


# decode-cache leaf base ranks (unstacked); a leading layer-stack dim is
# detected exactly as ndim == base+1.
_CACHE_BASE_RANK = {
    "k": 4, "v": 4,            # (B, S, Hkv, Dh)
    "k_mem": 4, "v_mem": 4,    # (B, M, Hkv, Dh)
    "ckv": 3, "krope": 3,      # (B, S, R)
    "conv": 3,                 # (B, W-1, C)
    "h": 4,                    # (B, NH, P, N)
}


def cache_shardings(
    cache: Any,
    mesh: Mesh,
    *,
    long_context: bool = False,
    layout: str = "seq",
) -> Any:
    """NamedShardings for a decode cache tree.

    ``layout="seq"`` (default): batch over (pod, data); the KV sequence dim
    over model (context parallel inside attention).  Long-context (B=1):
    the sequence dim shards over data instead, batch replicates.

    ``layout="heads"``: shard the head (k/v) or latent (MLA) dim over model
    and leave the sequence dim whole (``decode_rules_headsharded``).
    """
    dp = _dp(mesh)

    def one(path, leaf):
        name = str(path[-1])
        base = _CACHE_BASE_RANK.get(name)
        stacked = base is not None and leaf.ndim == base + 1
        nb = 1 if stacked else 0  # leading layer-stack dim
        dims: list[Any] = [None] * leaf.ndim
        seq_ax = "data" if long_context else "model"
        batch_ax = None if long_context else dp
        heads = layout == "heads" and not long_context
        if name in ("k", "v"):          # (.., B, S, Hkv, Dh)
            dims[nb + 0] = batch_ax
            if heads:
                dims[nb + 2] = "model"
            else:
                dims[nb + 1] = seq_ax
        elif name in ("k_mem", "v_mem"):  # (.., B, M, Hkv, Dh)
            dims[nb + 0] = batch_ax
        elif name in ("ckv", "krope"):    # (.., B, S, R)
            dims[nb + 0] = batch_ax
            if heads:
                dims[nb + 2] = "model"
            else:
                dims[nb + 1] = seq_ax
        elif name == "conv":              # (.., B, W-1, C)
            dims[nb + 0] = batch_ax
            dims[nb + 2] = "model"
        elif name == "h":                 # (.., B, NH, P, N)
            dims[nb + 0] = batch_ax
            dims[nb + 1] = "model"
        # drop non-divisible axes
        for i, (dim, ax) in enumerate(zip(leaf.shape, dims)):
            if ax is not None and dim % _axis_size(mesh, ax) != 0:
                dims[i] = None
        return NamedSharding(mesh, P(*dims))

    return _map_with_path(one, cache)
