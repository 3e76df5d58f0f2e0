"""The port's tensor-parallel train step under ``train_rules`` against the
JAX package's ``jax.jit`` of the same step.

The reference side runs once, in one child process on 8 forced host
devices (``tests/_torch_dist_ref.py``, cases ``tp_train`` and
``collective_grads``): the smoke configs of ``TRAIN_CASES``, qwen3's as it
is (bf16 compute) and in f32, on (2, 2, 2) ("pod", "data", "model") and on
(2, 4) ("data", "model"), where its 2 kv heads do not divide the model
axis; mamba2's and jamba's in f32 on both and jamba's in bf16 on (2, 2,
2); mixtral's in f32 on (2, 4) and at capacity factor 1 on (2, 2, 2),
where the groups drop choices and a rank's rows are not whole groups (its
token rows gathered over the data axes); deepseek-v2's (MLA), the vlm's
(cross-attention, its 2 kv heads split on (2, 2, 2) and replicated on (2,
4)) and whisper's (the encoder) in f32 on both, the vlm's in bf16 on (2,
2, 2), their cross gates drawn apart from 0 in the reference's tree
(``ref.tp_gates``), the memory inputs from ``ref.train_blocks``; and
``jax.grad`` through each collective of a ``shard_map``.  The port side
runs here, its ranks repeated ``cpu`` devices, from the child's params (its checkpoint) and the
same numpy blocks.

Bounds: qwen3's bf16 cases at the data-parallel test's
(``tests/test_torch_distributed.py``): the loss within 5e-3 of the
reference's, each gradient leaf within 2e-2 of its maximum of the port's
own unsharded step, as that test holds the data-parallel step, the first
moment there too and the second within 4e-2 (a square doubles the relative
error), each param within 2·lr (one AdamW step moves an element by at most
lr·(1 + weight decay · |p|)).  The two packages' unsharded bf16 gradients
already differ by up to 0.018 of a leaf's maximum at this size, which
leaves no room under 2e-2 for the sharded step's own rounding; jamba's
and the vlm's bf16 cases through their f32 cases (``BF16_HELD_BY_F32``);
the f32 cases hold the step to the reference: 1e-5 relative on the loss and 1e-4
of each leaf's maximum on the gradients and both moments, and each param
within 1e-4 of its leaf's maximum wherever the reference's gradient is at
least 1e-3 of its leaf's (a smaller one may take the other sign in either
package, and AdamW's first step moves its param by ±lr whatever its size),
within 2·lr elsewhere.
"""

import dataclasses
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import _torch_dist_ref as ref
from repro_torch._pytree import tree_leaves, tree_map
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.distributed import (
    NamedSharding,
    P,
    ShardedTensor,
    all_gather,
    axis_index,
    device_put,
    params_shardings,
    psum,
    psum_scatter,
    shard_map,
    sharded_train_step,
    train_rules,
    train_rules_sp,
)
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import _map_with_path
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.launch.train import _preset
from repro_torch.models import build_model
from repro_torch.models.lm import _vocab_parallel_log_likelihood
from repro_torch.optim import accumulate_gradients, adamw_init, adamw_update
from repro_torch.optim.adamw import global_norm
from repro_torch.optim.grad_accum import value_and_grad

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
CHILD = os.path.join(os.path.dirname(__file__), "_torch_dist_ref.py")
CPU = torch.device("cpu")
TRAIN_CASES = list(ref.TRAIN_CASES)
DENSE = ("qwen3-32b", "qwen2-72b", "command-r-35b", "deepseek-7b")
#: the SSM, MoE and hybrid families, admitted beside the dense one
FAMILIES = ("mamba2-1.3b", "mixtral-8x7b", "jamba-v0.1-52b")
#: MLA, cross-attention and the encoder
MEMORY_FAMILIES = ("deepseek-v2-236b", "llama-3.2-vision-11b", "whisper-tiny")
RULES = {"train_rules": train_rules, "train_rules_sp": train_rules_sp}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The child's outputs by name; ``"dir"``: its directory (the params
    are a checkpoint under ``params/`` there)."""
    path = str(tmp_path_factory.mktemp("tp_train_ref"))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, CHILD, path, "tp_train", "collective_grads"], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert f"RESULT {path}" in out.stdout
    with np.load(os.path.join(path, "out.npz")) as data:
        return {**data, "dir": path}


def _mesh(shape, axes):
    return compat_make_mesh(shape, axes, devices=(CPU,))


def _problem(reference, case):
    """The case's model, the reference's params (from the child's
    checkpoint), its mesh and blocks."""
    arch, ov, mesh_name, folder, _ = ref.TRAIN_CASES[case]
    model = build_model(dataclasses.replace(get_smoke_config(arch), **ov))
    template = model.init(torch.Generator().manual_seed(0), device="cpu", master=True)
    params, _, _ = Checkpointer(os.path.join(reference["dir"], folder)).restore(template)
    return (model, params, _mesh(*ref.TRAIN_MESHES[mesh_name]),
            _blocks(model.cfg, ref.TRAIN_SEQ.get(case, 16)))


def _rules(case, mesh):
    """The case's rules (``train_rules`` or ``train_rules_sp``) on ``mesh``."""
    return RULES[ref.TRAIN_CASES[case][4]](mesh)


def _blocks(cfg, seq: int = 16) -> dict[str, torch.Tensor]:
    """``ref.train_blocks`` as the port's tensors: tokens and labels in
    int64, a memory (frames, image embeddings) in f32."""
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v)
            for k, v in ref.train_blocks(cfg, seq).items()}


def _with_gates(params, value: float = 0.5):
    """``params`` with every cross-attention ``gate`` at ``value``: drawn
    0, as both packages draw it, ``tanh(gate)`` silences the cross layers
    and every gradient of their projections and of the encoder is 0."""
    def walk(node):
        if isinstance(node, dict):
            return {k: torch.full_like(v, value) if k == "gate" else walk(v)
                    for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def _assert_memory_path_trains(grads) -> None:
    """Every gradient leaf of the encoder and of the cross layers is
    nonzero: with a gate of 0 they would all be 0, and a check of them
    would check nothing."""
    names = _paths(grads)
    cross = {n.rsplit("/", 1)[0] for n in names if n.endswith("/wk_mem")}
    held = [(n, leaf) for n, leaf in zip(names, tree_leaves(grads))
            if n.startswith("enc_") or n.rsplit("/", 1)[0] in cross]
    assert cross and held
    for name, leaf in held:
        assert float(_full(leaf).abs().max()) > 0, f"{name}: a zero gradient"


def _paths(tree) -> list[str]:
    names: list[str] = []
    _map_with_path(lambda path, _: names.append("/".join(map(str, path))), tree)
    return names


def _full(x) -> torch.Tensor:
    return x.full() if isinstance(x, ShardedTensor) else x


def _from_reference(reference, key: str):
    """A param path's leaf of the child's outputs under ``key``."""
    return lambda name: reference[f"{key}/{name}"]


def _from_tree(tree):
    """A param path's leaf of a port tree, as numpy."""
    leaves = {n: _full(t).numpy() for n, t in zip(_paths(tree), tree_leaves(tree))}
    return leaves.__getitem__


def _assert_leaves(got, want, rel: float, what: str) -> None:
    """Each leaf of ``got`` within ``rel`` of the maximum of ``want(path)``."""
    for name, leaf in zip(_paths(got), tree_leaves(got)):
        w = want(name)
        g = _full(leaf).to(torch.float32).numpy()
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max()) or 1.0
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, f"{what}/{name}: {err} > {rel} · {scale}"


#: a bf16 case held through the f32 case of the same params and blocks:
#: bf16 rounding over jamba's period of 8 layers moves the port's unsharded
#: gradients by up to 1.07 of a leaf's maximum (0.32 of the tree's norm)
#: from the reference's f32 step, and the reference's own sharded bf16
#: gradients from its unsharded ones by up to 0.49 (``_torch_train_spread.py``),
#: so no leaf bound holds; the vlm's five layers move the port's unsharded
#: bf16 gradients by up to 0.038 of a leaf's maximum from the reference's
#: f32 ones, its sharded bf16 step 0.036 from its unsharded one, and the
#: reference's own sharded bf16 step 0.27 from its unsharded one
#: (``_torch_train_spread.py vlm``), so 2e-2 of a leaf's maximum does not
#: hold between two bf16 steps either; the sharded step is held no further from the f32
#: step, in the tree's norm, than ``BF16_NORM_FACTOR`` times the port's
#: unsharded bf16 step
BF16_HELD_BY_F32 = {"jamba/222": "jamba_f32/222", "vlm/222": "vlm_f32/222"}
BF16_NORM_FACTOR = 1.5
#: the second moment's bound where it is not 1e-4 (f32): v is (1 − β₂)·g²,
#: so its error over its leaf's maximum is twice the gradient's, and
#: jamba's f32 gradients move by 2.2e-5 of a leaf's maximum when its params
#: move by 1e-7 of themselves (``_torch_train_spread.py``)
V_RTOL = {"jamba_f32/222": 2e-4, "jamba_f32/24": 2e-4, "jamba_f32_sp/222": 2e-4}


def _tree_gap(got, want, *, of=None) -> float:
    """‖got − want‖ / ‖want‖ over a whole tree (``want``: a path's leaf,
    as numpy); ``of``: ``got`` a tree of numpy leaves by path instead."""
    num = den = 0.0
    for name, leaf in zip(_paths(got), tree_leaves(got)):
        g = of(name) if of is not None else _full(leaf).to(torch.float32).numpy()
        w = want(name)
        num += float(((g.astype(np.float64) - w) ** 2).sum())
        den += float((w.astype(np.float64) ** 2).sum())
    return (num / den) ** 0.5


def _assert_as_close_as_unsharded(got, unsharded, f32, what: str) -> None:
    """``got`` (a sharded bf16 tree) no further from the f32 step's tree
    ``f32`` than ``BF16_NORM_FACTOR`` times the unsharded bf16 tree."""
    mine = _tree_gap(got, f32)
    base = _tree_gap(got, f32, of=unsharded)
    assert mine <= BF16_NORM_FACTOR * base, f"{what}: {mine} > {BF16_NORM_FACTOR} · {base}"


def _is_f32(case: str) -> bool:
    return ref.TRAIN_CASES[case][1].get("dtype") == "float32"


def _assert_loss(loss, reference, key: str, f32: bool) -> None:
    if f32:
        np.testing.assert_allclose(float(loss), reference[f"{key}/loss"], rtol=1e-5)
        return
    for want in (reference[f"{key}/loss"], reference[f"{key}/loss_ref"]):
        np.testing.assert_allclose(float(loss), want, rtol=5e-3, atol=5e-3)


# ---------------------------------------------------------------------------
# the step against the reference's jax.jit under train_rules
# ---------------------------------------------------------------------------


#: the ``train_rules_sp`` cases whose 18 tokens a row the model axis (4)
#: does not divide: the stream stays whole, as the reference's ``shard``
#: drops the axis, so the rank program's collectives are ``train_rules``'
SP_WHOLE = ("qwen3_f32_sp_odd/24",)


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_gradients_match_reference(reference, case):
    """``tensor_parallel_gradients`` under the case's rules on the rank's
    shards: the loss and every gradient leaf, each held as the rank's
    shard in its param's layout (no leaf gathered whole over ``model``); in
    bf16 the gradients against the port's unsharded step (the module's
    docstring).  A ``train_rules_sp`` case over a length the model axis does
    not divide calls the collectives of the ``train_rules`` program."""
    model, params, mesh, blocks = _problem(reference, case)
    shardings = params_shardings(params, mesh, fsdp_axis="data")
    placed = device_put(params, shardings)
    with spmd.collective_census() as census:
        loss, grads = spmd.tensor_parallel_gradients(model.loss, placed, blocks, mesh=mesh,
                                                     rules=_rules(case, mesh))
    if case in SP_WHOLE:  # the stream the axis does not divide: train_rules' program
        with spmd.collective_census() as whole:
            spmd.tensor_parallel_gradients(model.loss, placed, blocks, mesh=mesh,
                                           rules=train_rules(mesh))
        assert census == whole
    key, f32 = f"tp_train/{case}", _is_f32(case)
    _assert_loss(loss, reference, key, f32)
    for g, sh, p in zip(tree_leaves(grads), tree_leaves(shardings), tree_leaves(params)):
        assert g.sharding == sh and g.dtype == torch.float32
        assert all(tuple(s.shape) == sh.shard_shape(tuple(p.shape)) for s in g.shards)
    if model.cfg.family in ("audio", "vlm"):
        _assert_memory_path_trains(grads)
    if f32:
        _assert_leaves(grads, _from_reference(reference, f"{key}/grads"), 1e-4, key)
    elif case in BF16_HELD_BY_F32:
        _, unsharded = accumulate_gradients(model.loss, params, blocks)
        _assert_as_close_as_unsharded(grads, _from_tree(unsharded), _from_reference(
            reference, f"tp_train/{BF16_HELD_BY_F32[case]}/grads"), key)
    else:
        _, unsharded = accumulate_gradients(model.loss, params, blocks)
        _assert_leaves(grads, _from_tree(unsharded), 2e-2, key)


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_step_matches_reference(reference, case):
    """``sharded_train_step(..., rules=...)`` under the case's rules: the loss, the
    new params and both AdamW moments, kept as ``model`` (and ``data``)
    shards in the params' layouts; in bf16 the params and moments against
    the port's unsharded step (the module's docstring), jamba's moments
    through its f32 case (``BF16_HELD_BY_F32``)."""
    model, params, mesh, blocks = _problem(reference, case)
    shardings = params_shardings(params, mesh, fsdp_axis="data")
    placed = device_put(params, shardings)
    new, opt, loss = sharded_train_step(model.loss, placed, adamw_init(params), blocks, mesh=mesh,
                                        lr=ref.TRAIN_LR, rules=_rules(case, mesh))
    key, f32 = f"tp_train/{case}", _is_f32(case)
    _assert_loss(loss, reference, key, f32)
    assert int(opt.step) == 1
    for tree in (new, opt.m, opt.v):
        for leaf, sh in zip(tree_leaves(tree), tree_leaves(shardings)):
            assert isinstance(leaf, ShardedTensor) and leaf.sharding == sh
    if f32:
        want_p, want_m, want_v = (_from_reference(reference, f"{key}/{name}")
                                  for name in ("params", "m", "v"))
    else:
        _, grads = accumulate_gradients(model.loss, params, blocks)
        p, o = adamw_update(tree_map(torch.clone, params), grads, adamw_init(params),
                            lr=ref.TRAIN_LR)
        want_p, want_m, want_v = _from_tree(p), _from_tree(o.m), _from_tree(o.v)
    if case in BF16_HELD_BY_F32:  # the moments and the update (new − old params)
        f32_key, old = f"tp_train/{BF16_HELD_BY_F32[case]}", _from_tree(params)
        moved = tree_map(lambda a, b: a - b, p, params)
        mine = tree_map(lambda a, b: ShardedTensor.from_global(_full(a) - b, a.sharding),
                        new, params)
        for name, tree, got in (("m", o.m, opt.m), ("v", o.v, opt.v), ("update", moved, mine)):
            want = (_from_reference(reference, f"{f32_key}/{name}") if name != "update" else
                    lambda n: reference[f"{f32_key}/params/{n}"] - old(n))
            _assert_as_close_as_unsharded(got, _from_tree(tree), want, f"{key}/{name}")
        return
    _assert_leaves(opt.m, want_m, 1e-4 if f32 else 2e-2, f"{key}/m")
    _assert_leaves(opt.v, want_v, V_RTOL.get(case, 1e-4) if f32 else 4e-2, f"{key}/v")
    for name, leaf in zip(_paths(new), tree_leaves(new)):
        got, want = _full(leaf).numpy(), want_p(name)
        err = np.abs(got - want)
        assert float(err.max()) <= 2 * ref.TRAIN_LR, name
        if f32:
            grad = np.abs(reference[f"{key}/grads/{name}"])
            firm = grad >= 1e-3 * grad.max()
            assert float(err[firm].max(initial=0)) <= 1e-4 * float(np.abs(want).max()), name


#: leaf -> (case, the path of its dict): leaves every model rank holds
#: whole and uses for its own share of the work, or (``gate``) after the
#: ranks' partials are summed
REPLICATED = {"q_norm": ("qwen3_f32/24", "seg0/0/mixer"),
              "k_norm": ("qwen3_f32/24", "seg0/0/mixer"),
              "wk": ("qwen3_f32/24", "seg0/0/mixer"), "wv": ("qwen3_f32/24", "seg0/0/mixer"),
              "router": ("mixtral_f32/24", "seg0/0/mlp"),
              "w_in_b": ("mamba2_f32/24", "seg0/0/mixer"),
              "w_in_c": ("mamba2_f32/24", "seg0/0/mixer"),
              "conv_b": ("mamba2_f32/24", "seg0/0/mixer"),
              "conv_c": ("mamba2_f32/24", "seg0/0/mixer"),
              "wq_a": ("deepseek_v2_f32/24", "seg0/0/mixer"),
              "wkv_a": ("deepseek_v2_f32/24", "seg0/0/mixer"),
              "q_norm_a": ("deepseek_v2_f32/24", "seg0/0/mixer"),
              "kv_norm_a": ("deepseek_v2_f32/24", "seg0/0/mixer"),
              "wk_mem": ("vlm_f32/24", "seg0/4/mixer"), "wv_mem": ("vlm_f32/24", "seg0/4/mixer"),
              "gate": ("vlm_f32/24", "seg0/4/mixer"),
              # under train_rules_sp: weights applied to each rank's rows of the stream
              "sp/ln1": ("qwen3_f32_sp/24", "seg0/0"), "sp/ln2": ("qwen3_f32_sp/24", "seg0/0"),
              "sp/final_norm": ("qwen3_f32_sp/24", ""),
              "sp/ln1_b": ("whisper_f32_sp/24", "enc_seg0/0"),
              "sp/enc_final_norm": ("whisper_f32_sp/24", ""),
              "sp/gate": ("vlm_f32_sp/222", "seg0/4/mixer")}


@pytest.mark.parametrize("leaf", list(REPLICATED))
def test_replicated_params_get_their_whole_gradient(reference, leaf):
    """On (2, 4) the smoke configs' ``q_norm``/``k_norm`` (replicated, used
    on each rank's own heads), ``wk``/``wv`` (replicated: 2 kv heads do not
    divide 4, so each rank projects its share of the rows), mixtral's
    ``router`` (every rank routes every token, but only its own experts'
    gates reach its combine), mamba2's ``w_in_b``, ``w_in_c``, ``conv_b``
    and ``conv_c`` (the B and C every rank's heads read), deepseek-v2's
    MLA down-projections ``wq_a``/``wkv_a`` and their norms (each rank
    projects its share of the rows, which every rank's heads read), and
    the vlm's ``wk_mem``/``wv_mem`` (replicated: each rank projects its
    share of the memory rows) get the sum of the ranks' partials: the whole
    gradient, on every model rank.  So does the vlm's cross ``gate``, which
    scales the output after its ``psum`` and so is counted once.  Under
    ``train_rules_sp`` (``sp/``) the weights each rank applies to its own
    rows of the stream get the sum too: qwen3's ``ln1``, ``ln2`` and final
    norm, whisper's encoder norms (a layernorm's bias, the final norm
    before the memory's gather) and the vlm's cross ``gate``, which then
    scales the rank's rows."""
    case, where = REPLICATED[leaf]
    leaf = leaf.rsplit("/", 1)[-1]
    model, params, mesh, blocks = _problem(reference, case)
    placed = device_put(params, params_shardings(params, mesh, fsdp_axis="data"))
    _, grads = spmd.tensor_parallel_gradients(model.loss, placed, blocks, mesh=mesh,
                                              rules=_rules(case, mesh))
    g = grads
    for step in filter(None, where.split("/")):
        g = g[int(step)] if step.isdigit() else g[step]
    g = g[leaf]
    assert "model" not in {a for e in g.sharding.spec if e for a in spmd._axes(e)}
    want = reference[f"tp_train/{case}/grads/{where + '/' if where else ''}{leaf}"]
    scale = float(np.abs(want).max())
    assert scale > 0
    for r in range(mesh.size):  # every rank holds the sum, not its partial
        block = g.shards[r].numpy()
        np.testing.assert_allclose(block, want[g.sharding.index(r, want.shape)],
                                   atol=1e-4 * scale, rtol=0)


# ---------------------------------------------------------------------------
# the collectives' transposes against jax.grad
# ---------------------------------------------------------------------------


class _Port:
    psum = staticmethod(psum)
    psum_scatter = staticmethod(psum_scatter)
    all_gather = staticmethod(all_gather)
    axis_index = staticmethod(axis_index)
    pvary = staticmethod(spmd.pvary)


@pytest.mark.parametrize("route", ["node", "segments"])
@pytest.mark.parametrize("name", list(ref.GRAD_PRIMITIVES))
def test_collective_gradient_matches_jax(reference, name, route):
    """Each collective's gradient through a ``shard_map`` body whose loss
    every rank holds alike: ``psum`` passes the cotangent to the rank's
    operand, ``all_gather`` returns the ``psum_scatter`` of it and
    ``psum_scatter`` the ``all_gather``, ``pvary`` the ``psum``.  ``node``:
    ``torch.autograd.grad`` in the rank's thread, through the collectives'
    autograd nodes (a CPU graph's backward runs in the calling thread);
    ``segments``: ``value_and_grad``, the backward in segments."""
    kind, body = ref.GRAD_PRIMITIVES[name]
    spec = P(ref.GRAD_KINDS[kind][1])
    v, w = (torch.from_numpy(a) for a in ref.grad_inputs(kind))

    def rank(vl, wl):
        if route == "segments":
            return value_and_grad(lambda p, b: body(_Port, p, b["w"]), vl, {"w": wl})[1]
        vd = vl.detach().requires_grad_()
        return torch.autograd.grad(body(_Port, vd, wl), vd)[0]

    got = shard_map(rank, mesh=_mesh((2, 4), ("data", "model")), in_specs=(spec, spec),
                    out_specs=spec)(v, w)
    np.testing.assert_allclose(got.numpy(), reference[f"collective_grad/{name}"], rtol=1e-5,
                               atol=1e-5)


def test_pmax_carries_no_gradient():
    def rank(vl):
        top = spmd.pmax(vl.detach().requires_grad_(), "model")
        return torch.tensor([float(top.requires_grad)])

    got = shard_map(rank, mesh=_mesh((2, 4), ("data", "model")), in_specs=(P(("data", "model")),),
                    out_specs=P(("data", "model")))(torch.ones(8))
    assert not got.any()


def test_a_node_backward_outside_its_rank_thread_raises():
    """A collective's autograd node whose backward runs on another thread
    (as a CUDA graph's runs on the card's autograd thread) raises rather
    than wait for a rendezvous no rank can join."""
    seen: dict = {}

    def grad_elsewhere(y, x):
        try:
            torch.autograd.grad((y * y).sum(), x)
        except RuntimeError as err:
            return err
        return None

    def rank(vl):
        x = vl.detach().requires_grad_()
        y = spmd.pvary(x, "model")  # no tape outside value_and_grad: an autograd node
        if axis_index("model") == 0:
            t = threading.Thread(target=lambda: seen.setdefault("error", grad_elsewhere(y, x)))
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
        return vl

    shard_map(rank, mesh=_mesh((1, 2), ("data", "model")), in_specs=(P("data"),),
              out_specs=P("data"))(torch.ones(2, 3))
    err = seen["error"]
    assert isinstance(err, RuntimeError) and "not its rank's" in str(err)


def test_rank_backward_runs_in_segments(reference, monkeypatch):
    """The train program's ranks differentiate through no collective node:
    with the nodes refused, the gradients are the same."""
    model, params, mesh, blocks = _problem(reference, "qwen3_f32/24")
    placed = device_put(params, params_shardings(params, mesh, fsdp_axis="data"))
    _, want = spmd.tensor_parallel_gradients(model.loss, placed, blocks, mesh=mesh,
                                             rules=train_rules(mesh))

    def refused(*args):
        raise AssertionError("a collective's autograd node in a rank's forward")

    monkeypatch.setattr(spmd._Transposed, "apply", refused)
    _, got = spmd.tensor_parallel_gradients(model.loss, placed, blocks, mesh=mesh,
                                            rules=train_rules(mesh))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a.full(), b.full())


# ---------------------------------------------------------------------------
# the vocabulary-parallel loss and the clipped norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("padded", [False, True])
def test_vocab_parallel_log_likelihood_matches_log_softmax(padded):
    """Each rank's block of f32 logits (the padding masked, as ``_logits``
    masks it) and the labels in every block: the label's log-probability
    equals ``log_softmax``'s over the whole row within 1e-6."""
    g = torch.Generator().manual_seed(5)
    logits = torch.randn((4, 6, 32), generator=g) * 3
    if padded:
        logits[..., 29:] = -1e30
    labels = torch.randint(0, 29 if padded else 32, (4, 6), generator=g)
    want = torch.gather(torch.log_softmax(logits, -1), -1, labels[..., None])[..., 0]

    def rank(lg, lab):
        with spmd.tensor_parallel_scope(spmd.TensorParallel()):
            return _vocab_parallel_log_likelihood(lg, lab)

    got = shard_map(rank, mesh=_mesh((2, 4), ("data", "model")),
                    in_specs=(P("data", None, "model"), P("data")), out_specs=P("data"))(
        logits, labels)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def _held_to_unsharded(cfg, shape=(2, 4), axes=("data", "model"), rules=train_rules):
    """The tensor-parallel loss and gradients of ``cfg`` (its cross gates
    at 0.5) on the mesh under ``rules`` against the unsharded
    ``Model.loss``: the loss within 1e-6, every gradient within 1e-4 of its
    leaf's maximum.  Returns the sharded gradients."""
    model = build_model(cfg)
    params = _with_gates(model.init(torch.Generator().manual_seed(0), device="cpu",
                                    master=True))
    blocks = _blocks(model.cfg)
    loss_ref, grads_ref = accumulate_gradients(model.loss, params, blocks)
    mesh = _mesh(shape, axes)
    placed = device_put(params, params_shardings(params, mesh, fsdp_axis="data"))
    loss, grads = spmd.tensor_parallel_gradients(model.loss, placed, blocks, mesh=mesh,
                                                 rules=rules(mesh))
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-6)
    for name, a, b in zip(_paths(grads), tree_leaves(grads), tree_leaves(grads_ref)):
        assert float((a.full() - b).abs().max()) <= 1e-4 * float(b.abs().max()), name
    return grads


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("arch", DENSE + FAMILIES + MEMORY_FAMILIES)
def test_loss_and_gradients_match_the_unsharded_model(arch, rules):
    """Each smoke config in f32 (command-r's head tied, qwen2's qkv
    biases, deepseek's 4 kv heads split over 4; mamba2's SSM heads, 2 a
    rank; mixtral's experts, 1 a rank; jamba's period of 7 mamba2 layers, an
    attention layer and 4 MoE MLPs; deepseek-v2's MLA heads, 1 a rank, its
    down-projections by rows; the vlm's cross layer, its 2 kv heads
    replicated; whisper's encoder and cross layers, tied head): the
    tensor-parallel loss on (2, 4) within 1e-6 of the unsharded
    ``Model.loss``, every gradient within 1e-4 of its leaf's maximum, and
    the cross layers' and the encoder's gradients nonzero; under
    ``train_rules`` and under ``train_rules_sp``, whose residual stream
    each rank holds as its 4 of the 16 rows (command-r's parallel block:
    one gather of the normed rows, one reduce-scatter of the summed
    partials; whisper's 24 encoder frames 6 a rank)."""
    grads = _held_to_unsharded(dataclasses.replace(get_smoke_config(arch), dtype="float32"),
                               rules=RULES[rules])
    if arch in MEMORY_FAMILIES[1:]:
        _assert_memory_path_trains(grads)


WHOLE_HEADS = [("whisper-tiny", 6), ("llama-3.2-vision-11b", 2), ("deepseek-v2-236b", 6)]


@pytest.mark.parametrize("arch,kv_heads", WHOLE_HEADS)
def test_heads_the_model_axis_does_not_divide_train_whole(arch, kv_heads):
    """Six heads over a model axis of 4 (whisper-tiny's at full width): each
    rank computes the attention, cross-attention or MLA layer whole, its
    k/v, memory and down-projections too (a gather of rows that every rank
    computes alike would have its transpose sum their cotangents four
    times), while the MLP and the vocabulary stay split; held to the
    unsharded model as above."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", num_heads=6,
                              num_kv_heads=kv_heads, head_dim=16)
    grads = _held_to_unsharded(cfg)
    if arch != "deepseek-v2-236b":
        _assert_memory_path_trains(grads)


@pytest.mark.parametrize("arch,kv_heads", WHOLE_HEADS + [("command-r-35b", 6)])
def test_whole_layers_on_the_ranks_rows_under_sequence_parallel(arch, kv_heads):
    """The six heads of the test above under ``train_rules_sp``: each rank
    gathers its 4 of the 16 rows, computes such a layer whole and keeps its
    rows of the output, every weight of the layer through ``pvary`` (its
    cotangent covers the rank's rows); command-r's parallel block, whose
    attention then runs whole beside its split MLP, gathers and scatters
    each apart.  Held to the unsharded model as above."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", num_heads=6,
                              num_kv_heads=kv_heads, head_dim=16)
    grads = _held_to_unsharded(cfg, rules=train_rules_sp)
    if arch in MEMORY_FAMILIES[1:]:
        _assert_memory_path_trains(grads)


def test_mla_without_a_q_down_projection_under_sequence_parallel():
    """deepseek-v2's smoke config without ``wq_a`` (``q_lora_rank=0``, q
    projected straight from the stream) under ``train_rules_sp``: the rank's
    rows feed the latent's down-projection as they are, and q takes the
    gathered rows; held to the unsharded model as above."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-v2-236b"), dtype="float32",
                              q_lora_rank=0)
    _held_to_unsharded(cfg, rules=train_rules_sp)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_encoder_gradients_through_recomputed_periods(shape):
    """Whisper's smoke config in f32 under ``remat="full"`` (its default),
    the cross gates at 0.5: each decoder period is recomputed in the
    rank's backward and closes over the encoder's output, so the
    cotangent every period sends into it must reach every encoder layer.
    Each ``enc_seg0`` gradient is nonzero and within 1e-4 of its leaf's
    maximum of the unsharded model's."""
    cfg = dataclasses.replace(get_smoke_config("whisper-tiny"), dtype="float32")
    assert cfg.remat == "full"
    grads = _held_to_unsharded(cfg, shape)
    enc = [leaf for name, leaf in zip(_paths(grads), tree_leaves(grads))
           if name.startswith("enc_seg0/")]
    assert enc and all(float(leaf.full().abs().max()) > 0 for leaf in enc)


def test_recomputed_period_carries_the_cotangent_of_what_it_closes_over():
    """A rank's tape recomputes a period (``recompute=True``) that closes
    over ``m``, computed before the period and cut from its producer by a
    ``psum`` (as whisper's decoder periods read the encoder's output): the
    cotangent the recomputation gives ``m`` goes on to ``m``'s producer.
    On (1, 2) ranks, ``we`` split by columns and ``wo`` by rows as Megatron
    splits an MLP, every gradient equals plain autograd's of the unsharded
    function within 1e-6."""
    g = torch.Generator().manual_seed(13)
    x = torch.randn((4, 6), generator=g)
    params = {"u": torch.randn((6, 6), generator=g), "v": torch.randn((6, 6), generator=g),
              "we": torch.randn((6, 8), generator=g), "wo": torch.randn((8, 6), generator=g)}

    def loss(p, b, period=lambda body, z: body(z), pvary=lambda t: t, psum=lambda t: t):
        m = psum(torch.tanh(pvary(b["x"]) @ p["we"]) @ p["wo"])
        z = b["x"] @ p["u"]
        y = period(lambda t: torch.tanh(t @ p["v"]) * m, z)
        return (y ** 2).sum()

    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    want = torch.autograd.grad(loss(leaves, {"x": x}), list(leaves.values()))

    def rank_loss(p, b):
        tape = spmd.recording_tape()
        assert tape is not None
        return loss(p, b, period=lambda body, z: tape.period(body, z, recompute=True),
                    pvary=lambda t: spmd.pvary(t, "model"), psum=lambda t: psum(t, "model"))

    specs = {"u": P(), "v": P(), "we": P(None, "model"), "wo": P("model")}
    got = shard_map(lambda p, xl: value_and_grad(rank_loss, p, {"x": xl})[1],
                    mesh=_mesh((1, 2), ("data", "model")), in_specs=(specs, P()),
                    out_specs=specs)(params, x)
    for name, w in zip(params, want):
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_clipped_norm_counts_a_replicated_leaf_once():
    """The global norm of gradients held as shards: a leaf split over
    ``model`` and ``data``, one replicated over every axis and one split
    over ``model`` alone, on (2, 2, 2); the norm equals ``global_norm`` of
    the whole tree, where counting each rank's copy would give more."""
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    g = torch.Generator().manual_seed(7)
    tree = {"split": torch.randn((4, 6), generator=g), "whole": torch.randn((5,), generator=g),
            "model": torch.randn((4, 3), generator=g)}
    specs = {"split": P("model", "data"), "whole": P(), "model": P("model")}
    placed = {k: device_put(v, NamedSharding(mesh, specs[k])) for k, v in tree.items()}
    got = shard_map(lambda t: spmd._sharded_norm(t, specs).reshape(1), mesh=mesh,
                    in_specs=(specs,), out_specs=P())(placed)
    np.testing.assert_allclose(float(got), float(global_norm(tree)), rtol=1e-6)


@pytest.mark.parametrize("route", ["node", "segments"])
def test_split_rms_norm_sums_its_normaliser_cotangent(route):
    """``rms_norm(..., axis="model")`` on each rank's block of the channels
    (mamba2's gated norm over its heads): the ``psum``'d sum of squares
    scales every rank's channels, so its cotangent is the sum of the ranks'
    (``pvary`` after the ``psum``).  The gradients of the rank's input and
    weight blocks equal the unsharded norm's within 1e-6."""
    from repro_torch.models.layers import rms_norm

    g = torch.Generator().manual_seed(11)
    x, w, c = (torch.randn(shape, generator=g) for shape in ((4, 16), (16,), (4, 16)))
    xd, wd = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad((rms_norm(xd, wd) * c).sum(), (xd, wd))

    def loss(p, b):
        return psum((rms_norm(p["x"], p["w"], axis="model") * b["c"]).sum(), ("data", "model"))

    def rank(xl, wl, cl):
        if route == "segments":
            grads = value_and_grad(loss, {"x": xl, "w": wl}, {"c": cl})[1]
            gx, gw = grads["x"], grads["w"]
        else:
            p = {"x": xl.detach().requires_grad_(), "w": wl.detach().requires_grad_()}
            gx, gw = torch.autograd.grad(loss(p, {"c": cl}), (p["x"], p["w"]))
        with torch.no_grad():  # w's gradient from the rank's rows, summed over data
            return gx, psum(gw, "data")

    gx, gw = shard_map(rank, mesh=_mesh((2, 4), ("data", "model")),
                       in_specs=(P("data", "model"), P("model"), P("data", "model")),
                       out_specs=(P("data", "model"), P("model")))(x, w, c)
    np.testing.assert_allclose(gx.numpy(), want[0].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), want[1].numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("program", ["tensor_parallel", "data_parallel"])
def test_route_recorder_records_a_forward_once_on_ranks(reference, program, remat):
    """Mixtral's smoke step on (2, 2, 2) ranks with ``moe_mlp.routes`` on:
    one record per MoE layer and block, each the whole block's routes (the
    mesh's first rank records them), whether the rank recomputes a period
    in its tape's backward (``remat="full"``), keeps its graph or runs it
    under ``torch.utils.checkpoint``; and the records equal the unsharded
    forward's."""
    from repro_torch.models.moe import moe_mlp

    model, params, mesh, blocks = _problem(reference, "mixtral_cf1/222")
    model = build_model(dataclasses.replace(model.cfg, remat=remat))
    placed = device_put(params, params_shardings(params, mesh, fsdp_axis="data"))
    moe_mlp.routes = []
    try:
        with torch.no_grad():
            for i in range(blocks["tokens"].shape[0]):
                model.loss(params, {k: v[i] for k, v in blocks.items()})
        want, moe_mlp.routes = moe_mlp.routes, []
        if program == "tensor_parallel":
            spmd.tensor_parallel_gradients(model.loss, placed, blocks, mesh=mesh,
                                           rules=train_rules(mesh))
        else:
            spmd.data_parallel_gradients(model.loss, placed, blocks, mesh=mesh)
        got = moe_mlp.routes
    finally:
        moe_mlp.routes = None
    assert len(want) == model.cfg.num_layers * blocks["tokens"].shape[0] == len(got)
    for a, b in zip(got, want):
        assert all(torch.equal(a[k], b[k]) for k in ("experts", "dropped"))


@pytest.mark.parametrize("attn_impl", ["ref", "flash"])
def test_rank_training_forward_launches_no_kernel(monkeypatch, attn_impl):
    """A rank's training forward takes the plain attention and SSD routes
    in both passes of a recomputed period (``remat="full"``: the tape's
    first pass runs without autograd), as the reference's training step
    runs its plain functions: jamba's smoke period on (2, 4) over 32-token
    rows (two SSD chunks, so the chunked route runs), the kernel wrappers
    refused, and the gradients equal to the unsharded step's within 1e-4
    of each leaf's maximum."""
    from repro_torch.kernels import ops

    def refused(*args, **kwargs):
        raise AssertionError("a kernel wrapper in a training forward")

    cfg = dataclasses.replace(get_smoke_config("jamba-v0.1-52b"), dtype="float32",
                              attn_impl=attn_impl)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu", master=True)
    g = torch.Generator().manual_seed(1)
    blocks = {k: torch.randint(0, cfg.vocab_size, (1, 4, 2 * cfg.ssm_chunk), generator=g)
              for k in ("tokens", "labels")}
    _, want = accumulate_gradients(model.loss, params, blocks)
    monkeypatch.setattr(ops, "ssd_scan", refused)
    monkeypatch.setattr(ops, "flash_attention", refused)
    mesh = _mesh((2, 4), ("data", "model"))
    placed = device_put(params, params_shardings(params, mesh, fsdp_axis="data"))
    _, grads = spmd.tensor_parallel_gradients(model.loss, placed, blocks, mesh=mesh,
                                              rules=train_rules(mesh))
    for a, b in zip(tree_leaves(grads), tree_leaves(want)):
        assert float((a.full() - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_data_parallel_moe_backward_runs_in_segments(reference, monkeypatch):
    """The data-parallel step's MoE ranks, whose token rows are gathered over
    the data axes (mixtral at capacity factor 1 on (2, 2, 2)), differentiate
    through no collective node, as they must on a card: with the nodes
    refused, the loss and gradients still match the reference's within its
    f32 bounds.  A dense model's data-parallel ranks call no collective and
    keep PyTorch's one-pass backward (no tape)."""
    def refused(*args):
        raise AssertionError("a collective's autograd node in a rank's forward")

    monkeypatch.setattr(spmd._Transposed, "apply", refused)
    case = "mixtral_cf1/222"
    model, params, mesh, blocks = _problem(reference, case)
    loss, grads = spmd.data_parallel_gradients(model.loss, device_put(
        params, params_shardings(params, mesh)), blocks, mesh=mesh)
    key = f"tp_train/{case}"
    np.testing.assert_allclose(float(loss), reference[f"{key}/loss"], rtol=1e-5)
    _assert_leaves(grads, _from_reference(reference, f"{key}/grads"), 1e-4, key)

    def no_tape(*args, **kwargs):
        raise AssertionError("a dense data-parallel rank ran its backward in segments")

    monkeypatch.setattr(spmd._Tape, "backward", no_tape)
    dense, dense_params, _, dense_blocks = _problem(reference, "qwen3_f32/222")
    spmd.data_parallel_gradients(dense.loss, dense_params, dense_blocks, mesh=mesh)


# ---------------------------------------------------------------------------
# what the program refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_training_refusal_names_each_family(arch):
    """Every config of the repo is admitted, the dense, SSM, MoE, hybrid,
    MLA, vision and audio families alike; the ragged MoE dispatch is
    refused with its reason, by the model and by the program."""
    model = build_model(get_smoke_config(arch))
    assert model.tensor_parallel_training_refusal() is None
    if not model.cfg.moe_experts:
        return
    ragged = build_model(dataclasses.replace(model.cfg, moe_impl="ragged"))
    assert "ragged" in ragged.tensor_parallel_training_refusal()
    mesh = _mesh((1, 2), ("data", "model"))
    params = ragged.init(torch.Generator().manual_seed(0), device="cpu", master=True)
    blocks = {k: torch.zeros((1, 2, 4), dtype=torch.int64) for k in ("tokens", "labels")}
    with pytest.raises(NotImplementedError, match="ragged"):
        spmd.tensor_parallel_gradients(ragged.loss, params, blocks, mesh=mesh,
                                       rules=train_rules(mesh))


@pytest.mark.parametrize("preset", ["lm1m", "lm20m", "lm100m"])
def test_presets_are_admitted(preset):
    assert build_model(_preset(preset)).tensor_parallel_training_refusal() is None


@pytest.mark.parametrize("rules", ["decode_rules", "long_decode_rules"])
def test_train_step_refuses_rules_it_does_not_implement(rules):
    """The tensor-parallel train step runs the programs of ``train_rules``'
    logical map and of ``train_rules_sp``'s; handed serving rules with
    another map (the heads whole and the KV sequence over ``model``, or over
    ``data``) it raises, from ``sharded_train_step`` and
    ``tensor_parallel_gradients`` alike, rather than run another program
    under their name."""
    from repro_torch.distributed import sharding

    model = build_model(dataclasses.replace(get_smoke_config("qwen3-32b"), dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu", master=True)
    blocks = _blocks(model.cfg)
    mesh = _mesh((2, 4), ("data", "model"))
    placed = device_put(params, params_shardings(params, mesh, fsdp_axis="data"))
    with pytest.raises(ValueError, match="runs train_rules or train_rules_sp"):
        sharded_train_step(model.loss, placed, adamw_init(params), blocks, mesh=mesh,
                           lr=ref.TRAIN_LR, rules=getattr(sharding, rules)(mesh))
    with pytest.raises(ValueError, match="runs train_rules or train_rules_sp"):
        spmd.tensor_parallel_gradients(model.loss, placed, blocks, mesh=mesh,
                                       rules=getattr(sharding, rules)(mesh))
