"""The port's distribution substrate against the JAX package's.

Every mode of ``tests/_dist_child.py`` but ``mesh_exec`` (which
``tests/test_torch_mesh_executor.py`` covers): ``hier_psum``,
``compressed_psum``, ``gpipe``, ``sharded_train``, ``elastic_restore``,
``cache_write`` and ``heads_cache``, and the ``jax.lax`` collectives on the
same mesh shapes; and the MoE groups of the data-parallel train step.
The reference side runs once, in one child process on 8 forced host
devices (``tests/_torch_dist_ref.py``); the port side runs here, its ranks
repeated ``cpu`` devices in this process.  Both draw the
same numpy inputs.  Beside the parity: reductions are bit-identical across
runs, a raising rank re-raises without a hang, ranks that disagree on a
collective raise, and a stress run with many rank threads keeps exact sums.
"""

import dataclasses
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import _torch_dist_ref as ref
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import (
    NamedSharding,
    P,
    ShardedTensor,
    all_gather,
    axis_index,
    compressed_psum_pod,
    data_parallel_gradients,
    decode_rules,
    decode_rules_headsharded,
    device_put,
    gpipe,
    hierarchical_psum,
    params_shardings,
    ppermute,
    psum,
    psum_scatter,
    shard_map,
    sharded_train_step,
    use_rules,
)
from repro_torch.distributed import spmd
from repro_torch.launch.mesh import compat_make_mesh, make_production_mesh, make_test_mesh
from repro_torch.models import build_model, layers
from repro_torch.models.layers import _cache_write_sharded, cache_write
from repro_torch.optim import accumulate_gradients, adamw_init, adamw_update

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
CHILD = os.path.join(os.path.dirname(__file__), "_torch_dist_ref.py")
CPU = torch.device("cpu")


def _mesh(shape, axes):
    return compat_make_mesh(shape, axes, devices=(CPU,))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The child's outputs by name; ``"dir"``: its directory (the train
    step's params are a checkpoint under ``params/`` there)."""
    path = str(tmp_path_factory.mktemp("dist_ref"))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, CHILD, path], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert f"RESULT {path}" in out.stdout
    with np.load(os.path.join(path, "out.npz")) as data:
        return {**data, "dir": path}


def _replicated(mesh):
    return lambda f: shard_map(f, mesh=mesh, in_specs=(P(),), out_specs=P(), check_vma=False)


# ---------------------------------------------------------------------------
# the modes of tests/_dist_child.py
# ---------------------------------------------------------------------------


def test_hier_psum_matches_reference(reference):
    sm = _replicated(_mesh((2, 4), ("pod", "data")))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32))
    got = sm(lambda v: hierarchical_psum(v, fast_axis="data", slow_axis="pod"))(x)
    flat = sm(lambda v: psum(v, ("data", "pod")))(x)
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), 8 * x.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), reference["hier_psum/hier"], rtol=1e-6)
    np.testing.assert_allclose(flat.numpy(), reference["hier_psum/flat"], rtol=1e-6)


def test_compressed_psum_matches_reference(reference):
    sm = _replicated(_mesh((2, 4), ("pod", "data")))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((16, 32)).astype(np.float32))
    got = sm(lambda v: compressed_psum_pod(v, fast_axis="data", slow_axis="pod"))(x).numpy()
    want = 8 * x.numpy()
    # int8 per-row quantization: |err| ≤ pods · scale/2, scale = rowmax/127
    bound = 2 * (np.abs(want).max(axis=-1, keepdims=True) / 127.0) * 1.01 + 1e-6
    assert (np.abs(got - want) <= bound).all()
    # the same quantization as the reference's (half to even, per-row scales)
    np.testing.assert_allclose(got, reference["compressed_psum"], rtol=1e-6, atol=1e-6)


def _gpipe_inputs():
    s, t, mb, d = 4, 6, 8, 16
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((s, d, d)) / np.sqrt(d)).astype(np.float32)
    b = (rng.standard_normal((s, d)) * 0.1).astype(np.float32)
    xs = rng.standard_normal((t, mb, d)).astype(np.float32)
    return torch.from_numpy(w), torch.from_numpy(b), torch.from_numpy(xs)


def test_gpipe_matches_reference(reference):
    w, b, xs = _gpipe_inputs()
    got = gpipe(lambda p, x: torch.tanh(x @ p["w"] + p["b"]), {"w": w, "b": b}, xs,
                mesh=_mesh((4, 2), ("pipe", "data")), axis="pipe")
    want = xs
    for i in range(w.shape[0]):  # the 4 stages applied in order
        want = torch.tanh(want @ w[i] + b[i])
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), reference["gpipe"], rtol=2e-5, atol=2e-5)


def _train_problem(reference):
    """qwen3's smoke config, the reference's params (the child's
    ``key(0)`` draw, read from its checkpoint) and the blocks from
    ``default_rng(3)``."""
    cfg = get_smoke_config("qwen3-32b")
    model = build_model(cfg)
    template = model.init(torch.Generator().manual_seed(0), device="cpu", master=True)
    params, _, _ = Checkpointer(os.path.join(reference["dir"], "params")).restore(template)
    rng = np.random.default_rng(3)
    blocks = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8, 16)).astype(np.int64))
              for k in ("tokens", "labels")}
    return model, params, blocks


def test_sharded_train_step_matches_reference(reference, monkeypatch):
    model, params, blocks = _train_problem(reference)
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    placed = device_put(params, params_shardings(params, mesh))
    assert isinstance(placed["embed"], ShardedTensor)
    loss_ref, grads_ref = accumulate_gradients(model.loss, params, blocks, mode="spliter")
    seen = []

    def recording(*args, **kwargs):
        seen.append(data_parallel_gradients(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(spmd, "data_parallel_gradients", recording)
    new, opt, loss = sharded_train_step(model.loss, placed, adamw_init(params), blocks,
                                        mesh=mesh, lr=1e-3)
    ((loss_dp, grads_dp),) = seen
    # the reference's bound (tests/_dist_child.py:139), against the port's
    # unsharded step and the reference's sharded and unsharded steps
    for want in (float(loss_ref), float(reference["sharded_train/loss"]),
                 float(reference["sharded_train/loss_ref"])):
        np.testing.assert_allclose(float(loss), want, rtol=5e-3, atol=5e-3)
    assert float(loss) == float(loss_dp)
    for g, gr in zip(jax.tree.leaves(grads_dp), jax.tree.leaves(grads_ref)):
        scale = float(gr.abs().max()) or 1.0
        assert float((g - gr).abs().max()) <= 2e-2 * scale
    # the params keep their layouts and moved
    assert new["embed"].sharding == placed["embed"].sharding
    assert int(opt.step) == 1
    assert not torch.equal(new["embed"].full(), params["embed"])
    # the update equals an unsharded AdamW step from the same gradients, bit
    # for bit: the sharded step gathers the params (a copy), runs the same
    # adamw_update on the same device and splits the result
    want_p, want_opt = adamw_update(jax.tree.map(torch.clone, params), grads_dp,
                                    adamw_init(params), lr=1e-3)
    got_p = jax.tree.map(lambda p: p.full() if isinstance(p, ShardedTensor) else p, new,
                         is_leaf=lambda x: isinstance(x, ShardedTensor))
    assert int(want_opt.step) == int(opt.step)
    for got_tree, want_tree in ((got_p, want_p), (opt.m, want_opt.m), (opt.v, want_opt.v)):
        got_leaves, want_leaves = jax.tree.leaves(got_tree), jax.tree.leaves(want_tree)
        assert len(got_leaves) == len(want_leaves) == len(jax.tree.leaves(params))
        for g, w in zip(got_leaves, want_leaves):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_moe_groups_of_the_data_parallel_step_match_reference(reference):
    """Mixtral's smoke config in f32 at capacity factor 1 (below E/k = 2:
    the groups drop choices): each 8-row block is one
    128-token group, and a data-parallel rank of (2, 2, 2) holds 2 rows (32
    tokens), not a whole group.  The data-parallel step groups the whole
    batch's tokens, as the reference's ``jax.jit`` under ``train_rules``
    does: the loss within 1e-5 and every gradient within 1e-4 of its leaf's
    maximum (f32).  Grouping a rank's own tokens gives other capacities and
    drops, and another loss."""
    from repro_torch._pytree import tree_leaves
    from repro_torch.distributed.sharding import _map_with_path
    from repro_torch.models.moe import moe_mlp

    case = "mixtral_cf1/222"
    arch, ov, mesh_name, folder, _ = ref.TRAIN_CASES[case]
    model = build_model(dataclasses.replace(get_smoke_config(arch), **ov))
    template = model.init(torch.Generator().manual_seed(0), device="cpu", master=True)
    params, _, _ = Checkpointer(os.path.join(reference["dir"], folder)).restore(template)
    blocks = {k: torch.from_numpy(v.astype(np.int64))
              for k, v in ref.train_blocks(model.cfg).items()}
    mesh = _mesh(*ref.TRAIN_MESHES[mesh_name])
    cfg = model.cfg
    tokens = blocks["tokens"].shape[1] * blocks["tokens"].shape[2]
    rank_tokens = tokens // (mesh.shape["pod"] * mesh.shape["data"])
    assert min(cfg.moe_group, tokens) == tokens and rank_tokens % tokens  # not whole groups
    moe_mlp.routes = []
    try:
        with torch.no_grad():
            model.loss(params, {k: v[0] for k, v in blocks.items()})
        dropped = sum(int(r["dropped"].sum()) for r in moe_mlp.routes)
    finally:
        moe_mlp.routes = None
    assert dropped > 0
    placed = device_put(params, params_shardings(params, mesh))
    loss, grads = data_parallel_gradients(model.loss, placed, blocks, mesh=mesh)
    key = f"tp_train/{case}"
    np.testing.assert_allclose(float(loss), reference[f"{key}/loss"], rtol=1e-5)
    names: list[str] = []
    _map_with_path(lambda path, _: names.append("/".join(map(str, path))), params)
    for name, g in zip(names, tree_leaves(grads), strict=True):
        want = reference[f"{key}/grads/{name}"]
        assert g.shape == want.shape, name
        assert float(np.abs(g.numpy() - want).max()) <= 1e-4 * float(np.abs(want).max()), name


def test_elastic_restore_matches_reference(reference, tmp_path):
    mesh8, mesh2 = _mesh((8,), ("data",)), _mesh((2,), ("data",))
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    tree = {"w": device_put(x, NamedSharding(mesh8, P("data"))),
            "b": torch.ones(3)}
    ck = Checkpointer(str(tmp_path))
    ck.save(7, tree, extras={"note": "elastic"}, blocking=True)
    sh2 = {"w": NamedSharding(mesh2, P("data")), "b": NamedSharding(mesh2, P())}
    got, extras, step = ck.restore({"w": torch.zeros_like(x), "b": torch.zeros(3)},
                                   shardings=sh2)
    assert step == 7 and extras["note"] == "elastic"
    assert got["w"].sharding.num_devices == 2 == int(reference["elastic_restore/num_devices"])
    assert [tuple(s.shape) for s in got["w"].shards] == [(4, 8), (4, 8)]
    np.testing.assert_array_equal(got["w"].full().numpy(), x.numpy())
    np.testing.assert_array_equal(got["w"].full().numpy(), reference["elastic_restore/w"])
    np.testing.assert_array_equal(got["b"].full().numpy(), reference["elastic_restore/b"])
    # a ShardedTensor template keeps its sharding; no template device needed
    again, _, _ = ck.restore({"w": got["w"], "b": torch.zeros(3)})
    assert again["w"].sharding == got["w"].sharding and isinstance(again["b"], torch.Tensor)


@pytest.mark.parametrize("mode", ["cache_write", "heads_cache"])
def test_cache_write_under_rules_matches_reference(reference, mode):
    mesh = _mesh((2, 4), ("data", "model"))
    seed, h, rules = {
        "cache_write": (5, 2, dataclasses.replace(decode_rules(mesh), cache_impl="sharded_dus")),
        "heads_cache": (7, 4, decode_rules_headsharded(mesh)),
    }[mode]
    rng = np.random.default_rng(seed)
    b, s, d = 4, 16, 8  # seq 16 shards over model=4
    masked, sharded = torch.zeros((b, s, h, d)), torch.zeros((b, s, h, d))
    for pos in range(s):
        new = torch.from_numpy(rng.standard_normal((b, 1, h, d)).astype(np.float32))
        cache_write(masked, new, pos)
        with use_rules(rules):
            cache_write(sharded, new, pos)
    assert torch.equal(masked, sharded)
    assert not torch.all(sharded == 0)
    np.testing.assert_array_equal(sharded.numpy(), reference[f"{mode}/rules"])
    np.testing.assert_array_equal(masked.numpy(), reference[f"{mode}/masked"])


def test_sharded_write_lands_on_the_owning_rank_only(monkeypatch):
    """The seq axis over model=4: slot 9 lives on model rank 2 (rows 8–11);
    every rank runs the body, and the one row lands in the caller's tensor.
    A seq length that model=4 does not divide falls back to the default
    write, as the reference's ``_cache_write_sharded`` returns None."""
    mesh = _mesh((2, 4), ("data", "model"))
    rules = dataclasses.replace(decode_rules(mesh), cache_impl="sharded_dus")
    cache = torch.zeros((4, 16, 2, 8))
    new = torch.ones((4, 1, 2, 8))
    seen = []

    def spy(axis):
        seen.append(axis_index(axis))
        return seen[-1]

    monkeypatch.setattr(layers, "axis_index", spy)
    assert _cache_write_sharded(cache, new, 9, rules)
    assert sorted(seen) == [0, 0, 1, 1, 2, 2, 3, 3]
    assert torch.equal(cache[:, 9], new[:, 0]) and int((cache != 0).sum()) == 4 * 2 * 8
    odd = torch.zeros((4, 18, 2, 8))
    assert not _cache_write_sharded(odd, new, 3, rules)
    with use_rules(rules):
        cache_write(odd, new, 3)
    assert torch.equal(odd[:, 3], new[:, 0])


# ---------------------------------------------------------------------------
# the collectives against jax.lax on the same mesh
# ---------------------------------------------------------------------------


class _Port:
    psum = staticmethod(psum)
    pmax = staticmethod(spmd.pmax)
    psum_scatter = staticmethod(psum_scatter)
    all_gather = staticmethod(all_gather)
    ppermute = staticmethod(ppermute)
    axis_index = staticmethod(axis_index)
    axis_size = staticmethod(spmd.axis_size)


@pytest.mark.parametrize("name", list(ref.PRIMITIVES))
def test_collective_matches_lax(reference, name):
    """Each collective over a (2, 4) ("pod", "data") mesh, every rank's
    result in rank order: ``tiled=False`` removes (scatter) or adds
    (gather) an axis, ``ppermute`` gives zeros to an untargeted rank,
    ``axis_index``/``axis_size`` over a tuple are row-major."""
    key, body = ref.PRIMITIVES[name]
    spec = P(("pod", "data"))
    f = shard_map(lambda v: body(_Port, v), mesh=_mesh((2, 4), ("pod", "data")),
                  in_specs=(spec,), out_specs=spec)
    got = f(torch.from_numpy(ref.primitive_inputs()[key]))
    want = reference[f"primitive/{name}"]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_ppermute_gives_zeros_to_untargeted_ranks():
    x = torch.arange(1, 9, dtype=torch.float32).reshape(8, 1)
    f = shard_map(lambda v: ppermute(v, "data", [(0, 1), (1, 2), (2, 3)]),
                  mesh=_mesh((2, 4), ("pod", "data")), in_specs=(P(("pod", "data")),),
                  out_specs=P(("pod", "data")))
    assert f(x).flatten().tolist() == [0, 1, 2, 3, 0, 5, 6, 7]


# ---------------------------------------------------------------------------
# the rendezvous: order, failure, disagreement, load
# ---------------------------------------------------------------------------


def test_reductions_are_bit_identical_across_runs():
    """Rank-order folds: 8 ranks' distinct f32 rows summed twice (and under
    a shortened switch interval, which reorders the threads' arrivals) give
    the same bits, and those of the rank-order sum."""
    rows = torch.from_numpy(np.random.default_rng(4).standard_normal((8, 4096)).astype(np.float32))
    mesh = _mesh((2, 4), ("pod", "data"))
    f = shard_map(lambda v: psum(v, ("pod", "data")), mesh=mesh,
                  in_specs=(P(("pod", "data")),), out_specs=P())
    first = f(rows)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runs = [f(rows) for _ in range(4)]
    finally:
        sys.setswitchinterval(interval)
    want = rows[0].clone()
    for r in rows[1:]:
        want += r
    for got in [first, *runs]:
        assert torch.equal(got, want[None])


def _run_guarded(fn):
    """``fn()`` in a thread joined with a timeout: the outcome, and whether
    the thread finished (a hang would leave it alive)."""
    box = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as err:  # handed to the test
            box["error"] = err

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "shard_map hung"
    return box


def test_a_raising_rank_reraises_without_a_hang():
    mesh = _mesh((2, 4), ("pod", "data"))

    def body(v):
        if axis_index(("pod", "data")) == 5:
            raise KeyError("rank five")
        return psum(psum(v, "data"), "pod")

    box = _run_guarded(lambda: _replicated(mesh)(body)(torch.ones(4)))
    err = box["error"]
    assert isinstance(err, KeyError) and err.args == ("rank five",)
    assert any("rank 5 of 8" in n for n in err.__notes__)


def test_ranks_that_disagree_on_a_collective_raise():
    mesh = _mesh((2, 4), ("pod", "data"))

    def body(v):
        if axis_index("data") == 3:
            return v  # returns while the others wait in a psum
        return psum(v, "data")

    box = _run_guarded(lambda: _replicated(mesh)(body)(torch.ones(4)))
    assert isinstance(box["error"], RuntimeError)
    assert "disagree" in str(box["error"])


def test_collectives_outside_shard_map_raise():
    with pytest.raises(RuntimeError, match="inside a shard_map"):
        psum(torch.ones(2), "data")


def test_many_rank_threads_keep_exact_sums():
    """64 ranks (more threads than cores) run 30 rounds of psum,
    psum_scatter and all_gather under a shortened switch interval; integer
    sums are exact, so a lost or doubled operand would show."""
    mesh = _mesh((8, 8), ("pod", "data"))

    def body(v):
        acc = v
        for _ in range(10):
            acc = psum(acc, "data") % 1009
            acc = all_gather(psum_scatter(acc, "pod", scatter_dimension=1, tiled=True),
                             "pod", axis=1, tiled=True)
            acc = (acc + axis_index(("pod", "data"))) % 1009
        return acc

    x = torch.arange(64 * 8, dtype=torch.int64).reshape(64, 8)
    want = x.reshape(8, 8, 8).clone()  # the ranks' rows by (pod, data)
    for _ in range(10):
        want = want.sum(1, keepdim=True).expand(8, 8, 8) % 1009
        want = want.sum(0, keepdim=True).expand(8, 8, 8).clone()
        want = (want + torch.arange(64).reshape(8, 8, 1)) % 1009
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        box = _run_guarded(lambda: shard_map(
            body, mesh=mesh, in_specs=(P(("pod", "data")),), out_specs=P(("pod", "data")))(x))
    finally:
        sys.setswitchinterval(interval)
    assert "error" not in box, box.get("error")
    assert torch.equal(box["value"].reshape(8, 8, 8), want)


def test_idle_rank_threads_keep_no_arguments_alive():
    """Once a ``shard_map`` call returns, its arguments (the rank shards of
    a model's params) are freed when the caller drops them: no idle rank
    thread still holds its last call's job."""
    import gc
    import weakref

    mesh = _mesh((2, 4), ("data", "model"))
    x = torch.ones((8, 16))
    seen = weakref.ref(x)
    out = shard_map(lambda v: psum(v, "model"), mesh=mesh, in_specs=(P("data", "model"),),
                    out_specs=P("data", None))(x)
    assert torch.equal(out, torch.full((8, 4), 4.0))
    del x
    gc.collect()
    assert seen() is None


# ---------------------------------------------------------------------------
# mesh construction and placement
# ---------------------------------------------------------------------------


def test_meshes_repeat_devices_and_need_a_card_by_default(monkeypatch, caplog):
    with caplog.at_level("INFO", logger="repro_torch.launch.mesh"):
        mesh = make_test_mesh(devices=(CPU,))
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    assert mesh.device_list == (CPU,) * 4 and "repeated" in caplog.text
    prod = make_production_mesh(multi_pod=True, devices=(CPU,))
    assert prod.shape == {"pod": 2, "data": 16, "model": 16} and prod.devices.shape == (2, 16, 16)
    assert make_production_mesh(devices=(CPU,)).shape == {"data": 16, "model": 16}
    with pytest.raises(ValueError, match="do not tile"):
        compat_make_mesh((2, 3), ("data", "model"), devices=(CPU, CPU, CPU, CPU))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="has none"):
        compat_make_mesh((2, 2), ("data", "model"))


def test_device_put_shards_and_full_round_trip():
    mesh = _mesh((2, 4), ("data", "model"))
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    st = device_put(x, NamedSharding(mesh, P("model", ("data",))))
    assert st.sharding.num_devices == 8 and tuple(st.shards[0].shape) == (2, 6)
    # rank (data 1, model 2) holds rows 4–5 and columns 6–11
    assert torch.equal(st.shards[1 * 4 + 2], x[4:6, 6:12])
    assert torch.equal(st.full(), x) and st.full().data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match="does not divide"):
        device_put(torch.zeros(6, 12), NamedSharding(mesh, P("model")))
