"""Tensor-parallel serving in the port (``spmd.sharded_prefill`` and
``sharded_decode_step``) against the JAX package's GSPMD-partitioned steps.

The reference side runs once, in one child process on 8 forced host
devices (``tests/_torch_dist_ref.py``'s ``tensor_parallel`` case, ~20 s):
``jax.jit(model.prefill)`` and ``jax.jit(model.decode_step)`` on a (2, 4)
("data", "model") mesh under ``decode_rules`` (the cache's sequence over
model) and ``decode_rules_headsharded`` (its kv heads), for the qwen3-32b
smoke config (2 kv heads over 4 ranks: ``wk``/``wv`` replicated) and
deepseek-7b's (4 over 4), in f32.  The port runs the same steps on a (2, 4)
mesh of repeated ``cpu`` positions in this process, on the reference's
weights: the logits within the reference's serving tolerances
(``tests/test_arch_smoke.py``: 3e-4 after the prefill, 5e-4 a decode step)
and every rank's block of the cache equal to the reference's placed cache
within the prefill's tolerance.  Beside the parity, the port's
tensor-parallel route is held to its own unsharded model on more meshes and
configs (the other dense configs, a padded vocabulary, ``fsdp`` over data),
and its structure is checked: the flash calls at the ranks' head counts,
its collectives per layer, the layouts, and what it refuses.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_dist_ref as ref
from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro_torch._pytree import tree_leaves, tree_map
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import (
    NamedSharding,
    P,
    ShardedTensor,
    cache_shardings,
    decode_rules,
    decode_rules_headsharded,
    device_put,
    long_decode_rules,
    params_shardings,
    sharded_decode_step,
    sharded_prefill,
    tensor_parallel,
)
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import _map_with_path
from repro_torch.kernels import ops
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import layers as L

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
CHILD = os.path.join(os.path.dirname(__file__), "_torch_dist_ref.py")
CPU = torch.device("cpu")
PREFILL_TOL = dict(rtol=3e-4, atol=3e-4)  # tests/test_arch_smoke.py
DECODE_TOL = dict(rtol=5e-4, atol=5e-4)
#: the port's tensor-parallel route against its own unsharded model, in f32:
#: the same products summed in another order
SELF_TOL = dict(rtol=2e-5, atol=2e-5)
RULES = {"seq": decode_rules, "heads": decode_rules_headsharded}
DENSE = ("qwen3-32b", "deepseek-7b", "qwen2-72b", "command-r-35b")


def _mesh(shape=(2, 4), axes=("data", "model")):
    return compat_make_mesh(shape, axes, devices=(CPU,))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp_ref"))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, CHILD, path, "tensor_parallel"], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert f"RESULT {path}" in out.stdout
    with np.load(os.path.join(path, "out.npz")) as data:
        return dict(data)


def _reference_params(arch, **overrides):
    """The port's model and the reference's key-0 weights in it (f32)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **overrides)
    jm = j_build(dataclasses.replace(j_smoke(arch), dtype="float32", **overrides))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    return build_model(cfg), params_from_numpy(tree, cfg, device="cpu")


def _serve(model, params, toks, *, mesh, layout, fsdp_axis=None, batch=ref.TP_BATCH,
           prompt=ref.TP_PROMPT, steps=ref.TP_STEPS, max_len=ref.TP_MAX_LEN, decomposed=False):
    """The tensor-parallel prefill and ``steps`` decode steps fed ``toks``
    (under a ``"decomposed"`` ``cache_impl`` too with ``decomposed``): the
    logits (B, 1 + steps, Vp) and the placed cache."""
    rules = RULES[layout](mesh)
    if decomposed:
        rules = dataclasses.replace(rules, cache_impl=rules.cache_impl + "+decomposed")
    placed = device_put(params, params_shardings(params, mesh, fsdp_axis=fsdp_axis))
    c0 = model.init_cache(batch, max_len, dtype=torch.float32, device="cpu")
    cache = device_put(c0, cache_shardings(c0, mesh, layout=layout))
    logits, cache = sharded_prefill(model, placed, {"tokens": toks[:, :prompt]}, cache,
                                    mesh=mesh, rules=rules)
    outs = [logits]
    for t in range(steps):
        logits, cache = sharded_decode_step(model, placed, cache,
                                            toks[:, prompt + t:prompt + t + 1], prompt + t,
                                            mesh=mesh, rules=rules)
        outs.append(logits)
    return torch.stack(outs, 1), cache


def _unsharded(model, params, toks, *, batch=ref.TP_BATCH, prompt=ref.TP_PROMPT,
               steps=ref.TP_STEPS, max_len=ref.TP_MAX_LEN):
    cache = model.init_cache(batch, max_len, dtype=torch.float32, device="cpu")
    logits, _ = model.prefill(params, {"tokens": toks[:, :prompt]}, cache)
    outs = [logits]
    for t in range(steps):
        logits, _ = model.decode_step(params, cache, toks[:, prompt + t:prompt + t + 1],
                                      prompt + t)
        outs.append(logits)
    return torch.stack(outs, 1), cache


def _tokens(model):
    return torch.from_numpy(ref.tp_tokens(model.cfg.vocab_size).astype(np.int64))


# ---------------------------------------------------------------------------
# against the reference's GSPMD partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ref.TP_LAYOUTS)
@pytest.mark.parametrize("arch", ref.TP_ARCHES)
def test_logits_match_reference(reference, arch, layout):
    model, params = _reference_params(arch)
    got, _ = _serve(model, params, _tokens(model), mesh=_mesh(), layout=layout)
    want = reference[f"tensor_parallel/{arch}/{layout}/logits"]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got[:, 0].numpy(), want[:, 0], **PREFILL_TOL)
    for t in range(1, ref.TP_STEPS + 1):
        np.testing.assert_allclose(got[:, t].numpy(), want[:, t], **DECODE_TOL)


@pytest.mark.parametrize("layout", ref.TP_LAYOUTS)
@pytest.mark.parametrize("arch", ref.TP_ARCHES)
def test_cache_blocks_match_reference(reference, arch, layout):
    """Every rank's block of the cache after the prefill and the decode
    steps is the block the reference's placed cache holds on that device
    (the replicated kv heads of qwen3 under ``heads`` too)."""
    model, params = _reference_params(arch)
    _, cache = _serve(model, params, _tokens(model), mesh=_mesh(), layout=layout)
    seen = []

    def one(path, leaf):
        want = reference[f"tensor_parallel/{arch}/{layout}/cache/" + ref.tp_path(path)]
        got = np.stack([s.numpy() for s in leaf.shards])
        assert got.shape == want.shape, path
        np.testing.assert_allclose(got, want, **PREFILL_TOL)
        seen.append(float(np.abs(got).max()))

    _map_with_path(one, cache)
    assert len(seen) == 2 and min(seen) > 0  # k and v, each written


def test_qwen3_smoke_keeps_its_kv_heads_whole(reference):
    """The replicated-kv case the parity above covers: qwen3's 2 kv heads do
    not divide the 4-way model axis, so every rank holds ``wk``/``wv``
    whole while ``wq`` is split a head a rank, and the heads-layout cache
    keeps both kv heads on every rank."""
    model, params = _reference_params("qwen3-32b")
    mesh = _mesh()
    sh = params_shardings(params, mesh, fsdp_axis=None)
    attn = sh["seg0"][0]["mixer"]
    assert attn["wq"].spec == P(None, None, "model", None)
    assert attn["wk"].spec == P(None, None, None, None)
    assert attn["wo"].spec == P(None, "model", None, None)
    assert all(spmd._gather_spec(attn[w].spec) == P(None, None, None, None)
               for w in ("wq", "wk", "wo"))
    placed = device_put(params, sh)["seg0"][0]["mixer"]
    layers, d, heads, dh = params["seg0"][0]["mixer"]["wq"].shape
    assert all(tuple(s.shape) == (layers, d, heads // 4, dh) for s in placed["wq"].shards)
    assert all(tuple(s.shape) == (layers, d, 2, dh) for s in placed["wk"].shards)
    assert all(tuple(s.shape) == (layers, heads // 4, dh, d) for s in placed["wo"].shards)
    c0 = model.init_cache(ref.TP_BATCH, ref.TP_MAX_LEN, dtype=torch.float32, device="cpu")
    heads = cache_shardings(c0, mesh, layout="heads")["seg0"][0]["k"]
    assert heads.spec == P(None, "data", None, None, None)  # the kv heads whole
    seq = cache_shardings(c0, mesh, layout="seq")["seg0"][0]["k"]
    assert seq.spec == P(None, "data", "model", None, None)


# ---------------------------------------------------------------------------
# against the port's unsharded model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (2, 2), (1, 1)])
@pytest.mark.parametrize("layout", ref.TP_LAYOUTS)
@pytest.mark.parametrize("arch", DENSE)
def test_matches_the_unsharded_model(arch, layout, shape):
    """Every dense config on meshes where the heads split 1 a rank, 2 a
    rank, not at all (4 heads over 8: ``wq`` whole too) and one rank."""
    model = build_model(dataclasses.replace(get_smoke_config(arch), dtype="float32"))
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    toks = _tokens(model)
    want, want_cache = _unsharded(model, params, toks)
    got, cache = _serve(model, params, toks, mesh=_mesh(shape), layout=layout)
    torch.testing.assert_close(got, want, **SELF_TOL)
    for a, b in zip(tree_leaves(cache), tree_leaves(want_cache)):
        torch.testing.assert_close(a.full(), b, **SELF_TOL)


@pytest.mark.parametrize("shape", [(2, 4), (1, 2)])
@pytest.mark.parametrize("layout", ref.TP_LAYOUTS)
@pytest.mark.parametrize("arch", ref.TP_ARCHES)
def test_decomposed_decode_matches_the_unsharded_model(monkeypatch, arch, layout, shape):
    """``cache_impl="decomposed"`` (the dry-run's ``dec`` variant): each
    decode step attends to the old rows and the new one, then writes; under
    the ``seq`` layout every rank joins the new row to the combined old
    rows.  The logits and the cache stay the unsharded model's."""
    model = build_model(dataclasses.replace(get_smoke_config(arch), dtype="float32"))
    params = model.init(torch.Generator().manual_seed(10), device="cpu")
    toks = _tokens(model)
    want, want_cache = _unsharded(model, params, toks)
    new_rows = []
    cp, dec = L._sdpa_context_parallel, L._sdpa_decode_decomposed
    monkeypatch.setattr(L, "_sdpa_context_parallel", lambda *a, new=None, **kw: (
        new_rows.append(new is not None), cp(*a, new=new, **kw))[1])
    monkeypatch.setattr(L, "_sdpa_decode_decomposed", lambda *a, **kw: (
        new_rows.append(True), dec(*a, **kw))[1])
    got, cache = _serve(model, params, toks, mesh=_mesh(shape), layout=layout,
                        decomposed=True)
    # every rank joins each step's new row, in every layer
    assert new_rows == [True] * shape[0] * shape[1] * model.cfg.num_layers * ref.TP_STEPS
    torch.testing.assert_close(got, want, **SELF_TOL)
    for a, b in zip(tree_leaves(cache), tree_leaves(want_cache)):
        torch.testing.assert_close(a.full(), b, **SELF_TOL)


@pytest.mark.parametrize("layout", ref.TP_LAYOUTS)
@pytest.mark.parametrize("arch", ["qwen3-32b", "command-r-35b"])
def test_padded_vocabulary_is_masked_by_global_column(arch, layout):
    """vocab 250 padded to 256: the last rank's block holds the 6 padded
    columns (-1e30), every other column a logit; command-r's head is its
    tied embedding."""
    model = build_model(dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                            vocab_size=250))
    params = model.init(torch.Generator().manual_seed(4), device="cpu")
    toks = _tokens(model)
    want, _ = _unsharded(model, params, toks)
    got, _ = _serve(model, params, toks, mesh=_mesh(), layout=layout)
    assert bool((got[..., 250:] == -1e30).all()) and bool((got[..., :250] > -1e29).all())
    torch.testing.assert_close(got, want, **SELF_TOL)


@pytest.mark.parametrize("layout", ref.TP_LAYOUTS)
def test_fsdp_dims_are_gathered_and_model_dims_kept(layout):
    """``fsdp`` over data: the rank all-gathers the d_model dims over data
    and keeps its model part; the values stay the unsharded model's."""
    model = build_model(dataclasses.replace(get_smoke_config("deepseek-7b"), dtype="float32"))
    params = model.init(torch.Generator().manual_seed(5), device="cpu")
    toks = _tokens(model)
    mesh = _mesh()
    sh = params_shardings(params, mesh, fsdp_axis="data")
    wq = sh["seg0"][0]["mixer"]["wq"]
    assert wq.spec == P(None, "data", "model", None)
    assert spmd._gather_spec(wq.spec) == P(None, "data", None, None)
    layers, d, heads, dh = params["seg0"][0]["mixer"]["wq"].shape
    shards = device_put(params, sh)["seg0"][0]["mixer"]["wq"].shards
    assert all(tuple(s.shape) == (layers, d // 2, heads // 4, dh) for s in shards)
    want, _ = _unsharded(model, params, toks)
    with spmd.collective_census() as census:
        got, _ = _serve(model, params, toks, mesh=mesh, layout=layout, fsdp_axis="data",
                        steps=0)
    torch.testing.assert_close(got, want[:, :1], **SELF_TOL)
    gathered = sum(tree_leaves(
        tree_map(lambda _, s: any(spmd._gather_spec(s.spec)), params, sh)))
    assert census["counts"]["all-gather"] >= gathered


def test_local_layout_keeps_model_and_gathers_the_rest():
    """A rank's gather spec: the model axis and the kept (batch) axes
    stay, every other axis is gathered; a dim that splits the model axis
    with another cannot be kept alone."""
    gather = spmd._gather_spec
    assert gather(P(("pod", "data"), "model", None), ("pod", "data")) == P(None, None, None)
    assert gather(P("data", None, "model")) == P("data", None, None)
    assert gather(P(("pod", "data"), None)) == P(("pod", "data"), None)
    with pytest.raises(ValueError, match="model axis"):
        gather(P(("data", "model")))
    with pytest.raises(ValueError, match="mixes kept and gathered"):
        gather(P(("pod", "data")), ("data",))


# ---------------------------------------------------------------------------
# structure: kernels, collectives, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape,heads", [("qwen3-32b", (2, 4), (1, 1)),
                                              ("deepseek-7b", (1, 4), (1, 1)),
                                              ("deepseek-7b", (2, 2), (2, 2))])
def test_flash_runs_once_a_rank_and_layer_at_the_ranks_heads(monkeypatch, arch, shape, heads):
    """Under ``attn_impl="flash"`` a tensor-parallel prefill calls the flash
    route once per rank and layer with the rank's q heads and the kv heads
    they read (qwen3: one q head and its one kv head of the replicated two,
    contiguous); decode calls it never."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", attn_impl="flash")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(6), device="cpu")
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        assert k.is_contiguous() and v.is_contiguous()
        calls.append((q.shape[2], k.shape[2]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    toks = _tokens(model)
    got, _ = _serve(model, params, toks, mesh=_mesh(shape), layout="seq")
    ranks = shape[0] * shape[1]
    assert calls == [heads] * ranks * cfg.num_layers
    monkeypatch.setattr(ops, "flash_attention", real)
    want, _ = _unsharded(model, params, toks)
    torch.testing.assert_close(got, want, **SELF_TOL)


def _layer_census(arch, layout, layers, decode):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", num_layers=layers)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(7), device="cpu")
    mesh = _mesh()
    rules = RULES[layout](mesh)
    placed = device_put(params, params_shardings(params, mesh, fsdp_axis=None))
    c0 = model.init_cache(ref.TP_BATCH, ref.TP_MAX_LEN, dtype=torch.float32, device="cpu")
    cache = device_put(c0, cache_shardings(c0, mesh, layout=layout))
    toks = _tokens(model)
    with spmd.collective_census() as census:
        if decode:
            sharded_decode_step(model, placed, cache, toks[:, :1], ref.TP_PROMPT, mesh=mesh,
                                rules=rules)
        else:
            sharded_prefill(model, placed, {"tokens": toks[:, :ref.TP_PROMPT]}, cache,
                            mesh=mesh, rules=rules)
    return census["counts"]


#: collectives a layer calls on the (2, 4) mesh, by (arch, layout, step):
#: (all-reduces, all-gathers); the embedding's psum adds one all-reduce.
#: Prefill: the psums after wo and w_down; qwen3's replicated wk/wv gather
#: their sequence-parallel rows (k, v), deepseek's split ones gather their
#: heads for a seq-layout cache.  Decode: under seq the q heads (and split
#: kv heads' new row) are gathered and the combine takes a pmax and a psum.
PER_LAYER = {
    ("qwen3-32b", "seq", False): (2, 2), ("qwen3-32b", "heads", False): (2, 2),
    ("deepseek-7b", "seq", False): (2, 2), ("deepseek-7b", "heads", False): (2, 0),
    ("qwen3-32b", "seq", True): (4, 1), ("qwen3-32b", "heads", True): (2, 0),
    ("deepseek-7b", "seq", True): (4, 3), ("deepseek-7b", "heads", True): (2, 0),
}


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("layout", ref.TP_LAYOUTS)
@pytest.mark.parametrize("arch", ref.TP_ARCHES)
def test_collectives_per_layer(arch, layout, decode):
    reduces, gathers = PER_LAYER[(arch, layout, decode)]
    for layers in (1, 3):
        counts = _layer_census(arch, layout, layers, decode)
        assert counts.get("all-reduce", 0) == 1 + reduces * layers
        assert counts.get("all-gather", 0) == gathers * layers


def test_outside_a_body_the_hooks_do_nothing():
    assert tensor_parallel() is None
    model = build_model(dataclasses.replace(get_smoke_config("qwen3-32b"), dtype="float32"))
    params = model.init(torch.Generator().manual_seed(8), device="cpu")
    with spmd.collective_census() as census:
        _unsharded(model, params, _tokens(model))
    assert census["counts"] == {}


def test_refuses_what_it_does_not_run():
    mesh = _mesh()
    for arch in ("mixtral-8x7b", "mamba2-1.3b", "whisper-tiny"):
        model = build_model(get_smoke_config(arch))
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        c0 = model.init_cache(2, 8, dtype=torch.float32, device="cpu")
        cache = device_put(c0, cache_shardings(c0, mesh))
        with pytest.raises(NotImplementedError, match="dense attention"):
            sharded_prefill(model, params, {"tokens": torch.zeros((2, 4), dtype=torch.int64)},
                            cache, mesh=mesh, rules=decode_rules(mesh))
    model = build_model(dataclasses.replace(get_smoke_config("qwen3-32b"), dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    c0 = model.init_cache(2, 8, dtype=torch.float32, device="cpu")
    tokens = {"tokens": torch.zeros((2, 4), dtype=torch.int64)}
    with pytest.raises(ValueError, match="placed on the mesh"):
        sharded_prefill(model, params, tokens, c0, mesh=mesh, rules=decode_rules(mesh))
    cache = device_put(c0, cache_shardings(c0, mesh))
    with pytest.raises(NotImplementedError, match="long_decode_rules"):
        sharded_prefill(model, params, tokens, cache, mesh=mesh, rules=long_decode_rules(mesh))
    mesh2 = _mesh((8,), ("data",))
    with pytest.raises(ValueError, match="'model' axis"):
        sharded_prefill(model, params, tokens, device_put(c0, NamedSharding(mesh2, P())),
                        mesh=mesh2, rules=decode_rules(mesh2))


def test_a_replicated_placement_computes_whole_on_every_rank():
    """Plain (replicated) params: every rank holds every weight, so no
    product is split and no partial sum taken; the logits are the
    unsharded model's."""
    model = build_model(dataclasses.replace(get_smoke_config("deepseek-7b"), dtype="float32"))
    params = model.init(torch.Generator().manual_seed(9), device="cpu")
    toks = _tokens(model)
    mesh = _mesh()
    c0 = model.init_cache(ref.TP_BATCH, ref.TP_MAX_LEN, dtype=torch.float32, device="cpu")
    cache = device_put(c0, cache_shardings(c0, mesh, layout="heads"))
    with pytest.raises(ValueError, match="split unlike"):
        sharded_prefill(model, params, {"tokens": toks[:, :ref.TP_PROMPT]}, cache, mesh=mesh,
                        rules=decode_rules_headsharded(mesh))
    cache = device_put(c0, cache_shardings(c0, mesh, layout="seq"))
    got, _ = sharded_prefill(model, params, {"tokens": toks[:, :ref.TP_PROMPT]}, cache,
                             mesh=mesh, rules=decode_rules(mesh))
    want, _ = _unsharded(model, params, toks, steps=0)
    torch.testing.assert_close(got, want[:, 0], **SELF_TOL)
    assert all(isinstance(leaf, ShardedTensor) for leaf in tree_leaves(cache))
