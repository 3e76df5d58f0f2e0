"""The port's sharding rules against the JAX package's.

Every case of ``tests/test_sharding.py`` on both packages' (1, 1) meshes
(axis *names* drive the specs; extent-1 axes make every dim divisible),
and the param and cache PartitionSpecs of every ``ARCH_IDS`` smoke config
on a (2, 4) ("data", "model") mesh, leaf by leaf: the reference's on a
``jax.sharding.AbstractMesh``, the port's on a mesh of ``cpu`` positions.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.distributed.sharding as jsh
from repro.configs import get_smoke_config as j_smoke
from repro.launch.mesh import compat_make_mesh as j_make_mesh
from repro.models import build_model as j_build
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.distributed import P, NamedSharding
from repro_torch.distributed.sharding import (
    cache_shardings,
    decode_rules,
    decode_rules_headsharded,
    long_decode_rules,
    param_pspec,
    params_shardings,
    shard,
    shard_spec,
    train_rules,
    train_rules_sp,
    use_rules,
)
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.models import build_model

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh():
    return compat_make_mesh((1, 1), ("data", "model"), devices=(CPU,))


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh((1, 1), ("data", "model"))


def _same(spec, jspec) -> bool:
    return tuple(spec) == tuple(jspec)


def test_param_pspec_stacked_by_rank(mesh, jmesh):
    for shape, want in (((4, 64, 8, 16), P(None, "data", "model", None)),
                        ((64, 8, 16), P("data", "model", None))):
        got = param_pspec("/seg0/0/mixer/wq", shape, mesh)
        assert got == want
        assert _same(got, jsh.param_pspec("/seg0/0/mixer/wq", shape, jmesh))


def test_param_pspec_norms_replicated(mesh, jmesh):
    for path, shape, want in (("/seg0/0/ln1", (4, 64), P(None, None)),
                              ("/final_norm", (64,), P(None))):
        assert param_pspec(path, shape, mesh) == want
        assert _same(want, jsh.param_pspec(path, shape, jmesh))


def test_param_pspec_embed_and_head(mesh, jmesh):
    for path, shape, want in (("/embed", (1024, 64), P("model", "data")),
                              ("/lm_head", (64, 1024), P("data", "model"))):
        assert param_pspec(path, shape, mesh) == want
        assert _same(want, jsh.param_pspec(path, shape, jmesh))


def test_param_pspec_fsdp_disable(mesh, jmesh):
    got = param_pspec("/seg0/0/mixer/wq", (64, 8, 16), mesh, fsdp_axis=None)
    assert got == P(None, "model", None)
    assert _same(got, jsh.param_pspec("/seg0/0/mixer/wq", (64, 8, 16), jmesh, fsdp_axis=None))


def test_param_pspec_nondivisible_replicates(mesh, jmesh):
    # a rank the rules don't expect must fully replicate, never crash
    got = param_pspec("/seg0/0/mixer/wq", (3, 4, 64, 8, 16), mesh)
    assert got == P(None, None, None, None, None)
    assert _same(got, jsh.param_pspec("/seg0/0/mixer/wq", (3, 4, 64, 8, 16), jmesh))
    # and on a real (2, 4) mesh a dim its axis does not divide replicates
    m24 = compat_make_mesh((2, 4), ("data", "model"), devices=(CPU,))
    j24 = AbstractMesh((2, 4), ("data", "model"))
    for shape in ((6, 5, 16), (64, 6, 16), (63, 8, 16)):
        got = param_pspec("/seg0/0/mixer/wq", shape, m24)
        assert _same(got, jsh.param_pspec("/seg0/0/mixer/wq", shape, j24)), shape


def _port_params(arch):
    return build_model(get_smoke_config(arch)).init(torch.Generator().manual_seed(0),
                                                    device="cpu")


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "jamba-v0.1-52b"])
def test_params_shardings_cover_whole_tree(mesh, arch):
    params = _port_params(arch)
    sh = params_shardings(params, mesh)
    # same structure, every leaf a NamedSharding of matching rank
    leaves = jax.tree.leaves(params)
    specs = jax.tree.leaves(sh, is_leaf=lambda s: isinstance(s, NamedSharding))
    assert len(leaves) == len(specs)
    for leaf, s in zip(leaves, specs):
        assert isinstance(s, NamedSharding) and len(s.spec) in (leaf.ndim, 0)


def _paths(tree, is_leaf=None) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in flat}


def _port_specs(tree) -> dict:
    return {k: tuple(s.spec) for k, s in
            _paths(tree, is_leaf=lambda s: isinstance(s, NamedSharding)).items()}


def _ref_specs(tree) -> dict:
    return {k: tuple(s.spec) for k, s in _paths(tree).items()}


def test_cache_shardings_stacked_vs_unstacked(mesh):
    model = build_model(get_smoke_config("deepseek-v2-236b"))  # seg0 repeats=1 + seg1 stacked
    specs = _port_specs(cache_shardings(model.init_cache(4, 32, torch.float32, device="cpu"),
                                        mesh))
    # unstacked first-layer MLA cache: (B, S, R) → batch, seq(model), none
    unstacked = [v for k, v in specs.items() if k.startswith("seg0") and "ckv" in k]
    stacked = [v for k, v in specs.items() if k.startswith("seg1") and "ckv" in k]
    assert unstacked and stacked
    assert unstacked[0][1] == "model" and len(unstacked[0]) == 3
    assert stacked[0][0] is None and stacked[0][2] == "model"  # stack dim first


def test_shard_constraint_drops_nondivisible(mesh):
    with use_rules(train_rules(mesh)):
        x = torch.zeros((2, 8, 16))
        y = shard(x, "batch", "seq", "embed")  # extent-1 axes: all divisible
        assert y is x and y.shape == x.shape
        with pytest.raises(ValueError, match="names"):
            shard(x, "batch")
    # outside a rules context shard() is the identity
    z = torch.zeros((3,))
    assert shard(z, "batch") is z and shard_spec(z, "batch") is None
    # on a (2, 4) mesh: 6 heads do not divide model=4 and replicate; 3 rows not data=2
    m24 = compat_make_mesh((2, 4), ("data", "model"), devices=(CPU,))
    with use_rules(train_rules(m24)):
        assert shard_spec(torch.zeros((2, 5, 8, 16)), "batch", "seq", "heads",
                          "head_dim") == P(("data",), None, "model", None)
        assert shard_spec(torch.zeros((3, 5, 6, 16)), "batch", "seq", "heads",
                          "head_dim") == P(None, None, None, None)


def test_rule_presets_differ_where_expected(mesh, jmesh):
    tr = train_rules(mesh).logical
    dr = decode_rules(mesh).logical
    lr = long_decode_rules(mesh).logical
    assert tr["heads"] == "model" and dr["heads"] is None
    assert dr["kv_seq"] == "model" and lr["kv_seq"] == "data"
    assert tr["batch"] == ("data",) and lr["batch"] is None
    for port, refr in ((train_rules, jsh.train_rules), (train_rules_sp, jsh.train_rules_sp),
                       (decode_rules, jsh.decode_rules),
                       (decode_rules_headsharded, jsh.decode_rules_headsharded),
                       (long_decode_rules, jsh.long_decode_rules)):
        got, want = port(mesh), refr(jmesh)
        assert got.logical == want.logical and got.cache_impl == want.cache_impl
        assert tuple(got.spec("batch", "heads", None)) == tuple(want.spec("batch", "heads", None))


@pytest.fixture(scope="module")
def meshes_2x4():
    return (compat_make_mesh((2, 4), ("data", "model"), devices=(CPU,)),
            AbstractMesh((2, 4), ("data", "model")))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference_leaf_by_leaf(arch, meshes_2x4):
    mesh, amesh = meshes_2x4
    jparams = jax.eval_shape(j_build(j_smoke(arch)).init, jax.random.key(0))
    port = _port_specs(params_shardings(_port_params(arch), mesh))
    want = _ref_specs(jsh.params_shardings(jparams, amesh))
    assert port == want
    assert any(s != (None,) * len(s) for s in port.values())  # the mesh shards something
    port_nofsdp = _port_specs(params_shardings(_port_params(arch), mesh, fsdp_axis=None))
    assert port_nofsdp == _ref_specs(jsh.params_shardings(jparams, amesh, fsdp_axis=None))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference_leaf_by_leaf(arch, meshes_2x4):
    mesh, amesh = meshes_2x4
    jm = j_build(j_smoke(arch))
    jcache = jax.eval_shape(lambda: jm.init_cache(4, 32, jnp.float32))
    cache = build_model(get_smoke_config(arch)).init_cache(4, 32, torch.float32, device="cpu")
    for kw in ({}, {"layout": "heads"}, {"long_context": True}):
        port = _port_specs(cache_shardings(cache, mesh, **kw))
        assert port == _ref_specs(jsh.cache_shardings(jcache, amesh, **kw)), kw
