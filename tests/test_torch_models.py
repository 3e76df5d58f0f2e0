"""The port's models on the CPU vs the JAX package's, on the same weights.

Smoke configs of both ported architectures in float32; the JAX model's
weights (``Model.init``) go to the port through ``params_from_numpy``.
Tolerances are the reference's serving contract (``tests/test_arch_smoke.py``):
3e-4 for the forward and prefill logits, 5e-4 for each decode step.  On the
CPU the flash route runs the kernel's plain version and the SSD chunked
route runs ``ssd_chunked``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import ssd_scan as ssd_module
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.lm import CAST_LEAVES
from repro_torch.models.ssm import mamba_block

B, S = 2, 24
PREFILL_TOL = dict(rtol=3e-4, atol=3e-4)
DECODE_TOL = dict(rtol=5e-4, atol=5e-4)


def _pair(arch, seed=1, **overrides):
    """(JAX model, its params, port model, the same params in the port)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **overrides)
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32", **overrides)
    jm = j_build(jcfg)
    jparams = jm.init(jax.random.key(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return jm, jparams, build_model(cfg), params_from_numpy(tree, cfg, device="cpu")


def _jforward(jm):
    return jax.jit(lambda params, batch: jm.forward(params, batch, remat=False))


def _tokens(cfg, seed, length=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, length)).astype(np.int32)


def _t(tokens):
    return torch.from_numpy(tokens.astype(np.int64))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_logits_match_reference(arch):
    jm, jparams, tm, tparams = _pair(arch)
    toks = _tokens(tm.cfg, 2)
    want = np.asarray(_jforward(jm)(jparams, {"tokens": jnp.asarray(toks)}))
    got = tm.forward(tparams, {"tokens": _t(toks)})
    assert tuple(got.shape) == (B, S, tm.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, **PREFILL_TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_each_decode_step_match_reference(arch):
    jm, jparams, tm, tparams = _pair(arch)
    toks = _tokens(tm.cfg, 3)
    p = S - 4
    jcache = jm.init_cache(B, S, dtype=jnp.float32)
    jlog, jcache = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :p])}, jcache)
    tcache = tm.init_cache(B, S, dtype=torch.float32, device="cpu")
    tlog, tcache = tm.prefill(tparams, {"tokens": _t(toks[:, :p])}, tcache)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **PREFILL_TOL)
    jdecode = jax.jit(jm.decode_step)
    for t in range(p, S):
        jlog, jcache = jdecode(
            jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t, jnp.int32)
        )
        tlog, tcache = tm.decode_step(tparams, tcache, _t(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **DECODE_TOL)
    for jleaf, tleaf in zip(jax.tree.leaves(jcache), _leaves(tcache), strict=True):
        np.testing.assert_allclose(tleaf.numpy(), np.asarray(jleaf), **DECODE_TOL)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def test_flash_route_matches_ref_route():
    """``attn_impl="flash"`` routes prefill attention through the kernel
    wrapper (its plain version here) and changes the logits only by float
    reassociation."""
    jm, jparams, ref_model, tparams = _pair("qwen3-32b")
    flash_model = build_model(dataclasses.replace(ref_model.cfg, attn_impl="flash"))
    toks = _t(_tokens(ref_model.cfg, 4))
    logits = {}
    for name, model in (("ref", ref_model), ("flash", flash_model)):
        cache = model.init_cache(B, S, dtype=torch.float32, device="cpu")
        logits[name], _ = model.prefill(tparams, {"tokens": toks}, cache)
        np.testing.assert_allclose(
            model.forward(tparams, {"tokens": toks}).numpy(),
            np.asarray(_jforward(jm)(jparams, {"tokens": jnp.asarray(toks.numpy())})),
            **PREFILL_TOL,
        )
    np.testing.assert_allclose(logits["flash"].numpy(), logits["ref"].numpy(), **PREFILL_TOL)


@pytest.mark.parametrize("length,chunked", [(32, True), (12, False)])
def test_ssd_routes_match_reference(length, chunked, monkeypatch):
    """mamba2 smoke (ssm_chunk 16): a 32-token prompt takes the chunked route
    (``ops.ssd_scan``), a 12-token one the sequential recurrence."""
    jm, jparams, tm, tparams = _pair("mamba2-1.3b")
    calls = []
    real = ssd_module.ssd_chunked
    monkeypatch.setattr(ssd_module, "ssd_chunked", lambda *a, **k: calls.append(1) or real(*a, **k))
    toks = _tokens(tm.cfg, 5, length)
    jcache = jm.init_cache(B, length + 1, dtype=jnp.float32)
    jlog, _ = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(toks)}, jcache)
    tcache = tm.init_cache(B, length + 1, dtype=torch.float32, device="cpu")
    tlog, _ = tm.prefill(tparams, {"tokens": _t(toks)}, tcache)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **PREFILL_TOL)
    assert len(calls) == (tm.cfg.num_layers if chunked else 0)


def test_chunked_block_matches_sequential_block():
    _, _, tm, tparams = _pair("mamba2-1.3b")
    layer = {k: v[0] for k, v in tparams["seg0"][0]["mixer"].items()}
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(B, 32, tm.cfg.d_model))
                         .astype(np.float32))
    chunked, _ = mamba_block(layer, tm.cfg, x, use_chunked=True)
    sequential, _ = mamba_block(layer, tm.cfg, x, use_chunked=False)
    np.testing.assert_allclose(chunked.numpy(), sequential.numpy(), **PREFILL_TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_from_numpy_stores_cast_leaves_in_model_dtype(arch):
    cfg = get_smoke_config(arch)  # bfloat16
    jparams = j_build(j_smoke(arch)).init(jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    seen = set()

    def walk(node, name):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v, name)
        else:
            seen.add(name)
            want = torch.bfloat16 if name in CAST_LEAVES else torch.float32
            assert node.dtype == want, name

    walk(tparams, "")
    assert {"embed", "final_norm"} <= seen
    assert ("lm_head" in seen) != cfg.tie_embeddings  # a tied head is the embedding
    assert ("wq" in seen) == (cfg.family == "dense") and ("A_log" in seen) == (cfg.family == "ssm")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_random_init_has_reference_tree(arch):
    """``Model.init`` gives the JAX tree's names, shapes and stacking, each
    leaf in the type ``params_from_numpy`` would store it in."""
    cfg = get_smoke_config(arch)
    shapes = jax.eval_shape(j_build(j_smoke(arch)).init, jax.random.key(0))
    want = params_from_numpy(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), cfg, device="cpu"
    )
    got = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, shapes)) == jax.tree.structure(
        jax.tree.map(lambda _: 0, got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    )


def test_full_configs_match_reference():
    from repro.configs import get_config as j_config

    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_config(arch))
        assert get_config(arch).param_counts() == j_config(arch).param_counts()


@pytest.mark.parametrize("arch,part", [("mixtral-8x7b", "moe"), ("deepseek-v2-236b", "MLA")])
def test_unported_families_raise(arch, part):
    from repro.configs import get_config as j_config

    with pytest.raises(NotImplementedError, match=part):
        build_model(j_config(arch))


def test_model_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_smoke_config("qwen3-32b")).init(torch.Generator())
