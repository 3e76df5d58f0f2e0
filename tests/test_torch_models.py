"""The port's models on the CPU vs the JAX package's, on the same weights.

Smoke configs of every architecture in float32; the JAX model's weights
(``Model.init``) go to the port through ``params_from_numpy``, with every
cross-attention gate set to a seeded value in [0.5, 1.5] (the reference
draws them 0, and ``tanh(0)`` would hide the whole cross path).  The audio
family gets frame embeddings and the vlm image embeddings drawn with numpy;
the vlm decodes with them as memory, as ``tests/test_arch_smoke.py`` does.
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


def set_gates(tree, seed):
    """A copy of a numpy params tree with every cross-attention ``gate`` at a
    seeded value in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32) if k == "gate"
                    else walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(tree)


def _pair(arch, seed=1, **overrides):
    """(JAX model, its params, port model, the same params in the port), the
    cross-attention gates set by :func:`set_gates`."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **overrides)
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32", **overrides)
    jm = j_build(jcfg)
    tree = set_gates(jax.tree.map(np.asarray, jm.init(jax.random.key(seed))), seed)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jm, jparams, build_model(cfg), params_from_numpy(tree, cfg, device="cpu")


def _jforward(jm):
    return jax.jit(lambda params, batch: jm.forward(params, batch, remat=False))


def _tokens(cfg, seed, length=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, length)).astype(np.int32)


def _t(tokens):
    return torch.from_numpy(tokens.astype(np.int64))


def extras(cfg, seed):
    """The stubbed frontends' outputs as numpy f32: ``frames`` (audio) or
    ``image_embeds`` (vlm); empty for the other families."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"image_embeds": rng.normal(size=(B, cfg.image_tokens, cfg.image_embed_dim))
                .astype(np.float32)}
    return {}


def batches(cfg, tokens, seed):
    """The same batch for both packages: ``(JAX batch, port batch)``."""
    ex = extras(cfg, seed)
    return ({"tokens": jnp.asarray(tokens), **{k: jnp.asarray(v) for k, v in ex.items()}},
            {"tokens": _t(tokens), **{k: torch.from_numpy(v) for k, v in ex.items()}})


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_logits_match_reference(arch):
    jm, jparams, tm, tparams = _pair(arch)
    jbatch, tbatch = batches(tm.cfg, _tokens(tm.cfg, 2), 7)
    want = np.asarray(_jforward(jm)(jparams, jbatch))
    got = tm.forward(tparams, tbatch)
    assert tuple(got.shape) == (B, S, tm.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, **PREFILL_TOL)


def prefill_and_decode_match(jm, jparams, tm, tparams, toks, seed, p):
    """Prefill ``toks[:, :p]`` and decode the rest token by token in both
    packages, the vlm with its image embeddings as each step's memory: the
    logits of every step and the caches' end state agree."""
    jbatch, tbatch = batches(tm.cfg, toks[:, :p], seed)
    jmem, tmem = jbatch.get("image_embeds"), tbatch.get("image_embeds")
    jcache = jm.init_cache(B, S, dtype=jnp.float32)
    jlog, jcache = jax.jit(jm.prefill)(jparams, jbatch, jcache)
    tcache = tm.init_cache(B, S, dtype=torch.float32, device="cpu")
    tlog, tcache = tm.prefill(tparams, tbatch, tcache)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **PREFILL_TOL)
    jdecode = jax.jit(jm.decode_step)
    for t in range(p, S):
        jlog, jcache = jdecode(
            jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t, jnp.int32), jmem
        )
        tlog, tcache = tm.decode_step(tparams, tcache, _t(toks[:, t:t + 1]), t, tmem)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **DECODE_TOL)
    for jleaf, tleaf in zip(jax.tree.leaves(jcache), _leaves(tcache), strict=True):
        np.testing.assert_allclose(tleaf.numpy(), np.asarray(jleaf), **DECODE_TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_each_decode_step_match_reference(arch):
    jm, jparams, tm, tparams = _pair(arch)
    prefill_and_decode_match(jm, jparams, tm, tparams, _tokens(tm.cfg, 3), 8, S - 4)


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
    mixers = {spec.mixer for seg in cfg.segments() for spec in seg.period}
    assert ("wq" in seen) == ("attn" in mixers) and ("A_log" in seen) == ("mamba2" in mixers)
    assert ("router" in seen) == bool(cfg.moe_experts) and ("wkv_a" in seen) == cfg.mla


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


def test_swa_ring_buffer_beyond_window_matches_reference():
    """mixtral with a window of 8 and a 20-token prompt: the prefill writes
    the last window into the ring through ``torch.roll`` and each decode
    step writes slot ``pos % 8``; every step's logits equal the JAX model's
    and the full forward's (``tests/test_arch_smoke.py``'s ring case)."""
    jm, jparams, tm, tparams = _pair("mixtral-8x7b", seed=2, sliding_window=8)
    toks = np.random.default_rng(3).integers(0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    full = tm.forward(tparams, {"tokens": _t(toks)})
    p = 20
    jcache = jm.init_cache(B, S, dtype=jnp.float32)
    jlog, jcache = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :p])}, jcache)
    tcache = tm.init_cache(B, S, dtype=torch.float32, device="cpu")
    assert tcache["seg0"][0]["k"].shape[2] == 8  # (repeats, B, window, Hkv, Dh)
    tlog, tcache = tm.prefill(tparams, {"tokens": _t(toks[:, :p])}, tcache)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **PREFILL_TOL)
    np.testing.assert_allclose(tlog.numpy(), full[:, p - 1].numpy(), **DECODE_TOL)
    jdecode = jax.jit(jm.decode_step)
    for t in range(p, S):
        jlog, jcache = jdecode(
            jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t, jnp.int32)
        )
        tlog, tcache = tm.decode_step(tparams, tcache, _t(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **DECODE_TOL)
        np.testing.assert_allclose(tlog.numpy(), full[:, t].numpy(), **DECODE_TOL)
    for jleaf, tleaf in zip(jax.tree.leaves(jcache), _leaves(tcache), strict=True):
        np.testing.assert_allclose(tleaf.numpy(), np.asarray(jleaf), **DECODE_TOL)


def test_model_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_smoke_config("qwen3-32b")).init(torch.Generator())
