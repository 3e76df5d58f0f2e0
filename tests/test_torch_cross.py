"""Cross-attention and the encoder in the port against the JAX package, on the CPU.

The same numpy inputs go to both packages: one cross-attention layer
(whisper-tiny's and llama-3.2-vision-11b's smoke widths), whisper's encoder,
and whole models, in float32 within the reference's serving tolerances
(3e-4 for forward and prefill, 5e-4 for decode).  Every carried tree has its
cross-attention gates at seeded values in [0.5, 1.5]: the reference draws
them 0, and ``tanh(0) * out`` would let a wrong cross path match exactly
(the last test shows that the gates reach the logits).  On the CPU the
flash route runs the kernel's plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import (
    B,
    DECODE_TOL,
    PREFILL_TOL,
    S,
    _jforward,
    _pair,
    _tokens,
    batches,
    extras,
    prefill_and_decode_match,
    set_gates,
)

from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.models import layers as JL
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models.lm import CAST_LEAVES

CROSS_ARCHS = ["whisper-tiny", "llama-3.2-vision-11b"]
PROMPT = 7


def _memory_shape(cfg):
    if cfg.family == "vlm":
        return (B, cfg.image_tokens, cfg.image_embed_dim)
    return (B, cfg.encoder_seq, cfg.d_model)


def _cross_layer(arch, seed, qk_norm):
    """One cross layer's configs, weights (numpy: seeded gate, and seeded
    qk-norm weights under the override), a prompt's activations and two
    memories."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", qk_norm=qk_norm)
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32", qk_norm=qk_norm)
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) for k, v in
         JL.init_attention(jax.random.key(seed), jcfg, cross=True).items()}
    p["gate"] = np.float32(rng.uniform(0.5, 1.5))
    for name in ("q_norm", "k_norm"):
        if name in p:
            p[name] = rng.normal(scale=0.3, size=p[name].shape).astype(np.float32)
    x = rng.normal(size=(B, PROMPT, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    mems = [rng.normal(size=_memory_shape(cfg)).astype(np.float32) for _ in range(2)]
    return cfg, jcfg, p, x, x1, mems


def _jattend(p, jcfg, x, cache, memory):
    b, length, _ = x.shape
    return JL.attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(x),
        positions=jnp.broadcast_to(jnp.arange(length), (b, length)),
        cache=cache, memory=None if memory is None else jnp.asarray(memory))


def _tattend(p, cfg, x, cache, memory):
    b, length, _ = x.shape
    return TL.attention(
        {k: torch.from_numpy(np.array(v)) for k, v in p.items()}, cfg, torch.from_numpy(x),
        positions=torch.arange(length).expand(b, length),
        cache=cache, memory=None if memory is None else torch.from_numpy(memory))


def _assert_cache(tcache, jcache, tol):
    for name in ("k_mem", "v_mem"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **tol)


@pytest.mark.parametrize("mode", ["prefill", "decode_from_cache", "decode_with_memory"])
@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_cross_attention_matches_reference(arch, qk_norm, mode):
    """Prefill projects the memory into the cache; decode without memory
    reads it; decode with memory (what the vlm server does every step)
    projects the new memory again and rewrites the cache.  Outputs and the
    cache's end state equal the reference's."""
    cfg, jcfg, p, x, x1, (mem, mem2) = _cross_layer(arch, 11, qk_norm)
    shape = (B, mem.shape[1], cfg.num_kv_heads, cfg.resolved_head_dim)
    jcache = {"k_mem": jnp.zeros(shape, jnp.float32), "v_mem": jnp.zeros(shape, jnp.float32)}
    tcache = {"k_mem": torch.zeros(shape), "v_mem": torch.zeros(shape)}
    jout, jcache = _jattend(p, jcfg, x, jcache, mem)
    tout, tcache = _tattend(p, cfg, x, tcache, mem)
    if mode == "prefill":
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **PREFILL_TOL)
        _assert_cache(tcache, jcache, PREFILL_TOL)
        return
    step_mem = mem2 if mode == "decode_with_memory" else None
    jout, jcache = _jattend(p, jcfg, x1, jcache, step_mem)
    tout, tcache = _tattend(p, cfg, x1, tcache, step_mem)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **DECODE_TOL)
    _assert_cache(tcache, jcache, DECODE_TOL)


@pytest.mark.parametrize("attn_impl", ["ref", "flash"])
def test_encode_matches_reference(attn_impl):
    """Whisper's encoder (bidirectional, layernorm, its final norm) on the
    same frames; the flash route runs the kernel's plain version here."""
    jm, jparams, tm, tparams = _pair("whisper-tiny", attn_impl=attn_impl)
    frames = extras(tm.cfg, 4)["frames"]
    want = np.asarray(jax.jit(jm._encode)(jparams, jnp.asarray(frames)))
    got = tm._encode(tparams, torch.from_numpy(frames))
    assert tuple(got.shape) == frames.shape
    np.testing.assert_allclose(got.numpy(), want, **PREFILL_TOL)


@pytest.mark.parametrize("arch,overrides", [
    ("llama-3.2-vision-11b", {"num_layers": 10}),            # two periods: stacked cross caches
    ("whisper-tiny", {"num_layers": 3, "encoder_layers": 3}),
])
def test_deeper_stacks_match_reference(arch, overrides):
    jm, jparams, tm, tparams = _pair(arch, seed=5, **overrides)
    toks = _tokens(tm.cfg, 6)
    jbatch, tbatch = batches(tm.cfg, toks, 9)
    np.testing.assert_allclose(tm.forward(tparams, tbatch).numpy(),
                               np.asarray(_jforward(jm)(jparams, jbatch)), **PREFILL_TOL)
    cross = tm.init_cache(B, S, dtype=torch.float32, device="cpu")["seg0"][-1]["k_mem"]
    repeats = tm.cfg.segments()[0].repeats
    assert tuple(cross.shape) == (repeats, *_memory_shape(tm.cfg)[:2], tm.cfg.num_kv_heads,
                                  tm.cfg.resolved_head_dim)
    prefill_and_decode_match(jm, jparams, tm, tparams, toks, 9, S - 3)


def _bf16_values(tree):
    """A numpy tree whose cast leaves are bf16 values, so both packages
    compute with the same weights (the port stores those leaves in bf16)."""
    if isinstance(tree, dict):
        return {k: (np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
                    if k in CAST_LEAVES and not isinstance(v, (dict, tuple, list))
                    else _bf16_values(v)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_bf16_values(v) for v in tree)
    return tree


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_bf16_cross_layer_with_f32_memory_promotes_like_the_reference(arch):
    """A bf16 cross layer decoding with f32 memory: ``jnp.einsum`` promotes
    the projections to f32, and so does the port (``torch.einsum`` would
    reject the mix), so the output is f32 and within the f32 decode
    tolerance (casting the memory to bf16 first misses it by ~3e-3); the
    cache holds the projections in bf16."""
    cfg, jcfg, p, _, x1, (_, mem) = _cross_layer(arch, 11, False)
    cfg, jcfg = (dataclasses.replace(c, dtype="bfloat16") for c in (cfg, jcfg))
    p = _bf16_values(p)
    x1 = np.array(jnp.asarray(x1, jnp.bfloat16).astype(jnp.float32))
    shape = (B, mem.shape[1], cfg.num_kv_heads, cfg.resolved_head_dim)
    jcache = {"k_mem": jnp.zeros(shape, jnp.bfloat16), "v_mem": jnp.zeros(shape, jnp.bfloat16)}
    jout, jcache = JL.attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(x1, jnp.bfloat16),
        positions=jnp.zeros((B, 1), jnp.int32), cache=jcache, memory=jnp.asarray(mem))
    tparams = {k: torch.from_numpy(np.array(v)).to(torch.bfloat16 if k in CAST_LEAVES
                                                    else torch.float32) for k, v in p.items()}
    tcache = {name: torch.zeros(shape, dtype=torch.bfloat16) for name in ("k_mem", "v_mem")}
    tout, tcache = TL.attention(
        tparams, cfg, torch.from_numpy(x1).to(torch.bfloat16),
        positions=torch.zeros((B, 1), dtype=torch.int64), cache=tcache,
        memory=torch.from_numpy(mem))
    assert jout.dtype == jnp.float32 and tout.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **DECODE_TOL)
    for name in ("k_mem", "v_mem"):
        assert tcache[name].dtype == torch.bfloat16
        np.testing.assert_allclose(tcache[name].float().numpy(),
                                   np.asarray(jcache[name], np.float32), **DECODE_TOL)


def test_bf16_vlm_decode_with_f32_image_embeds_promotes_like_the_reference():
    """A bf16 vlm (smoke: one period of 4 self-attention layers and a cross
    layer) prefilled on its image embeddings, then one decode step fed them
    in f32, uncast, as the reference's server passes them: the residual
    stream after the cross layer, and the logits, are f32 in both packages.
    The logits agree within four bf16 steps at their largest magnitude:
    the self-attention layers before the cross layer compute in bf16 in
    both packages, whose products round alike only to a step or two (the
    bf16 prefill's logits differ by 2.5 steps)."""
    cfg, jcfg = get_smoke_config("llama-3.2-vision-11b"), j_smoke("llama-3.2-vision-11b")
    assert cfg.dtype == "bfloat16" and cfg.segments()[0].repeats == 1
    jm, tm = j_build(jcfg), build_model(cfg)
    tree = _bf16_values(set_gates(jax.tree.map(np.asarray, jm.init(jax.random.key(3))), 3))
    jparams, tparams = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, cfg, device="cpu")
    toks = _tokens(cfg, 12)
    jbatch, tbatch = batches(cfg, toks[:, :PROMPT], 13)
    jcache = jm.init_cache(B, S, dtype=jnp.bfloat16)
    _, jcache = jax.jit(jm.prefill)(jparams, jbatch, jcache)
    tcache = tm.init_cache(B, S, dtype=torch.bfloat16, device="cpu")
    _, tcache = tm.prefill(tparams, tbatch, tcache)
    tok = toks[:, PROMPT:PROMPT + 1]
    jlog, _ = jax.jit(jm.decode_step)(jparams, jcache, jnp.asarray(tok),
                                      jnp.asarray(PROMPT, jnp.int32), jbatch["image_embeds"])
    tlog, _ = tm.decode_step(tparams, tcache, torch.from_numpy(tok.astype(np.int64)), PROMPT,
                             tbatch["image_embeds"])
    assert jlog.dtype == jnp.float32 and tlog.dtype == torch.float32
    want = np.asarray(jlog)
    np.testing.assert_allclose(tlog.numpy(), want, rtol=0,
                               atol=4 * 2.0**-8 * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_flash_route_runs_encoder_and_cross_calls(arch, monkeypatch):
    """Under ``attn_impl="flash"`` one prefill calls the kernel's wrapper once
    per attention layer: causal for the decoder's self-attention, not causal
    for the encoder's and for cross-attention (Lq the prompt, Lk the
    memory); the logits equal the ref route's."""
    _, _, ref_model, tparams = _pair(arch)
    flash_model = build_model(dataclasses.replace(ref_model.cfg, attn_impl="flash"))
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, **kw: calls.append(
        (q.shape[1], k.shape[1], kw["causal"])) or real(q, k, v, **kw))
    _, tbatch = batches(ref_model.cfg, _tokens(ref_model.cfg, 14), 15)
    logits = {}
    for name, model in (("ref", ref_model), ("flash", flash_model)):
        cache = model.init_cache(B, S, dtype=torch.float32, device="cpu")
        logits[name], _ = model.prefill(tparams, tbatch, cache)
    np.testing.assert_allclose(logits["flash"].numpy(), logits["ref"].numpy(), **PREFILL_TOL)
    cfg = ref_model.cfg
    mixers = [spec.mixer for seg in (*cfg.segments(), *cfg.encoder_segments())
              for spec in seg.period for _ in range(seg.repeats)]
    m = _memory_shape(cfg)[1]
    want = sorted({"attn": (S, S, True), "enc_attn": (m, m, False),
                   "cross_attn": (S, m, False)}[mx] for mx in mixers)
    assert sorted(calls) == want


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_zero_gates_change_the_logits(arch):
    """With the reference's own zero gates both packages still agree, and
    the logits differ from the gated model's: the memory reaches them."""
    jm, jparams, tm, tparams = _pair(arch)
    zero = jax.tree.map(np.asarray, jm.init(jax.random.key(1)))  # gates 0, as drawn
    jbatch, tbatch = batches(tm.cfg, _tokens(tm.cfg, 16), 17)
    gated = tm.forward(tparams, tbatch).numpy()
    ungated = tm.forward(params_from_numpy(zero, tm.cfg, device="cpu"), tbatch).numpy()
    np.testing.assert_allclose(
        ungated, np.asarray(_jforward(jm)(jax.tree.map(jnp.asarray, zero), jbatch)), **PREFILL_TOL)
    assert np.abs(gated - ungated).max() > 100 * PREFILL_TOL["atol"]
