"""Decode-path equivalence in the port: the decomposed (old cache ⊕ new
token) attention that ``cache_impl="decomposed"`` selects against the
port's default write-then-attend path and against the reference's
decomposed path, incl. SWA ring wrap (``tests/test_decode_paths.py``'s
three archs; mixtral's 40 steps wrap its smoke window of 32).  Also: MLA's
two latent writes follow ``"sharded_dus"`` on a (2, 4) mesh, bit-equal to
the default path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.distributed.sharding import decode_rules as j_decode_rules
from repro.distributed.sharding import use_rules as j_use_rules
from repro.launch.mesh import compat_make_mesh as j_make_mesh
from repro.models import build_model as j_build
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import decode_rules, use_rules
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.models import build_model, layers, params_from_numpy

B, PROMPT, STEPS = 2, 6, 40  # 40 steps: wraps mixtral's window=32 ring
TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_decode_paths.py
CPU = torch.device("cpu")


def _pair(arch, **overrides):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **overrides)
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32", **overrides)
    jm = j_build(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    return jm, jax.tree.map(jnp.asarray, tree), build_model(cfg), params_from_numpy(
        tree, cfg, device="cpu")


def _port_run(m, params, toks, rules):
    total = toks.shape[1]
    cache = m.init_cache(B, total, dtype=torch.float32, device="cpu")
    logits, cache = m.prefill(params, {"tokens": torch.from_numpy(toks[:, :PROMPT])}, cache)
    outs = [logits]
    for t in range(PROMPT, total):
        with use_rules(rules):
            logits, cache = m.decode_step(params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        outs.append(logits)
    return np.stack([o.numpy() for o in outs], 1), cache


def _ref_decomposed(jm, jparams, toks):
    total = toks.shape[1]
    rules = dataclasses.replace(j_decode_rules(j_make_mesh((1, 1), ("data", "model"))),
                                cache_impl="decomposed")
    cache = jm.init_cache(B, total, dtype=jnp.float32)
    logits, cache = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                                        cache)
    outs = [logits]
    with j_use_rules(rules):  # read while the step traces
        step = jax.jit(jm.decode_step)
        for t in range(PROMPT, total):
            logits, cache = step(jparams, cache, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.asarray(t, jnp.int32))
            outs.append(logits)
    return np.stack([np.asarray(o) for o in outs], 1)


@pytest.mark.parametrize("arch", ["qwen3-32b", "mixtral-8x7b", "qwen2-72b"])
def test_decomposed_decode_matches_default_and_reference(arch, monkeypatch):
    jm, jparams, m, params = _pair(arch)
    toks = np.random.default_rng(1).integers(0, m.cfg.vocab_size, (B, PROMPT + STEPS),
                                             dtype=np.int32)
    toks64 = toks.astype(np.int64)
    calls = []
    real = layers._sdpa_decode_decomposed
    monkeypatch.setattr(layers, "_sdpa_decode_decomposed",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    mesh = compat_make_mesh((1, 1), ("data", "model"), devices=(CPU,))
    base, base_cache = _port_run(m, params, toks64, None)
    assert not calls
    dec, dec_cache = _port_run(m, params, toks64,
                               dataclasses.replace(decode_rules(mesh), cache_impl="decomposed"))
    n_attn = sum(seg.repeats * sum(s.mixer == "attn" for s in seg.period)
                 for seg in m.cfg.segments())
    assert len(calls) == STEPS * n_attn  # every decode step's every layer decomposed
    np.testing.assert_allclose(dec, base, **TOL)
    np.testing.assert_allclose(dec, _ref_decomposed(jm, jparams, toks), **TOL)
    # the cache holds the same rows (a later layer's k/v carry the earlier
    # layers' rounding): each written once, after attending
    for a, b in zip(jax.tree.leaves(dec_cache), jax.tree.leaves(base_cache)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_mla_latent_writes_follow_sharded_dus(monkeypatch):
    """deepseek-v2's MLA decode writes ``ckv`` and ``krope`` through
    ``cache_write``; under ``"sharded_dus"`` on a (2, 4) mesh (the cache's
    sequence over model) they run as one ``shard_map`` each, and the logits
    and caches equal the default path's bit for bit."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-v2-236b"), dtype="float32")
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 16)))
    mesh = compat_make_mesh((2, 4), ("data", "model"), devices=(CPU,))
    rules = dataclasses.replace(decode_rules(mesh), cache_impl="sharded_dus")
    sharded = []
    real = layers._cache_write_sharded

    def spy(*a):
        sharded.append(real(*a))
        return sharded[-1]

    monkeypatch.setattr(layers, "_cache_write_sharded", spy)
    runs = []
    for r in (None, rules):
        cache = m.init_cache(B, 16, dtype=torch.float32, device="cpu")
        logits, cache = m.prefill(params, {"tokens": toks[:, :8]}, cache)
        outs = [logits]
        for t in range(8, 16):
            with use_rules(r):
                logits, cache = m.decode_step(params, cache, toks[:, t:t + 1], t)
            outs.append(logits)
        runs.append((torch.stack(outs), cache))
    assert sharded and all(sharded) and len(sharded) == 8 * 2 * cfg.num_layers
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(jax.tree.leaves(runs[0][1]), jax.tree.leaves(runs[1][1])):
        assert torch.equal(a, b)
