"""The port's multi-head latent attention on the CPU vs the JAX package's.

``mla_attention`` in float32 on the JAX ``init_mla`` weights: the
decompressed prefill below 2048 tokens, the query-chunked prefill at 2048
(four chunks of 512, the reference's ``lax.scan``), the compressed cache it
fills, and the absorbed decode over that cache, with and without the
query's low-rank projection.  Tolerance: the reference serving contract's
3e-4 for prefill outputs, 5e-4 for decode (``tests/test_arch_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mla as jmla
from repro.configs.base import ModelConfig as JConfig
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.models import mla as tmla

PREFILL_TOL = dict(rtol=3e-4, atol=3e-4)
DECODE_TOL = dict(rtol=5e-4, atol=5e-4)


def _setup(q_lora, seed=0):
    """deepseek-v2's smoke widths in both packages, and the same weights."""
    base = dict(
        name="mla-test", family="moe", source="[test]", num_layers=1, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=64, vocab_size=64, mla=True,
        kv_lora_rank=32, q_lora_rank=q_lora, rope_head_dim=8, rope_theta=1e4,
        dtype="float32",
    )
    jcfg, tcfg = JConfig(**base), TConfig(**base)
    jp = jmla.init_mla(jax.random.key(seed), jcfg)
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _x(b, l, seed):
    x = np.random.default_rng(seed).normal(size=(b, l, 64)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _positions(b, l, start=0):
    pos = np.broadcast_to(np.arange(start, start + l), (b, l)).astype(np.int32)
    return jnp.asarray(pos), torch.from_numpy(pos.astype(np.int64))


@pytest.mark.parametrize("q_lora", [48, 0])
@pytest.mark.parametrize("l", [24, 2048])
def test_prefill_matches_reference(l, q_lora, monkeypatch):
    """Below 2048 tokens one pass; at 2048 the reference chunks the queries
    by 512, and so does the port (four chunks, counted)."""
    jcfg, tcfg, jp, tp = _setup(q_lora)
    b = 1 if l == 2048 else 2
    jx, tx = _x(b, l, 1)
    jpos, tpos = _positions(b, l)
    want, _ = jax.jit(lambda p, x, pos: jmla.mla_attention(p, jcfg, x, positions=pos))(
        jp, jx, jpos)
    chunks = []
    real = tmla._q_chunk_attn
    monkeypatch.setattr(tmla, "_q_chunk_attn",
                        lambda qn, *a: chunks.append(qn.shape[1]) or real(qn, *a))
    got, cache = tmla.mla_attention(tp, tcfg, tx, positions=tpos)
    assert cache is None and chunks == ([512] * 4 if l == 2048 else [l])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PREFILL_TOL)


@pytest.mark.parametrize("q_lora", [48, 0])
def test_prefill_cache_and_absorbed_decode_match_reference(q_lora):
    """A 20-token prefill fills the compressed cache (``ckv``, ``krope``);
    four absorbed decode steps then read it and each writes its own row."""
    jcfg, tcfg, jp, tp = _setup(q_lora, seed=2)
    b, s, p = 2, 24, 20
    jx, tx = _x(b, s, 3)
    jcache = {"ckv": jnp.zeros((b, s, 32), jnp.float32), "krope": jnp.zeros((b, s, 8), jnp.float32)}
    tcache = {"ckv": torch.zeros((b, s, 32)), "krope": torch.zeros((b, s, 8))}
    jpos, tpos = _positions(b, p)
    want, jcache = jmla.mla_attention(jp, jcfg, jx[:, :p], positions=jpos, cache=jcache,
                                      cache_pos=jnp.asarray(0, jnp.int32))
    got, tcache2 = tmla.mla_attention(tp, tcfg, tx[:, :p], positions=tpos, cache=tcache,
                                      cache_pos=0)
    assert tcache2 is tcache  # filled in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PREFILL_TOL)
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **PREFILL_TOL)
    jdecode = jax.jit(lambda p, x, pos, c, cp: jmla.mla_attention(
        p, jcfg, x, positions=pos, cache=c, cache_pos=cp))
    for t in range(p, s):
        jpos, tpos = _positions(b, 1, t)
        want, jcache = jdecode(jp, jx[:, t:t + 1], jpos, jcache, jnp.asarray(t, jnp.int32))
        got, _ = tmla.mla_attention(tp, tcfg, tx[:, t:t + 1], positions=tpos, cache=tcache,
                                    cache_pos=t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DECODE_TOL)
        for name in ("ckv", "krope"):
            np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                       **DECODE_TOL)


def test_absorbed_decode_equals_decompressed_prefill():
    """The absorbed step at position t gives the decompressed prefill's row t
    (the two forms are the same function)."""
    _, tcfg, _, tp = _setup(48, seed=4)
    b, s = 2, 16
    _, tx = _x(b, s, 5)
    _, tpos = _positions(b, s)
    full, _ = tmla.mla_attention(tp, tcfg, tx, positions=tpos)
    cache = {"ckv": torch.zeros((b, s, 32)), "krope": torch.zeros((b, s, 8))}
    tmla.mla_attention(tp, tcfg, tx[:, :8], positions=tpos[:, :8], cache=cache, cache_pos=0)
    for t in range(8, s):
        step, _ = tmla.mla_attention(tp, tcfg, tx[:, t:t + 1], positions=tpos[:, t:t + 1],
                                     cache=cache, cache_pos=t)
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, t].numpy(), **DECODE_TOL)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_one_layer_model_has_an_empty_moe_segment(device):
    """deepseek-v2's smoke config cut to one layer: its MoE segment repeats
    0 times, and both packages build it with every leaf stacked ``(0, ...)``
    (the reference's ``vmap`` over no keys), on any device."""
    import dataclasses

    from repro.configs import get_smoke_config as j_smoke
    from repro.models import build_model as j_build
    from repro_torch._pytree import tree_leaves
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import _map_with_path
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_smoke_config("deepseek-v2-236b"), num_layers=1)
    assert [s.repeats for s in cfg.segments()] == [1, 0]
    want = jax.eval_shape(j_build(dataclasses.replace(j_smoke("deepseek-v2-236b"),
                                                      num_layers=1)).init, jax.random.key(0))
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    gen = torch.Generator().manual_seed(0) if device == "cpu" else None
    params = build_model(cfg).init(gen, device=device, master=True)
    names: list[str] = []
    _map_with_path(lambda path, _: names.append("/".join(map(str, path))), params)
    got = dict(zip(names, (tuple(t.shape) for t in tree_leaves(params))))
    assert got == want
    assert all(shape[0] == 0 for name, shape in got.items() if name.startswith("seg1/"))
    assert all(t.device.type == device for t in tree_leaves(params))


def test_one_layer_model_loss_matches_reference():
    """The one-layer deepseek-v2 of the test above in f32, its params the
    reference's (``params_from_numpy``): the loss within 1e-5 of the
    reference's (``tests/test_torch_grads.py``'s f32 bound)."""
    import dataclasses

    from repro.configs import get_smoke_config as j_smoke
    from repro.models import build_model as j_build
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.lm import params_from_numpy

    jcfg = dataclasses.replace(j_smoke("deepseek-v2-236b"), num_layers=1, dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("deepseek-v2-236b"), num_layers=1,
                              dtype="float32")
    jm = j_build(jcfg)
    jp = jm.init(jax.random.key(0))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want = jax.jit(jm.loss)(jp, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu", master=True)
    got = build_model(cfg).loss(params, {"tokens": torch.from_numpy(tokens.astype(np.int64)),
                                         "labels": torch.from_numpy(labels.astype(np.int64))})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
