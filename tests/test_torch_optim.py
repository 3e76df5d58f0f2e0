"""The port's optimizer substrate on the CPU, alone and against the JAX package.

Every case of ``tests/test_optim.py`` runs on the port, then the parity
cases feed the same numpy inputs to both packages (JAX with
``JAX_PLATFORMS=cpu``): ``cosine_schedule`` at every step, one
``adamw_update`` (rtol 1e-6: the same f32 arithmetic in the same order, up
to the last ulp of ``pow``/``sqrt``), ``accumulate_gradients`` in each mode
and with ``hoist`` on the quadratic and on lm1m in f32, int8 codes
(exactly), and top-k with planted ties (``lax.top_k``'s order, exactly).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as jopt
import repro.optim.compression as jcomp
from repro.launch.train import _preset as j_preset
from repro.models import build_model as j_build
from repro_torch._pytree import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import (
    AdamWState,
    accumulate_gradients,
    adamw_init,
    adamw_update,
    cosine_schedule,
)
from repro_torch.optim.adamw import global_norm
from repro_torch.optim.compression import (
    ErrorFeedback,
    compress_with_feedback,
    int8_compress,
    int8_decompress,
    topk_compress,
    topk_decompress,
)
from repro_torch.optim.grad_accum import hoist_params_bf16, value_and_grad

MODES = ("spliter", "spliter_unrolled", "materialized")


def _quad_loss(params, batch):
    # simple convex objective: || w·x - y ||²
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2)


def _j_quad_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return jnp.mean((pred - batch["y"]) ** 2)


def _problem_np(seed=0, n=64, d=8):
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal((d,)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = x @ w_true + 0.01 * rng.standard_normal(n).astype(np.float32)
    return {"w": np.zeros((d,), np.float32), "b": np.zeros((), np.float32)}, {"x": x, "y": y}


def _problem(seed=0, n=64, d=8):
    params, batch = _problem_np(seed, n, d)
    return ({k: torch.from_numpy(v) for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _blocked(batch, nb):
    return {k: v.reshape((nb, v.shape[0] // nb) + tuple(v.shape[1:])) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# tests/test_optim.py on the port
# ---------------------------------------------------------------------------


def test_adamw_converges_on_quadratic():
    params, batch = _problem()
    opt = adamw_init(params)
    for _ in range(300):
        loss, g = value_and_grad(_quad_loss, params, batch)
        params, opt = adamw_update(params, g, opt, lr=3e-2, weight_decay=0.0)
    assert float(_quad_loss(params, batch)) < 1e-2


def test_adamw_weight_decay_shrinks_weights():
    params = {"w": torch.ones(4)}
    opt = adamw_init(params)
    p2, _ = adamw_update(params, {"w": torch.zeros(4)}, opt, lr=1e-1, weight_decay=0.5)
    assert float(torch.max(p2["w"])) < 1.0  # decoupled decay applied


def test_cosine_schedule_shape():
    peak, warm, total = 1e-3, 10, 100
    lrs = [float(cosine_schedule(s, peak_lr=peak, warmup_steps=warm, total_steps=total))
           for s in range(total)]
    assert lrs[0] < lrs[9] <= peak * 1.0001
    assert abs(lrs[10] - peak) < 1e-9 or lrs[9] <= peak
    assert lrs[-1] < 0.11 * peak  # decayed to ~10% floor or below
    assert all(lr >= 0 for lr in lrs)


def test_accumulation_modes_equivalent():
    params, batch = _problem(n=64)
    blocks = _blocked(batch, 4)
    l1, g1 = accumulate_gradients(_quad_loss, params, blocks, mode="spliter")
    l2, g2 = accumulate_gradients(_quad_loss, params, blocks, mode="materialized")
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    for a, b in zip(tree_leaves(g1), tree_leaves(g2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_int8_roundtrip_error_bound():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((16, 256)).astype(np.float32))
    q, s = int8_compress(x)
    back = int8_decompress(q, s)
    err = (back - x).abs().numpy()
    assert (err <= s.numpy() / 2 * 1.01 + 1e-7).all()


def test_topk_roundtrip():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((64,)).astype(np.float32))
    v, i = topk_compress(x, 8)
    back = topk_decompress(v, i, (64,))
    nz = np.nonzero(back.numpy())[0]
    assert len(nz) == 8
    assert set(nz) == set(np.argsort(-np.abs(x.numpy()))[:8])


def test_error_feedback_preserves_sum():
    """EF: Σ_t decompressed_t == Σ_t grad_t + residual_T (unbiased over time)."""
    rng = np.random.default_rng(3)
    grads = [{"w": torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))}
             for _ in range(20)]
    ef = ErrorFeedback.init(grads[0])
    sent_sum = np.zeros((4, 32), np.float32)
    true_sum = np.zeros((4, 32), np.float32)
    for g in grads:
        sent, ef = compress_with_feedback(g, ef)
        sent_sum += sent["w"].numpy()
        true_sum += g["w"].numpy()
    assert np.abs(sent_sum + ef.residual["w"].numpy() - true_sum).max() < 1e-3


def test_error_feedback_training_converges():
    params, batch = _problem(seed=4)
    opt = adamw_init(params)
    ef = None
    for _ in range(300):
        _, g = value_and_grad(_quad_loss, params, batch)
        if ef is None:
            ef = ErrorFeedback.init(g)
        g, ef = compress_with_feedback(g, ef)
        params, opt = adamw_update(params, g, opt, lr=3e-2, weight_decay=0.0)
    assert float(_quad_loss(params, batch)) < 2e-2


def test_hoist_params_matches_baseline():
    params, batch = _problem(seed=5, n=32)
    blocks = _blocked(batch, 2)
    l0, g0 = accumulate_gradients(_quad_loss, params, blocks, mode="spliter")
    l1, g1 = accumulate_gradients(_quad_loss, params, blocks, mode="spliter", hoist=True)
    np.testing.assert_allclose(float(l0), float(l1), rtol=2e-2)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-2, atol=3e-2)


def test_unrolled_accumulation_equals_scan():
    params, batch = _problem(seed=6, n=48)
    blocks = _blocked(batch, 3)
    l0, g0 = accumulate_gradients(_quad_loss, params, blocks, mode="spliter")
    l1, g1 = accumulate_gradients(_quad_loss, params, blocks, mode="spliter_unrolled")
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# the port's own contract
# ---------------------------------------------------------------------------


def test_per_block_raises_as_the_reference():
    params, batch = _problem()
    with pytest.raises(ValueError, match="per_block"):
        accumulate_gradients(_quad_loss, params, _blocked(batch, 2), mode="per_block")


def test_accumulation_leaves_params_untouched_and_gradient_free():
    params, batch = _problem(seed=7)
    params = {k: v + 0.5 for k, v in params.items()}
    before = {k: v.clone() for k, v in params.items()}
    loss, grads = accumulate_gradients(_quad_loss, params, _blocked(batch, 4))
    assert loss.requires_grad is False and loss.dtype == torch.float32
    for k in params:
        assert not params[k].requires_grad and torch.equal(params[k], before[k])
        assert grads[k].dtype == torch.float32 and not grads[k].requires_grad


def test_hoist_casts_matrices_only_and_applies_the_constraint():
    params = {"m": torch.ones(2, 3), "v": torch.ones(3), "s": torch.ones(()),
              "i": torch.ones(2, 2, dtype=torch.int32)}
    seen = []
    out = hoist_params_bf16(params, lambda t: seen.append(t) or t)
    assert out["m"].dtype == torch.bfloat16 and out["v"].dtype == torch.float32
    assert out["s"].dtype == torch.float32 and out["i"].dtype == torch.int32
    assert seen == [out]


def test_adamw_state_is_a_tree_in_field_order():
    params = {"b": torch.zeros(2), "a": torch.zeros(3, 2, dtype=torch.bfloat16)}
    opt = adamw_init(params)
    assert opt.step.dtype == torch.int32 and opt.step.shape == ()
    assert all(leaf.dtype == torch.float32 for leaf in tree_leaves((opt.m, opt.v)))
    leaves = tree_leaves(opt)
    assert leaves[0] is opt.step and len(leaves) == 5
    doubled = tree_map(lambda t: t + 1, opt)
    assert isinstance(doubled, AdamWState) and int(doubled.step) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_update_writes_its_inputs_in_place(dtype):
    """The update returns the tensors it was given, holding what the same
    update of a copy returns."""
    rng = np.random.default_rng(8)
    mk = lambda: {"w": torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))}  # noqa: E731
    params, grads = {"w": mk()["w"].to(dtype)}, mk()
    before = params["w"].clone()
    copy = {"w": params["w"].clone()}
    ref_p, ref_o = adamw_update(copy, grads, adamw_init(copy), lr=1e-2)
    opt = adamw_init(params)
    new_p, new_o = adamw_update(params, grads, opt, lr=1e-2)
    assert new_p["w"] is params["w"] and new_p["w"].dtype == dtype
    assert new_o.m["w"] is opt.m["w"] and new_o.v["w"] is opt.v["w"]
    assert not torch.equal(new_p["w"], before)
    for a, b in ((new_p, ref_p), (new_o.m, ref_o.m), (new_o.v, ref_o.v)):
        assert torch.equal(a["w"], b["w"])


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("peak,warm,total", [(1e-3, 10, 100), (3e-3, 2, 12), (1e-3, 20, 50),
                                             (5e-4, 0, 7)])
def test_cosine_schedule_matches_reference_at_every_step(peak, warm, total):
    kw = dict(peak_lr=peak, warmup_steps=warm, total_steps=total)
    for s in range(total + 3):
        got = cosine_schedule(torch.tensor(s, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jopt.cosine_schedule(s, **kw)),
                                   rtol=1e-6, atol=0)


def _np_tree(rng, dtype=np.float32):
    return {"embed": rng.standard_normal((6, 4)).astype(dtype),
            "seg0": ({"w": rng.standard_normal((4, 3)).astype(dtype),
                      "ln": rng.standard_normal((3,)).astype(dtype)},),
            "gate": np.asarray(rng.standard_normal(), dtype)}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("step", [0, 5])
def test_adamw_update_matches_reference(grad_scale, step):
    """One update from the same params, grads and state (a non-zero state
    at step 5): params, moments and step within rtol 1e-6."""
    rng = np.random.default_rng(9 + step)
    p = _np_tree(rng)
    g = tree_map(lambda a: (a * grad_scale).astype(np.float32), _np_tree(rng))
    m = tree_map(lambda a: a * 0.01, _np_tree(rng)) if step else tree_map(np.zeros_like, p)
    v = tree_map(lambda a: a * a * 1e-3, _np_tree(rng)) if step else tree_map(np.zeros_like, p)
    kw = dict(lr=3e-3, weight_decay=0.1)
    jstate = jopt.AdamWState(step=jnp.asarray(step, jnp.int32), m=jax.tree.map(jnp.asarray, m),
                             v=jax.tree.map(jnp.asarray, v))
    jp, jo = jopt.adamw_update(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
                               jstate, **kw)
    t = lambda tree: tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)  # noqa: E731
    tstate = AdamWState(step=torch.tensor(step, dtype=torch.int32), m=t(m), v=t(v))
    tp, to = adamw_update(t(p), t(g), tstate, **kw)
    np.testing.assert_allclose(float(global_norm(t(g))), float(jopt.adamw.global_norm(g)),
                               rtol=1e-6)
    assert int(to.step) == int(jo.step) == step + 1
    for got, want in ((tp, jp), (to.m, jo.m), (to.v, jo.v)):
        for a, b in zip(_jax_order(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


def test_adamw_update_keeps_a_bf16_leaf_bf16_like_the_reference():
    rng = np.random.default_rng(11)
    p = rng.standard_normal((8, 8)).astype(np.float32)
    g = rng.standard_normal((8, 8)).astype(np.float32)
    jp, _ = jopt.adamw_update({"w": jnp.asarray(p, jnp.bfloat16)}, {"w": jnp.asarray(g)},
                              jopt.adamw_init({"w": jnp.asarray(p, jnp.bfloat16)}), lr=1e-1)
    tp, _ = adamw_update({"w": torch.from_numpy(p).bfloat16()}, {"w": torch.from_numpy(g)},
                         adamw_init({"w": torch.from_numpy(p).bfloat16()}), lr=1e-1)
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["w"].float().numpy(), np.asarray(jp["w"], np.float32))


def _jax_order(tree):
    """The leaves of a port tree in ``jax.tree.leaves``' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _jax_order(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _jax_order(t)]
    return [tree]


@pytest.mark.parametrize("hoist", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_accumulate_quadratic_matches_reference(mode, hoist):
    params, batch = _problem_np(seed=12, n=48, d=8)
    params = {"w": np.linspace(-1, 1, 8).astype(np.float32), "b": np.float32(0.3)}
    nb = 3
    jl, jg = jopt.accumulate_gradients(
        _j_quad_loss, jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v.reshape((nb, -1) + v.shape[1:])) for k, v in batch.items()},
        mode=mode, hoist=hoist)
    tl, tg = accumulate_gradients(
        _quad_loss, tree_map(torch.tensor, params),
        _blocked({k: torch.from_numpy(v) for k, v in batch.items()}, nb), mode=mode, hoist=hoist)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for k in params:
        assert tg[k].dtype == torch.float32
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=1e-5, atol=1e-6)


def _lm1m_pair(seed=0):
    jcfg = dataclasses.replace(j_preset("lm1m"), dtype="float32")
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    jm = j_build(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return jm, jax.tree.map(jnp.asarray, tree), build_model(cfg), params_from_numpy(
        tree, cfg, device="cpu", master=True)


@pytest.mark.parametrize("hoist", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_accumulate_lm1m_matches_reference(mode, hoist):
    """lm1m in f32, two blocks of 4 × 32 tokens: the mean loss and every
    gradient leaf against the JAX package's (hoisted: its bf16 products
    against the JAX package's bf16 products)."""
    jm, jparams, tm, tparams = _lm1m_pair()
    rng = np.random.default_rng(13)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 4, 33)).astype(np.int32)
    blocks = {"tokens": toks[..., :-1], "labels": toks[..., 1:].copy()}
    blocks["labels"][0, 0, :5] = -1  # masked positions
    jl, jg = jax.jit(lambda p, b: jopt.accumulate_gradients(jm.loss, p, b, mode=mode,
                                                            hoist=hoist))(
        jparams, {k: jnp.asarray(v) for k, v in blocks.items()})
    tl, tg = accumulate_gradients(tm.loss, tparams,
                                  {k: torch.from_numpy(v) for k, v in blocks.items()},
                                  mode=mode, hoist=hoist)
    tol = dict(rtol=2e-2, atol=2e-3) if hoist else dict(rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-2 if hoist else 1e-5)
    got, want = _jax_order(tg), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


def test_int8_codes_equal_reference_exactly():
    """Codes and scales bit for bit, half-way values included (round half
    to even on both sides)."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    x[0, :4] = [127.0, 63.5, -0.5, 1.5]  # scale 1: exact halves
    x[1, :3] = [254.0, 1.0, 3.0]         # scale 2: 0.5 and 1.5 again
    jq, js = jcomp.int8_compress(jnp.asarray(x))
    tq, ts = int8_compress(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(int8_decompress(tq, ts).numpy(),
                                  np.asarray(jcomp.int8_decompress(jq, js)))


def test_error_feedback_matches_reference():
    rng = np.random.default_rng(15)
    grads = [{"w": rng.standard_normal((4, 32)).astype(np.float32),
              "s": np.float32(rng.standard_normal())} for _ in range(5)]
    jef = jcomp.ErrorFeedback.init(jax.tree.map(jnp.asarray, grads[0]))
    tef = ErrorFeedback.init(tree_map(torch.tensor, grads[0]))
    for g in grads:
        jsent, jef = jcomp.compress_with_feedback(jax.tree.map(jnp.asarray, g), jef)
        tsent, tef = compress_with_feedback(tree_map(torch.tensor, g), tef)
        for k in g:
            np.testing.assert_array_equal(tsent[k].numpy(), np.asarray(jsent[k]))
            np.testing.assert_array_equal(tef.residual[k].numpy(), np.asarray(jef.residual[k]))


@pytest.mark.parametrize("k", [1, 5, 9, 16])
def test_topk_planted_ties_keep_lax_top_k_order(k):
    """Equal magnitudes (and a value against its negation) come out lower
    index first, as ``lax.top_k`` orders them."""
    x = np.zeros((24,), np.float32)
    x[[3, 7, 11, 19]] = [2.0, -2.0, 2.0, -2.0]
    x[[1, 5, 6, 20, 23]] = [0.5, -0.5, 0.5, 0.5, -0.5]
    x[[0, 2]] = [3.0, 1.0]
    jv, ji = jcomp.topk_compress(jnp.asarray(x), k)
    tv, ti = topk_compress(torch.from_numpy(x), k)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(topk_decompress(tv, ti, (4, 6)).numpy(),
                                  np.asarray(jcomp.topk_decompress(jv, ji, (4, 6))))
