"""The port's MoE MLP on the CPU vs the JAX package's, on the same weights.

Every case of ``tests/test_moe.py`` and ``tests/test_moe_properties.py``,
each run through both packages on the same numpy inputs in float32 and
held to the reference's 2e-5; the gradient case (``test_onehot_grads_finite``)
also holds the port's gradients to ``jax.grad``'s.  The onehot dispatch's kept/dropped (token, expert) sets
must be equal exactly: the JAX side's are read from its dispatch tensor
(captured where the reference hands it to ``shard``), the port's from its
route recorder (``moe_mlp.routes``).  The places where a faithful port most
easily diverges each have a case: ``lax.top_k``'s tie order (a zero router,
planted ties), a dropped choice's out-of-range slot, the choice-major slot
priority at several capacity factors, the virtual split, token counts 1–7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
from repro.configs.base import ModelConfig as JConfig
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.models import moe as tmoe

TOL = dict(rtol=2e-5, atol=2e-5)


def _cfgs(**kw):
    """The same config in both packages (``tests/test_moe.py``'s ``_cfg``)."""
    base = dict(
        name="moe-test", family="moe", source="[test]",
        num_layers=1, d_model=32, num_heads=4, num_kv_heads=4, d_ff=64,
        vocab_size=64, moe_experts=8, moe_top_k=2, moe_d_ff=64,
        dtype="float32",
    )
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def _params(jcfg, seed):
    """JAX ``init_moe`` weights, and the same values as port tensors."""
    jp = jmoe.init_moe(jax.random.key(seed), jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), jp)
    return jp, tp


def _x(d, b=2, l=16, seed=0):
    x = np.random.default_rng(seed).normal(size=(b, l, d)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _jax_onehot(jp, jcfg, jx, monkeypatch):
    """The JAX onehot output and its kept (token, virtual expert) set, read
    from the dispatch tensor ``disp (n, g, ev, cap)`` (1 where a kept choice
    sits in a slot)."""
    seen = []

    def record(a, *axes):
        seen.append(a)
        return a

    monkeypatch.setattr(jmoe, "shard", record)
    y = jmoe._moe_onehot(jp, jcfg, jx)
    disp = np.asarray(seen[1])  # xg, then disp
    kept = disp.sum(-1).reshape(-1, disp.shape[2]) > 0  # (t, ev)
    return np.asarray(y), kept


def _port_onehot(tp, tcfg, tx):
    """The port's onehot output and its kept (token, virtual expert) set,
    from the route recorder; also the recorded dropped choices."""
    tmoe.moe_mlp.routes = []
    try:
        y = tmoe._moe_onehot(tp, tcfg, tx)
        (rec,) = tmoe.moe_mlp.routes
    finally:
        tmoe.moe_mlp.routes = None
    experts = rec["experts"].reshape(-1, tcfg.moe_top_k)
    dropped = rec["dropped"].reshape(-1, tcfg.moe_top_k)
    vs = tcfg.moe_virtual_split
    kept = np.zeros((experts.shape[0], tcfg.moe_experts * vs), bool)
    for t, (row, drow) in enumerate(zip(experts.tolist(), dropped.tolist())):
        for e, dropped_choice in zip(row, drow):
            if not dropped_choice:
                kept[t, e * vs:(e + 1) * vs] = True
    return y.numpy(), kept, dropped


def _split_ef(w):  # (E, D, F) -> (2E, D, F/2)
    e, d, f = w.shape
    return w.reshape(e, d, 2, f // 2).permute(0, 2, 1, 3).reshape(2 * e, d, f // 2)


def _split_fd(w):  # (E, F, D) -> (2E, F/2, D)
    e, f, d = w.shape
    return w.reshape(2 * e, f // 2, d)


# ---------------------------------------------------------------------------
# the onehot dispatch against JAX's: outputs and kept/dropped sets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])  # 4.0 = E/k: dropless
def test_onehot_kept_sets_and_outputs_match_reference(cf, monkeypatch):
    jcfg, tcfg = _cfgs(moe_capacity_factor=cf)
    jp, tp = _params(jcfg, 1)
    jx, tx = _x(32, b=4, l=32, seed=2)
    want, jkept = _jax_onehot(jp, jcfg, jx, monkeypatch)
    got, tkept, dropped = _port_onehot(tp, tcfg, tx)
    np.testing.assert_array_equal(tkept, jkept)
    np.testing.assert_allclose(got, want, **TOL)
    assert bool(dropped.any()) == (cf < 4.0)  # 0.5 and 1.25 drop; E/k does not


@pytest.mark.parametrize("cf", [0.5, 1.0])
def test_virtual_split_matches_reference(cf, monkeypatch):
    """vs = 2 (mixtral's): ``idx·vs + j`` with the gate repeated; a split's
    slices are kept or dropped together, in both packages."""
    jcfg, tcfg = _cfgs(moe_capacity_factor=cf, moe_virtual_split=2)
    jp, tp = _params(jcfg, 3)
    jx, tx = _x(32, b=4, l=32, seed=4)
    want, jkept = _jax_onehot(jp, jcfg, jx, monkeypatch)
    got, tkept, dropped = _port_onehot(tp, tcfg, tx)
    np.testing.assert_array_equal(tkept, jkept)
    np.testing.assert_allclose(got, want, **TOL)
    assert bool(dropped.any())


def test_virtual_split_is_exact():
    """vs=2 on reshaped weights == vs=1 in the port, and both equal JAX's
    vs=1 output (``test_moe.py::test_virtual_split_is_exact``)."""
    jcfg1, tcfg1 = _cfgs(moe_capacity_factor=4.0)
    tcfg2 = dataclasses.replace(tcfg1, moe_virtual_split=2)
    jp1, tp1 = _params(jcfg1, 4)
    tp2 = {
        "router": tp1["router"],
        "experts_gate": _split_ef(tp1["experts_gate"]),
        "experts_up": _split_ef(tp1["experts_up"]),
        "experts_down": _split_fd(tp1["experts_down"]),
    }
    jx, tx = _x(32, seed=5)
    want = np.asarray(jmoe.moe_mlp(jp1, jcfg1, jx))
    y1 = tmoe.moe_mlp(tp1, tcfg1, tx).numpy()
    y2 = tmoe.moe_mlp(tp2, tcfg2, tx).numpy()
    np.testing.assert_allclose(y2, y1, **TOL)
    np.testing.assert_allclose(y1, want, **TOL)


# ---------------------------------------------------------------------------
# ragged (dropless reference) and shared experts
# ---------------------------------------------------------------------------


def test_ragged_matches_reference():
    jcfg, tcfg = _cfgs(moe_impl="ragged")
    jp, tp = _params(jcfg, 1)
    jx, tx = _x(32)
    want = np.asarray(jmoe._moe_ragged(jp, jcfg, jx))
    np.testing.assert_allclose(tmoe._moe_ragged(tp, tcfg, tx).numpy(), want, **TOL)


@pytest.mark.parametrize("shared", [0, 1])
def test_onehot_matches_ragged_when_dropless(shared):
    """cf = E/k ⇒ capacity = group ⇒ no drops ⇒ the ragged path's math, in
    the port and against both of JAX's paths (``test_moe.py``'s two
    onehot-vs-ragged cases, without and with shared experts)."""
    jcfg_r, tcfg_r = _cfgs(moe_impl="ragged", moe_shared_experts=shared)
    jcfg_o, tcfg_o = _cfgs(moe_impl="onehot", moe_capacity_factor=4.0,
                           moe_shared_experts=shared)
    jp, tp = _params(jcfg_r, 2 if shared else 1)
    assert ("shared" in tp) == bool(shared)
    jx, tx = _x(32, seed=3 if shared else 0)
    onehot, ragged = tmoe.moe_mlp(tp, tcfg_o, tx).numpy(), tmoe.moe_mlp(tp, tcfg_r, tx).numpy()
    np.testing.assert_allclose(onehot, ragged, **TOL)
    np.testing.assert_allclose(onehot, np.asarray(jmoe.moe_mlp(jp, jcfg_o, jx)), **TOL)
    np.testing.assert_allclose(ragged, np.asarray(jmoe.moe_mlp(jp, jcfg_r, jx)), **TOL)


def test_shared_experts_at_published_capacity_match_reference():
    """deepseek-v2's layout: routed experts with drops plus the shared MLP."""
    jcfg, tcfg = _cfgs(moe_shared_experts=2, moe_top_k=3)
    jp, tp = _params(jcfg, 6)
    jx, tx = _x(32, b=4, l=32, seed=7)
    want = np.asarray(jmoe.moe_mlp(jp, jcfg, jx))
    np.testing.assert_allclose(tmoe.moe_mlp(tp, tcfg, tx).numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# capacity drops, small token counts, out-of-range slots
# ---------------------------------------------------------------------------


def test_capacity_drops_are_bounded_and_finite():
    """``test_moe.py``'s case: cf 0.5 stays finite and differs from the
    dropless run; both equal JAX's."""
    jcfg, tcfg = _cfgs(moe_capacity_factor=0.5)
    jp, tp = _params(jcfg, 6)
    jx, tx = _x(32, b=4, l=32, seed=7)
    y = tmoe.moe_mlp(tp, tcfg, tx).numpy()
    assert np.isfinite(y).all()
    np.testing.assert_allclose(y, np.asarray(jmoe.moe_mlp(jp, jcfg, jx)), **TOL)
    y_nd = tmoe.moe_mlp(tp, dataclasses.replace(tcfg, moe_capacity_factor=4.0), tx).numpy()
    assert not np.allclose(y, y_nd)


@pytest.mark.parametrize("tokens", [1, 2, 3, 4, 5, 6, 7, 128])
def test_onehot_tiny_token_counts(tokens, monkeypatch):
    """Decode-shaped inputs (``tokens`` sequences of one token): ``g`` is the
    token count, halved until it divides it, and ``cap`` its ceiling."""
    jcfg, tcfg = _cfgs(moe_capacity_factor=1.25)
    jp, tp = _params(jcfg, 10)
    x = np.random.default_rng(11).normal(size=(tokens, 1, 32)).astype(np.float32)
    want, jkept = _jax_onehot(jp, jcfg, jnp.asarray(x), monkeypatch)
    got, tkept, _ = _port_onehot(tp, tcfg, torch.from_numpy(x))
    assert got.shape == x.shape and np.isfinite(got).all()
    np.testing.assert_array_equal(tkept, jkept)
    np.testing.assert_allclose(got, want, **TOL)


def test_dropped_choice_slot_past_capacity(monkeypatch):
    """Every token prefers expert 0, so its slots run far past the capacity:
    JAX's ``one_hot`` gives those rows zeros, the port clamps the slot and
    zeroes the row with the drop mask.  Dropped tokens' rows are 0 where
    both choices dropped."""
    jcfg, tcfg = _cfgs(moe_capacity_factor=0.5)
    jp, tp = _params(jcfg, 12)
    router = np.array(jp["router"])
    router[:, 0] = 0.0
    router[0, 0] = 8.0  # x[..., 0] >= 1 picks expert 0 first, by far
    jp = {**jp, "router": jnp.asarray(router)}
    tp = {**tp, "router": torch.from_numpy(router)}
    x = np.random.default_rng(13).normal(size=(2, 32, 32)).astype(np.float32)
    x[..., 0] = np.abs(x[..., 0]) + 1.0
    want, jkept = _jax_onehot(jp, jcfg, jnp.asarray(x), monkeypatch)
    got, tkept, dropped = _port_onehot(tp, tcfg, torch.from_numpy(x))
    cap = max(int(np.ceil(64 * 2 / 8 * 0.5)), 1)  # g = 64 tokens, one group
    assert int(tkept[:, 0].sum()) == cap and bool(dropped[:, 0].sum() == 64 - cap)
    np.testing.assert_array_equal(tkept, jkept)
    np.testing.assert_allclose(got, want, **TOL)
    both = dropped.all(-1).numpy()
    assert both.any() and (got.reshape(64, 32)[both] == 0).all()


# ---------------------------------------------------------------------------
# routing: lax.top_k's tie order
# ---------------------------------------------------------------------------


def test_zero_router_picks_the_lowest_experts():
    """A zero router gives every expert the same probability: ``lax.top_k``
    takes experts 0 and 1 for every token, with equal gates."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 1)
    jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    tp = {**tp, "router": torch.zeros_like(tp["router"])}
    jx, tx = _x(32, seed=8)
    jg, ji = jmoe._route(jp, jcfg, jx)
    tg, ti = tmoe._route(tp, tcfg, tx)
    assert (np.asarray(ji) == np.array([0, 1])).all()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_planted_ties_keep_lax_top_k_order(seed):
    """Router columns copied onto others make those experts' probabilities
    equal bit for bit; the port picks among them as ``lax.top_k`` does."""
    jcfg, tcfg = _cfgs(moe_top_k=3)
    jp, _ = _params(jcfg, seed)
    router = np.array(jp["router"])
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 8)
    for dst in rng.choice([e for e in range(8) if e != src], 3, replace=False):
        router[:, dst] = router[:, src]
    jx, tx = _x(32, b=4, l=32, seed=seed + 20)
    jg, ji = jmoe._route({"router": jnp.asarray(router)}, jcfg, jx)
    tg, ti = tmoe._route({"router": torch.from_numpy(router)}, tcfg, tx)
    probs = torch.softmax(tx @ torch.from_numpy(router), -1)
    tied = (probs[..., :, None] == probs[..., None, :]).sum(-1) > 1
    assert bool(tied.gather(-1, ti).any())  # some picked experts tie
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


# ---------------------------------------------------------------------------
# tests/test_moe_properties.py's invariants, on fixed draws, against JAX
# ---------------------------------------------------------------------------


def _prop_cfgs(e, k, cf, vs=1):
    return _cfgs(d_model=16, num_heads=2, num_kv_heads=2, d_ff=32, moe_experts=e,
                 moe_top_k=k, moe_d_ff=32, moe_capacity_factor=cf, moe_virtual_split=vs,
                 name="moe-prop")


@pytest.mark.parametrize("e,k,b,l,seed", [(4, 1, 1, 1, 0), (4, 3, 2, 8, 1), (8, 2, 3, 32, 2),
                                          (8, 3, 1, 8, 3)])
def test_route_gates_normalized(e, k, b, l, seed):
    jcfg, tcfg = _prop_cfgs(e, k, 1.25)
    jp, tp = _params(jcfg, seed % 997)
    x = np.random.default_rng(seed).normal(size=(b * l, 16)).astype(np.float32)
    jg, ji = jmoe._route(jp, jcfg, jnp.asarray(x))
    g, i = tmoe._route(tp, tcfg, torch.from_numpy(x))
    g, i = g.numpy(), i.numpy()
    assert np.allclose(g.sum(-1), 1.0, atol=1e-5) and (g >= 0).all()
    assert ((0 <= i) & (i < e)).all()
    assert all(len(set(row)) == len(row) for row in i.tolist())
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(g, np.asarray(jg), **TOL)


@pytest.mark.parametrize("e,k,cf,seed", [(4, 1, 0.5, 0), (4, 2, 1.0, 1), (8, 1, 1.25, 2),
                                         (8, 2, 0.5, 3)])
def test_onehot_output_finite_and_bounded(e, k, cf, seed, monkeypatch):
    jcfg, tcfg = _prop_cfgs(e, k, cf)
    jp, tp = _params(jcfg, seed % 9973)
    x = np.random.default_rng(seed).normal(size=(2, 32, 16)).astype(np.float32)
    want, jkept = _jax_onehot(jp, jcfg, jnp.asarray(x), monkeypatch)
    got, tkept, _ = _port_onehot(tp, tcfg, torch.from_numpy(x))
    assert got.shape == x.shape and np.isfinite(got).all()
    np.testing.assert_array_equal(tkept, jkept)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("vs", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_virtual_split_conserves_token_mass(seed, vs):
    """Dropless (cf = E/k): vs = 2 equals vs = 1 on the unsplit weights, and
    each equals JAX's."""
    jcfg, tcfg = _prop_cfgs(4, 2, 2.0, vs=vs)
    jp, tp = _params(jcfg, seed % 7919)
    x = np.random.default_rng(seed).normal(size=(1, 16, 16)).astype(np.float32)
    y = tmoe._moe_onehot(tp, tcfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jmoe._moe_onehot(jp, jcfg, jnp.asarray(x))), **TOL)
    if vs == 2:
        e, d, f = 4, 16, 32
        p1 = {
            "router": tp["router"],
            "experts_gate": tp["experts_gate"].reshape(e, 2, d, f // 2)
            .permute(0, 2, 1, 3).reshape(e, d, f),
            "experts_up": tp["experts_up"].reshape(e, 2, d, f // 2)
            .permute(0, 2, 1, 3).reshape(e, d, f),
            "experts_down": tp["experts_down"].reshape(e, f, d),
        }
        _, tcfg1 = _prop_cfgs(4, 2, 2.0, vs=1)
        np.testing.assert_allclose(tmoe._moe_onehot(p1, tcfg1, torch.from_numpy(x)).numpy(),
                                   y, **TOL)


def test_route_recorder_is_off_by_default_and_records_each_call():
    jcfg, tcfg = _cfgs(moe_capacity_factor=1.25)
    _, tp = _params(jcfg, 1)
    _, tx = _x(32)
    assert tmoe.moe_mlp.routes is None
    tmoe.moe_mlp(tp, tcfg, tx)  # off: nothing kept
    tmoe.moe_mlp.routes = []
    try:
        tmoe.moe_mlp(tp, tcfg, tx)
        tmoe.moe_mlp(tp, tcfg, tx[:, :1])
        first, second = tmoe.moe_mlp.routes
    finally:
        tmoe.moe_mlp.routes = None
    assert first["experts"].shape == (2, 16, 2) and second["experts"].shape == (2, 1, 2)
    assert first["dropped"].dtype == torch.bool
    _, idx = tmoe._route(tp, tcfg, tx)
    assert torch.equal(first["experts"], idx)


# ---------------------------------------------------------------------------
# the plain per-expert version the card's checks use
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf,vs,shared,tokens", [
    (0.5, 1, 0, 128), (1.25, 1, 0, 128), (1.25, 2, 0, 128), (4.0, 1, 1, 128),
    (1.25, 2, 0, 8), (1.25, 1, 2, 8),
])
def test_plain_version_matches_reference(cf, vs, shared, tokens):
    """``moe_ref.moe_plain`` (argmax top-k, sort-ranked slots, per-expert
    gathers) gives JAX's output and the port's dropped choices."""
    from repro_torch.models.moe_ref import moe_plain

    jcfg, tcfg = _cfgs(moe_capacity_factor=cf, moe_virtual_split=vs, moe_shared_experts=shared)
    jp, tp = _params(jcfg, 30 + tokens)
    jx, tx = _x(32, b=tokens // 8, l=8, seed=31)
    want = np.asarray(jmoe.moe_mlp(jp, jcfg, jx))
    got, experts, dropped = moe_plain(tp, tcfg, tx)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    tmoe.moe_mlp.routes = []
    try:
        tmoe.moe_mlp(tp, tcfg, tx)
        (rec,) = tmoe.moe_mlp.routes
    finally:
        tmoe.moe_mlp.routes = None
    assert torch.equal(experts, rec["experts"]) and torch.equal(dropped, rec["dropped"])
    if cf != 1.25:  # 0.5 drops, E/k cannot
        assert bool(dropped.any()) == (cf < 1)


# ---------------------------------------------------------------------------
# gradients (tests/test_moe.py::test_onehot_grads_finite)
# ---------------------------------------------------------------------------


def _grads(tp, tcfg, tx, impl):
    diff = {k: v.clone().requires_grad_() if torch.is_tensor(v) else
            {kk: vv.clone().requires_grad_() for kk, vv in v.items()} for k, v in tp.items()}
    x = tx.clone().requires_grad_()
    fn = tmoe._moe_onehot if impl == "onehot" else tmoe._moe_ragged
    out = fn(diff, tcfg, x) if "shared" not in diff else tmoe.moe_mlp(diff, tcfg, x)
    torch.sum(out ** 2).backward()
    return diff, x


def test_onehot_grads_finite():
    jcfg, tcfg = _cfgs(moe_impl="onehot", moe_capacity_factor=1.25)
    _, tp = _params(jcfg, 8)
    _, tx = _x(32, b=2, l=64, seed=9)
    diff, _ = _grads(tp, tcfg, tx, "onehot")
    grads = [v.grad for v in diff.values()]
    assert all(torch.isfinite(g).all() for g in grads)
    assert sum(float(g.abs().sum()) for g in grads) > 0


@pytest.mark.parametrize("impl,cf,vs,shared", [
    ("onehot", 1.25, 1, 0), ("onehot", 0.5, 1, 0), ("onehot", 1.0, 2, 0),
    ("onehot", 1.25, 1, 1), ("ragged", 1.25, 1, 0),
])
def test_grads_match_reference(impl, cf, vs, shared):
    """The gradient of ``sum(moe(x)²)`` with respect to every weight and to
    ``x`` against ``jax.grad``'s, with tokens dropped (cf 0.5, 1.25), a
    virtual split and shared experts: the drop mask and the gate carry the
    gradient alike."""
    jcfg, tcfg = _cfgs(moe_impl=impl, moe_capacity_factor=cf, moe_virtual_split=vs,
                       moe_shared_experts=shared)
    jp, tp = _params(jcfg, 10)
    jx, tx = _x(32, b=2, l=32, seed=11)
    fn = {"onehot": jmoe._moe_onehot, "ragged": jmoe._moe_ragged}[impl]

    def jloss(p, x):
        return jnp.sum((jmoe.moe_mlp(p, jcfg, x) if shared else fn(p, jcfg, x)) ** 2)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    diff, x = _grads(tp, tcfg, tx, impl)
    for name, leaf in diff.items():
        pairs = [(leaf, jg[name])] if torch.is_tensor(leaf) else [
            (v, jg[name][k]) for k, v in leaf.items()]
        for got, want in pairs:
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **GRAD_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), **GRAD_TOL)


#: the backward sums over every token and slot: the forward's 2e-5, loosened
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
