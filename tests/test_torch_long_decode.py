"""Long-context serving in the port: ``spmd.sharded_prefill`` and
``sharded_decode_step`` under ``long_decode_rules`` (a batch of one, the
cache's sequence over ``data``, the heads over ``model``) against the JAX
package's GSPMD-partitioned steps and against the port's own unsharded
model.

The reference side runs once, in one child process on 8 forced host
devices (``tests/_torch_dist_ref.py``'s ``long_decode`` case, ~90 s):
``jax.jit(model.prefill)`` and ``jax.jit(model.decode_step)`` on a (2, 4)
("data", "model") mesh under ``long_decode_rules``, params by
``params_shardings(fsdp_axis=None)``, the cache by
``cache_shardings(long_context=True)`` (``k``/``v`` and MLA's
``ckv``/``krope`` split by rows over ``data``, every kv head and the whole
latent on each rank; the SSM ``h`` and ``conv`` over ``model``), the tokens
replicated and the logits out as ``P(None, "model")``, for every arch of
``TP_ARCHES`` and the cases of ``LD_CASES``: mamba2's chunked SSD, the MoE
configs at capacity factor 1.25 and mixtral's window rolled by the prompt
and wrapped by the decode steps, the ring's slots over the data ranks.  The
port runs the same steps on a (2, 4) mesh of repeated ``cpu`` positions in
this process, on the reference's weights: the logits within the
reference's serving tolerances and every rank's block of the cache equal
to the reference's placed cache.  Beside the parity: the unsharded model on
(2, 4), (4, 2), (8, 1) and (1, 8) (the ``"decomposed"`` and
``"sharded_dus"`` cache writes too), a decode step at the cache's last
slot over seeded rows, the kernels at the ranks' heads in the prompt, the
collectives per layer, and the refusal of a cache laid out for other rules.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist_ref as ref
from repro_torch._pytree import tree_leaves, tree_map
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import (
    cache_shardings,
    decode_rules,
    decode_rules_headsharded,
    device_put,
    long_decode_rules,
    params_shardings,
    sharded_decode_step,
    sharded_prefill,
)
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import _map_with_path
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import layers as L
from test_torch_tensor_parallel import (
    CHILD,
    DECODE_TOL,
    PREFILL_TOL,
    SELF_TOL,
    SRC,
    _init,
    _layers,
    _mesh,
    _reference_params,
)

B = ref.LD_BATCH


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ld_ref"))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, CHILD, path, "long_decode"], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert f"RESULT {path}" in out.stdout
    with np.load(os.path.join(path, "out.npz")) as data:
        return dict(data)


def _extras(model):
    """The prompt's ``frames`` or ``image_embeds`` for a batch of one, and
    the decode steps' memory (the vlm's image embeddings again)."""
    extras = {k: torch.from_numpy(v) for k, v in ref.tp_extras(model.cfg, B).items()}
    return extras, extras.get("image_embeds")


def _tokens(model, length):
    return torch.from_numpy(ref.tp_tokens(model.cfg.vocab_size, length, B).astype(np.int64))


def _rules(mesh, cache_impl=None):
    rules = long_decode_rules(mesh)
    if cache_impl:
        rules = dataclasses.replace(rules, cache_impl=f"{rules.cache_impl}+{cache_impl}")
    return rules


def _placed_cache(model, mesh, max_len):
    c0 = model.init_cache(B, max_len, dtype=torch.float32, device="cpu")
    return device_put(c0, cache_shardings(c0, mesh, long_context=True))


def _serve(model, params, toks, *, mesh, prompt, steps, max_len, cache_impl=None):
    """The long-context prefill of ``toks[:, :prompt]`` and ``steps``
    decode steps fed the next tokens: the logits (1, 1 + steps, Vp) and
    the placed cache."""
    rules = _rules(mesh, cache_impl)
    extras, memory = _extras(model)
    placed = device_put(params, params_shardings(params, mesh, fsdp_axis=None))
    cache = _placed_cache(model, mesh, max_len)
    logits, cache = sharded_prefill(model, placed, {"tokens": toks[:, :prompt], **extras}, cache,
                                    mesh=mesh, rules=rules)
    outs = [logits]
    for t in range(steps):
        logits, cache = sharded_decode_step(model, placed, cache,
                                            toks[:, prompt + t:prompt + t + 1], prompt + t,
                                            memory, mesh=mesh, rules=rules)
        outs.append(logits)
    return torch.stack(outs, 1), cache


def _unsharded(model, params, toks, *, prompt, steps, max_len):
    extras, memory = _extras(model)
    cache = model.init_cache(B, max_len, dtype=torch.float32, device="cpu")
    logits, _ = model.prefill(params, {"tokens": toks[:, :prompt], **extras}, cache)
    outs = [logits]
    for t in range(steps):
        logits, _ = model.decode_step(params, cache, toks[:, prompt + t:prompt + t + 1],
                                      prompt + t, memory)
        outs.append(logits)
    return torch.stack(outs, 1), cache


def _held_to_reference(reference, name, got, cache) -> None:
    """The logits (prefill, then each decode step) and every rank's block of
    every cache leaf against the reference's, each leaf written."""
    key = f"long_decode/{name}"
    want = reference[f"{key}/logits"]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got[:, 0].numpy(), want[:, 0], **PREFILL_TOL)
    for t in range(1, want.shape[1]):
        np.testing.assert_allclose(got[:, t].numpy(), want[:, t], **DECODE_TOL)
    seen = []

    def one(path, leaf):
        want = reference[f"{key}/cache/" + ref.tp_path(path)]
        blocks = np.stack([s.numpy() for s in leaf.shards])
        assert blocks.shape == want.shape, path
        np.testing.assert_allclose(blocks, want, **PREFILL_TOL)
        seen.append(float(np.abs(blocks).max()))

    _map_with_path(one, cache)
    assert seen and min(seen) > 0


def _sequence_over_data(model, cache) -> int:
    """Asserts the long layout of every attention and MLA leaf (the rows
    over ``data``, every kv head and the whole latent on each rank);
    returns the number of such leaves."""
    found = []

    def one(path, leaf):
        name = path[-1]
        if name not in ("k", "v", "ckv", "krope"):
            return
        nb = leaf.ndim - (4 if name in ("k", "v") else 3)
        assert leaf.sharding.spec[nb + 1] == "data", path
        assert all(s.shape[nb + 1] * 2 == leaf.shape[nb + 1] for s in leaf.shards)
        assert all(s.shape[nb + 2:] == leaf.shape[nb + 2:] for s in leaf.shards)
        found.append(name)

    _map_with_path(one, cache)
    return len(found)


# ---------------------------------------------------------------------------
# against the reference's GSPMD partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ref.TP_ARCHES)
def test_arch_matches_reference(reference, arch):
    """Every arch of ``TP_ARCHES``: the logits after the prefill and each
    decode step and every rank's block of the cache, which lies by rows
    over ``data`` (mamba2 has none such; its ``h`` and ``conv`` lie over
    ``model``)."""
    _, _, prompt, steps, max_len = ref.ld_case(arch)
    model, params = _reference_params(arch)
    got, cache = _serve(model, params, _tokens(model, prompt + steps), mesh=_mesh(),
                        prompt=prompt, steps=steps, max_len=max_len)
    _held_to_reference(reference, arch, got, cache)
    rows = _layers(model.cfg, "attn") + _layers(model.cfg, "mla")  # layers with a row cache
    assert bool(_sequence_over_data(model, cache)) == bool(rows)


@pytest.mark.parametrize("case", ref.LD_CASES)
def test_case_matches_reference(reference, monkeypatch, case):
    """The cases beside the archs, each held to the reference and checked
    to reach what it is for: the chunked SSD route at the ranks' 2 heads;
    the MoE groups of the batch's own tokens at capacity factor 1.25, where
    the reference drops choices in the prefill (a decode step's one token
    sends its k choices to k experts, each with room for one, so none is
    dropped there) and the port's routes, recorded once a forward, drop the
    same; the window's ring, its slots split over the data ranks, rolled by
    the prompt or wrapped by the decode steps."""
    from repro_torch.models.moe import moe_mlp

    arch, ov, prompt, steps, max_len = ref.ld_case(case)
    model, params = _reference_params(arch, **ov)
    cfg = model.cfg
    ssd_heads = []
    real_ssd = ops.ssd_scan
    monkeypatch.setattr(ops, "ssd_scan", lambda x, *a, **kw: (
        ssd_heads.append(x.shape[2]), real_ssd(x, *a, **kw))[1])
    monkeypatch.setattr(moe_mlp, "routes", [] if cfg.moe_experts else None)
    got, cache = _serve(model, params, _tokens(model, prompt + steps), mesh=_mesh(),
                        prompt=prompt, steps=steps, max_len=max_len)
    routes = moe_mlp.routes
    monkeypatch.setattr(moe_mlp, "routes", None)
    _held_to_reference(reference, case, got, cache)
    if case.endswith("/chunked"):
        assert prompt == 2 * cfg.ssm_chunk
        assert ssd_heads == [2] * 8 * _layers(cfg, mixer="mamba2")
    if case.endswith("/cf1.25"):
        drops = reference[f"long_decode/{case}/drops"]
        assert drops[0] > 0 and not drops[1:].any()
        moe = _layers(cfg, mlp="moe")
        assert len(routes) == moe * (1 + steps)  # once a forward, not once a rank
        assert all(r["experts"].shape == (B, prompt if i < moe else 1, cfg.moe_top_k)
                   for i, r in enumerate(routes))
        port_drops = [sum(int(r["dropped"].sum()) for r in routes[i:i + moe])
                      for i in range(0, len(routes), moe)]
        assert port_drops == [int(d) for d in drops]
    if case.endswith(("/roll", "/wrap")):
        ring = min(max_len, cfg.sliding_window)
        k = cache["seg0"][0]["k"]
        assert k.shape[2] == ring and ring % 2 == 0
        assert (ring < prompt) if case.endswith("/roll") else (prompt < ring < prompt + steps)
        assert k.sharding.spec[2] == "data"  # the ring's slots split over the data ranks
        assert all(s.shape[2] == ring // 2 and s.shape[3] == cfg.num_kv_heads for s in k.shards)


# ---------------------------------------------------------------------------
# against the port's unsharded model
# ---------------------------------------------------------------------------

#: the configs' overrides against the unsharded model: the MoE configs at
#: capacity factor 1.25 (the prompt's groups drop choices), mixtral with a
#: window of 8 that the decode steps wrap
SELF_OVERRIDES = {"jamba-v0.1-52b": {"moe_capacity_factor": 1.25},
                  "deepseek-v2-236b": {"moe_capacity_factor": 1.25},
                  "mixtral-8x7b": {"moe_capacity_factor": 1.25, "sliding_window": 8}}


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (8, 1), (1, 8)])
@pytest.mark.parametrize("arch", ref.TP_ARCHES)
def test_matches_the_unsharded_model(arch, shape):
    """Every arch on meshes whose data axis splits the cache's 16 rows in
    2, 4 and 8 blocks (and not at all on (1, 8)) while the model axis
    splits the heads 4, 2, 1 and 8 ways (4 heads over 8: whole on every
    rank); the cross gates at 1."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              **SELF_OVERRIDES.get(arch, {}))
    model, params = _init(cfg, 21)
    toks = _tokens(model, ref.TP_PROMPT + ref.TP_STEPS)
    kw = dict(prompt=ref.TP_PROMPT, steps=ref.TP_STEPS, max_len=ref.TP_MAX_LEN)
    want, want_cache = _unsharded(model, params, toks, **kw)
    got, cache = _serve(model, params, toks, mesh=_mesh(shape), **kw)
    torch.testing.assert_close(got, want, **SELF_TOL)
    for a, b in zip(tree_leaves(cache), tree_leaves(want_cache)):
        torch.testing.assert_close(a.full(), b, **SELF_TOL)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
@pytest.mark.parametrize("cache_impl", ["decomposed", "sharded_dus"])
@pytest.mark.parametrize("arch", ["qwen3-32b", "deepseek-7b", "mixtral-8x7b"])
def test_cache_impls_match_the_unsharded_model(monkeypatch, arch, cache_impl, shape):
    """``cache_impl="decomposed"``: each rank joins the new row to its
    combined old rows, then the owner of the slot writes it (mixtral's
    window of 8 wrapped at 8, 9 and 10); ``"sharded_dus"``: the row is
    written on the data rank whose block holds the slot, as under
    ``"masked"``.  The logits and the cache stay the unsharded model's."""
    ov = {"sliding_window": 8} if arch == "mixtral-8x7b" else {}
    model = build_model(dataclasses.replace(get_smoke_config(arch), dtype="float32", **ov))
    params = model.init(torch.Generator().manual_seed(22), device="cpu")
    toks = _tokens(model, ref.TP_PROMPT + ref.TP_STEPS)
    kw = dict(prompt=ref.TP_PROMPT, steps=ref.TP_STEPS, max_len=ref.TP_MAX_LEN)
    new_rows = []
    real = L._sdpa_context_parallel
    monkeypatch.setattr(L, "_sdpa_context_parallel", lambda *a, new=None, axis, **k: (
        new_rows.append((new is not None, axis)), real(*a, new=new, axis=axis, **k))[1])
    want, want_cache = _unsharded(model, params, toks, **kw)
    got, cache = _serve(model, params, toks, mesh=_mesh(shape), cache_impl=cache_impl, **kw)
    assert new_rows == [(cache_impl == "decomposed", "data")] * (
        shape[0] * shape[1] * model.cfg.num_layers * ref.TP_STEPS)
    torch.testing.assert_close(got, want, **SELF_TOL)
    for a, b in zip(tree_leaves(cache), tree_leaves(want_cache)):
        torch.testing.assert_close(a.full(), b, **SELF_TOL)


def _seed_unwritten(cache, written: int, seed: int) -> None:
    """Seeded draws into the attention and MLA rows that a prompt of
    ``written`` tokens left empty (all of a ring it did not fill), as the
    card's last-slot step seeds them."""
    g = torch.Generator().manual_seed(seed)

    def one(path, leaf):
        if path[-1] in ("k", "v", "ckv", "krope"):
            rows = leaf[..., written:, :, :] if path[-1] in ("k", "v") else leaf[..., written:, :]
            rows.copy_(torch.randn(rows.shape, generator=g) * 0.5)

    _map_with_path(one, cache)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mixtral-8x7b", "deepseek-v2-236b"])
def test_last_slot_step_matches_the_unsharded_model(arch):
    """The dry-run's step, at the cache's last slot: the rows the prompt
    did not write (jamba's attention rows, the whole of mixtral's ring of
    8, deepseek-v2's latent rows) hold seeded draws in both caches, and one
    step at slot ``max_len - 1`` attends to all of them; the slot lies in
    the last data block, so only its ranks write."""
    ov = {"sliding_window": 8} if arch == "mixtral-8x7b" else {}
    model, params = _init(dataclasses.replace(get_smoke_config(arch), dtype="float32", **ov), 23)
    max_len, prompt = 32, ref.TP_PROMPT
    toks = _tokens(model, prompt + 1)
    want_cache = model.init_cache(B, max_len, dtype=torch.float32, device="cpu")
    model.prefill(params, {"tokens": toks[:, :prompt]}, want_cache)
    ring = model.cfg.sliding_window and model.cfg.sliding_window < max_len
    _seed_unwritten(want_cache, 0 if ring else prompt, 24)
    mesh = _mesh()
    cache = device_put(tree_map(torch.clone, want_cache),
                       cache_shardings(want_cache, mesh, long_context=True))
    placed = device_put(params, params_shardings(params, mesh, fsdp_axis=None))
    last = max_len - 1
    want, _ = model.decode_step(params, want_cache, toks[:, prompt:], last)
    got, cache = sharded_decode_step(model, placed, cache, toks[:, prompt:], last, mesh=mesh,
                                     rules=long_decode_rules(mesh))
    torch.testing.assert_close(got, want, **SELF_TOL)
    for a, b in zip(tree_leaves(cache), tree_leaves(want_cache)):
        torch.testing.assert_close(a.full(), b, **SELF_TOL)


# ---------------------------------------------------------------------------
# structure: kernels, collectives, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b", "mixtral-8x7b"])
def test_kernels_run_once_a_rank_and_layer_at_the_ranks_heads(monkeypatch, arch):
    """A 32-token prompt (2 × ``ssm_chunk``) under ``attn_impl="flash"`` on
    (2, 4): the SSD's chunked route once per rank and mamba2 layer at the
    rank's quarter of the 8 SSM heads, flash once per rank and attention
    layer at its q heads (4 over 4) and the kv heads they read (1 of the 2,
    replicated), over the whole prompt on both data ranks; decode calls
    neither.  The logits stay the unsharded model's."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", attn_impl="flash")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(25), device="cpu")
    calls = {"ssd": [], "flash": []}
    real_ssd, real_flash = ops.ssd_scan, ops.flash_attention
    monkeypatch.setattr(ops, "ssd_scan", lambda x, *a, **kw: (
        calls["ssd"].append(tuple(x.shape)), real_ssd(x, *a, **kw))[1])
    monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, **kw: (
        calls["flash"].append((tuple(q.shape), k.shape[2])), real_flash(q, k, v, **kw))[1])
    prompt, steps = 2 * cfg.ssm_chunk, 2
    kw = dict(prompt=prompt, steps=steps, max_len=prompt + steps)
    toks = _tokens(model, prompt + steps)
    got, _ = _serve(model, params, toks, mesh=_mesh(), **kw)
    nh = cfg.ssm_expand * cfg.d_model // max(cfg.ssm_head_dim, 1)
    assert calls["ssd"] == [(B, prompt, nh // 4, cfg.ssm_head_dim)] * 8 * _layers(
        cfg, mixer="mamba2")
    dh = cfg.resolved_head_dim
    assert calls["flash"] == [((B, prompt, cfg.num_heads // 4, dh), 1)] * 8 * _layers(
        cfg, mixer="attn")
    monkeypatch.setattr(ops, "ssd_scan", real_ssd)
    monkeypatch.setattr(ops, "flash_attention", real_flash)
    want, _ = _unsharded(model, params, toks, **kw)
    torch.testing.assert_close(got, want, **SELF_TOL)


#: collectives a layer calls on the (2, 4) mesh in a long-context step, by
#: (arch, decode): (all-reduces, all-gathers); the embedding's psum adds
#: one all-reduce.  Prefill (the prompt whole on every data rank): the
#: psums after wo and w_down; qwen3's replicated wk/wv gather their
#: sequence-parallel rows (k, v), deepseek-7b's split ones gather their kv
#: heads for the cache, which holds every kv head.  Decode: the combine over
#: data (a pmax and a psum) beside the two psums; deepseek-7b gathers the
#: new row's kv heads (k, v); no q head is gathered.  A mamba2 layer as
#: under decode_rules: the gated norm's squares and w_out's partial summed,
#: the conv blocks gathered.  A mixtral layer is qwen3's attention and an
#: MoE layer: its experts' partial summed; the batch replicated, so no
#: token row moves over data.  deepseek-v2 (the unit an MLA layer with its
#: MoE): wo, the experts and the shared experts summed; the prompt's wq_a
#: and wkv_a rows gathered; a decode step combines over data (2 reduces)
#: and gathers nothing
LONG_PER_LAYER = {
    ("qwen3-32b", False): (2, 2), ("qwen3-32b", True): (4, 0),
    ("deepseek-7b", False): (2, 2), ("deepseek-7b", True): (4, 2),
    ("mamba2-1.3b", False): (2, 1), ("mamba2-1.3b", True): (2, 1),
    ("mixtral-8x7b", False): (2, 2), ("mixtral-8x7b", True): (4, 0),
    ("deepseek-v2-236b", False): (3, 2), ("deepseek-v2-236b", True): (5, 0),
}
#: deepseek-v2's dense first layer (an MLA layer and its MLP), once
LONG_ONCE = {("deepseek-v2-236b", False): (2, 2), ("deepseek-v2-236b", True): (4, 0)}


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-32b", "deepseek-7b", "mamba2-1.3b", "mixtral-8x7b",
                                  "deepseek-v2-236b"])
def test_collectives_per_layer(arch, decode):
    reduces, gathers = LONG_PER_LAYER[(arch, decode)]
    once_r, once_g = LONG_ONCE.get((arch, decode), (0, 0))
    mesh = _mesh()
    for layers in ((2, 4) if arch == "deepseek-v2-236b" else (1, 3)):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", num_layers=layers)
        n = _layers(cfg, mlp="moe") if arch == "deepseek-v2-236b" else cfg.num_layers
        model, params = _init(cfg, 26)
        placed = device_put(params, params_shardings(params, mesh, fsdp_axis=None))
        cache = _placed_cache(model, mesh, ref.TP_MAX_LEN)
        toks = _tokens(model, ref.TP_PROMPT)
        with spmd.collective_census() as census:
            if decode:
                sharded_decode_step(model, placed, cache, toks[:, :1], ref.TP_PROMPT,
                                    mesh=mesh, rules=long_decode_rules(mesh))
            else:
                sharded_prefill(model, placed, {"tokens": toks}, cache, mesh=mesh,
                                rules=long_decode_rules(mesh))
        counts = census["counts"]
        assert counts.get("all-reduce", 0) == 1 + once_r + reduces * n
        assert counts.get("all-gather", 0) == once_g + gathers * n


@pytest.mark.parametrize("what", ["heads_layout", "seq_over_model", "long_under_decode_rules",
                                  "long_under_headsharded"])
def test_refuses_a_cache_laid_out_for_other_rules(what):
    """A cache is held to the rules it runs under: under
    ``long_decode_rules`` a cache split by kv heads (``layout="heads"``) or
    by rows over ``model`` (``layout="seq"``) is refused, and a
    ``long_context=True`` cache (rows over ``data``) under
    ``decode_rules`` or ``decode_rules_headsharded``; a rank would attend
    to its own block as if it held every row."""
    model = build_model(dataclasses.replace(get_smoke_config("deepseek-7b"), dtype="float32"))
    params = model.init(torch.Generator().manual_seed(27), device="cpu")
    mesh = _mesh()
    c0 = model.init_cache(B, ref.TP_MAX_LEN, dtype=torch.float32, device="cpu")
    tokens = {"tokens": _tokens(model, ref.TP_PROMPT)}
    rules = long_decode_rules(mesh)
    if what == "heads_layout":
        cache = device_put(c0, cache_shardings(c0, mesh, layout="heads"))
        match = r"its heads or latent over 'model'\); these rules put the KV sequence over 'data'"
    elif what == "seq_over_model":
        cache = device_put(c0, cache_shardings(c0, mesh))
        match = r"its sequence over 'model'\).*cache_shardings\(long_context=True\)"
    else:
        cache = device_put(c0, cache_shardings(c0, mesh, long_context=True))
        rules = (decode_rules if what == "long_under_decode_rules"
                 else decode_rules_headsharded)(mesh)
        match = r"laid out for other rules \(its sequence over 'data'\)"
    with pytest.raises(ValueError, match=match):
        sharded_prefill(model, params, tokens, cache, mesh=mesh, rules=rules)


def test_logits_are_replicated_over_data(monkeypatch):
    """``P(None, "model")``: every data rank returns the batch's one row of
    its vocabulary block, and the logits assembled are the unsharded
    model's."""
    from repro_torch.models.lm import Model

    model, params = _init(dataclasses.replace(get_smoke_config("qwen3-32b"), dtype="float32"), 28)
    toks = _tokens(model, ref.TP_PROMPT)
    mesh = _mesh()
    want, _ = _unsharded(model, params, toks, prompt=ref.TP_PROMPT, steps=0, max_len=16)
    seen = []
    real = Model.prefill

    def spy(self, p, batch, cache):
        logits, c = real(self, p, batch, cache)
        seen.append((spmd.axis_index("data"), spmd.axis_index("model"), logits))
        return logits, c

    monkeypatch.setattr(Model, "prefill", spy)
    placed = device_put(params, params_shardings(params, mesh, fsdp_axis=None))
    got, _ = sharded_prefill(model, placed, {"tokens": toks}, _placed_cache(model, mesh, 16),
                             mesh=mesh, rules=long_decode_rules(mesh))
    torch.testing.assert_close(got, want[:, 0], **SELF_TOL)
    blocks = {(d, m): t for d, m, t in seen}
    assert sorted(blocks) == [(d, m) for d in range(2) for m in range(4)]
    width = model.cfg.padded_vocab // 4
    for (d, m), t in blocks.items():
        assert tuple(t.shape) == (B, width)
        torch.testing.assert_close(t, blocks[(0, m)], rtol=0, atol=0)
