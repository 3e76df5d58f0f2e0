"""Tensor-parallel serving in the port (``spmd.sharded_prefill`` and
``sharded_decode_step``) against the JAX package's GSPMD-partitioned steps.

The reference side runs once, in one child process on 8 forced host
devices (``tests/_torch_dist_ref.py``'s ``tensor_parallel`` case, ~130 s):
``jax.jit(model.prefill)`` and ``jax.jit(model.decode_step)`` on a (2, 4)
("data", "model") mesh under ``decode_rules`` (the cache's sequence over
model) and ``decode_rules_headsharded`` (its kv heads, or MLA's latent),
for the qwen3-32b smoke config (2 kv heads over 4 ranks: ``wk``/``wv``
replicated), deepseek-7b's (4 over 4), mamba2-1.3b's (8 SSM heads, 2 a
rank), jamba-v0.1-52b's (Mamba2, attention and MoE layers),
mixtral-8x7b's (windowed attention, 4 experts, 1 a rank),
deepseek-v2-236b's (MLA, its latent cache, 8 experts and a shared
expert), whisper-tiny's (the encoder, self- and cross-attention, fed
frames) and llama-3.2-vision-11b's (cross-attention to image embeddings,
which every decode step gets again), in f32, the cross gates drawn apart
from 0 (``tp_gates``), and the cases of ``TP_CASES``: a prompt that takes
the chunked SSD route, the MoE configs at capacity factor 1.25 (where the
reference drops choices in decode), mixtral's window rolled by the prompt
and wrapped by the decode steps, the vlm's memory projection split by kv
heads and whisper's 6 heads, which do not divide the axis.  The port runs
the same steps on a (2, 4) mesh of repeated ``cpu`` positions in this
process, on the reference's weights: the logits within the reference's
serving tolerances (``tests/test_arch_smoke.py``: 3e-4 after the prefill,
5e-4 a decode step) and every rank's block of the cache (``conv``, ``h``,
``ckv``, ``krope``, ``k_mem`` and ``v_mem`` included) equal to the
reference's placed cache within the prefill's tolerance.  Beside the
parity, the port's tensor-parallel route is held to its own unsharded
model on more meshes and configs (the other dense configs, a padded
vocabulary, ``fsdp`` over data, the SSM, hybrid, MoE, MLA and
cross-attention families where the heads or experts split 1 a rank or not
at all), and its structure is checked: the flash and SSD calls at the
ranks' head counts, its collectives per layer, the layouts, and what it
refuses.
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
#: the families beyond the dense one that tensor-parallel serving runs
FAMILIES = ("mamba2-1.3b", "jamba-v0.1-52b", "mixtral-8x7b")
#: MLA, the encoder and cross-attention
LATENT_AND_CROSS = ("deepseek-v2-236b", "whisper-tiny", "llama-3.2-vision-11b")


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
    """The port's model and the reference's key-0 weights in it (f32), the
    cross-attention gates drawn by ``tp_gates`` as the reference side's."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **overrides)
    jm = j_build(dataclasses.replace(j_smoke(arch), dtype="float32", **overrides))
    tree = ref.tp_gates(jax.tree.map(np.asarray, jm.init(jax.random.key(0))))
    return build_model(cfg), params_from_numpy(tree, cfg, device="cpu")


def _init(cfg, seed):
    """The port's model of ``cfg`` and its random weights from ``seed``, the
    cross-attention gates set apart from the init's 0 (which would hide the
    cross path): ``tanh(gate)`` at 1."""
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed), device="cpu")
    _map_with_path(lambda path, t: t.fill_(1.0) if path[-1] == "gate" else None, params)
    return model, params


def _extras(model):
    """The prompts' ``frames`` or ``image_embeds`` (``ref.tp_extras``) as
    tensors, and the decode steps' memory: the vlm's image embeddings again,
    as the reference's server passes them every step."""
    extras = {k: torch.from_numpy(v) for k, v in ref.tp_extras(model.cfg).items()}
    return extras, extras.get("image_embeds")


def _serve(model, params, toks, *, mesh, layout, fsdp_axis=None, prompt=ref.TP_PROMPT,
           steps=ref.TP_STEPS, max_len=ref.TP_MAX_LEN, decomposed=False):
    """The tensor-parallel prefill and ``steps`` decode steps fed ``toks``
    (under a ``"decomposed"`` ``cache_impl`` too with ``decomposed``) and
    :func:`_extras`: the logits (B, 1 + steps, Vp) and the placed cache."""
    rules = RULES[layout](mesh)
    if decomposed:
        rules = dataclasses.replace(rules, cache_impl=rules.cache_impl + "+decomposed")
    extras, memory = _extras(model)
    placed = device_put(params, params_shardings(params, mesh, fsdp_axis=fsdp_axis))
    c0 = model.init_cache(ref.TP_BATCH, max_len, dtype=torch.float32, device="cpu")
    cache = device_put(c0, cache_shardings(c0, mesh, layout=layout))
    logits, cache = sharded_prefill(model, placed, {"tokens": toks[:, :prompt], **extras}, cache,
                                    mesh=mesh, rules=rules)
    outs = [logits]
    for t in range(steps):
        logits, cache = sharded_decode_step(model, placed, cache,
                                            toks[:, prompt + t:prompt + t + 1], prompt + t,
                                            memory, mesh=mesh, rules=rules)
        outs.append(logits)
    return torch.stack(outs, 1), cache


def _unsharded(model, params, toks, *, prompt=ref.TP_PROMPT, steps=ref.TP_STEPS,
               max_len=ref.TP_MAX_LEN):
    extras, memory = _extras(model)
    cache = model.init_cache(ref.TP_BATCH, max_len, dtype=torch.float32, device="cpu")
    logits, _ = model.prefill(params, {"tokens": toks[:, :prompt], **extras}, cache)
    outs = [logits]
    for t in range(steps):
        logits, _ = model.decode_step(params, cache, toks[:, prompt + t:prompt + t + 1],
                                      prompt + t, memory)
        outs.append(logits)
    return torch.stack(outs, 1), cache


def _tokens(model, length=ref.TP_PROMPT + ref.TP_STEPS):
    return torch.from_numpy(ref.tp_tokens(model.cfg.vocab_size, length).astype(np.int64))


def _layers(cfg, mixer=None, mlp=None) -> int:
    """The config's layers with this mixer and/or MLP."""
    return sum(seg.repeats for seg in cfg.segments() for s in seg.period
               if mixer in (None, s.mixer) and mlp in (None, s.mlp))


def _held_to_reference(reference, key, got, cache) -> int:
    """The logits (prefill, then each decode step) and every rank's block of
    every cache leaf against the reference's under ``key``; returns the
    number of leaves, each checked to be written."""
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
    assert min(seen) > 0  # every leaf written
    return len(seen)


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
    (the replicated kv heads of qwen3 under ``heads`` too; the SSM layers'
    ``conv`` blocks, which are not the rank's own channels, and ``h``; the
    MLA layers' ``ckv``/``krope`` rows or latent columns; the cross layers'
    ``k_mem``/``v_mem``, every head of the rank's batch rows)."""
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
    # two leaves a layer of a period, each written (a stacked segment's
    # layers are one leaf): k and v of an attention layer, conv and h of a
    # mamba2 layer, ckv and krope of an MLA layer, k_mem and v_mem of a
    # cross layer
    want = {"attn": ("k", "v"), "mamba2": ("conv", "h"), "mla": ("ckv", "krope"),
            "cross_attn": ("k_mem", "v_mem")}
    names = []
    _map_with_path(lambda path, _: names.append(path[-1]), cache)
    assert names == [n for seg in model.cfg.segments() for spec in seg.period
                     for n in want[spec.mixer]]
    assert len(seen) == len(names) and min(seen) > 0


@pytest.mark.parametrize("layout", ref.TP_LAYOUTS)
@pytest.mark.parametrize("case", list(ref.TP_CASES))
def test_case_matches_reference(reference, monkeypatch, case, layout):
    """The cases no smoke config reaches, each held to the reference as
    above and checked to reach what it is for: the chunked SSD route at
    the ranks' 2 heads; choices dropped at capacity in decode (by the
    reference, counted from its dispatch tensor), the port's routes
    recorded once a forward with the same drops (mixtral, jamba and
    deepseek-v2, whose experts split 2 a rank beside its shared experts);
    the window's ring rolled by the prompt or wrapped by the decode steps;
    the vlm's memory projection split by its kv heads; whisper's heads
    whole on every rank, as at full width."""
    from repro_torch.models.moe import moe_mlp

    arch, ov, prompt, steps, max_len = ref.tp_case(case)
    model, params = _reference_params(arch, **ov)
    cfg = model.cfg
    ssd_heads = []
    real_ssd = ops.ssd_scan
    monkeypatch.setattr(ops, "ssd_scan", lambda x, *a, **kw: (
        ssd_heads.append(x.shape[2]), real_ssd(x, *a, **kw))[1])
    monkeypatch.setattr(moe_mlp, "routes", [] if cfg.moe_experts else None)
    got, cache = _serve(model, params, _tokens(model, prompt + steps), mesh=_mesh(),
                        layout=layout, prompt=prompt, steps=steps, max_len=max_len)
    routes = moe_mlp.routes
    monkeypatch.setattr(moe_mlp, "routes", None)
    _held_to_reference(reference, f"tensor_parallel/{case}/{layout}", got, cache)
    if case.endswith("/chunked"):
        assert prompt == 2 * cfg.ssm_chunk
        assert ssd_heads == [2] * 8 * _layers(cfg, mixer="mamba2")
    if case.endswith("/cf1.25"):
        drops = reference[f"tensor_parallel/{case}/drops"]
        assert drops[1:].sum() > 0  # the reference dropped in decode
        moe = _layers(cfg, mlp="moe")
        assert len(routes) == moe * (1 + steps)  # once a forward, not once a rank
        assert all(r["experts"].shape == (ref.TP_BATCH, prompt if i < moe else 1,
                                          cfg.moe_top_k) for i, r in enumerate(routes))
        port_drops = [sum(int(r["dropped"].sum()) for r in routes[i:i + moe])
                      for i in range(0, len(routes), moe)]
        assert port_drops == [int(d) for d in drops]
    if case.endswith("/kv4"):  # the memory projection split by kv heads, 1 a rank
        sh = params_shardings(params, _mesh(), fsdp_axis=None)["seg0"][4]["mixer"]
        assert sh["wk_mem"].spec == sh["wv_mem"].spec == P(None, "model", None)
        assert cache["seg0"][4]["k_mem"].sharding.spec == P("data", None, None, None)
    if case.endswith("/h6"):  # 6 heads over 4 ranks: every head's weights whole on each
        sh = params_shardings(params, _mesh(), fsdp_axis=None)
        for mixer in (sh["enc_seg0"][0]["mixer"], sh["seg0"][0]["mixer"], sh["seg0"][1]["mixer"]):
            assert all("model" not in t.spec for t in tree_leaves(mixer))
    if case.endswith(("/roll", "/wrap")):
        ring = min(max_len, cfg.sliding_window)
        k = cache["seg0"][0]["k"]
        assert k.shape[2] == ring
        assert (ring < prompt) if case.endswith("/roll") else (prompt < ring < prompt + steps)
        if layout == "seq":
            assert k.sharding.spec[2] == "model"  # the ring's slots split over the ranks


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


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (2, 2), (1, 1)])
@pytest.mark.parametrize("layout", ref.TP_LAYOUTS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_families_match_the_unsharded_model(arch, layout, shape):
    """The SSM, hybrid and MoE families on meshes where the SSM heads split
    2 a rank, 1 a rank or 4, and the experts 1 a rank, not at all (4
    experts over 8: whole on every rank) or 2; at capacity factor 1.25, so
    that the groups drop choices, and mixtral with a window the decode
    steps wrap."""
    ov = {"moe_capacity_factor": 1.25} if arch != "mamba2-1.3b" else {}
    if arch == "mixtral-8x7b":
        ov["sliding_window"] = 8
    model = build_model(dataclasses.replace(get_smoke_config(arch), dtype="float32", **ov))
    params = model.init(torch.Generator().manual_seed(11), device="cpu")
    toks = _tokens(model)
    want, want_cache = _unsharded(model, params, toks)
    got, cache = _serve(model, params, toks, mesh=_mesh(shape), layout=layout)
    torch.testing.assert_close(got, want, **SELF_TOL)
    for a, b in zip(tree_leaves(cache), tree_leaves(want_cache)):
        torch.testing.assert_close(a.full(), b, **SELF_TOL)


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (2, 2), (1, 1)])
@pytest.mark.parametrize("layout", ref.TP_LAYOUTS)
@pytest.mark.parametrize("arch", LATENT_AND_CROSS)
def test_latent_and_cross_match_the_unsharded_model(arch, layout, shape):
    """MLA, the encoder and cross-attention on meshes where the heads
    split 1 a rank, 2 a rank, not at all (4 over 8: ``wq``/``wq_b`` whole,
    deepseek-v2's latent split 4 a rank under ``heads``, its experts 1 a
    rank) and one rank, the cross gates at 1: deepseek-v2 at capacity
    factor 1.25 (the groups drop choices), whisper's encoder and decoder,
    the vlm's decode steps given the image embeddings again."""
    ov = {"moe_capacity_factor": 1.25} if arch == "deepseek-v2-236b" else {}
    model, params = _init(dataclasses.replace(get_smoke_config(arch), dtype="float32", **ov), 13)
    toks = _tokens(model)
    want, want_cache = _unsharded(model, params, toks)
    got, cache = _serve(model, params, toks, mesh=_mesh(shape), layout=layout)
    torch.testing.assert_close(got, want, **SELF_TOL)
    for a, b in zip(tree_leaves(cache), tree_leaves(want_cache)):
        torch.testing.assert_close(a.full(), b, **SELF_TOL)


def test_the_encoder_leaves_every_rank_the_whole_memory(monkeypatch):
    """Whisper's encoder runs in the serving body: its layers sum their
    partials over ``model``, so every rank's memory is the whole encoder
    output of its batch rows, as the unsharded encoder gives it."""
    from repro_torch.models.lm import Model

    model, params = _init(dataclasses.replace(get_smoke_config("whisper-tiny"),
                                              dtype="float32"), 14)
    frames = _extras(model)[0]["frames"]
    want = model._encode(params, frames)
    seen = []
    real = Model._encode
    monkeypatch.setattr(Model, "_encode", lambda self, p, f: (
        lambda out: (seen.append((spmd.axis_index("data"), spmd.axis_index("model"), out)),
                     out)[1])(real(self, p, f)))
    _serve(model, params, _tokens(model), mesh=_mesh(), layout="seq", steps=0)
    assert sorted((d, m) for d, m, _ in seen) == [(d, m) for d in range(2) for m in range(4)]
    rows = ref.TP_BATCH // 2
    for d, _, out in seen:
        assert tuple(out.shape) == (rows, *want.shape[1:])
        torch.testing.assert_close(out, want[d * rows:(d + 1) * rows], **SELF_TOL)


@pytest.mark.parametrize("shape", [(2, 4), (1, 2)])
@pytest.mark.parametrize("layout", ref.TP_LAYOUTS)
@pytest.mark.parametrize("arch", [*ref.TP_ARCHES[:2], "mixtral-8x7b"])
def test_decomposed_decode_matches_the_unsharded_model(monkeypatch, arch, layout, shape):
    """``cache_impl="decomposed"`` (the dry-run's ``dec`` variant): each
    decode step attends to the old rows and the new one, then writes; under
    the ``seq`` layout every rank joins the new row to the combined old
    rows.  The logits and the cache stay the unsharded model's."""
    ov = {"sliding_window": 8} if arch == "mixtral-8x7b" else {}  # wrapped at 8, 9, 10
    model = build_model(dataclasses.replace(get_smoke_config(arch), dtype="float32", **ov))
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
                                              ("deepseek-7b", (2, 2), (2, 2)),
                                              ("whisper-tiny", (2, 4), (1, 1)),
                                              ("whisper-tiny", (1, 2), (2, 2)),
                                              ("llama-3.2-vision-11b", (2, 4), (1, 1)),
                                              ("llama-3.2-vision-11b", (1, 2), (2, 1)),
                                              ("deepseek-v2-236b", (2, 4), None)])
def test_flash_runs_once_a_rank_and_layer_at_the_ranks_heads(monkeypatch, arch, shape, heads):
    """Under ``attn_impl="flash"`` a tensor-parallel prefill calls the flash
    route once per rank and attention layer with a prompt (self-attention,
    whisper's encoder layers, cross-attention to the memory) with the
    rank's q heads and the kv heads they read (qwen3: one q head and its one
    kv head of the replicated two, contiguous; the vlm's cross layers the
    same of its 2 replicated kv heads); MLA (deepseek-v2) never, as the
    unsharded MLA never; decode calls it never."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", attn_impl="flash")
    model, params = _init(cfg, 6)
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
    prompt_layers = _layers(cfg, "attn") + _layers(cfg, "cross_attn") + cfg.encoder_layers
    assert calls == [heads] * ranks * prompt_layers
    assert bool(calls) == (heads is not None)
    monkeypatch.setattr(ops, "flash_attention", real)
    want, _ = _unsharded(model, params, toks)
    torch.testing.assert_close(got, want, **SELF_TOL)


@pytest.mark.parametrize("arch,shape", [("mamba2-1.3b", (2, 4)), ("mamba2-1.3b", (1, 8)),
                                        ("jamba-v0.1-52b", (1, 4)), ("mixtral-8x7b", (2, 4))])
def test_kernels_run_once_a_rank_and_layer_at_the_ranks_heads(monkeypatch, arch, shape):
    """A 32-token prompt (2 × ``ssm_chunk``) under ``attn_impl="flash"``:
    the SSD's chunked route (``ops.ssd_scan``, the kernel on the card) once
    per rank and mamba2 layer at the rank's heads (8 over the model axis),
    flash once per rank and attention layer at its q heads and the kv heads
    they read (4 q heads, 2 kv heads: 1 and 1 over 4 ranks); decode calls
    neither.  The logits stay the unsharded model's."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", attn_impl="flash")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(12), device="cpu")
    calls = {"ssd": [], "flash": []}
    real_ssd, real_flash = ops.ssd_scan, ops.flash_attention
    monkeypatch.setattr(ops, "ssd_scan", lambda x, *a, **kw: (
        calls["ssd"].append(x.shape[2]), real_ssd(x, *a, **kw))[1])
    monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, **kw: (
        calls["flash"].append((q.shape[2], k.shape[2])), real_flash(q, k, v, **kw))[1])
    prompt, steps = 2 * cfg.ssm_chunk, 2
    toks = _tokens(model, prompt + steps)
    got, _ = _serve(model, params, toks, mesh=_mesh(shape), layout="seq", prompt=prompt,
                    steps=steps, max_len=prompt + steps)
    ranks, m = shape[0] * shape[1], shape[1]
    nh = cfg.ssm_expand * cfg.d_model // max(cfg.ssm_head_dim, 1)
    assert calls["ssd"] == [nh // m] * ranks * _layers(cfg, mixer="mamba2")
    assert calls["flash"] == [(cfg.num_heads // m, 1)] * ranks * _layers(cfg, mixer="attn")
    monkeypatch.setattr(ops, "ssd_scan", real_ssd)
    monkeypatch.setattr(ops, "flash_attention", real_flash)
    want, _ = _unsharded(model, params, toks, prompt=prompt, steps=steps, max_len=prompt + steps)
    torch.testing.assert_close(got, want, **SELF_TOL)


def _layer_census(arch, layout, layers, decode):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", num_layers=layers)
    model, params = _init(cfg, 7)
    mesh = _mesh()
    rules = RULES[layout](mesh)
    placed = device_put(params, params_shardings(params, mesh, fsdp_axis=None))
    c0 = model.init_cache(ref.TP_BATCH, ref.TP_MAX_LEN, dtype=torch.float32, device="cpu")
    cache = device_put(c0, cache_shardings(c0, mesh, layout=layout))
    toks = _tokens(model)
    extras, memory = _extras(model)
    with spmd.collective_census() as census:
        if decode:
            sharded_decode_step(model, placed, cache, toks[:, :1], ref.TP_PROMPT, memory,
                                mesh=mesh, rules=rules)
        else:
            sharded_prefill(model, placed, {"tokens": toks[:, :ref.TP_PROMPT], **extras}, cache,
                            mesh=mesh, rules=rules)
    return census["counts"]


#: collectives a layer calls on the (2, 4) mesh, by (arch, layout, step):
#: (all-reduces, all-gathers); the embedding's psum adds one all-reduce.
#: Prefill: the psums after wo and w_down; qwen3's replicated wk/wv gather
#: their sequence-parallel rows (k, v), deepseek's split ones gather their
#: heads for a seq-layout cache.  Decode: under seq the q heads (and split
#: kv heads' new row) are gathered and the combine takes a pmax and a psum.
#: A mamba2 layer, in either step and layout: the gated norm's sum of
#: squares and w_out's partial are summed (2), and the conv cache blocks
#: are gathered with the ranks' last x inputs (1).  A mixtral layer is
#: qwen3's attention (2 kv heads over 4: replicated) and an MoE layer: its
#: experts' partial combine summed (1, where qwen3 sums w_down), and the
#: token rows gathered over data (1): the rank's 2 rows of 8 tokens (or of
#: one) are half of the batch's one group of 32 (or 4).
PER_LAYER = {
    ("qwen3-32b", "seq", False): (2, 2), ("qwen3-32b", "heads", False): (2, 2),
    ("deepseek-7b", "seq", False): (2, 2), ("deepseek-7b", "heads", False): (2, 0),
    ("qwen3-32b", "seq", True): (4, 1), ("qwen3-32b", "heads", True): (2, 0),
    ("deepseek-7b", "seq", True): (4, 3), ("deepseek-7b", "heads", True): (2, 0),
    ("mamba2-1.3b", "seq", False): (2, 1), ("mamba2-1.3b", "heads", False): (2, 1),
    ("mamba2-1.3b", "seq", True): (2, 1), ("mamba2-1.3b", "heads", True): (2, 1),
    ("mixtral-8x7b", "seq", False): (2, 3), ("mixtral-8x7b", "heads", False): (2, 3),
    ("mixtral-8x7b", "seq", True): (4, 2), ("mixtral-8x7b", "heads", True): (2, 1),
    # by the unit UNITS names.  deepseek-v2, an MLA and MoE layer: the psum
    # after wo, the experts' and the shared experts' partials summed (3),
    # the prompt's rows of the wq_a and wkv_a down-projections gathered (2)
    # and the token rows gathered over data (1); a decode step under seq
    # gathers the q_lat and q_rope heads (2) and combines (2 reduces), under
    # heads gathers the ckv and krope latent (2).  whisper, a decoder layer
    # (self-attention, then cross-attention and its MLP): 3 psums; the
    # prompt's memory projection gathers its k and v heads (2) and, under
    # seq, the self-attention's k and v heads for the cache (2); a seq decode
    # step is deepseek-7b's self-attention without its MLP (3, 3) and the
    # cross layer's 2 psums.  The vlm, a period (4 attention layers of
    # qwen3's kind, 2 replicated kv heads over 4, and a cross layer): the
    # prompt's replicated projections gather their sequence-parallel rows,
    # k and v in each layer (10 gathers, 10 psums); a decode step
    # re-projects the memory (2 gathers) beside the attention layers'
    ("deepseek-v2-236b", "seq", False): (3, 3), ("deepseek-v2-236b", "heads", False): (3, 3),
    ("deepseek-v2-236b", "seq", True): (5, 3), ("deepseek-v2-236b", "heads", True): (3, 3),
    ("whisper-tiny", "seq", False): (3, 4), ("whisper-tiny", "heads", False): (3, 2),
    ("whisper-tiny", "seq", True): (5, 3), ("whisper-tiny", "heads", True): (3, 0),
    ("llama-3.2-vision-11b", "seq", False): (10, 10),
    ("llama-3.2-vision-11b", "heads", False): (10, 10),
    ("llama-3.2-vision-11b", "seq", True): (18, 6),
    ("llama-3.2-vision-11b", "heads", True): (10, 2),
}
#: the configs whose depth repeats more than one layer: the depths the
#: census runs at and the unit of PER_LAYER (its count at a depth)
UNITS = {"deepseek-v2-236b": ((2, 4), lambda cfg: _layers(cfg, mlp="moe")),
         "whisper-tiny": ((1, 3), lambda cfg: cfg.num_layers),
         "llama-3.2-vision-11b": ((5, 10), lambda cfg: _layers(cfg, mixer="cross_attn"))}
#: what runs once beside the units (reduces, gathers), the embedding's psum
#: aside: deepseek-v2's dense first layer (an MLA layer and its MLP) and
#: whisper's 2 encoder layers in a prefill (a psum after wo and w_down each)
ONCE = {("deepseek-v2-236b", "seq", False): (2, 2), ("deepseek-v2-236b", "heads", False): (2, 2),
        ("deepseek-v2-236b", "seq", True): (4, 2), ("deepseek-v2-236b", "heads", True): (2, 2),
        ("whisper-tiny", "seq", False): (4, 0), ("whisper-tiny", "heads", False): (4, 0)}


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("layout", ref.TP_LAYOUTS)
@pytest.mark.parametrize("arch", [*ref.TP_ARCHES[:2], "mamba2-1.3b", "mixtral-8x7b",
                                  *LATENT_AND_CROSS])
def test_collectives_per_layer(arch, layout, decode):
    reduces, gathers = PER_LAYER[(arch, layout, decode)]
    once_r, once_g = ONCE.get((arch, layout, decode), (0, 0))
    depths, units = UNITS.get(arch, ((1, 3), lambda cfg: cfg.num_layers))
    for layers in depths:
        n = units(dataclasses.replace(get_smoke_config(arch), num_layers=layers))
        counts = _layer_census(arch, layout, layers, decode)
        assert counts.get("all-reduce", 0) == 1 + once_r + reduces * n
        assert counts.get("all-gather", 0) == once_g + gathers * n


def test_outside_a_body_the_hooks_do_nothing():
    assert tensor_parallel() is None
    model = build_model(dataclasses.replace(get_smoke_config("qwen3-32b"), dtype="float32"))
    params = model.init(torch.Generator().manual_seed(8), device="cpu")
    with spmd.collective_census() as census:
        _unsharded(model, params, _tokens(model))
    assert census["counts"] == {}


def test_every_config_is_admitted():
    """MLA (deepseek-v2), the encoder and cross-attention (whisper, the
    vlm) run since they were ported: every config of the repo is admitted
    with the onehot MoE, and a prefill of each of the three under the
    ``seq`` layout gives finite logits of the batch's rows and the padded
    vocabulary."""
    from repro_torch.configs import ARCH_IDS

    assert [a for a in ARCH_IDS
            if build_model(get_smoke_config(a)).tensor_parallel_refusal() is not None] == []
    for arch in LATENT_AND_CROSS:
        model, params = _init(dataclasses.replace(get_smoke_config(arch), dtype="float32"), 0)
        got, _ = _serve(model, params, _tokens(model), mesh=_mesh(), layout="seq", steps=0)
        assert tuple(got.shape) == (ref.TP_BATCH, 1, model.cfg.padded_vocab)
        assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("what", ["ragged", "long_decode_rules", "unplaced_cache",
                                  "no_model_axis"])
def test_refuses_what_it_does_not_run(what):
    """The ragged MoE dispatch (jamba's and deepseek-v2's), a
    ``decode_rules`` cache (its sequence over ``model``) run under
    ``long_decode_rules``, a cache not placed on the mesh and a mesh
    without a ``model`` axis are refused."""
    mesh = _mesh()
    tokens = {"tokens": torch.zeros((2, 4), dtype=torch.int64)}
    if what == "ragged":
        for arch in ("jamba-v0.1-52b", "deepseek-v2-236b"):
            model = build_model(dataclasses.replace(get_smoke_config(arch), moe_impl="ragged"))
            assert "'ragged' is the data-parallel dropless" in model.tensor_parallel_refusal()
            params = model.init(torch.Generator().manual_seed(0), device="cpu")
            c0 = model.init_cache(2, 8, dtype=torch.float32, device="cpu")
            with pytest.raises(NotImplementedError,
                               match="tensor-parallel serving runs .*'ragged' is the data-"):
                sharded_prefill(model, params, tokens,
                                device_put(c0, cache_shardings(c0, mesh)), mesh=mesh,
                                rules=decode_rules(mesh))
        return
    model = build_model(dataclasses.replace(get_smoke_config("qwen3-32b"), dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    c0 = model.init_cache(2, 8, dtype=torch.float32, device="cpu")
    if what == "unplaced_cache":
        with pytest.raises(ValueError, match="placed on the mesh"):
            sharded_prefill(model, params, tokens, c0, mesh=mesh, rules=decode_rules(mesh))
    elif what == "long_decode_rules":
        cache = device_put(c0, cache_shardings(c0, mesh))
        assert cache["seg0"][0]["k"].sharding.spec[2] == "model"
        with pytest.raises(ValueError, match=r"laid out for other rules \(its sequence over "
                                             r"'model'\).*cache_shardings\(long_context=True\)"):
            sharded_prefill(model, params, tokens, cache, mesh=mesh,
                            rules=long_decode_rules(mesh))
    else:
        mesh2 = _mesh((8,), ("data",))
        with pytest.raises(ValueError, match="'model' axis"):
            sharded_prefill(model, params, tokens, device_put(c0, NamedSharding(mesh2, P())),
                            mesh=mesh2, rules=decode_rules(mesh2))


def test_mixed_cache_layouts_are_refused():
    """The MLA layers' ``ckv``/``krope`` set the layout as the attention
    layers' ``k`` does (the sequence over ``model`` under ``seq``, the
    latent and rope dims under ``heads``); a cache whose leaves lie
    differently (a latent split beside a rope dim kept whole) is refused."""
    model = build_model(dataclasses.replace(get_smoke_config("deepseek-v2-236b"),
                                            dtype="float32"))
    mesh = _mesh()
    c0 = model.init_cache(ref.TP_BATCH, ref.TP_MAX_LEN, dtype=torch.float32, device="cpu")
    specs = lambda layout: tree_map(lambda _, s: s.spec,  # noqa: E731
                                    c0, cache_shardings(c0, mesh, layout=layout))
    assert spmd._kv_cache_layout(c0, specs("seq")) == ("model", False, False)
    assert spmd._kv_cache_layout(c0, specs("heads")) == (None, False, True)
    mixed = specs("heads")
    mixed["seg1"][0]["krope"] = P(None, "data", None, None)
    with pytest.raises(ValueError, match="lie differently"):
        spmd._kv_cache_layout(c0, mixed)


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
