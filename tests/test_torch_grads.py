"""The port's loss and gradient on the CPU against ``jax.value_and_grad``.

Every ``ARCH_IDS`` smoke config in f32, the JAX weights in the port as f32
master weights (``params_from_numpy(master=True)``), every cross-attention
gate seeded in [0.5, 1.5] (the reference draws 0, and ``tanh(0)`` would
give the cross path and whisper's whole encoder an exact zero gradient,
which a wrong backward would match bit for bit).  The batch: 2 × 32
tokens, labels with masked (-1) positions, the audio family's frames and
the vlm's image embeddings.  32 tokens are two of mamba2's and jamba's
smoke SSD chunks, so the chunked SSD route carries the gradient.

Held: the loss (rtol 1e-5) and every gradient leaf, each within
``GRAD_RTOL`` of its largest magnitude (an f32 backward summed in another
order); the encoder's and the cross layers' gradients are non-zero; remat
``none``, ``full`` and ``dots`` give bit-equal losses and gradients; the
repair's route rule (under autograd the model takes the plain attention
and SSD, never the kernel wrappers, whatever ``attn_impl`` says) and the
wrappers' ``RuntimeError``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro_torch._pytree import tree_leaves
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd_module
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm
from repro_torch.optim.grad_accum import value_and_grad
from test_torch_models import set_gates

B, S = 2, 32
#: a gradient leaf's largest error against the JAX gradient, over the leaf's
#: largest magnitude
GRAD_RTOL = 2e-4


def _pair(arch, seed=3, **overrides):
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32", **overrides)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **overrides)
    jm = j_build(jcfg)
    tree = set_gates(jax.tree.map(np.asarray, jm.init(jax.random.key(seed))), seed)
    return (jm, jax.tree.map(jnp.asarray, tree), build_model(cfg),
            params_from_numpy(tree, cfg, device="cpu", master=True))


def _batch(cfg, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :3] = -1
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(
            size=(B, cfg.image_tokens, cfg.image_embed_dim)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _paths(tree, prefix=""):
    """``[(path, leaf)]`` in ``jax.tree.leaves``' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [item for i, t in enumerate(tree) for item in _paths(t, f"{prefix}/{i}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_every_gradient_match_reference(arch):
    jm, jparams, tm, tparams = _pair(arch)
    jbatch, tbatch = _batch(tm.cfg)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jparams, jbatch)
    tl, tg = value_and_grad(tm.loss, tparams, tbatch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    got, want = _paths(tg), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for (path, a), b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, path
        err = float(np.max(np.abs(a.numpy() - b))) if b.size else 0.0
        assert err <= GRAD_RTOL * float(np.max(np.abs(b))) + 1e-12, (path, err)
    nonzero = {path: bool(torch.any(a != 0)) for path, a in got}
    for path, ok in nonzero.items():
        if path.startswith("/enc_") or "wk_mem" in path or "wv_mem" in path or "gate" in path:
            assert ok, f"{path}: zero gradient on the encoder or cross path"
    if tm.cfg.encoder_layers or tm.cfg.family == "vlm":
        assert any(p.startswith("/enc_") or "wk_mem" in p for p in nonzero)


@pytest.mark.parametrize("arch", ["qwen3-32b", "mixtral-8x7b", "mamba2-1.3b",
                                  "deepseek-v2-236b", "whisper-tiny"])
def test_remat_policies_give_equal_gradients(arch):
    _, _, tm, tparams = _pair(arch)
    _, tbatch = _batch(tm.cfg)
    results = {}
    for remat in ("none", "full", "dots"):
        model = build_model(dataclasses.replace(tm.cfg, remat=remat))
        results[remat] = value_and_grad(model.loss, tparams, tbatch)
    for remat in ("full", "dots"):
        assert torch.equal(results[remat][0], results["none"][0])
        for a, b in zip(tree_leaves(results[remat][1]), tree_leaves(results["none"][1])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_route_recorder_records_a_forward_once_under_remat(remat):
    _, _, tm, tparams = _pair("mixtral-8x7b", remat=remat)
    _, tbatch = _batch(tm.cfg)
    tmoe.moe_mlp.routes = []
    try:
        value_and_grad(tm.loss, tparams, tbatch)
        routes = tmoe.moe_mlp.routes
    finally:
        tmoe.moe_mlp.routes = None
    assert len(routes) == tm.cfg.num_layers
    assert all(r["experts"].shape[:2] == (B, S) for r in routes)


# ---------------------------------------------------------------------------
# the repair: no kernel takes part in a gradient
# ---------------------------------------------------------------------------


def _counting(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("arch", ["qwen3-32b", "whisper-tiny", "llama-3.2-vision-11b",
                                  "mixtral-8x7b"])
def test_flash_route_takes_plain_attention_under_autograd(arch, monkeypatch):
    """``attn_impl="flash"``: the loss's forward and its gradient never call
    ``ops.flash_attention`` and equal the ``"ref"`` route's bit for bit; a
    forward without autograd does call it."""
    _, _, ref, tparams = _pair(arch)
    flash = build_model(dataclasses.replace(ref.cfg, attn_impl="flash"))
    _, tbatch = _batch(ref.cfg)
    calls = _counting(monkeypatch, ops, "flash_attention")
    fl, fg = value_and_grad(flash.loss, tparams, tbatch)
    assert calls == []
    rl, rg = value_and_grad(ref.loss, tparams, tbatch)
    assert torch.equal(fl, rl)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(fg), tree_leaves(rg)))
    with torch.no_grad():
        flash.forward(tparams, tbatch)
    assert calls


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_chunked_ssd_route_takes_ssd_chunked_under_autograd(arch, monkeypatch):
    _, _, tm, tparams = _pair(arch)
    _, tbatch = _batch(tm.cfg)
    assert S % tm.cfg.ssm_chunk == 0 and S > tm.cfg.ssm_chunk  # the chunked route
    kernel = _counting(monkeypatch, ops, "ssd_scan")
    plain = _counting(monkeypatch, ssm, "ssd_chunked")
    value_and_grad(tm.loss, tparams, tbatch)
    assert kernel == [] and len(plain) > 0
    plain.clear()
    with torch.no_grad():
        tm.forward(tparams, tbatch)
    assert kernel and plain == []


def _flash_operands(requires_grad):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 8, 2, 16), generator=g) for _ in range(3))
    return q.requires_grad_(requires_grad), k, v


def _ssd_operands(requires_grad):
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, 8, 2, 4), generator=g).requires_grad_(requires_grad)
    dt = torch.rand((1, 8, 2), generator=g)
    a = -torch.rand((2,), generator=g)
    bm, cm = (torch.randn((1, 8, 3), generator=g) for _ in range(2))
    return x, dt, a, bm, cm


def test_flash_attention_refuses_an_operand_that_requires_grad():
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(*_flash_operands(True))
    with torch.no_grad():
        ops.flash_attention(*_flash_operands(True))  # grad mode off: no graph, no refusal
    out = ops.flash_attention(*_flash_operands(False))
    assert out.shape == (1, 8, 2, 16)


def test_ssd_scan_refuses_an_operand_that_requires_grad():
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd_scan(*_ssd_operands(True), chunk=4)
    with torch.no_grad():
        ops.ssd_scan(*_ssd_operands(True), chunk=4)
    y, h = ops.ssd_scan(*_ssd_operands(False), chunk=4)
    assert y.shape == (1, 8, 2, 4) and h.dtype == torch.float32


def test_prefill_attention_rule(monkeypatch):
    cfg = dataclasses.replace(get_smoke_config("qwen3-32b"), attn_impl="flash")
    calls = _counting(monkeypatch, ops, "flash_attention")
    q, k, v = _flash_operands(True)
    L._prefill_attention(q, k, v, causal=True, window=0, cfg=cfg)
    assert calls == []
    L._prefill_attention(q.detach(), k, v, causal=True, window=0, cfg=cfg)
    assert calls == ["flash_attention"]


def test_ssd_module_exports_the_plain_version():
    assert ssm.ssd_chunked is ssd_module.ssd_chunked
