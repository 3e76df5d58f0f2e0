"""The port's MoE layer on the card against its plain per-expert version,
and the cross-attention families' prefill through the flash kernel against
the ref route.

Needs an NVIDIA GPU; on a host without one every test skips with that
reason.  Run on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_models.py

``moe_mlp`` (one-hot dispatch and combine, capacity buffers) and
``moe_ref.moe_plain`` (argmax top-k, sort-ranked slots, per-expert gathers)
at the published capacity factor 1.25, on 4096 tokens in groups of 1024 and
on decode-sized groups of 8, with mixtral's virtual split 2 and jamba's 16
experts at reduced widths.  In f32 (no TF32) the dropped choices must be
equal and the outputs within ``F32_TOL`` (``tests/test_kernels.py``'s f32
tolerance); in bf16 the outputs within ``BF16_TOL`` at every token whose
routes agree (the two compute the router product in different shapes, so a
near-tie of bf16 probabilities may route a token apart).

whisper-tiny whole (its encoder's bidirectional self-attention over 1500
frames and cross-attention at head dim 64) and llama-3.2-vision-11b at two
periods of reduced width (cross-attention over 1600 image tokens at head dim
128), every gate at 1: the prefill under ``attn_impl="flash"`` launches the
kernel once per attention layer and its last logits equal the ref route's,
within ``F32_LOGIT_TOL`` in f32 (the split route) and ``BF16_LOGIT_TOL`` in
bf16 (the wgmma route; ``chip_smoke.py``'s qwen3 serve tolerance).
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import build_model
from repro_torch.models.moe import init_moe, moe_mlp
from repro_torch.models.moe_ref import moe_plain

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
F32_LOGIT_TOL = 1e-3
BF16_LOGIT_TOL = 0.25

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _layer(arch, dev, dtype, seed):
    cfg = dataclasses.replace(get_config(arch), d_model=512, moe_d_ff=1024,
                              dtype=str(dtype).removeprefix("torch."))
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, init_moe(cfg, generator=gen, device=dev, dtype=dtype)


def _routes(p, cfg, x):
    moe_mlp.routes = []
    try:
        out = moe_mlp(p, cfg, x)
        (rec,) = moe_mlp.routes
    finally:
        moe_mlp.routes = None
    return out, rec


def _x(b, l, d, dev, seed, skew=0.0):
    """Normal rows, plus ``skew`` times one shared random row: the shared
    part tilts every token's router logits the same way, so some experts
    are over-subscribed and the capacity drops choices (unskewed random
    rows spread evenly: a 1024-token group at 1.25 drops none)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, l, d), generator=gen, device=dev)
    return x + skew * torch.randn((d,), generator=gen, device=dev)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("b,l,skew", [(4, 1024, 1.0), (4, 1024, 0.0), (8, 1, 0.0)])
def test_moe_f32_matches_plain_with_equal_drops(dev, arch, b, l, skew):
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, p = _layer(arch, dev, torch.float32, 1)
    x = _x(b, l, cfg.d_model, dev, 2, skew)
    got, rec = _routes(p, cfg, x)
    want, experts, dropped = moe_plain(p, cfg, x)
    assert torch.equal(rec["experts"], experts) and torch.equal(rec["dropped"], dropped)
    torch.testing.assert_close(got, want, **F32_TOL)
    if skew:
        assert bool(dropped.any())


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-v0.1-52b"])
def test_moe_bf16_matches_plain_where_routes_agree(dev, arch):
    cfg, p = _layer(arch, dev, torch.bfloat16, 3)
    x = _x(4, 1024, cfg.d_model, dev, 4, 1.0).to(torch.bfloat16)
    got, rec = _routes(p, cfg, x)
    want, experts, dropped = moe_plain(p, cfg, x)
    agree = ((rec["experts"] == experts) & (rec["dropped"] == dropped)).all(-1)
    assert agree.float().mean() > 0.9 and bool(dropped.any())
    torch.testing.assert_close(got[agree].float(), want[agree].float(), **BF16_TOL)



def _gates(tree, value):
    for key, node in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(node, (dict, tuple, list)):
            _gates(node, value)
        elif key == "gate":
            node.fill_(value)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,overrides", [
    ("whisper-tiny", {}),
    ("llama-3.2-vision-11b", {"num_layers": 10, "d_model": 512, "num_heads": 8,
                              "num_kv_heads": 2, "d_ff": 1024, "vocab_size": 1024,
                              "image_embed_dim": 256}),
])
def test_cross_prefill_flash_matches_ref_route(dev, arch, overrides, dtype):
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config(arch), dtype=str(dtype).removeprefix("torch."),
                              attn_impl="flash", **overrides)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(5)
    params = model.init(gen, device=dev)
    _gates(params, 1.0)
    b, prompt = 2, 64
    m = cfg.encoder_seq if cfg.family == "audio" else cfg.image_tokens
    key, width = ("frames", cfg.d_model) if cfg.family == "audio" else ("image_embeds",
                                                                         cfg.image_embed_dim)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen, device=dev),
             key: torch.randn((b, m, width), generator=gen, device=dev).to(dtype)}
    logits = {}
    for impl in ("flash", "ref"):
        routed = build_model(dataclasses.replace(cfg, attn_impl=impl))
        cache = routed.init_cache(b, prompt, dtype=dtype, device=dev)
        before = fa.flash_attention.launches
        with torch.no_grad():
            logits[impl], _ = routed.prefill(params, batch, cache)
        torch.cuda.synchronize()
        mixers = [s.mixer for seg in (*cfg.segments(), *cfg.encoder_segments())
                  for s in seg.period for _ in range(seg.repeats)]
        assert fa.flash_attention.launches - before == (len(mixers) if impl == "flash" else 0)
    tol = F32_LOGIT_TOL if dtype == torch.float32 else BF16_LOGIT_TOL
    v = cfg.vocab_size
    torch.testing.assert_close(logits["flash"][:, :v].float(), logits["ref"][:, :v].float(),
                               rtol=0, atol=tol)
