"""The port's MoE layer on the card against its plain per-expert version.

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
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.moe import init_moe, moe_mlp
from repro_torch.models.moe_ref import moe_plain

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

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

