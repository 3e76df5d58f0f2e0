"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU built for ``sm_90a`` and ``nvcc``; on a
host without a card each one skips with that reason.  Run them on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: bf16 outputs within ``BF16_TOL`` (the reference tests' bf16
tolerance, ``tests/test_kernels.py`` ``TOL``), the SSD scan in f32 within
``SSD_TOL`` (``tests/test_kernels.py``), the value histogram bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import partition_reduce as pr
from repro_torch.kernels import ssd_scan as ss

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
SSD_TOL = dict(rtol=3e-4, atol=3e-4)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a) and nvcc")
    return torch.device("cuda", 0)


def _normal(gen, dev, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("b,lq,lk,h,hkv,d,causal,window", [
    (1, 64, 64, 2, 2, 128, True, 0),     # group 1: 128 consecutive rows per CTA
    (2, 128, 128, 8, 1, 64, True, 0),    # MQA (group 8): head pairs
    (1, 500, 500, 8, 2, 128, True, 0),   # ragged Lq = Lk
    (1, 500, 500, 6, 2, 64, True, 0),    # odd group 3
    (2, 256, 256, 4, 4, 32, True, 0),    # D = 32 (64-byte swizzle)
    (1, 200, 328, 4, 2, 64, False, 0),   # cross length, not causal
    (1, 300, 300, 4, 2, 128, True, 100), # window edge tiles
    (8, 512, 512, 64, 8, 128, True, 0),  # one qwen3-32b prefill layer
])
def test_flash_matches_plain(dev, b, lq, lk, h, hkv, d, causal, window):
    gen = torch.Generator(device=dev).manual_seed(lq + d + h)
    q, k, v = _normal(gen, dev, b, lq, h, d), _normal(gen, dev, b, lk, hkv, d), \
        _normal(gen, dev, b, lk, hkv, d)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


def test_flash_fully_masked_rows_are_zero(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = _normal(gen, dev, 1, 64, 4, 128), _normal(gen, dev, 1, 16, 1, 128), \
        _normal(gen, dev, 1, 16, 1, 128)
    got = fa.flash_attention(q, k, v, causal=True, window=4)
    assert bool((got[:, 19:] == 0).all())
    torch.testing.assert_close(
        got.float(), fa.flash_attention_ref(q, k, v, causal=True, window=4).float(), **BF16_TOL)


def test_flash_counts_launches(dev):
    x = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=dev)
    before = fa.flash_attention.launches
    fa.flash_attention(x, x, x)
    assert fa.flash_attention.launches == before + 1


def _ssd_inputs(gen, dev, b, l, nh, p, n, dtype):
    x = torch.randn((b, l, nh, p), generator=gen, device=dev)
    dt = torch.rand((b, l, nh), generator=gen, device=dev) * 0.8 + 0.1
    a = -(torch.rand((nh,), generator=gen, device=dev) + 0.5)
    bm = torch.randn((b, l, n), generator=gen, device=dev)
    cm = torch.randn((b, l, n), generator=gen, device=dev)
    return tuple(t.to(dtype) for t in (x, dt, a, bm, cm))


@pytest.mark.parametrize("b,l,nh,p,n", [
    (2, 256, 4, 64, 128),   # the mamba2 widths, 4 chunks
    (1, 100, 3, 64, 128),   # ragged last chunk, odd head count
    (2, 64, 2, 16, 32),     # narrow head and state
    (1, 130, 2, 20, 36),    # widths that take the element-by-element loads
    (8, 512, 64, 64, 128),  # one mamba2-1.3b prefill layer
])
def test_ssd_f32_matches_plain(dev, b, l, nh, p, n):
    """f32 inputs that are not bf16 values: the three-product route."""
    gen = torch.Generator(device=dev).manual_seed(l + nh)
    inputs = _ssd_inputs(gen, dev, b, l, nh, p, n, torch.float32)
    y, h = ss.ssd_scan(*inputs, chunk=l)
    ry, rh = ss.ssd_chunked(*inputs, chunk=l)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ry, **SSD_TOL)
    torch.testing.assert_close(h, rh, **SSD_TOL)


@pytest.mark.parametrize("b,l,nh,p,n", [(2, 256, 4, 64, 128), (1, 100, 3, 64, 128)])
def test_ssd_bf16_matches_f32_plain(dev, b, l, nh, p, n):
    gen = torch.Generator(device=dev).manual_seed(l + 7)
    inputs = _ssd_inputs(gen, dev, b, l, nh, p, n, torch.bfloat16)
    y, h = ss.ssd_scan(*inputs, chunk=l)
    ry, rh = ss.ssd_chunked(*(t.float() for t in inputs), chunk=l)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), ry, **BF16_TOL)
    torch.testing.assert_close(h, rh, **SSD_TOL)


@pytest.mark.parametrize("lo,hi,bins", [(0.1, 2.5, 8), (-1.2, 2.0, 16), (0.0, 1.0, 128)])
def test_histogram_bit_exact_with_plain(dev, lo, hi, bins):
    rng = np.random.default_rng(bins)
    w = np.float32((hi - lo) / bins)
    k = np.arange(bins + 1, dtype=np.float32)
    edges = np.concatenate([np.float32(lo) + w * k, w * k + (np.float32(lo) + w)])
    laced = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                            np.nextafter(edges, np.float32(-np.inf)),
                            np.float32([1e-45, -1e-45, 0.0, np.inf, -np.inf, np.nan])])
    x = np.concatenate([rng.uniform(lo - 1, hi + 1, 4096).astype(np.float32), laced])
    t = torch.from_numpy(x).reshape(1, -1, 1).to(dev)
    got = pr.partition_histogram(t, bins=bins, lo=lo, hi=hi)
    want = pr.partition_histogram_ref(t, bins=bins, lo=lo, hi=hi)
    assert torch.equal(got, want)
    assert math.isclose(float(got.sum()), float(pr.partition_histogram_ref(
        t.cpu(), bins=bins, lo=lo, hi=hi).sum()))
