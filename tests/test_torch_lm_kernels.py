"""The port's LM kernels on the CPU (their plain versions) vs the JAX kernels.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do
(``tests/test_kernels.py``), on the same inputs made with numpy from a seed.
Tolerances are the reference tests': flash attention at ``TOL`` per dtype,
SSD at 3e-4; ``partition_histogram`` must be bit-exact.  The CUDA kernels
only run on a card, where ``chip_smoke.py`` holds each against the plain
version tested here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.partition_reduce import partition_histogram as j_hist
from repro.kernels.ssd_scan import ssd_scan as j_ssd
from repro_torch.api.kernels import pallas_interpret
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_emulated,
                                                 flash_attention_ref, split_terms_ref)
from repro_torch.kernels.partition_reduce import _SMEM_OPTIN, _histogram_plan
from repro_torch.kernels.partition_reduce import _flush_subnormal as tpr_flush
from repro_torch.kernels.partition_reduce import _hist_thresholds as tpr_hist_thresholds
from repro_torch.kernels.partition_reduce import partition_histogram
from repro_torch.kernels.ssd_scan import ssd_scan

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SSD_TOL = dict(rtol=3e-4, atol=3e-4)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _both(x, dtype="float32"):
    """One numpy array as a JAX array and a torch tensor of ``dtype``."""
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def _flash_pair(rng, b, lq, lk, h, hkv, d, dtype="float32"):
    q, k, v = _normal(rng, b, lq, h, d), _normal(rng, b, lk, hkv, d), _normal(rng, b, lk, hkv, d)
    return [_both(a, dtype) for a in (q, k, v)]


@pytest.mark.parametrize("b,lq,lk,h,hkv,d", [
    (1, 32, 32, 2, 2, 8),      # MHA
    (2, 64, 64, 4, 2, 16),     # GQA 2:1
    (1, 128, 128, 8, 1, 32),   # MQA
    (2, 48, 96, 4, 4, 64),     # cross-length, non-causal
])
def test_flash_shapes_vs_jax(b, lq, lk, h, hkv, d):
    (jq, tq), (jk, tk), (jv, tv) = _flash_pair(np.random.default_rng(lq + d), b, lq, lk, h, hkv, d)
    causal = lq == lk
    want = j_flash(jq, jk, jv, causal=causal, block_q=16, block_k=16)
    got = ops.flash_attention(tq, tk, tv, causal=causal, block_q=16, block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])
    np.testing.assert_allclose(
        got.numpy(), tref.attention_ref(tq, tk, tv, causal=causal).numpy(), **TOL["float32"]
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_dtypes_vs_jax(dtype):
    (jq, tq), (jk, tk), (jv, tv) = _flash_pair(np.random.default_rng(1), 2, 64, 64, 4, 2, 16, dtype)
    want = j_flash(jq, jk, jv, block_q=32, block_k=32)
    got = ops.flash_attention(tq, tk, tv, block_q=32, block_k=32)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("window", [8, 24, 64])
def test_flash_sliding_window_vs_jax(window):
    (jq, tq), (jk, tk), (jv, tv) = _flash_pair(np.random.default_rng(window), 1, 64, 64, 2, 2, 16)
    want = j_flash(jq, jk, jv, window=window, block_q=16, block_k=16)
    got = ops.flash_attention(tq, tk, tv, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("bq,bk", [(8, 8), (16, 32), (32, 16), (64, 64)])
def test_flash_tile_invariance(bq, bk):
    """Neither package's result depends on the tiling it is asked for."""
    (jq, tq), (jk, tk), (jv, tv) = _flash_pair(np.random.default_rng(2), 1, 64, 64, 2, 2, 16)
    want = j_flash(jq, jk, jv, block_q=bq, block_k=bk)
    got = ops.flash_attention(tq, tk, tv, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])
    np.testing.assert_array_equal(got.numpy(), ops.flash_attention(tq, tk, tv).numpy())


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fully_masked_rows_are_zero(causal):
    """A query row that no key reaches gives 0 in the JAX kernel and in the
    port's plain version; the JAX ``attention_ref`` oracle averages ``v``."""
    lq, lk, window = 32, 16, 4
    (jq, tq), (jk, tk), (jv, tv) = _flash_pair(np.random.default_rng(3), 1, lq, lk, 2, 1, 16)
    want = np.asarray(j_flash(jq, jk, jv, causal=causal, window=window, block_q=16, block_k=16))
    got = flash_attention(tq, tk, tv, causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, want, **TOL["float32"])
    # rows from lk + window - 1 (causal) or lk - 1 + window (window only) see no key
    first_masked = lk + window - 1
    assert np.all(got[:, first_masked:] == 0) and np.all(want[:, first_masked:] == 0)
    assert np.abs(got[:, :first_masked]).max() > 0
    oracle = tref.attention_ref(tq, tk, tv, causal=causal, window=window).numpy()
    mean_v = tv.numpy().mean(axis=1)[:, None, :, :]  # (1, 1, Hkv=1, D)
    np.testing.assert_allclose(oracle[:, first_masked:], np.broadcast_to(
        mean_v, oracle[:, first_masked:].shape), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(jref.attention_ref(jq, jk, jv, causal=causal, window=window)), oracle,
        **TOL["float32"])


def test_flash_ragged_query_length_on_plain_version():
    """The kernel masks a ragged last tile; its plain version takes any Lq."""
    rng = np.random.default_rng(4)
    (_, tq), (_, tk), (_, tv) = _flash_pair(rng, 1, 37, 37, 2, 1, 16)
    got = flash_attention_ref(tq, tk, tv)
    np.testing.assert_allclose(got.numpy(), tref.attention_ref(tq, tk, tv).numpy(),
                               **TOL["float32"])


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, b, l, nh, p, n):
    rng = np.random.default_rng(seed)
    return (
        _normal(rng, b, l, nh, p),
        rng.uniform(0.1, 0.9, (b, l, nh)).astype(np.float32),
        -rng.uniform(0.5, 1.5, (nh,)).astype(np.float32),
        _normal(rng, b, l, n),
        _normal(rng, b, l, n),
    )


@pytest.mark.parametrize("b,l,nh,p,n,chunk", [
    (1, 32, 1, 4, 8, 8),
    (2, 64, 3, 8, 16, 16),
    (1, 128, 2, 16, 32, 32),
    (2, 64, 4, 8, 16, 64),   # single chunk
])
def test_ssd_shapes_vs_jax(b, l, nh, p, n, chunk):
    arrays = _ssd_inputs(l + nh, b, l, nh, p, n)
    jy, jh = j_ssd(*map(jnp.asarray, arrays), chunk=chunk)
    ty, th = ops.ssd_scan(*map(torch.from_numpy, arrays), chunk=chunk)
    assert ty.dtype == torch.float32 and th.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SSD_TOL)
    ry, rh = tref.ssd_ref(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(ty.numpy(), ry.numpy(), **SSD_TOL)
    np.testing.assert_allclose(th.numpy(), rh.numpy(), **SSD_TOL)


def test_ssd_chunk_invariance():
    arrays = _ssd_inputs(5, 1, 64, 2, 8, 16)
    tensors = list(map(torch.from_numpy, arrays))
    base, hbase = ssd_scan(*tensors, chunk=8)
    jbase, _ = j_ssd(*map(jnp.asarray, arrays), chunk=8)
    np.testing.assert_allclose(base.numpy(), np.asarray(jbase), **SSD_TOL)
    for chunk in (16, 32, 64):
        y, hf = ssd_scan(*tensors, chunk=chunk)
        np.testing.assert_allclose(y.numpy(), base.numpy(), **SSD_TOL)
        np.testing.assert_allclose(hf.numpy(), hbase.numpy(), **SSD_TOL)


def test_ssd_rejects_ragged_chunking():
    tensors = list(map(torch.from_numpy, _ssd_inputs(6, 1, 24, 1, 4, 8)))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan(*tensors, chunk=16)


# ---------------------------------------------------------------------------
# partition_histogram
# ---------------------------------------------------------------------------


def _hist_data(seed, shape, lo, hi, bins=8):
    """Uniform values over [lo - 10%, hi + 10%] laced with ±inf, NaN, huge
    values, ±0 and subnormals, and values on and one ulp beside each edge
    lo + k (hi - lo) / bins, each upper edge as f32 arithmetic forms it
    (lo + w*k) + w and w*k + (lo + w), and the two clamp thresholds."""
    rng = np.random.default_rng(seed)
    width = hi - lo
    x = rng.uniform(lo - 0.1 * width, hi + 0.1 * width, shape).astype(np.float32).reshape(-1)
    w = np.float32(width / bins)
    k = np.arange(bins + 1, dtype=np.float32)
    edges = np.concatenate([
        (lo + np.arange(bins + 1) * (width / bins)).astype(np.float32),
        (np.float32(lo) + w * k) + w,
        w * k + (np.float32(lo) + w),
        np.float32([lo + width / bins, hi - width / bins]),
    ])
    special = np.concatenate([
        [np.inf, -np.inf, np.nan, 1e10, -1e10, lo, hi, 0.0, -0.0, 1e-45, -1e-45, 1e-39,
         np.nextafter(np.float32(lo), np.float32(-np.inf)),
         np.nextafter(np.float32(hi), np.float32(-np.inf))],
        edges,
        np.nextafter(edges, np.float32(np.inf)),
        np.nextafter(edges, np.float32(-np.inf)),
    ]).astype(np.float32)
    idx = rng.choice(x.size, size=special.size, replace=False)
    x[idx] = special
    return x.reshape(shape)


@pytest.mark.parametrize("nb,rows,d,bins", [
    (1, 16, 2, 8), (4, 32, 4, 16), (8, 64, 1, 128), (3, 8, 8, 32),
])
def test_histogram_bit_exact_vs_jax(nb, rows, d, bins):
    x = np.random.default_rng(nb * rows).uniform(0, 1, (nb, rows, d)).astype(np.float32)
    want = np.asarray(j_hist(jnp.asarray(x), bins=bins, lo=0.0, hi=1.0))
    got = ops.partition_histogram(torch.from_numpy(x), bins=bins, lo=0.0, hi=1.0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (bins,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tref.histogram_ref(torch.from_numpy(x), bins=bins, lo=0.0, hi=1.0).numpy()
    )
    assert int(got.sum()) == nb * rows * d


@pytest.mark.parametrize("bins", [8, 128])
def test_histogram_outliers_and_edges_bit_exact(bins):
    """±inf, NaN (counted nowhere), huge values, the reference tests'
    N(0.5, 2) outliers, and values exactly on k/bins."""
    rng = np.random.default_rng(bins)
    x = np.concatenate([
        _hist_data(bins, (2, 32, 2), 0.0, 1.0).reshape(-1),
        rng.normal(0.5, 2.0, 128).astype(np.float32),
        (np.arange(bins + 1) / bins).astype(np.float32),
    ]).reshape(1, -1, 1)
    want = np.asarray(j_hist(jnp.asarray(x), bins=bins, lo=0.0, hi=1.0))
    got = partition_histogram(torch.from_numpy(x), bins=bins, lo=0.0, hi=1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == x.size - int(np.isnan(x).sum())


def test_histogram_off_zero_range_bit_exact():
    """With lo != 0 the edges lo + width*j round in f32; values on and
    beside every edge land where the JAX kernel puts them."""
    x = _hist_data(7, (2, 64, 3), -0.3, 0.4)
    want = np.asarray(j_hist(jnp.asarray(x), bins=8, lo=-0.3, hi=0.4))
    got = partition_histogram(torch.from_numpy(x), bins=8, lo=-0.3, hi=0.4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_histogram_edge_rounding_at_lo_0p1_hi_2p5():
    """At lo=0.1, hi=2.5, bins=8 the source's upper edge (lo + width*j) +
    width and XLA's reassociated width*j + f32(lo + width) differ; the port
    rounds as XLA does, so the three f32 values on those edges (1.3, 1.6,
    1.9) land in the JAX kernel's bins, and all edge-laced data agrees bit
    for bit."""
    lo, hi = 0.1, 2.5
    for value, jax_bins in {1.3: (3,), 1.6: (5,), 1.9: ()}.items():
        one = np.full((1, 1, 1), value, np.float32)
        want = np.asarray(j_hist(jnp.asarray(one), bins=8, lo=lo, hi=hi))
        got = partition_histogram(torch.from_numpy(one), bins=8, lo=lo, hi=hi).numpy()
        assert tuple(np.flatnonzero(want)) == jax_bins, value
        np.testing.assert_array_equal(got, want)
    x = _hist_data(7, (2, 64, 3), lo, hi)
    want = np.asarray(j_hist(jnp.asarray(x), bins=8, lo=lo, hi=hi))
    got = partition_histogram(torch.from_numpy(x), bins=8, lo=lo, hi=hi)
    np.testing.assert_array_equal(got.numpy(), want)


def _hist_grids(seed=13, count=30):
    """Seeded (lo, hi, bins) grids, plus (-1.2, 2.0, 16), where a subnormal
    value beside the zero edge once fell on the other side."""
    rng = np.random.default_rng(seed)
    grids = [(-1.2, 2.0, 16)]
    while len(grids) < count:
        lo = round(float(rng.uniform(-3.0, 3.0)), int(rng.integers(1, 4)))
        hi = round(lo + float(rng.uniform(0.05, 5.0)), int(rng.integers(1, 4)))
        if hi > lo:
            grids.append((lo, hi, int(rng.choice([2, 3, 5, 8, 16, 33, 64, 128]))))
    return grids


@pytest.mark.parametrize("lo,hi,bins", _hist_grids())
def test_histogram_seeded_grids_bit_exact_vs_jax(lo, hi, bins):
    """Edge-laced data on each grid: the port's plain version equals the JAX
    kernel bit for bit (subnormals compare as 0 in both)."""
    x = _hist_data(int(bins * 1000 + abs(lo) * 100), (1, 4 * bins + 96, 3), lo, hi, bins)
    want = np.asarray(j_hist(jnp.asarray(x), bins=bins, lo=lo, hi=hi))
    got = partition_histogram(torch.from_numpy(x), bins=bins, lo=lo, hi=hi)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_calls_do_not_count_launches():
    counts = (flash_attention.launches, ssd_scan.launches, partition_histogram.launches)
    x = torch.rand(1, 8, 2, 8)
    ops.flash_attention(x, x[:, :, :1], x[:, :, :1])
    ops.ssd_scan(*map(torch.from_numpy, _ssd_inputs(8, 1, 8, 2, 4, 4)), chunk=4)
    ops.partition_histogram(torch.rand(2, 4, 3), bins=4)
    assert (flash_attention.launches, ssd_scan.launches, partition_histogram.launches) == counts


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 32, "wgmma"), (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "split"), (torch.bfloat16, 72, "split"), (torch.float32, 8, "split"),
    (torch.float32, 128, "split"), (torch.float16, 64, None), (torch.float32, 12, None),
    (torch.float32, 136, None), (torch.bfloat16, 4, None),
])
def test_flash_routes_by_type_and_head_dim(dtype, d, route):
    """On the card bf16 at head dims 32/64/128 takes the wgmma route, f32 and
    the other bf16 head dims (multiples of 8 up to 128) the split route; any
    other case raises, with no quiet fall-back to the plain version."""
    from repro_torch.kernels.flash_attention import _route

    if route is None:
        with pytest.raises(ValueError, match="not taken on the card"):
            _route(dtype, d)
    else:
        assert _route(dtype, d) == route


def test_other_devices_raise():
    """No silent fallback off the CPU and the card: ``pallas_interpret``
    raises for ``meta`` and the partition kernels with it, while the LM
    kernels take ``meta`` as their shape-only route, launching nothing."""
    x = torch.empty((1, 8, 2, 8), device="meta")
    with pytest.raises(ValueError, match="meta"):
        pallas_interpret(x)
    with pytest.raises(ValueError, match="meta"):
        ops.partition_histogram(torch.empty((2, 4, 3), device="meta"))
    out = ops.flash_attention(x, x, x)
    assert out.device == x.device and out.shape == x.shape and out.dtype == x.dtype
    assert ops.flash_attention.launches == 0


# ---------------------------------------------------------------------------
# the CUDA kernels' number schemes, emulated on the CPU
# ---------------------------------------------------------------------------
#
# The card cannot run here, so these tests repeat in torch what the kernels do
# to the numbers: every f32 value is rounded to bf16 terms (term k = bf16 of
# what the terms before it leave) and multiplied as bf16 products summed in
# f32, as the tensor cores do.  The results are held to the JAX kernels.
#
# Schemes, by products per f32 product: 2 = an f32 factor in two terms times
# an exact bf16 input (the kernels' bf16 route); 3 = two terms each, hi.hi +
# hi.lo + lo.hi; 6 = three terms each, the term products of order <= 2
# (ssd_scan's f32 route).
_SCHEMES = {2: (2, 1, 1), 3: (2, 2, 1), 6: (3, 3, 2)}  # terms of f, terms of x, max order


def _terms(t, k):
    out = []
    for _ in range(k):
        out.append(t.to(torch.bfloat16).float())
        t = t - out[-1]
    return out


def _split_product(f, x, products):
    """f @ x as the scheme with that many products computes it."""
    tf, tx, order = _SCHEMES[products]
    fs, xs = _terms(f, tf), _terms(x, tx)
    return sum(fs[i] @ xs[j] for i in range(tf) for j in range(tx) if i + j <= order)


def _ssd_emulated(x, dt, a, bm, cm, *, products, q=64):
    """csrc/ssd_scan.cu's arithmetic: 64-row chunks, C.B^T per chunk, each
    product split by the scheme; the state in f32.  C.B^T of bf16 inputs
    (scheme 2) is exact."""
    b, l, nh, p = x.shape
    n = bm.shape[-1]
    y = torch.zeros_like(x)
    hout = torch.zeros((b, nh, p, n))
    for bi in range(b):
        for hd in range(nh):
            h = torch.zeros((p, n))
            for c0 in range(0, l, q):
                xs, cs, bs = x[bi, c0:c0 + q, hd], cm[bi, c0:c0 + q], bm[bi, c0:c0 + q]
                dts = dt[bi, c0:c0 + q, hd]
                seg = torch.cumsum(dts * a[hd], 0)
                cb = cs @ bs.T if products == 2 else _split_product(cs, bs.T, products)
                lower = torch.tril(torch.ones((len(seg), len(seg)), dtype=torch.bool))
                g = torch.where(lower, cb * torch.exp(seg[:, None] - seg[None, :]) * dts[None, :],
                                torch.zeros(()))
                inter = _split_product(h, cs.T, products).T * torch.exp(seg)[:, None]
                y[bi, c0:c0 + q, hd] = inter + _split_product(g, xs, products)
                tail = torch.exp(seg[-1] - seg) * dts
                h = h * torch.exp(seg[-1]) + _split_product((xs * tail[:, None]).T, bs,
                                                            products)
            hout[bi, hd] = h
    return y, hout


@pytest.mark.parametrize("products", [2, 3, 6])
def test_ssd_split_products_vs_jax(products):
    """Two products on bf16-valued inputs (the served route); three and six
    on f32 inputs that are not bf16 values: each within SSD_TOL of the JAX
    kernel at this size.  (At the mamba2 prefill's shapes three products
    left 2.3x SSD_TOL on the card, so the kernel's f32 route takes six.)"""
    arrays = _ssd_inputs(11, 2, 160, 2, 16, 32)
    if products == 2:
        arrays = tuple(np.asarray(torch.from_numpy(t).to(torch.bfloat16).float()) for t in arrays)
    jy, jh = j_ssd(*map(jnp.asarray, arrays), chunk=32)
    ty, th = _ssd_emulated(*map(torch.from_numpy, arrays), products=products)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SSD_TOL)


def _hist_guess_and_step(x, *, bins, lo, hi, start_shift=0):
    """csrc/partition_histogram.cu's binning, value by value in torch.

    Subnormals are flushed first; a NaN is counted nowhere.  With width > 0
    the guess is ``j = int(clamp((v - lo) * f32(1 / width), 0, bins - 1))``
    (clamped in float, so +-inf give an index), moved by ``start_shift`` to
    show that the result does not depend on the start.  Where
    ``max(e_j, upper_{j-1}) <= v < min(upper_j, e_{j+1})`` (+-inf past the
    ends), the pair the kernel keeps per bin, the value is in bin j alone;
    otherwise ``a``, the last j with ``e_j <= v``,
    and ``b``, the first j with ``v < upper_j``, are found by stepping along
    the edges from j.  With width <= 0 no interval holds.  Bins ``b..a``
    count, and the clamps into bins 0 and ``bins - 1`` unless the search
    already counted them."""
    lo_f, width_f, upper0, first_below, last_from = tpr_hist_thresholds(bins, lo, hi)
    f32 = torch.float32
    v = tpr_flush(torch.from_numpy(np.ascontiguousarray(x)).reshape(-1).to(f32))
    v = v[~torch.isnan(v)]
    jw = torch.tensor(width_f, dtype=f32) * torch.arange(bins, dtype=f32)
    lower = tpr_flush(jw + torch.tensor(lo_f, dtype=f32))
    upper = tpr_flush(jw + torch.tensor(upper0, dtype=f32))
    a = torch.full(v.shape, -1, dtype=torch.int64)
    b = torch.full(v.shape, bins, dtype=torch.int64)
    if width_f > 0:
        inv = torch.tensor(1.0, dtype=f32) / torch.tensor(width_f, dtype=f32)
        g = (v - torch.tensor(lo_f, dtype=f32)) * inv
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g).clamp(0, bins - 1)
        j = (g.to(torch.int64) + start_shift).clamp(0, bins - 1)
        inf = torch.tensor([np.inf], dtype=f32)
        next_lower, prev_upper = torch.cat([lower[1:], inf]), torch.cat([-inf, upper[:-1]])
        alone_lo, alone_hi = torch.maximum(lower, prev_upper), torch.minimum(upper, next_lower)
        alone = (alone_lo[j] <= v) & (v < alone_hi[j])
        up = lower[j] <= v
        a = torch.where(up, j, j - 1)
        while True:
            step_up = up & (a + 1 < bins) & (lower[(a + 1).clamp(max=bins - 1)] <= v)
            step_down = ~up & (a >= 0) & ~(lower[a.clamp(min=0)] <= v)
            if not (step_up.any() or step_down.any()):
                break
            a = a + step_up.long() - step_down.long()
        below = v < upper[j]
        b = torch.where(below, j, j + 1)
        while True:
            step_down = below & (b > 0) & (v < upper[(b - 1).clamp(min=0)])
            step_up = ~below & (b < bins) & ~(v < upper[b.clamp(max=bins - 1)])
            if not (step_up.any() or step_down.any()):
                break
            b = b - step_down.long() + step_up.long()
        assert bool((a[alone] == j[alone]).all() and (b[alone] == j[alone]).all())
        a, b = torch.where(alone, j, a), torch.where(alone, j, b)
    counts = torch.zeros(bins, dtype=torch.int64)
    span = (a - b + 1).clamp(min=0)
    for off in range(int(span.max()) if span.numel() else 0):
        hit = span > off
        counts.index_add_(0, b[hit] + off, torch.ones(int(hit.sum()), dtype=torch.int64))
    counts[0] += int(((v < first_below) & ~((b == 0) & (a >= 0))).sum())
    counts[-1] += int(((v >= last_from) & ~((b <= bins - 1) & (a == bins - 1))).sum())
    return counts.to(f32)


@pytest.mark.parametrize("lo,hi,bins", _hist_grids() + [(1.0, 1.0, 8), (2.0, -1.0, 16)])
def test_histogram_guess_and_step_vs_jax(lo, hi, bins):
    """The value-histogram kernel's guess-then-step binning, emulated, equals
    the JAX kernel bit for bit on the seeded grids' edge-laced data (NaN,
    +-inf, huge values, subnormals) and with width <= 0, from the kernel's
    guess and from guesses moved off it.  (With hi < lo the data is laced
    for the range [hi, lo].)"""
    x = _hist_data(int(bins * 1000 + abs(lo) * 100), (1, 4 * bins + 96, 3), min(lo, hi),
                   max(lo, hi), bins)
    want = np.asarray(j_hist(jnp.asarray(x), bins=bins, lo=lo, hi=hi))
    for shift in (0, -2, 3):
        got = _hist_guess_and_step(x, bins=bins, lo=lo, hi=hi, start_shift=shift)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bins,copies", [(128, 8), (4096, 8), (7264, 6), (19370, 1)])
def test_histogram_plan_fits_bins(bins, copies):
    """The value-histogram kernel keeps 8 bytes of edges per bin and one
    sub-histogram per warp, fewer where shared memory runs short: up to
    19,370 bins fit one CTA; one more raises."""
    got, shared = _histogram_plan(bins)
    assert (got, shared) == (copies, 4 * bins * (2 + copies)) and shared <= _SMEM_OPTIN
    if bins == 19370:
        with pytest.raises(ValueError, match="exceed"):
            _histogram_plan(bins + 1)


@pytest.mark.parametrize("lq,h,hkv,d,window", [
    (96, 4, 2, 32, 0), (160, 2, 1, 64, 0), (128, 4, 4, 16, 40),
])
def test_flash_split_p_vs_jax(lq, h, hkv, d, window):
    (jq, tq), (jk, tk), (jv, tv) = _flash_pair(np.random.default_rng(lq), 1, lq, lq, h, hkv, d,
                                               "bfloat16")
    want = j_flash(jq, jk, jv, causal=True, window=window, block_q=32, block_k=32)
    got = flash_attention_emulated(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["bfloat16"])


@pytest.mark.parametrize("data", ["normal", "wide"])
def test_split_terms_reconstruct_f32_bit_for_bit(data):
    """The split kernel's plain version: hi + mid + lo is the f32 input bit
    for bit, for normal draws and for magnitudes from about 1e-24 to 1e20
    (10**u, u uniform in [-20, 20]); zero past the head dim."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 50, 2, 40)).astype(np.float32)
    if data == "wide":
        x = x * np.float32(10.0) ** rng.uniform(-20, 20, x.shape).astype(np.float32)
    t = split_terms_ref(torch.from_numpy(x))
    assert t.shape == (3, 3, 50, 2, 64) and t.dtype == torch.bfloat16
    assert bool((t[..., 40:] == 0).all())
    total = (t[0].float() + t[1].float()) + t[2].float()
    np.testing.assert_array_equal(total[..., :40].numpy(), x)


def _split_route_vs_jax(b, lq, lk, h, hkv, d, *, causal=True, window=0, bq=16, bk=16, scale=1):
    rng = np.random.default_rng(lq + d + window)
    q, k, v = _normal(rng, b, lq, h, d), _normal(rng, b, lk, hkv, d), _normal(rng, b, lk, hkv, d)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a) for a in (scale * q, scale * k, v))
    want = j_flash(jq, jk, jv, causal=causal, window=window, block_q=bq, block_k=bk)
    got = flash_attention_emulated(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("b,lq,lk,h,hkv,d,bq", [
    (1, 32, 32, 2, 2, 8, 16),      # MHA
    (2, 64, 64, 4, 2, 16, 16),     # GQA 2:1
    (1, 128, 128, 8, 1, 32, 16),   # MQA
    (2, 48, 96, 4, 4, 64, 16),     # cross-length, non-causal
    (2, 64, 64, 4, 2, 16, 32),     # the reference's f32 dtype case
])
def test_flash_split_route_shapes_vs_jax(b, lq, lk, h, hkv, d, bq):
    """The split route's arithmetic, emulated, at the reference's f32
    TestFlashAttention shapes, within its f32 TOL of the JAX kernel."""
    _split_route_vs_jax(b, lq, lk, h, hkv, d, causal=lq == lk, bq=bq, bk=bq)


@pytest.mark.parametrize("window", [8, 24, 64])
def test_flash_split_route_windows_vs_jax(window):
    _split_route_vs_jax(1, 64, 64, 2, 2, 16, window=window)


@pytest.mark.parametrize("bq,bk", [(8, 8), (16, 32), (32, 16), (64, 64)])
def test_flash_split_route_block_shapes_vs_jax(bq, bk):
    _split_route_vs_jax(1, 64, 64, 2, 2, 16, bq=bq, bk=bk)


@pytest.mark.parametrize("scale", [1, 2])
def test_flash_split_route_qwen3_layer_vs_jax(scale):
    """A narrowed f32 qwen3-32b layer: head dim 128 (32-key tiles), GQA 8,
    128 tokens, causal; also with q and k at twice the scale, where three
    products (two terms) miss TOL and the six products hold it."""
    _split_route_vs_jax(1, 128, 128, 16, 2, 128, bq=64, bk=64, scale=scale)


def test_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    """A changed csrc/*.cuh header changes every library's build target."""
    from repro_torch.kernels import _build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._target("k")
    assert _build._target("k") == before
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._target("k") != before
