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
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
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


def _hist_data(seed, shape, lo, hi):
    """Uniform values over [lo - 10%, hi + 10%] laced with ±inf, NaN, huge
    values and values exactly on the edges lo + k (hi - lo) / bins."""
    rng = np.random.default_rng(seed)
    width = hi - lo
    x = rng.uniform(lo - 0.1 * width, hi + 0.1 * width, shape).astype(np.float32).reshape(-1)
    edges = (lo + np.arange(9) * (width / 8)).astype(np.float32)
    special = np.concatenate([
        [np.inf, -np.inf, np.nan, 1e10, -1e10, lo, hi,
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


# f32 value -> (bins the JAX kernel counts it in on the CPU, bins the port does)
EDGE_SIDES = {1.3: ((3,), ()), 1.6: ((5,), (4, 5)), 1.9: ((), (5,))}


def test_histogram_edge_rounding_at_lo_0p1_hi_2p5():
    """At lo=0.1, hi=2.5, bins=8 three values on the edges land on other
    sides.  The port computes each upper edge as the kernel's source writes
    it, (lo + width*j) + width, rounding twice in f32; XLA on the CPU
    reassociates it into width*j + f32(lo + width).  Every other value of
    the edge-laced data agrees bit for bit."""
    lo, hi = 0.1, 2.5
    for value, (jax_bins, port_bins) in EDGE_SIDES.items():
        one = np.full((1, 1, 1), value, np.float32)
        want = np.asarray(j_hist(jnp.asarray(one), bins=8, lo=lo, hi=hi))
        got = partition_histogram(torch.from_numpy(one), bins=8, lo=lo, hi=hi).numpy()
        assert tuple(np.flatnonzero(want)) == jax_bins, value
        assert tuple(np.flatnonzero(got)) == port_bins, value
    x = _hist_data(7, (2, 64, 3), lo, hi)
    x = x[~np.isin(x, np.float32(list(EDGE_SIDES)))].reshape(1, -1, 1)
    want = np.asarray(j_hist(jnp.asarray(x), bins=8, lo=lo, hi=hi))
    got = partition_histogram(torch.from_numpy(x), bins=8, lo=lo, hi=hi)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_calls_do_not_count_launches():
    counts = (flash_attention.launches, ssd_scan.launches, partition_histogram.launches)
    x = torch.rand(1, 8, 2, 8)
    ops.flash_attention(x, x[:, :, :1], x[:, :, :1])
    ops.ssd_scan(*map(torch.from_numpy, _ssd_inputs(8, 1, 8, 2, 4, 4)), chunk=4)
    ops.partition_histogram(torch.rand(2, 4, 3), bins=4)
    assert (flash_attention.launches, ssd_scan.launches, partition_histogram.launches) == counts


def test_other_devices_raise():
    x = torch.empty((1, 8, 2, 8), device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="meta"):
        ops.partition_histogram(torch.empty((2, 4, 3), device="meta"))
