"""The port's partition kernels on the CPU (their plain versions) vs JAX.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do.
Histogram counts must be bit-exact, outliers included; k-means counts exact
and sums within the reference's f32 tolerance (``tests/test_kernels.py``
``TOL``).  The CUDA kernels themselves only run on a card; there
``chip_smoke.py`` holds each against the plain version tested here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.apps.histogram import histogramdd_block as j_hist_block
from repro.core.apps.kmeans import partial_sum_block as j_partial_sum
from repro.kernels import partition_reduce as jpr
from repro_torch.core.apps.histogram import histogramdd_block as t_hist_block
from repro_torch.core.apps.kmeans import partial_sum_block as t_partial_sum
from repro_torch.kernels import partition_reduce as tpr

TOL = dict(rtol=2e-5, atol=2e-5)
RANGES = [(0.0, 1.0), (-0.3, 0.4)]


def _uniform(seed, shape, lo, hi):
    width = hi - lo
    return np.random.default_rng(seed).uniform(lo - 0.1 * width, hi + 0.1 * width, shape).astype(
        np.float32
    )


def _outliers(seed, shape, lo, hi):
    """Uniform data laced with ±1e10, ±inf, NaN, 8e10 and values in
    (lo - width, lo), where truncation and flooring disagree."""
    x = _uniform(seed, shape, lo, hi).reshape(-1)
    width = (hi - lo) / 4
    special = np.array(
        [1e10, -1e10, np.inf, -np.inf, np.nan, 8e10, lo - 0.5 * width, lo - 0.999 * width,
         np.nextafter(np.float32(lo), np.float32(-1)), hi, np.nextafter(np.float32(hi), np.float32(0))],
        np.float32,
    )
    idx = np.random.default_rng(seed + 1).choice(x.size, size=3 * special.size, replace=False)
    x[idx] = np.tile(special, 3)
    return x.reshape(shape)


@pytest.mark.parametrize("lo,hi", RANGES)
@pytest.mark.parametrize("nb,rows,d,bins", [
    (1, 16, 1, 8), (4, 32, 2, 4), (3, 8, 3, 4), (2, 64, 1, 128), (2, 40, 5, 3),
])
def test_histogramdd_bit_exact(nb, rows, d, bins, lo, hi):
    x = _uniform(nb * rows * d, (nb, rows, d), lo, hi)
    want = np.asarray(jpr.partition_histogramdd(jnp.asarray(x), bins=bins, lo=lo, hi=hi))
    got = tpr.partition_histogramdd(torch.from_numpy(x), bins=bins, lo=lo, hi=hi)
    assert got.dtype == torch.int32 and tuple(got.shape) == (bins,) * d
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == nb * rows


@pytest.mark.parametrize("lo,hi", RANGES)
@pytest.mark.parametrize("seed", [0, 1])
def test_histogramdd_outliers_bit_exact(seed, lo, hi):
    x = _outliers(seed, (3, 32, 2), lo, hi)
    want = np.asarray(jpr.partition_histogramdd(jnp.asarray(x), bins=4, lo=lo, hi=hi))
    got = tpr.partition_histogramdd(torch.from_numpy(x), bins=4, lo=lo, hi=hi)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lo,hi", RANGES)
def test_histogramdd_block_bit_exact(lo, hi):
    """The scan path's block fn, outliers included, against the reference's."""
    x = _outliers(5, (96, 3), lo, hi)
    want = np.asarray(j_hist_block(jnp.asarray(x), bins=4, lo=lo, hi=hi))
    got = t_hist_block(torch.from_numpy(x), bins=4, lo=lo, hi=hi)
    np.testing.assert_array_equal(got.numpy(), want)


def test_float_to_int_saturation_trap():
    """PyTorch's float→int32 cast gives INT_MIN for 8e10 and +inf where XLA
    saturates to INT_MAX; the port clamps first, so they land in the last bin."""
    assert torch.tensor([8e10, float("inf")]).to(torch.int32).tolist()[0] < 0
    x = torch.tensor([[8e10], [float("inf")], [float("nan")], [-float("inf")]])
    cells = tpr.digitize_cells(x, bins=4, lo=0.0, hi=1.0)
    assert cells.tolist() == [3, 3, 0, 0]


def test_histogramdd_block_count_invariance():
    x = _uniform(3, (64, 2), 0.0, 1.0)
    outs = [
        tpr.partition_histogramdd(torch.from_numpy(x).reshape(nb, -1, 2), bins=4)
        for nb in (1, 2, 4, 8)
    ]
    for h in outs[1:]:
        np.testing.assert_array_equal(h.numpy(), outs[0].numpy())


def test_histogramdd_casts_other_float_types():
    x = _uniform(4, (2, 16, 2), 0.0, 1.0)
    h32 = tpr.partition_histogramdd(torch.from_numpy(x), bins=4)
    h64 = tpr.partition_histogramdd(torch.from_numpy(x.astype(np.float64)), bins=4)
    np.testing.assert_array_equal(h64.numpy(), h32.numpy())


def _no_near_ties(x, centers, gap=1e-4):
    """In float64: every row's two best kernel distances differ by > gap,
    so an exact count comparison is not luck."""
    x64 = x.reshape(-1, x.shape[-1]).astype(np.float64)
    c64 = centers.astype(np.float64)
    d2 = np.sort((c64 * c64).sum(1)[None, :] - 2.0 * x64 @ c64.T, axis=1)
    return d2.shape[1] < 2 or float((d2[:, 1] - d2[:, 0]).min()) > gap


@pytest.mark.parametrize("nb,rows,d,k", [
    (1, 16, 4, 2), (4, 32, 8, 4), (6, 24, 3, 8), (2, 64, 20, 8),
])
def test_kmeans_matches_reference(nb, rows, d, k):
    rng = np.random.default_rng(10 * nb + d)
    x = rng.normal(size=(nb, rows, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    assert _no_near_ties(x, c)
    js, jc = jpr.partition_kmeans(jnp.asarray(x), jnp.asarray(c))
    ts, tc = tpr.partition_kmeans(torch.from_numpy(x), torch.from_numpy(c))
    assert ts.dtype == tc.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def test_kmeans_block_count_invariance():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(128, 4)).astype(np.float32)
    c = rng.normal(size=(4, 4)).astype(np.float32)
    assert _no_near_ties(x, c)
    outs = [
        tpr.partition_kmeans(torch.from_numpy(x).reshape(nb, -1, 4), torch.from_numpy(c))
        for nb in (1, 2, 4, 8)
    ]
    for s, n in outs[1:]:
        np.testing.assert_allclose(s.numpy(), outs[0][0].numpy(), **TOL)
        np.testing.assert_array_equal(n.numpy(), outs[0][1].numpy())


def test_partial_sum_block_matches_reference():
    """The scan path's block fn keeps |x|² in the distance, as the reference's."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(96, 5)).astype(np.float32)
    c = rng.normal(size=(6, 5)).astype(np.float32)
    assert _no_near_ties(x, c)
    js, jc = j_partial_sum(jnp.asarray(x), jnp.asarray(c))
    ts, tc = t_partial_sum(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def test_cpu_calls_do_not_count_launches():
    h0, k0 = tpr.partition_histogramdd.launches, tpr.partition_kmeans.launches
    x = torch.rand(2, 8, 3)
    tpr.partition_histogramdd(x, bins=2)
    tpr.partition_kmeans(x, torch.rand(2, 3))
    assert (tpr.partition_histogramdd.launches, tpr.partition_kmeans.launches) == (h0, k0)


def test_other_devices_raise():
    x = torch.empty((2, 8, 3), device="meta")
    with pytest.raises(ValueError, match="meta"):
        tpr.partition_histogramdd(x, bins=2)
    with pytest.raises(ValueError, match="meta"):
        tpr.partition_kmeans(x, torch.empty((2, 3), device="meta"))
