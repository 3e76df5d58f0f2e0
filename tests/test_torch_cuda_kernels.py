"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU built for ``sm_90a`` and ``nvcc``; on a
host without a card each one skips with that reason.  Run them on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: bf16 outputs within ``BF16_TOL`` (the reference tests' bf16
tolerance, ``tests/test_kernels.py`` ``TOL``), the SSD scan in f32 within
``SSD_TOL`` (``tests/test_kernels.py``), both histograms bit for bit;
k-means counts exactly (on data with no float64 near-tie row) and sums within
``KMEANS_TOL`` (f32 sums of the same rows in another order).  The partition
kernels also give the same bits on a second launch.
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
KMEANS_TOL = dict(rtol=1e-4, atol=1e-3)

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
    (8, 1500, 1500, 6, 6, 64, False, 0),   # whisper-tiny's encoder self-attention
    (8, 512, 1500, 6, 6, 64, False, 0),    # whisper-tiny's cross-attention prefill
    (8, 512, 1600, 32, 8, 128, False, 0),  # llama-3.2-vision's cross-attention prefill
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


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128), (torch.float32, 64),
                                     (torch.bfloat16, 48)])
def test_lm_kernel_costs_equal_on_the_card_and_on_meta(dev, dtype, d):
    """A launch reports the same formula to the dry-run's counter as the
    ``meta`` route does, and the counter counts the same around it."""
    from repro_torch.launch.dryrun_lib import count_cost

    gen = torch.Generator(device=dev).manual_seed(d)
    q, k, v = (_normal(gen, dev, 2, 96, 4, d, dtype=dtype) for _ in range(3))
    before = fa.flash_attention.launches
    _, card = count_cost(fa.flash_attention, q, k, v, causal=True, window=40)
    _, meta = count_cost(fa.flash_attention, *(t.to("meta") for t in (q, k, v)), causal=True,
                         window=40)
    assert fa.flash_attention.launches == before + 1
    assert (card.flops, card.bytes_accessed, card.kernels) == \
        (meta.flops, meta.bytes_accessed, meta.kernels)
    x = _normal(gen, dev, 2, 128, 4, 32, dtype=dtype)
    dt = (torch.rand((2, 128, 4), generator=gen, device=dev) * 0.5).to(dtype)
    a = -(torch.rand((4,), generator=gen, device=dev) + 0.5).to(dtype)
    bm, cm = (_normal(gen, dev, 2, 128, 16, dtype=dtype) for _ in range(2))
    _, card = count_cost(ss.ssd_scan, x, dt, a, bm, cm, chunk=64)
    _, meta = count_cost(ss.ssd_scan, *(t.to("meta") for t in (x, dt, a, bm, cm)), chunk=64)
    assert card.kernels == meta.kernels == {"ssd_scan": dict(zip(
        ("calls", "flops", "bytes"), (1, *ss.ssd_cost(x, bm)[1:])))}
    assert (card.flops, card.bytes_accessed) == (meta.flops, meta.bytes_accessed)


@pytest.mark.parametrize("b,l,nh,p,n", [
    (2, 256, 4, 64, 128),   # the mamba2 widths, 4 chunks
    (1, 100, 3, 64, 128),   # ragged last chunk, odd head count
    (2, 64, 2, 16, 32),     # narrow head and state
    (1, 130, 2, 20, 36),    # widths that take the element-by-element loads
    (8, 512, 64, 64, 128),  # one mamba2-1.3b prefill layer
    (8, 512, 128, 64, 16),  # one jamba-v0.1-52b prefill layer: state 16, 128 heads
    (1, 100, 3, 64, 16),    # state 16 with a ragged last chunk
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


@pytest.mark.parametrize("b,l,nh,p,n", [(2, 256, 4, 64, 128), (1, 100, 3, 64, 128),
                                       (8, 512, 128, 64, 16), (1, 100, 3, 64, 16)])
def test_ssd_bf16_matches_f32_plain(dev, b, l, nh, p, n):
    gen = torch.Generator(device=dev).manual_seed(l + 7)
    inputs = _ssd_inputs(gen, dev, b, l, nh, p, n, torch.bfloat16)
    y, h = ss.ssd_scan(*inputs, chunk=l)
    ry, rh = ss.ssd_chunked(*(t.float() for t in inputs), chunk=l)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), ry, **BF16_TOL)
    torch.testing.assert_close(h, rh, **SSD_TOL)


def _laced(rng, lo, hi, bins, size):
    """``size`` values: every lower and upper edge (as both f32 formulas
    round it), the values one ulp beside them, +-0, +-inf, NaN and
    subnormals, then uniform values over [lo - 1, hi + 1), shuffled (cut to
    ``size`` before the shuffle where the laced values alone are more)."""
    w = np.float32((hi - lo) / bins)
    k = np.arange(bins + 1, dtype=np.float32)
    edges = np.concatenate([np.float32(lo) + w * k, w * k + (np.float32(lo) + w)])
    laced = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                            np.nextafter(edges, np.float32(-np.inf)),
                            np.float32([1e-45, -1e-45, 1e-39, 0.0, -0.0, np.inf, -np.inf,
                                        np.nan])])
    x = np.concatenate([laced, rng.uniform(lo - 1, hi + 1, max(0, size - laced.size))
                        .astype(np.float32)])[:size]
    return x[rng.permutation(size)]


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


def _check_histogram(t, **kw):
    got = pr.partition_histogram(t, **kw)
    again = pr.partition_histogram(t, **kw)
    want = pr.partition_histogram_ref(t, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("bins", [1024, 4096])
def test_histogram_many_bins_bit_exact(dev, bins):
    """Edge arrays of 4 and 16 KB in shared memory, sub-histograms per warp."""
    x = _laced(np.random.default_rng(bins), -1.2, 2.0, bins, 200_000)
    assert np.isnan(x).any() and np.isinf(x).any()
    _check_histogram(torch.from_numpy(x).reshape(1, -1, 1).to(dev), bins=bins, lo=-1.2, hi=2.0)


def test_histogram_most_bins_bit_exact(dev):
    """19,370 bins, the most one CTA's shared memory holds (8 bytes of edges
    and one 4-byte sub-histogram per bin)."""
    bins = 19_370
    x = _laced(np.random.default_rng(bins), -1.2, 2.0, bins, 3 * 2 * (bins + 1) + 30_011)
    assert pr._histogram_plan(bins)[0] == 1
    _check_histogram(torch.from_numpy(x).reshape(1, -1, 1).to(dev), bins=bins, lo=-1.2, hi=2.0)


@pytest.mark.parametrize("n,offset", [
    (4099, 0),         # n % 4 = 3: a tail after the last 16-byte boundary
    (4099, 1),         # a view one element into its storage: a head of 3
    (1, 2),            # a head only
    (6, 3),            # a head of 1 and a tail of 1
    (1_000_003, 1),    # many CTAs, both ends ragged
])
def test_histogram_any_length_and_offset(dev, n, offset):
    rng = np.random.default_rng(n + offset)
    x = _laced(rng, 0.1, 2.5, 8, n)
    buf = torch.from_numpy(np.concatenate([np.zeros(offset, np.float32), x])).to(dev)
    t = buf[offset:]
    assert t.data_ptr() % 16 == 4 * offset % 16 and t.numel() == n
    _check_histogram(t, bins=8, lo=0.1, hi=2.5)


def _blobs(seed, n, d, k, sigma=0.05):
    """Rows around k well-separated centers, and centers near them."""
    rng = np.random.default_rng(seed)
    means = 3.0 * rng.normal(size=(k, d))
    x = means[rng.integers(0, k, n)] + sigma * rng.normal(size=(n, d))
    c = means + sigma * rng.normal(size=(k, d))
    return x.astype(np.float32), c.astype(np.float32)


def _no_near_ties(x, centers, gap=1e-4):
    """In float64: every row's two best kernel distances differ by > gap,
    so an exact count comparison is not luck."""
    x64 = x.reshape(-1, x.shape[-1]).astype(np.float64)
    c64 = centers.astype(np.float64)
    d2 = np.sort((c64 * c64).sum(1)[None, :] - 2.0 * x64 @ c64.T, axis=1)
    return d2.shape[1] < 2 or float((d2[:, 1] - d2[:, 0]).min()) > gap


def _check_kmeans(x, c):
    sums, counts = pr.partition_kmeans(x, c)
    sums2, counts2 = pr.partition_kmeans(x, c)
    want_sums, want_counts = pr.partition_kmeans_ref(x, c)
    torch.cuda.synchronize()
    assert torch.equal(counts, want_counts)
    torch.testing.assert_close(sums, want_sums, **KMEANS_TOL)
    assert torch.equal(sums, sums2) and torch.equal(counts, counts2)


@pytest.mark.parametrize("d", [3, 20, 33, 64])
@pytest.mark.parametrize("k", [2, 8, 32])
@pytest.mark.parametrize("nb,rows", [(3, 1000), (1, 100)])  # a ragged last tile; under one tile
def test_kmeans_matches_plain(dev, nb, rows, d, k):
    x, c = _blobs(d * 100 + k, nb * rows, d, k)
    assert _no_near_ties(x, c)
    _check_kmeans(torch.from_numpy(x).reshape(nb, rows, d).to(dev), torch.from_numpy(c).to(dev))


def test_kmeans_main_path_shape(dev):
    x, c = _blobs(20, 4 * 65536, 20, 8)
    assert _no_near_ties(x, c)
    _check_kmeans(torch.from_numpy(x).reshape(4, 65536, 20).to(dev), torch.from_numpy(c).to(dev))


@pytest.mark.parametrize("d", [4, 20])
def test_kmeans_rows_at_any_offset(dev, d):
    """A view one element into its storage: tiles start off 16-byte
    boundaries, so rows are read element by element."""
    x, c = _blobs(d, 3000, d, 8)
    assert _no_near_ties(x, c)
    buf = torch.from_numpy(np.concatenate([np.zeros(1, np.float32), x.reshape(-1)])).to(dev)
    t = buf[1:].view(3, 1000, d)
    assert t.data_ptr() % 16 == 4
    _check_kmeans(t, torch.from_numpy(c).to(dev))


def test_kmeans_counts_launches(dev):
    x = torch.zeros((1, 64, 4), device=dev)
    before = pr.partition_kmeans.launches
    pr.partition_kmeans(x, x[0, :2])
    assert pr.partition_kmeans.launches == before + 1



def _edge_laced_rows(seed, n, d, lo, hi, bins):
    """``(n, d)`` f32 values: each nominal bin edge lo + j (hi - lo) / bins
    in f32 and the two f32 values on either side (the edges as XLA rounds
    them lie among these), NaN, ±inf, ±1e10, ±0 and subnormals, the rest
    uniform over [lo - 10%, hi + 10%] of the range, shuffled."""
    rng = np.random.default_rng(seed)
    a, b = min(lo, hi), max(lo, hi) if hi != lo else lo + 1.0
    nominal = np.float32(lo + np.arange(bins + 1) * ((hi - lo) / bins))
    near = [nominal]
    for direction in (np.inf, -np.inf):
        v = nominal
        for _ in range(2):
            v = np.nextafter(v, np.float32(direction))
            near.append(v)
    special = np.concatenate(near + [np.float32([np.nan, np.inf, -np.inf, 1e10, -1e10, 0.0,
                                                 -0.0, 1e-45, -1e-45, 1e-39])])
    x = rng.uniform(a - 0.1 * (b - a), b + 0.1 * (b - a), n * d).astype(np.float32)
    m = min(special.size, x.size)
    x[:m] = special[:m]
    return x[rng.permutation(x.size)].reshape(n, d)


def _check_histdd(blocks, **kw):
    """The kernel on the block list and on the stacked blocks, twice each,
    against the plain version, bit for bit."""
    want = pr.partition_histogramdd_ref(blocks, **kw)
    for operand in (blocks, torch.stack(blocks)):
        got = pr.partition_histogramdd(operand, **kw)
        again = pr.partition_histogramdd(operand, **kw)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == want.shape
        assert torch.equal(got, want) and torch.equal(again, want)
    assert int(want.sum()) == sum(b.shape[0] for b in blocks)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.1, 2.5), (-1.2, 2.0), (1.0, 0.0)])
@pytest.mark.parametrize("bins,d", [
    (2, 1), (16, 1), (5, 3), (3, 5), (4, 6),  # one CTA holds the histogram
    (8, 5),                                   # the main path's 8**5 cells: clusters of 2
    (6, 6), (7, 6),                           # clusters of 4 and 8
    (16, 5),                                  # 2**20 cells: counts in global memory
])
def test_histdd_bit_exact_with_plain(dev, lo, hi, bins, d):
    """Three blocks of 1000 rows (ragged row tiles) laced with the bin
    edges and their neighbours, NaN, ±inf, ±1e10 and subnormals; hi <= lo
    included."""
    x = _edge_laced_rows(bins * 10 + d, 3000, d, lo, hi, bins)
    blocks = list(torch.from_numpy(x).to(dev).split(1000))
    _check_histdd(blocks, bins=bins, lo=lo, hi=hi)


@pytest.mark.parametrize("rows", [1, 37, 511, 513, 1025])
def test_histdd_rows_that_do_not_fill_a_tile(dev, rows):
    x = _edge_laced_rows(rows, 2 * rows, 5, 0.1, 2.5, 8)
    _check_histdd(list(torch.from_numpy(x).to(dev).split(rows)), bins=8, lo=0.1, hi=2.5)


@pytest.mark.parametrize("bins", [8, 16])
def test_histdd_blocks_at_a_4_byte_offset(dev, bins):
    """Blocks that are views one float into their storage: every tile starts
    off a 16-byte boundary."""
    x = _edge_laced_rows(bins, 3 * 777, 5, -1.2, 2.0, bins).reshape(-1)
    buf = torch.from_numpy(np.concatenate([np.zeros(1, np.float32), x])).to(dev)
    blocks = list(buf[1:].view(3 * 777, 5).split(777))
    assert all(b.data_ptr() % 16 != 0 for b in blocks)
    _check_histdd(blocks, bins=bins, lo=-1.2, hi=2.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_histdd_other_float_types(dev, dtype):
    """f64 and bf16 blocks are cast to f32, as the reference casts them."""
    x = _edge_laced_rows(3, 2000, 4, 0.1, 2.5, 8)
    blocks = list(torch.from_numpy(x).to(dev, dtype).split(500))
    _check_histdd(blocks, bins=8, lo=0.1, hi=2.5)


@pytest.mark.parametrize("nblocks", [1, 16, 200])
def test_histdd_block_counts(dev, nblocks):
    """Up to 256 block pointers ride in the launch's parameters; 200 blocks
    there, and 300 through a device table."""
    x = _edge_laced_rows(nblocks, nblocks * 300, 3, -1.2, 2.0, 5)
    blocks = list(torch.from_numpy(x).to(dev).split(300))
    _check_histdd(blocks, bins=5, lo=-1.2, hi=2.0)
    if nblocks == 200:
        many = list(torch.from_numpy(_edge_laced_rows(7, 300 * 64, 3, -1.2, 2.0, 5)).to(dev)
                    .split(64))
        assert len(many) == 300
        _check_histdd(many, bins=5, lo=-1.2, hi=2.0)


@pytest.mark.parametrize("bins", [8, 16])
def test_histdd_main_path_shape(dev, bins):
    """16 blocks of 262,144 rows of 5 values, views 8 blocks apart in one
    tensor, as a partition of the main path's data lies."""
    gen = torch.Generator(device=dev).manual_seed(bins)
    big = torch.rand((8 * 16 * 65_536, 5), generator=gen, device=dev)
    blocks = [big[8 * b * 65_536:(8 * b + 1) * 65_536] for b in range(16)]
    big[0, :] = float("nan")
    big[8 * 65_536, :] = float("inf")
    _check_histdd(blocks, bins=bins)


def test_histdd_counts_launches(dev):
    x = torch.zeros((2, 64, 3), device=dev)
    before = pr.partition_histogramdd.launches
    pr.partition_histogramdd(x, bins=4)
    pr.partition_histogramdd(list(x), bins=4)
    assert pr.partition_histogramdd.launches == before + 2


# ---------------------------------------------------------------------------
# flash attention's split route (f32, and bf16 at the other head dims, on
# bf16 terms): the reference's TestFlashAttention cases (tests/test_kernels.py)
# on the card
# ---------------------------------------------------------------------------

F32_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py TOL[float32]


def _np_normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _flash_case(dev, seed, b, lq, lk, h, hkv, d, dtype=torch.float32):
    return tuple(torch.from_numpy(_np_normal(seed + i, *shape)).to(dev, dtype)
                 for i, shape in enumerate(((b, lq, h, d), (b, lk, hkv, d), (b, lk, hkv, d))))


def _check_flash(q, k, v, tol, route, **kw):
    before = (fa.flash_attention.launches, fa.flash_attention.split_launches,
              fa.split_kv.launches)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype
    split = int(route == "split")
    split_kv = int(route == "split" and q.dtype == torch.float32)  # bf16 K/V are read as they are
    assert (fa.flash_attention.launches - before[0], fa.flash_attention.split_launches - before[1],
            fa.split_kv.launches - before[2]) == (1, split, split_kv)
    if tol is not None:  # None: the caller compares
        ref_kw = {key: val for key, val in kw.items() if key in ("causal", "window")}
        torch.testing.assert_close(got.float(), fa.flash_attention_ref(q, k, v, **ref_kw).float(),
                                   **tol)
    return got


@pytest.mark.parametrize("b,lq,lk,h,hkv,d", [
    (1, 32, 32, 2, 2, 8),      # MHA
    (2, 64, 64, 4, 2, 16),     # GQA 2:1
    (1, 128, 128, 8, 1, 32),   # MQA
    (2, 48, 96, 4, 4, 64),     # cross length, not causal
])
def test_flash_split_reference_shapes_f32(dev, b, lq, lk, h, hkv, d):
    q, k, v = _flash_case(dev, lq + d, b, lq, lk, h, hkv, d)
    _check_flash(q, k, v, F32_TOL, "split", causal=lq == lk, block_q=16, block_k=16)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
def test_flash_split_reference_dtypes(dev, dtype, tol):
    q, k, v = _flash_case(dev, 5, 2, 64, 64, 4, 2, 16, dtype)
    _check_flash(q, k, v, tol, "split", block_q=32, block_k=32)


@pytest.mark.parametrize("window", [8, 24, 64])
def test_flash_split_reference_windows(dev, window):
    q, k, v = _flash_case(dev, window, 1, 64, 64, 2, 2, 16)
    _check_flash(q, k, v, F32_TOL, "split", window=window, block_q=16, block_k=16)


@pytest.mark.parametrize("bq,bk", [(8, 8), (16, 32), (32, 16), (64, 64)])
def test_flash_split_block_shape_invariance(dev, bq, bk):
    q, k, v = _flash_case(dev, 9, 1, 64, 64, 2, 2, 16)
    got = _check_flash(q, k, v, F32_TOL, "split", block_q=bq, block_k=bk)
    assert torch.equal(got, fa.flash_attention(q, k, v))


@pytest.mark.parametrize("b,lq,lk,h,hkv,d,causal,window", [
    (1, 100, 100, 4, 2, 24, True, 0),     # ragged tiles, D = 24
    (1, 77, 130, 6, 3, 40, False, 0),     # cross length, odd group, D = 40
    (2, 300, 300, 4, 2, 96, True, 100),   # window edge tiles, D = 96
    (1, 200, 200, 8, 2, 128, True, 0),    # D = 128
    (8, 512, 512, 64, 8, 128, True, 0),   # one f32 qwen3-32b prefill layer
    (8, 1500, 1500, 6, 6, 64, False, 0),   # whisper-tiny's encoder, f32
    (8, 512, 1500, 6, 6, 64, False, 0),    # whisper-tiny's cross-attention prefill, f32
    (8, 512, 1600, 32, 8, 128, False, 0),  # llama-3.2-vision's cross-attention prefill, f32
])
def test_flash_split_f32_other_shapes(dev, b, lq, lk, h, hkv, d, causal, window):
    q, k, v = _flash_case(dev, lq + h, b, lq, lk, h, hkv, d)
    _check_flash(q, k, v, F32_TOL, "split", causal=causal, window=window)


@pytest.mark.parametrize("scale", [2, 3])
@pytest.mark.parametrize("b,lq,h,hkv,d", [
    (1, 200, 8, 2, 128),   # D = 128: 32-key tiles
    (2, 160, 4, 4, 40),    # D = 40, padded to 64
    (8, 512, 64, 8, 128),  # one f32 qwen3-32b prefill layer
])
def test_flash_split_larger_scores(dev, b, lq, h, hkv, d, scale):
    """q and k drawn at scale 2 and 3 (scores 4x and 9x as large, softmax
    far from uniform), within the reference's f32 tolerance: at 2 of the
    plain version, at 3 of the plain version computed in f64 (there the f32
    plain version's own rounding of the scores puts it further from f64
    than the kernel)."""
    q, k, v = _flash_case(dev, lq + d, b, lq, lq, h, hkv, d)
    q, k = scale * q, scale * k
    got = _check_flash(q, k, v, F32_TOL if scale == 2 else None, "split", causal=True)
    if scale == 3:
        want = fa.flash_attention_ref(q.double(), k.double(), v.double(), causal=True)
        torch.testing.assert_close(got.double(), want, **F32_TOL)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128), (torch.float32, 24),
                                     (torch.float32, 72), (torch.float32, 16)])
@pytest.mark.parametrize("data", ["normal", "wide"])
def test_split_kv_terms_sum_back_bit_for_bit(dev, dtype, d, data):
    """The split kernel's three terms of f32 K and V sum back to them bit for
    bit, are zero past the head dim and equal the plain version's; "wide"
    scales each value by 10**u, u uniform in [-20, 20].  (bf16 K and V are
    not split: the route reads them as they are.)"""
    rng = np.random.default_rng(d)
    k, v = (rng.normal(size=(2, 77, 3, d)).astype(np.float32) for _ in range(2))
    if data == "wide":
        k, v = (x * np.float32(10.0) ** rng.uniform(-20, 20, x.shape).astype(np.float32)
                for x in (k, v))
    k, v = (torch.from_numpy(x).to(dev, dtype) for x in (k, v))
    dp = fa._padded_head_dim(d)
    before = fa.split_kv.launches
    kt, vt = fa.split_kv(k, v)
    torch.cuda.synchronize()
    assert fa.split_kv.launches == before + 1
    for x, t in ((k, kt), (v, vt)):
        assert t.shape == (3, *x.shape[:-1], dp)
        assert t.dtype == torch.bfloat16 and bool((t[..., d:] == 0).all())
        total = t[0].float()
        for term in t[1:]:
            total = total + term.float()
        assert torch.equal(total[..., :d], x.float())
        assert torch.equal(t, fa.split_terms_ref(x))


@pytest.mark.parametrize("d", [8, 16, 48, 72, 120])
def test_flash_split_bf16_other_head_dims(dev, d):
    q, k, v = _flash_case(dev, d, 2, 96, 96, 4, 2, d, torch.bfloat16)
    _check_flash(q, k, v, BF16_TOL, "split", causal=True)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_wgmma_route_head_dims(dev, d):
    q, k, v = _flash_case(dev, d, 2, 192, 192, 8, 2, d, torch.bfloat16)
    _check_flash(q, k, v, BF16_TOL, "wgmma", causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_split_fully_masked_rows_are_zero(dev, dtype):
    q, k, v = _flash_case(dev, 3, 1, 64, 16, 4, 1, 16, dtype)
    got = _check_flash(q, k, v, F32_TOL if dtype == torch.float32 else BF16_TOL, "split",
                       causal=True, window=4)
    assert bool((got[:, 19:] == 0).all())


def test_flash_rejects_what_no_route_takes(dev):
    x = torch.zeros((1, 16, 2, 12), device=dev)
    with pytest.raises(ValueError, match="not taken on the card"):
        fa.flash_attention(x, x, x)
    x = torch.zeros((1, 16, 2, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="not taken on the card"):
        fa.flash_attention(x, x, x)


# ---------------------------------------------------------------------------
# top-k tie order (kNN, cascade SVM) and the ThreadedExecutor on the card
# ---------------------------------------------------------------------------


def test_top_k_tie_order_on_the_card(dev):
    """``top_k`` keeps the lower index first among equal values on the card
    as on the CPU: values with many exact ties, rows long enough for the
    card's segmented sort."""
    from repro_torch._topk import top_k

    x = torch.from_numpy(np.random.default_rng(0).integers(0, 6, (64, 70_000)).astype(np.float32))
    cv, ci = top_k(x, 40)
    gv, gi = top_k(x.to(dev), 40)
    assert torch.equal(gv.cpu(), cv) and torch.equal(gi.cpu(), ci)
    # lower index first among equals
    assert bool(((cv[:, 1:] < cv[:, :-1]) | (ci[:, 1:] > ci[:, :-1])).all())


@pytest.mark.parametrize("policy", ["Baseline", "SplIter"])
def test_knn_ties_on_the_card_equal_the_cpu(dev, policy):
    """Fit rows repeated three times, on a 1/16 grid so that every distance
    is exact on both devices: the card keeps the CPU's copies, in its order
    (the CPU's equals ``lax.top_k``'s, tests/test_torch_apps.py)."""
    from repro_torch import api
    from repro_torch.core.apps import knn
    from repro_torch.core.blocked import BlockedArray, round_robin_placement

    rng = np.random.default_rng(11)
    fit = np.concatenate([(rng.integers(0, 16, (100, 3)) / 16).astype(np.float32)] * 3)
    q = (rng.integers(0, 16, (64, 3)) / 16).astype(np.float32)
    out = []
    for device in ("cpu", dev):
        blocked = lambda a, r: BlockedArray.from_array(  # noqa: E731
            a, r, num_locations=4, policy=round_robin_placement, device=device)
        r = knn(blocked(fit, 25), blocked(q, 16), k=5, policy=getattr(api, policy)())
        out.append((r.indices.cpu(), r.distances.cpu()))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert bool((out[0][1][:, 1:] == out[0][1][:, :-1]).any())  # the case has ties


def test_svm_ties_on_the_card_equal_the_cpu(dev):
    """With ``c`` tiny every coefficient clips to exactly ``c``: the support
    vectors are the first ``num_sv`` points on the card as on the CPU."""
    from repro_torch.core.apps.cascade_svm import svc_train

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(64, 4)).astype(np.float32))
    y = torch.from_numpy(np.sign(rng.normal(size=(64,))).astype(np.float32))
    cpu = svc_train(x, y, c=1e-3, steps=50, num_sv=16)
    card = svc_train(x.to(dev), y.to(dev), c=1e-3, steps=50, num_sv=16)
    assert bool((cpu[2] == 1e-3).all()) and torch.equal(cpu[0], x[:16])
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())


def test_threaded_executor_launches_kernels_from_workers(dev):
    """Histogram and pipelined k-means on a ThreadedExecutor, the kernels
    launched from its worker threads: the bits and the launch counts of a
    LocalExecutor."""
    from repro_torch.api import LocalExecutor, SplIter, ThreadedExecutor
    from repro_torch.core.apps import histogram, kmeans
    from repro_torch.core.blocked import BlockedArray, round_robin_placement

    gen = torch.Generator(device=dev).manual_seed(0)
    xh = BlockedArray.from_array(torch.rand((64 * 4096, 5), generator=gen, device=dev), 4096,
                                 num_locations=8, policy=round_robin_placement, device=dev)
    xk = BlockedArray.from_array(torch.rand((64 * 4096, 6), generator=gen, device=dev), 4096,
                                 num_locations=8, policy=round_robin_placement, device=dev)
    pol = SplIter(fusion="pallas")
    results = {}
    for name, ex in (("local", LocalExecutor()), ("threaded", ThreadedExecutor())):
        with ex:
            h0, k0 = pr.partition_histogramdd.launches, pr.partition_kmeans.launches
            h, _ = histogram(xh, bins=4, policy=pol, executor=ex)
            km = kmeans(xk, k=4, iters=5, seed=1, policy=pol, executor=ex, pipeline=True)
            torch.cuda.synchronize()
            results[name] = (h, km.centers, pr.partition_histogramdd.launches - h0,
                             pr.partition_kmeans.launches - k0,
                             [r.overlapped_launches for r in km.reports])
            workers = [w._thread for w in getattr(ex, "_workers", {}).values()]
        assert not any(t.is_alive() for t in workers)
    local, threaded = results["local"], results["threaded"]
    assert torch.equal(local[0], threaded[0]) and torch.equal(local[1], threaded[1])
    assert local[2:4] == threaded[2:4] == (8, 40)
    assert local[4] == [0] * 5 and threaded[4][0] == 0 and all(n > 0 for n in threaded[4][1:])
