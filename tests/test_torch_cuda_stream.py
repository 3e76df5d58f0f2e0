"""The out-of-core tier on the card: DiskStore residency and StreamExecutor.

Every test here needs an NVIDIA GPU; on a host without one each skips with
that reason.  Run them on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_stream.py

* Resident chunks are tensors on the card, and reloads (disk → pinned
  host buffer → card on the store's side stream) give every bit back.
* The stream-order guard: a ``map_partitions`` task that queues a
  ``torch.cuda._sleep`` before it reads its blocks, under a budget of one
  partition, so that eviction frees a partition's blocks while the
  compute stream has not read them yet.  The StreamExecutor's result
  equals the LocalExecutor's bit for bit.  Without the store's
  ``record_stream`` the side stream's next reload reuses the blocks and the
  result differs.
* The streamed ``partition_histogramdd`` and ``partition_kmeans`` launches
  against their plain versions: histogram counts exact; k-means counts
  exact (rows drawn far from ties) and centers within ``KMEANS_TOL`` of the
  plain fold, and bit for bit those of the kernels over the in-memory data.
"""

import pytest
import torch

from repro_torch.kernels import partition_reduce as pr

#: the card tests' k-means tolerance (tests/test_torch_cuda_kernels.py):
#: f32 sums of the same rows in another order
KMEANS_TOL = dict(rtol=1e-4, atol=1e-3)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a) and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64])
def test_resident_chunks_on_the_card_and_bit_exact_reloads(dev, dtype):
    from repro_torch.api import DiskStore

    gen = torch.Generator(device=dev).manual_seed(1)
    bits = torch.randint(0, 256, (8, 4096, 8 * dtype.itemsize), generator=gen, device=dev,
                         dtype=torch.uint8)
    blocks = list(bits.view(dtype).unbind(0))  # views of one tensor
    nb = blocks[0].nbytes
    with DiskStore(residency_bytes=2 * nb, device=dev) as store:
        refs = [store.put(b) for b in blocks[:4]] + [store.put(b.cpu()) for b in blocks[4:]]
        assert store.stats.resident_bytes <= 2 * nb and store.stats.spills == 6
        for ref, b in zip(refs, blocks):
            got = ref.resolve()
            assert got.is_cuda and got.device == dev and ref.device == dev
            assert got.dtype == dtype
            assert got.untyped_storage().nbytes() == nb  # no parent kept alive
            assert torch.equal(got.view(torch.uint8), b.view(torch.uint8))
        store.trim()
        store.prefetch(refs[:2])
        assert torch.equal(refs[0].resolve().view(torch.uint8), blocks[0].view(torch.uint8))
        assert store.stats.prefetch_hits == 1 and store.stats.loads >= 8


def _sleepy_sum(view):
    """Queue ~20 ms of sleep on the current stream, then read the blocks."""
    torch.cuda._sleep(40_000_000)
    return torch.cat(view.blocks_of(0)).sum(0)


def test_stream_order_guard(dev):
    from repro_torch.api import Collection, DiskStore, LocalExecutor, SplIter, StreamExecutor
    from repro_torch.core.blocked import BlockedArray, round_robin_placement

    locs, per_loc, rows, d = 8, 2, 65536, 16
    gen = torch.Generator(device=dev).manual_seed(2)
    x = BlockedArray.from_array(torch.rand((locs * per_loc * rows, d), generator=gen, device=dev),
                                rows, num_locations=locs, policy=round_robin_placement,
                                device=dev)
    partition = per_loc * rows * d * 4
    want = (Collection.from_blocked(x).split(SplIter()).map_partitions(_sleepy_sum)
            .compute(executor=LocalExecutor()).value)
    store = DiskStore(residency_bytes=partition, device=dev)
    xd = x.to_store(store)
    store.trim()  # every chunk reloads on the store's side stream
    with StreamExecutor() as ex:
        got = (Collection.from_blocked(xd).split(SplIter()).map_partitions(_sleepy_sum)
               .compute(executor=ex))
    assert got.report.prefetch_hits > 0 and got.report.bytes_loaded == x.nbytes
    assert len(got.value) == locs
    for a, b in zip(got.value, want):
        assert torch.equal(a, b)


def test_streamed_partition_kernels_match_plain(dev):
    from repro_torch.api import DiskStore, LocalExecutor, SplIter, StreamExecutor
    from repro_torch.core.apps import histogram, kmeans
    from repro_torch.api import Collection
    from repro_torch.core.apps.kmeans import _combine, _init_centers, partial_sum_block
    from repro_torch.core.blocked import BlockedArray, round_robin_placement

    # a quarter of the data holds two partitions: the current and the prefetched
    locs, per_loc, rows = 8, 4, 32768
    gen = torch.Generator(device=dev).manual_seed(3)
    xh = BlockedArray.from_array(torch.rand((locs * per_loc * rows, 5), generator=gen, device=dev),
                                 rows, num_locations=locs, policy=round_robin_placement,
                                 device=dev)
    # tight blobs near the seed's initial centers, as chip_smoke.py draws
    # them: every row is far from a tie, so counts compare exactly
    n = locs * per_loc * rows
    means = _init_centers(0, 8, 20, torch.float32, dev) + 0.05 * torch.randn(
        (8, 20), generator=gen, device=dev)
    labels = torch.randint(0, 8, (n,), generator=gen, device=dev)
    pts = means[labels] + 0.02 * torch.randn((n, 20), generator=gen, device=dev)
    xk = BlockedArray.from_array(pts, rows, num_locations=locs, policy=round_robin_placement,
                                 device=dev)
    pallas, plain = SplIter(fusion="pallas"), SplIter(fusion="scan")

    h_plain, _ = histogram(xh, bins=8, policy=plain, executor=LocalExecutor())
    km_plain = kmeans(xk, k=8, iters=3, seed=0, policy=plain, executor=LocalExecutor())
    km_mem = kmeans(xk, k=8, iters=3, seed=0, policy=pallas, executor=LocalExecutor())
    for x in (xh, xk):
        store = DiskStore(residency_bytes=x.nbytes // 4, device=dev)
        xd = x.to_store(store)
        with StreamExecutor() as ex:
            h0, k0 = pr.partition_histogramdd.launches, pr.partition_kmeans.launches
            if x is xh:
                h, rep = histogram(xd, bins=8, policy=pallas, executor=ex)
                assert pr.partition_histogramdd.launches - h0 == locs
                assert torch.equal(h, h_plain)
                assert rep.bytes_loaded > 0 and rep.prefetch_hits > 0
            else:
                km = kmeans(xd, k=8, iters=3, seed=0, policy=pallas, executor=ex)
                assert pr.partition_kmeans.launches - k0 == 3 * locs
                assert torch.equal(km.centers, km_mem.centers)
                torch.testing.assert_close(km.centers, km_plain.centers, **KMEANS_TOL)
                counts = [
                    Collection.from_blocked(a).split(pol)
                    .map_blocks(partial_sum_block, extra_args=(km_plain.centers,))
                    .reduce(_combine).compute(executor=e).value[1]
                    for a, pol, e in ((xd, pallas, ex), (xk, plain, LocalExecutor()))
                ]
                assert torch.equal(counts[0], counts[1])
                assert sum(r.bytes_loaded for r in km.reports) > 0
        assert store.closed and store.stats.peak_resident_bytes <= 1.25 * store.residency_bytes
