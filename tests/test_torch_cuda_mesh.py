"""The mesh backend and the job service on the card.

Every test here needs an NVIDIA GPU; on a host without one each skips with
that reason.  Run them on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_mesh.py

* A mesh pass with kernel fusion over CUDA blocks, at one rank and at eight
  ranks on one card, launches the kernel once per task and equals
  LocalExecutor: histogram counts exactly, k-means centers bit for bit
  where the fold's association is Local's (SplIter(1)), within the
  reference's mesh tolerance ``MESH_TOL`` elsewhere.
* A JobServer restarted over a journal of a CUDA plan rebuilds the job's
  inputs on the card and its resumed units launch the kernel: a resumed
  job never drops to the CPU route.
* The Checkpointer restores onto CUDA template leaves.
"""

import functools
import operator
import threading

import pytest
import torch

from repro_torch.kernels import partition_reduce as pr

#: the reference's mesh tolerance (tests/test_api.py:427)
MESH_TOL = dict(rtol=2e-4, atol=2e-4)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a) and nvcc")
    return torch.device("cuda", 0)


def _data(dev, d, seed=0, locations=4, blocks=4, rows=4096):
    from repro_torch.core.blocked import BlockedArray, round_robin_placement

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((locations * blocks * rows, d), generator=gen, device=dev)
    return BlockedArray.from_array(x, rows, num_locations=locations,
                                   policy=round_robin_placement, device=dev)


@pytest.mark.parametrize("ranks", [1, 8])
def test_mesh_histogram_launches_once_per_task_and_equals_local(dev, ranks):
    from repro_torch.api import SplIter, engine
    from repro_torch.core.apps.histogram import histogram

    x = _data(dev, 5)
    with engine("local") as ex:
        ref, _ = histogram(x, bins=8, policy=SplIter(1, fusion="pallas"), executor=ex)
    for ppl in (1, 2):
        c0 = pr.partition_histogramdd.launches
        with engine("mesh", devices=(dev,) * ranks) as ex:
            h, rep = histogram(x, bins=8, policy=SplIter(ppl, fusion="pallas"), executor=ex)
        assert pr.partition_histogramdd.launches - c0 == 4 * ppl
        assert h.is_cuda and torch.equal(h, ref)
        m = min(ranks, 4 * ppl)
        assert (rep.dispatches, rep.merges, rep.bytes_moved) == (
            1, int(m > 1), (m - 1) * 8**5 * 4)


@pytest.mark.parametrize("ranks,ppl", [(1, 1), (8, 1), (4, 2), (1, 2)])
def test_mesh_kmeans_on_the_card(dev, ranks, ppl):
    from repro_torch.api import SplIter, engine
    from repro_torch.core.apps.kmeans import kmeans

    x = _data(dev, 6, seed=1)
    pol = SplIter(ppl, fusion="pallas")
    with engine("local") as ex:
        ref = kmeans(x, k=4, iters=3, policy=pol, executor=ex)
    c0 = pr.partition_kmeans.launches
    with engine("mesh", devices=(dev,) * ranks) as ex:
        got = kmeans(x, k=4, iters=3, policy=pol, executor=ex)
    assert pr.partition_kmeans.launches - c0 == 3 * 4 * ppl
    assert got.total_dispatches == 3
    # Local chains each location's partials, then the locations; the mesh
    # chains each rank's share, then the ranks: the same tree except at one
    # rank over two partitions a location
    if (ranks, ppl) != (1, 2):
        assert torch.equal(got.centers, ref.centers)
    else:
        torch.testing.assert_close(got.centers, ref.centers, **MESH_TOL)


def test_mesh_operands_stay_in_place_on_the_card(dev):
    """No group-axis stack: a fused mesh pass over 8 ranks raises device
    memory by about what Local's pass does, far below one partition."""
    from repro_torch.api import SplIter, engine
    from repro_torch.core.apps.histogram import histogram

    x = _data(dev, 5, locations=8, blocks=4, rows=65536)
    partition = 4 * 65536 * 5 * 4
    rises = []
    for backend, kw in (("local", {}), ("mesh", {"devices": (dev,) * 8})):
        with engine(backend, **kw) as ex:
            histogram(x, bins=8, policy=SplIter(1, fusion="pallas"), executor=ex)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            histogram(x, bins=8, policy=SplIter(1, fusion="pallas"), executor=ex)
            torch.cuda.synchronize()
            rises.append(torch.cuda.max_memory_allocated() - base)
    assert rises[1] <= rises[0] + 4 * 2**20 and rises[1] < partition, rises


def test_jobserver_restart_rebuilds_inputs_on_the_card(dev, tmp_path):
    from repro_torch.api import Collection, SplIter, engine
    from repro_torch.core.apps.histogram import histogramdd_block

    x = _data(dev, 5, seed=2)
    plan = (Collection.from_blocked(x).split(SplIter(1, fusion="pallas"))
            .map_blocks(functools.partial(histogramdd_block, bins=8, lo=0.0, hi=1.0))
            .reduce(operator.add).plan())
    with engine("local") as ex:
        ref = ex.execute(plan).value

    server = engine("server", root=str(tmp_path), autostart=False)
    job = server.submit(plan, tenant="t")
    assert job.durable
    hit = threading.Event()
    emit = server._emit

    def watched(j, kind, detail="", completed=0, total=0):
        emit(j, kind, detail, completed, total)
        if kind == "running" and j.recomputed_units >= 1 and not hit.is_set():
            server._stop.set()  # stop right after the first unit
            hit.set()

    server._emit = watched
    server.start()
    assert hit.wait(120)
    server.kill()

    c0 = pr.partition_histogramdd.launches
    server2 = engine("server", root=str(tmp_path))
    job2 = server2.jobs()[0]
    value = server2.wait(job2, 120).value
    server2.close()
    assert job2.spec.inputs[0].device.type == "cuda"
    assert job2.restored_units == 1
    assert job2.restored_units + job2.recomputed_units == job2.total_units
    assert pr.partition_histogramdd.launches - c0 == job2.recomputed_units - 1 == 3
    assert value.is_cuda and torch.equal(value, ref)


def test_checkpoint_restores_onto_the_card(dev, tmp_path):
    from repro_torch.checkpoint import Checkpointer

    tree = {"w": torch.randn(4, 3, device=dev), "h": torch.randn(5, device=dev).bfloat16()}
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, tree, blocking=False)
    got, _, _ = ckpt.restore({k: torch.zeros_like(v) for k, v in tree.items()})
    for k in tree:
        assert got[k].device == dev and got[k].dtype == tree[k].dtype
        assert torch.equal(got[k], tree[k])
