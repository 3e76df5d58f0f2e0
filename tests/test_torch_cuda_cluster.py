"""The cluster backend on the card: spawned workers, each in its own CUDA context.

Every test here needs an NVIDIA GPU; on a host without one each skips with
that reason.  Run them on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_cluster.py

* A fused histogram pass and a k-means run over CUDA blocks launch the
  partition kernels in the worker processes — once per task, counted by
  the workers' own wrappers — and none in the driver; the values equal
  LocalExecutor's bit for bit and come back on the card.
* A ``DiskStore`` on the card hands off through shared memory (resident
  chunks copied to the host once) and the workers put the chunks back on
  the card; a worker killed mid-run replays bit-identically, leaving no
  segment behind.
* With ``p2p=True`` (the peer exchange) a location's partials are folded
  by a fold unit in its worker, on the card: the histogram's and k-means's
  values equal Local's bit for bit, the bill is the exact byte formula.
  A member whose publish is declined (its reply comes back as values)
  still folds in its worker on the card, never on the host.
* Tensors on the card (f32 and bf16) round-trip through the arena and the
  workers' attachments bit for bit; a driver RPC (kNN's lookups) computes
  on the card and returns there.
"""

import pytest
import torch

import _torch_cluster_fns as fns

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


def _launches(ex) -> dict:
    per = ex.call_workers(fns.launch_counts)
    return {k: sum(v[k] for v in per.values()) for k in fns.launch_counts()}


def test_cluster_histogram_launches_in_the_workers(dev):
    from repro_torch.api import SplIter, engine
    from repro_torch.core.apps.histogram import histogram
    from repro_torch.kernels import partition_reduce as pr

    x = _data(dev, 5)
    pol = SplIter(1, fusion="pallas")
    with engine("local") as ex:
        ref, _ = histogram(x, bins=8, policy=pol, executor=ex)
    parent = pr.partition_histogramdd.launches
    with engine("cluster") as ex:
        for _ in range(2):
            before = _launches(ex) if ex.workers_alive() else {"partition_histogramdd": 0}
            h, rep = histogram(x, bins=8, policy=pol, executor=ex)
            assert h.device == dev and torch.equal(h, ref)
            assert _launches(ex)["partition_histogramdd"] - before["partition_histogramdd"] == 4
            assert rep.remote_dispatches == 4 and rep.retries == 0
    assert pr.partition_histogramdd.launches == parent  # none in the driver


def test_cluster_kmeans_bit_identical_with_worker_launches(dev):
    from repro_torch.api import SplIter, engine
    from repro_torch.core.apps.kmeans import kmeans

    x = _data(dev, 20, seed=1)
    pol = SplIter(1, fusion="pallas")
    with engine("local") as ex:
        ref = kmeans(x, k=8, iters=3, policy=pol, executor=ex)
    with engine("cluster") as ex:
        res = kmeans(x, k=8, iters=3, policy=pol, executor=ex)
        assert _launches(ex)["partition_kmeans"] == 3 * 4
    assert res.centers.device == dev and torch.equal(res.centers, ref.centers)


def test_cluster_disk_store_on_the_card_hands_off_through_shm(dev):
    from repro_torch.api import DiskStore, SplIter, engine
    from repro_torch.api.shm import leaked_segments
    from repro_torch.core.apps.histogram import histogram

    x = _data(dev, 5, seed=2)
    pol = SplIter(2, fusion="pallas")
    ref, _ = histogram(x, bins=8, policy=pol)
    store = DiskStore(residency_bytes=x.nbytes, device=dev)  # everything resident
    chunked = x.to_store(store)
    with engine("cluster") as ex:
        prefix = ex._shm.prefix
        h, rep = histogram(chunked, bins=8, policy=pol, executor=ex)
        assert store.stats.spills == 0  # resident chunks went through shm, no file
    assert torch.equal(h, ref)
    assert rep.shm_bytes >= x.nbytes and rep.bytes_loaded == 0
    assert leaked_segments(prefix) == []
    store.close()


def test_cluster_killed_worker_replays_on_the_card(dev):
    from repro_torch.api import FaultPlan, SplIter, engine
    from repro_torch.api.shm import leaked_segments
    from repro_torch.core.apps.histogram import histogram

    x = _data(dev, 5, seed=3)
    pol = SplIter(2, fusion="pallas")
    ref, _ = histogram(x, bins=8, policy=pol)
    with engine("cluster", fault_plan=FaultPlan(kill_after=((1, 2),))) as ex:
        prefix = ex._shm.prefix
        h, rep = histogram(x, bins=8, policy=pol, executor=ex)
        assert [e["worker"] for e in ex.retry_log] == [1]
    assert torch.equal(h, ref) and rep.retries == 1
    assert leaked_segments(prefix) == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_tensors_round_trip_through_shm(dev, dtype):
    from repro_torch.api.shm import ShmAttachments, ShmStore

    t = torch.randn((1024, 7), device=dev).to(dtype)
    with ShmStore() as arena:
        ref, wrote = arena.export(t)
        assert wrote == t.nbytes
        att = ShmAttachments()
        back = att.tensor(ref, dev)
        att.close()
    assert back.device == dev and back.dtype == dtype and torch.equal(back, t)


def test_driver_rpc_computes_on_the_card(dev):
    from repro_torch.api import SplIter, engine
    from repro_torch.core.apps.knn import knn

    fit = _data(dev, 3, seed=4)
    qry = _data(dev, 3, seed=5, blocks=1, rows=256)
    pol = SplIter(1)
    ref = knn(fit, qry, k=4, policy=pol)
    with engine("cluster") as ex:
        res = knn(fit, qry, k=4, policy=pol, executor=ex)
    assert res.report.remote_dispatches >= 1
    assert res.indices.device == dev
    assert torch.equal(res.indices, ref.indices) and torch.equal(res.distances, ref.distances)


def test_cluster_p2p_folds_on_the_card(dev, tmp_path):
    from repro_torch.api import SplIter, cluster_worker, engine
    from repro_torch.api.shm import leaked_segments
    from repro_torch.core.apps.histogram import histogram
    from repro_torch.core.apps.kmeans import kmeans

    x = _data(dev, 5, seed=6)
    pol = SplIter(2, fusion="pallas")
    partial = 8**5 * 4  # one histogram partial, int32
    with engine("local") as ex:
        ref, ref_rep = histogram(x, bins=8, policy=pol, executor=ex)
    with engine("cluster", p2p=True, log_dir=str(tmp_path)) as ex:
        prefix = ex._shm.prefix
        h, rep = histogram(x, bins=8, policy=pol, executor=ex)
        stats = ex.call_workers(cluster_worker.unit_stats, True)
        assert _launches(ex)["partition_histogramdd"] == 8  # 2 tasks a location
        assert sum(v["folds"] for v in stats.values()) == 4  # one fold a location
        xk = _data(dev, 20, seed=7)
        with engine("local") as local:
            kref = kmeans(xk, k=8, iters=2, policy=pol, executor=local)
        kres = kmeans(xk, k=8, iters=2, policy=pol, executor=ex)
    assert h.device == dev and torch.equal(h, ref)
    assert (rep.p2p_bytes, rep.driver_merge_bytes) == (8 * partial, 4 * partial)
    assert ref_rep.driver_merge_bytes == 8 * partial
    assert (rep.dispatches, rep.merges) == (ref_rep.dispatches + 4, ref_rep.merges + 4)
    logs = "".join(f.read_text() for f in tmp_path.glob("worker-*.log"))
    assert logs.count("fan_in=2 device=cuda:0") == 4 + 2 * 4
    assert torch.equal(kres.centers, kref.centers)
    assert all(r.p2p_bytes > 0 for r in kres.reports)
    assert leaked_segments(prefix) == []


def test_cluster_declined_publish_folds_on_the_card(dev, tmp_path, monkeypatch):
    from repro_torch.api import SplIter, cluster_worker, engine, shm
    from repro_torch.api.shm import leaked_segments
    from repro_torch.core.apps.histogram import histogram

    x = _data(dev, 5, seed=6)
    pol = SplIter(2, fusion="pallas")
    with engine("local") as ex:
        ref, _ = histogram(x, bins=8, policy=pol, executor=ex)
    def declined(tree):
        return None  # the driver reads every publishing reply's values in place

    with engine("cluster", p2p=True, log_dir=str(tmp_path)) as ex:
        prefix = ex._shm.prefix
        monkeypatch.setattr(shm, "tree_lease", declined)
        h, rep = histogram(x, bins=8, policy=pol, executor=ex)
        monkeypatch.undo()
        stats = ex.call_workers(cluster_worker.unit_stats, True)
    assert h.device == dev and torch.equal(h, ref)
    assert sum(v["folds"] for v in stats.values()) == 4  # one fold a location
    assert rep.p2p_bytes == 0 and rep.driver_merge_bytes == 4 * 8**5 * 4
    logs = "".join(f.read_text() for f in tmp_path.glob("worker-*.log"))
    assert logs.count("fan_in=2 device=cuda:0") == 4
    assert "device=cpu" not in logs
    assert leaked_segments(prefix) == []
