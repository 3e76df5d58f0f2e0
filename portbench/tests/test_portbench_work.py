"""The kernels' work counts and the roofline share built on them."""

from __future__ import annotations

import pytest

from portbench.tests._small import ROOT  # noqa: F401  (puts the benchmark on the path)

from portbench import harness, peaks
from portbench.trace import Trace
from portbench.work import partition_histogramdd, partition_kmeans

H100 = "NVIDIA H100 80GB HBM3"


def test_histogramdd_work_on_known_shapes():
    cfg = {"rows": 1000, "d": 5, "bins": 8, "locations": 8}
    flops, nbytes = partition_histogramdd.work(cfg, {})
    assert flops == 2 * 1000 * 5
    assert nbytes == 4 * 1000 * 5 + 8 * 4 * 8**5


def test_kmeans_work_on_known_shapes():
    cfg = {"rows": 1000, "d": 20, "k": 8, "locations": 8}
    flops, nbytes = partition_kmeans.work(cfg, {})
    assert flops == 2 * 1000 * 20 * 8 + 1000 * 20
    assert nbytes == 4 * 1000 * 20 + 8 * 4 * (8 * 20 * 2 + 8)


@pytest.mark.parametrize("name,rows,d", [("histogram-d5-b8", 880_000_000, 5),
                                         ("kmeans-d20-k8", 268_435_456, 20)])
def test_the_cells_are_bound_by_bytes(name, rows, d):
    import json

    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    assert (cfg["rows"], cfg["d"]) == (rows, d)
    mod = partition_kmeans if cfg["app"] == "kmeans" else partition_histogramdd
    flops, nbytes = mod.work(cfg, {})
    card = peaks.peak_for(H100)
    assert nbytes / card["hbm_bytes_per_s"] > flops / card["flops_per_s"][mod.PRECISION]
    assert 4 * rows * d == cfg["device_bytes"]


def _window(op_s: dict, passes: int, kind: str = H100) -> harness.Window:
    cfg = {"rows": 1000, "d": 5, "bins": 8, "locations": 8}
    trace = Trace(window_s=1.0, busy_s=0.5, device_s=sum(op_s.values()), op_s=op_s, gap_s={})
    return harness.Window(cfg=cfg, traffic={}, device_kind=kind, setup_s=1.0, seconds=1.0,
                          passes=passes, job_s=[1.0], reports=[], dispatch_s=0.0,
                          peak_bytes=None, trace=trace)


def test_roofline_share_is_the_least_time_over_the_kernels_time():
    w = _window({"histdd_kernel(Args, int*)": 2e-6, "Memset (Device)": 5e-6}, passes=3)
    _, nbytes = partition_histogramdd.work(w.cfg, {})
    want = 100 * 3 * nbytes / 3.35e12 / 2e-6
    assert harness.roofline_pct(w, "partition_histogramdd") == pytest.approx(want, rel=1e-12)


def test_roofline_share_is_silent_without_the_kernel_a_trace_or_the_card():
    assert harness.roofline_pct(_window({"other": 1.0}, 1), "partition_histogramdd") is None
    assert harness.roofline_pct(_window({"histdd_kernel": 1.0}, 1, "cpu"),
                                "partition_histogramdd") is None
    w = _window({"histdd_kernel": 1.0}, 1)
    w.trace = None
    assert harness.roofline_pct(w, "partition_histogramdd") is None


def test_power_limit_is_none_where_nvidia_smi_cannot_run(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert peaks.power_limit() is None
