"""The comparison that decides ``correct`` fails where it must, on the CPU.

* The control, the plain reference computed in the precision below the
  configuration's (bfloat16 digitizing for the histogram, TF32 products for
  k-means) and put in the program's place, fails one of the cell's limits.
* A run whose timed path is broken underneath comes out not correct, once for
  each fault the cell can have: a step that returns its state unchanged
  (k-means), half of the blocks left out, an answer altered where it is
  produced.  One chip, so no exchange between chips to leave out.
"""

from __future__ import annotations

import dataclasses
import functools

import pytest
import torch

from portbench.tests._small import ROOT, SMALL_ROWS

from portbench import harness

CPU = torch.device("cpu")
BENCH = harness.load_benchmark(ROOT)
CELLS = [c["name"] for c in BENCH["workloads"]]


def _limits(config: str) -> dict:
    cell = next(c for c in BENCH["workloads"] if c["config"] == config)
    return harness.cell_files(ROOT, cell)[0]["limits"]


def _app(config: str, traffic: str, rows: int, iters: int | None = None):
    cell = next(c for c in BENCH["workloads"] if c["config"] == config
                and c["traffic"] == traffic)
    cfg, mix = harness.cell_files(ROOT, cell)
    cfg["rows"] = rows
    if iters is not None:
        cfg["iters"] = iters
    return harness.app_class(cfg["app"])(cfg, mix, 2**31 + 5, CPU)


def _fails(readings: dict, limits: dict) -> list[str]:
    return [n for n, limit in limits.items() if not readings[n] <= limit]


def test_the_histogram_control_fails():
    app = _app("histogram-d5-b8", "fragmented", 8 * 64 * 256)
    app.job(harness.generator.executor({"executor": "local"}), 0)
    ref = app.reference()
    assert not _fails(app.compare(app.answer(), ref), _limits("histogram-d5-b8"))
    assert _fails(app.compare(app.reference(control=True), ref), _limits("histogram-d5-b8"))


def test_the_kmeans_control_fails():
    app = _app("kmeans-d20-k8", "fragmented", 8 * 64 * 512)
    app.job(harness.generator.executor({"executor": "local"}), 0)
    ref = app.reference()
    assert _fails(app.compare(app.reference(control=True), ref), _limits("kmeans-d20-k8"))


# -- faults planted underneath the timed path --------------------------------


def _half_of_the_blocks(module):
    """``module.Collection`` that builds its collection from half the blocks."""
    real = module.Collection

    class Half:
        @staticmethod
        def from_blocked(x):
            keep = x.num_blocks // 2
            return real.from_blocked(dataclasses.replace(
                x, blocks=x.blocks[:keep], placements=x.placements[:keep]))

    return Half


def _histogram_altered(module):
    real = module.histogramdd_block

    @functools.wraps(real)
    def block(b, **kw):
        out = real(b, **kw)
        out.view(-1)[0] += 1
        return out

    return block


def _kmeans_altered(module):
    real = module.partial_sum_block

    def block(b, centers):
        sums, counts = real(b, centers)
        return sums * torch.tensor([1.01] + [1.0] * (sums.shape[0] - 1))[:, None], counts

    return block


def _kmeans_unchanged(module, monkeypatch):
    """The step's centers come back as they went in."""
    seen = {}
    real = module.partial_sum_block

    def block(b, centers):
        seen["centers"] = centers
        return real(b, centers)

    monkeypatch.setattr(module, "partial_sum_block", block)
    monkeypatch.setattr(module, "_centers_of", lambda partials: seen["centers"])


FAULTS = {
    "histogram": {
        "half_of_the_blocks": lambda m, mp: mp.setattr(m, "Collection", _half_of_the_blocks(m)),
        "answer_altered": lambda m, mp: mp.setattr(m, "histogramdd_block", _histogram_altered(m)),
    },
    "kmeans": {
        "state_unchanged": _kmeans_unchanged,
        "half_of_the_blocks": lambda m, mp: mp.setattr(m, "Collection", _half_of_the_blocks(m)),
        "answer_altered": lambda m, mp: mp.setattr(m, "partial_sum_block", _kmeans_altered(m)),
    },
}
CASES = [(c, f) for c in CELLS for f in FAULTS[c.split("-")[0]]]


def _run(cell: str):
    config = next(c["config"] for c in BENCH["workloads"] if c["name"] == cell)
    sizes = {"rows": SMALL_ROWS[config]}
    if config.startswith("kmeans"):
        sizes["iters"] = 1
    return harness.run(cell, 2**31 + 3, 0.02, False, device=CPU, sizes=sizes)


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_comes_out_not_correct(cell, fault, monkeypatch):
    import importlib

    assert _run(cell)["correct"]
    app = "histogram" if cell.startswith("histogram") else "kmeans"
    module = importlib.import_module(f"repro_torch.core.apps.{app}")
    FAULTS[app][fault](module, monkeypatch)
    result = _run(cell)
    assert not result["correct"], result["checks"]
