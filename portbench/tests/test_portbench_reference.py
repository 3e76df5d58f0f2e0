"""The plain references against the program's apps, on the CPU at a small size.

The program runs its kernels' plain versions here; the references import
nothing of it.  Both get the same rows from the benchmark's generator.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from portbench.tests._small import ROOT

from portbench import generator, harness
from portbench.apps.histogram import App as HistogramApp
from portbench.apps.kmeans import App as KMeansApp
from portbench.reference.histogram import histogram_counts
from portbench.reference.kmeans import lloyd, to_tf32
from portbench.reference.threefry import uniform_f32

CPU = torch.device("cpu")
TRAFFIC = {"fragmented": 16, "balanced": 1}


def _traffic(blocks_per_location: int) -> dict:
    return {"blocks_per_location": blocks_per_location, "placement": "round_robin",
            "policy": {"name": "SplIter", "args": {}}, "executor": "local"}


@pytest.mark.parametrize("seed", [0, 1, 12345, -7, 2**31 - 1, -(2**31)])
def test_frozen_draw_equals_the_programs(seed):
    from repro_torch._threefry import uniform

    for shape in [(8, 20), (3, 5), (1,)]:
        assert torch.equal(uniform_f32(seed, shape), uniform(seed, shape, torch.float32))


def test_frozen_draw_refuses_a_seed_outside_int32():
    with pytest.raises(ValueError):
        uniform_f32(2**31, (2,))


@pytest.mark.parametrize("mix", sorted(TRAFFIC))
@pytest.mark.parametrize("d,bins", [(5, 8), (2, 16), (3, 4)])
def test_histogram_reference_equals_the_program(mix, d, bins):
    cfg = {"rows": 8 * 16 * 250, "d": d, "bins": bins, "lo": 0.0, "hi": 1.0,
           "locations": 8, "dtype": "float32"}
    app = HistogramApp(cfg, _traffic(TRAFFIC[mix]), 2**31 + 99, CPU)
    app.job(generator.executor({"executor": "local"}), 0)
    ref = app.reference()
    assert int(ref.sum()) == cfg["rows"]
    assert app.compare(app.answer(), ref) == {"cells_off": 0.0}


def test_histogram_reference_clips_and_counts_every_row():
    x = torch.tensor([[-0.5, 0.0], [0.99, 1.0], [0.5, 2.0], [0.25, 0.7499]])
    counts = histogram_counts(x, bins=4, lo=0.0, hi=1.0, rows_per_block=3).reshape(4, 4)
    want = torch.zeros(4, 4, dtype=torch.int64)
    for i, j in [(0, 0), (3, 3), (2, 3), (1, 2)]:
        want[i, j] += 1
    assert torch.equal(counts, want)


@pytest.mark.parametrize("mix", sorted(TRAFFIC))
@pytest.mark.parametrize("iters", [1, 2])
def test_kmeans_reference_equals_the_program(mix, iters):
    cfg = {"rows": 8 * 16 * 512, "d": 20, "k": 8, "iters": iters, "locations": 8,
           "dtype": "float32"}
    app = KMeansApp(cfg, _traffic(TRAFFIC[mix]), 4242, CPU)
    ex = generator.executor({"executor": "local"})
    app.warm(ex)
    app.job(ex, 0)
    centers, counts = app.answer()
    rc, rn = app.reference()
    assert torch.equal(counts, rn)
    assert int(rn.sum()) == cfg["rows"]
    gaps = app.compare((centers, counts), (rc, rn))
    assert gaps["counts_gap"] == 0.0 and gaps["centers_gap"] < 1e-6


def test_lloyd_moves_an_empty_center_to_zero_and_breaks_ties_to_the_first():
    x = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.5, 0.0]])
    centers, counts = lloyd(x, torch.tensor([[0.0, 0.0], [1.0, 0.0], [9.0, 9.0]]), 1)
    assert counts.tolist() == [2, 1, 0]
    assert torch.equal(centers, torch.tensor([[0.25, 0.0], [1.0, 0.0], [0.0, 0.0]]))


def test_tf32_rounding_keeps_ten_mantissa_bits_to_nearest_even():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-11 + 2**-20])
    got = to_tf32(x)
    assert got.tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-9, 1.0 + 2**-10]
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    return names


@pytest.mark.parametrize("path", sorted((ROOT / "portbench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        top = name.split(".", 1)[0]
        assert top not in ("repro_torch", *harness.FORBIDDEN), (path.name, name)
        if top == "portbench":
            assert name.startswith("portbench.reference"), (path.name, name)


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_nothing_in_the_benchmark_imports_jax_or_reads_the_jax_benches(path):
    for name in _imports(path):
        assert name.split(".", 1)[0] not in harness.FORBIDDEN + ("benchmarks",), name
    if path.parent.name != "tests":
        assert "benchmarks" not in path.read_text(), path
