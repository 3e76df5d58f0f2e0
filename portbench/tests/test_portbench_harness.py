"""The harness finds everything by name, and a cell added as files is picked up."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.tests._small import ROOT, SMALL_ROWS

from portbench import harness
from portbench.trace import WINDOW, kernel_seconds, reduce_events

BENCH = harness.load_benchmark(ROOT)
CELLS = [c["name"] for c in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_by_name(name):
    cell = next(c for c in BENCH["workloads"] if c["name"] == name)
    cfg, traffic = harness.cell_files(ROOT, cell)
    assert cfg["name"] == cell["config"] and traffic["name"] == cell["traffic"]
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert json.loads((ROOT / entry["file"]).read_text()) == cfg
    assert entry["source"] == cfg["source"] and entry["reduced"] == cfg["reduced"]
    assert harness.app_class(cfg["app"]) is not None


@pytest.mark.parametrize("name", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader_found_by_name(name):
    assert callable(harness.load_metric(ROOT, name))


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_the_contracts_keys(section):
    for entry in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(entry) <= KEYS[section] | extra, entry["name"]


def test_names_units_and_texts_keep_to_their_characters():
    names = [e["name"] for s in KEYS for e in BENCH[s]]
    names += [c[k] for c in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.fullmatch(n), n
    for s in KEYS:
        assert len({e["name"] for e in BENCH[s]}) == len(BENCH[s]), s
    for m in METRICS:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for e in BENCH["configs"]:
        assert 1 <= len(e["source"]) <= 200


def test_every_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(0 < m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS and cell in e2e[m["moves"]].get("workloads", CELLS)
    for cell in CELLS:
        assert len(harness.metrics_of(BENCH, cell, "end_to_end")) >= 2
        assert harness.metrics_of(BENCH, cell, "per_layer")


def test_paths_hold_the_command_and_the_files():
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][-1].split(".")[0] == "portbench"
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")


def _copy_benchmark(tmp_path):
    root = tmp_path / "checkout"
    (root / "portbench").mkdir(parents=True)
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "portbench" / sub, root / "portbench" / sub)
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_a_configuration_mix_metric_and_cell_added_as_files_are_picked_up(tmp_path):
    root = _copy_benchmark(tmp_path)
    cfg = json.loads((root / "portbench/configs/histogram-d5-b8.json").read_text())
    cfg.update(name="histogram-d3-b16", d=3, bins=16, rows=4 * 3 * 40,
               locations=4, device_bytes=4 * 4 * 3 * 40 * 3)
    (root / "portbench/configs/histogram-d3-b16.json").write_text(json.dumps(cfg))
    mix = {"name": "thirds", "blocks_per_location": 3, "placement": "contiguous",
           "policy": {"name": "SplIter", "args": {"partitions_per_location": 3}},
           "executor": "local", "clients": 1, "loop": "closed"}
    (root / "portbench/traffic/thirds.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/jobs_per_s.py").write_text(
        "def read(w):\n    return len(w.job_s) / w.seconds\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
                             "file": "portbench/configs/histogram-d3-b16.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "histogram-d3-b16.thirds", "config": cfg["name"],
                               "traffic": "thirds", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "jobs_per_s", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "app", "moves": "pass_ms",
                               "workloads": ["histogram-d3-b16.thirds"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cpu = torch.device("cpu")
    r = harness.run("histogram-d3-b16.thirds", 5, 0.05, False, device=cpu, root=root)
    assert r["correct"] and r["checks"]["cells_off"]["value"] == 0
    assert set(r["metrics"]) == {"setup_s", "pass_ms"}  # no device memory on the CPU
    r = harness.run("histogram-d3-b16.thirds", 5, 0.05, True, device=cpu, root=root)
    assert r["correct"] and r["metrics"]["jobs_per_s"]["value"] > 0
    assert "dispatches_per_pass" not in r["metrics"]  # not listed for the new cell


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_runs_on_the_cpu_at_a_small_size(name):
    cell = next(c for c in BENCH["workloads"] if c["name"] == name)
    sizes = {"rows": SMALL_ROWS[cell["config"]]}
    if cell["config"].startswith("kmeans"):
        sizes["iters"] = 1  # rounding flips of 64-row blocks grow over more iterations
    r = harness.run(name, 2**31 + 17, 0.05, False, device=torch.device("cpu"), sizes=sizes)
    assert r["correct"], r["checks"]
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


def test_the_import_guard_compares_whole_top_level_names():
    loaded = ["repro_torch", "repro_torch.api", "jax_free", "reprox", "torch"]
    assert harness.forbidden_modules(loaded) == []
    assert harness.forbidden_modules(loaded + ["repro.api", "jaxlib.xla", "jax", "flax"]) == [
        "flax", "jax", "jaxlib.xla", "repro.api"]


def test_percentile_is_the_nearest_rank():
    values = list(range(1, 101))
    assert harness.percentile(values, 95) == 95
    assert harness.percentile([3.0], 95) == 3.0
    assert harness.percentile([1, 2], 95) == 2


def test_trace_reduction_unites_busy_time_and_names_idle_gaps():
    events = [
        (WINDOW, False, 0.0, 10.0),
        ("portbench.job", False, 0.0, 10.0),
        ("aten::add_", False, 5.0, 6.0),
        ("histdd_kernel(Args, int*)", True, 1.0, 3.0),
        ("kmeans_partial(float const*)", True, 2.0, 4.0),
        ("Memset (Device)", True, 6.0, 7.0),
        ("late", True, 9.5, 12.0),
    ]
    t = reduce_events(events)
    assert t.window_s == 10.0 and t.busy_s == 4.5
    assert t.device_s == 2 + 2 + 1 + 0.5
    assert t.gap_s == {"portbench.job": 1.0 + 1.0 + 2.5, "aten::add_": 1.0}
    assert kernel_seconds(t, ["histdd_kernel"]) == 2.0
    assert kernel_seconds(t, ["kmeans_partial", "kmeans_reduce"]) == 2.0
    assert reduce_events([e for e in events if e[0] != WINDOW]) is None


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr
