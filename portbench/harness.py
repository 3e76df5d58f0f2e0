"""The benchmark of ``repro_torch``: one cell, one seed, one measured window.

Everything a cell needs is found by name:

* the cell in ``BENCHMARK.json`` names a configuration and a traffic mix,
  read from ``portbench/configs/<name>.json`` and
  ``portbench/traffic/<name>.json``;
* the configuration's ``app`` names the driver ``portbench/apps/<app>.py``;
* each metric that ``BENCHMARK.json`` gives the cell is read by
  ``portbench/metrics/<name>.py``, whose ``read(window)`` returns a number,
  or None where it finds nothing to read;
* a kernel's roofline share takes its work from ``portbench/work/<kernel>.py``
  and the card's peaks from :mod:`portbench.peaks`.

A run makes the rows on the device from the seed, warms up with one pass,
then runs jobs one after another (a closed loop with one client) until the
window's seconds have passed, and lets the last job finish.  After the window
it frees the executor and holds the last job's answer against the plain
reference (:mod:`portbench.reference`).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from portbench import generator, peaks
from portbench.trace import WINDOW, Trace, events_of, kernel_seconds, reduce_events

__all__ = ["ROOT", "FORBIDDEN", "Window", "load_benchmark", "cell_files", "metrics_of",
           "load_metric", "app_class", "work_module", "forbidden_modules", "percentile",
           "roofline_pct", "run"]

ROOT = Path(__file__).resolve().parents[1]
#: Top-level module names no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: Entries the traced run's breakdown lists of each kind.
_BREAKDOWN = 10


@dataclasses.dataclass
class Window:
    """What a measured window leaves for the metric readers."""

    cfg: dict
    traffic: dict
    device_kind: str
    setup_s: float
    seconds: float                   # the window's wall time
    passes: int
    job_s: list[float]               # each job's wall time
    reports: list                    # the EngineReport of every execute in the window
    dispatch_s: float                # the executor's ProfileStore dispatch time in it
    peak_bytes: int | None           # max_memory_allocated over the window
    trace: Trace | None = None


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _cell(bench: dict, workload: str) -> dict:
    for c in bench["workloads"]:
        if c["name"] == workload:
            return c
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def cell_files(root: Path, cell: dict) -> tuple[dict, dict]:
    """The configuration and the traffic mix a cell names."""
    folder = root / "portbench"
    cfg = json.loads((folder / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((folder / "traffic" / f"{cell['traffic']}.json").read_text())
    return cfg, traffic


def metrics_of(bench: dict, workload: str, section: str) -> list[dict]:
    """The entries of ``section`` that ``workload`` reports."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def load_metric(root: Path, name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def app_class(app: str):
    return importlib.import_module(f"portbench.apps.{app}").App


def work_module(kernel: str):
    return importlib.import_module(f"portbench.work.{kernel}")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def percentile(values: list[float], q: float) -> float:
    """The ``q``-th percentile by nearest rank: the smallest value that at
    least ``q`` percent of ``values`` do not exceed."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


def roofline_pct(w: Window, kernel: str) -> float | None:
    """The least time ``kernel``'s work in the window needs on the card, as a
    share of its device time in the window; None without a trace, a launch of
    it, or the card's peaks."""
    card = peaks.peak_for(w.device_kind)
    if w.trace is None or card is None:
        return None
    mod = work_module(kernel)
    spent = kernel_seconds(w.trace, mod.KERNELS)
    if spent <= 0:
        return None
    flops, nbytes = mod.work(w.cfg, w.traffic)
    least = max(nbytes / card["hbm_bytes_per_s"], flops / card["flops_per_s"][mod.PRECISION])
    return 100.0 * least * w.passes / spent


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dispatch_s(ex) -> float:
    return sum(p.dispatch_s for p in ex.profile.snapshot())


def _measure(app, ex, seconds: float, device: torch.device):
    """Jobs back to back until ``seconds`` have passed, the last one finished."""
    passes, job_s, reports = 0, [], []
    t0 = time.perf_counter()
    index = 0
    while True:
        t = time.perf_counter()
        with torch.profiler.record_function("portbench.job"):
            n, reps = app.job(ex, index)
            _sync(device)
        end = time.perf_counter()
        job_s.append(end - t)
        passes += n
        reports.extend(reps)
        index += 1
        if end - t0 >= seconds:
            return end - t0, passes, job_s, reports


def _top(d: dict[str, float]) -> list[list]:
    return [[name, s] for name, s in sorted(d.items(), key=lambda kv: -kv[1])[:_BREAKDOWN]]


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: torch.device,
        root: Path = ROOT, t_start: float | None = None, sizes: dict | None = None) -> dict:
    """One run of ``workload``: the result line's object, checks last.

    ``sizes`` replaces keys of the configuration (the tests' small runs).
    """
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_benchmark(root)
    cell = _cell(bench, workload)
    cfg, traffic = cell_files(root, cell)
    cfg.update(sizes or {})
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else device.type

    t_imports = time.perf_counter()
    app = app_class(cfg["app"])(cfg, traffic, seed, device)
    _sync(device)
    t_rows = time.perf_counter()
    ex = generator.executor(traffic)
    app.warm(ex)
    _sync(device)
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    print(f"setup_s {setup_s:.3f}: imports and files {t_imports - t_start:.3f}, rows "
          f"{t_rows - t_imports:.3f}, warm pass {t_warm - t_rows:.3f}", file=sys.stderr)

    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    dispatch0 = _dispatch_s(ex)
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW):
                window_s, passes, job_s, reports = _measure(app, ex, seconds, device)
        traced = reduce_events(events_of(prof))
        del prof
    else:
        window_s, passes, job_s, reports = _measure(app, ex, seconds, device)
        traced = None
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    w = Window(cfg=cfg, traffic=traffic, device_kind=kind, setup_s=setup_s, seconds=window_s,
               passes=passes, job_s=job_s, reports=reports,
               dispatch_s=_dispatch_s(ex) - dispatch0, peak_bytes=peak, trace=traced)

    metrics = {}
    for m in metrics_of(bench, workload, "per_layer" if trace else "end_to_end"):
        value = load_metric(root, m["name"])(w)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace and cuda:
        print(f"peaks of {kind}: {peaks.peak_for(kind)}; name, power.limit: "
              f"{peaks.power_limit(device.index or 0) or 'not read'}", file=sys.stderr)

    # the program's state goes before the reference runs
    ex.close()
    del ex
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = app.compare(app.answer(), app.reference())
    limits = cfg["limits"]
    checks = {name: {"value": readings.get(name, math.inf), "limit": limit}
              for name, limit in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    dev = {"platform": "gpu" if cuda else device.type, "kind": kind,
           "count": cell["chips"], "memory_peak_bytes": max(setup_peak or 0, peak or 0)}
    result = {"correct": correct, "attempted": len(job_s), "failed": 0, "metrics": metrics,
              "device": dev}
    if trace and traced is not None:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": _top(traced.op_s),
                               "idle_gaps": _top(traced.gap_s)}
    result["checks"] = checks
    return result
