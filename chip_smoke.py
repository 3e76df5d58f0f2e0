#!/usr/bin/env python3
"""chip_smoke — drive the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--repeats N]

Runs the paper's two memory-bound apps through the port's entry points
(``repro_torch.core.apps.histogram`` / ``kmeans``) at the benchmarks' full
widths, on data generated on the card from ``--seed``: 8 locations × 16
blocks × 262,144 rows (33,554,432 rows, round-robin placement); histogram
at d=5, bins=8; k-means at d=20, k=8, 10 iterations, over 8 tight Gaussian
blobs (σ=0.02).  Five policies — Baseline, SplIter(1, scan),
SplIter(1, pallas), SplIter(2) (fusion "auto": the kernel on a card) and
Rechunk — must agree: histograms exactly, with a total equal to the row
count; k-means counts exactly and centers to 1e-4 relative.

Then each hand-written kernel runs at the main path's per-task shape
(16 × 262,144 rows stacked) beside its plain PyTorch version, compared with
a stated tolerance and timed with CUDA events.  Kernel launches are counted
over the main-path phase only.

Output: the card's name and power limit (``nvidia-smi``) on the first line,
one JSON line per run and check, a ``{"kernels": [...]}`` line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failed check raises and
the script exits non-zero; it also exits non-zero, printing no result,
when no CUDA device is present or the repository's ``src`` is missing.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

LOCATIONS, BLOCKS_PER_LOCATION, BLOCK_ROWS = 8, 16, 262_144
HIST_D, HIST_BINS = 5, 8
KM_D, KM_K, KM_ITERS, KM_SIGMA = 20, 8, 10, 0.02


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median time of ``fn`` on the current stream, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    """Least time (ms) for the work on an H100 SXM, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def make_data(seed: int, dev: torch.device):
    """Uniform histogram rows and k-means blobs, generated on the card.

    The blob means sit near the seed's initial k-means centers (a 0.05
    offset, against ~1.8 between centers), so every row is far from a tie
    and counts compare exactly across policies and formulas.
    """
    from repro_torch.core.apps.kmeans import _init_centers

    n = LOCATIONS * BLOCKS_PER_LOCATION * BLOCK_ROWS
    gen = torch.Generator(device=dev).manual_seed(seed)
    hist = torch.rand((n, HIST_D), generator=gen, device=dev)
    init = _init_centers(seed, KM_K, KM_D, torch.float32, dev)
    means = init + 0.05 * torch.randn((KM_K, KM_D), generator=gen, device=dev)
    labels = torch.randint(0, KM_K, (n,), generator=gen, device=dev)
    km = torch.randn((n, KM_D), generator=gen, device=dev).mul_(KM_SIGMA)
    km.add_(means[labels])
    return hist, km, means, torch.bincount(labels, minlength=KM_K)


def main_path(x_hist, x_km, means, label_counts, seed: int, repeats: int) -> dict:
    """Both apps under every policy through the port's entry points."""
    from repro_torch.api import Baseline, Collection, LocalExecutor, Rechunk, SplIter
    from repro_torch.core.apps.histogram import histogram
    from repro_torch.core.apps.kmeans import _combine, kmeans, partial_sum_block
    from repro_torch.kernels import partition_reduce as pr

    policies = {
        "baseline": (Baseline(), False),
        "spliter1_scan": (SplIter(1, fusion="scan"), False),
        "spliter1_pallas": (SplIter(1, fusion="pallas"), True),
        "spliter2_auto": (SplIter(2), True),
        "rechunk": (Rechunk(), False),
    }
    pr.partition_histogramdd.launches = 0
    pr.partition_kmeans.launches = 0
    hists, centers, counts = {}, {}, {}
    for name, (pol, kernel_path) in policies.items():
        with LocalExecutor() as ex:
            h0, k0 = pr.partition_histogramdd.launches, pr.partition_kmeans.launches
            runs = []
            for _ in range(1 + repeats):  # one warm-up, then timed runs
                h, rep = histogram(x_hist, bins=HIST_BINS, policy=pol, executor=ex)
                runs.append(rep)
            hists[name] = h
            emit({"phase": "main_path", "app": "histogram", "policy": name,
                  "dispatches": rep.dispatches, "traces": runs[0].traces,
                  "bytes_moved": runs[0].bytes_moved,
                  "wall_s": statistics.median(r.wall_s for r in runs[1:]),
                  "launches": pr.partition_histogramdd.launches - h0})
            check((pr.partition_histogramdd.launches > h0) == kernel_path,
                  f"histogram/{name} kernel routing")
            walls, results = [], []
            for _ in range(1 + repeats):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = kmeans(x_km, k=KM_K, iters=KM_ITERS, seed=seed, policy=pol, executor=ex)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                results.append(res)
            centers[name] = res.centers
            counts[name] = (
                Collection.from_blocked(x_km).split(pol)
                .map_blocks(partial_sum_block, extra_args=(res.centers,))
                .reduce(_combine).compute(executor=ex).value[1]
            )
            emit({"phase": "main_path", "app": "kmeans", "policy": name,
                  "iterations": KM_ITERS, "dispatches": res.total_dispatches,
                  "traces": sum(r.traces for r in results[0].reports),
                  "bytes_moved": results[0].total_bytes_moved,
                  "wall_s": statistics.median(walls[1:]),
                  "report_wall_s": statistics.median(r.total_wall_s for r in results[1:]),
                  "launches": pr.partition_kmeans.launches - k0})
            check((pr.partition_kmeans.launches > k0) == kernel_path,
                  f"kmeans/{name} kernel routing")
    launches = {"partition_histogramdd": pr.partition_histogramdd.launches,
                "partition_kmeans": pr.partition_kmeans.launches}

    n = x_hist.num_rows
    ref_h = hists["baseline"]
    for name, h in hists.items():
        check(torch.equal(h, ref_h), f"histogram {name} equals baseline")
    check(int(ref_h.sum()) == n, "histogram total equals the row count")
    ref_c, ref_n = centers["baseline"], counts["baseline"]
    for name in centers:
        check(torch.equal(counts[name], ref_n), f"kmeans counts {name} equal baseline")
        check(torch.allclose(centers[name], ref_c, rtol=1e-4, atol=1e-6),
              f"kmeans centers {name} within 1e-4 of baseline")
    check(torch.equal(ref_n, label_counts.to(ref_n.dtype)), "kmeans counts equal blob sizes")
    # each center is its blob's sample mean: off by ~sigma/sqrt(size) per coordinate
    err = float((ref_c - means).abs().max())
    limit = 6 * KM_SIGMA / float(label_counts.min()) ** 0.5
    check(err < limit, f"kmeans centers recover the blob means ({err} >= {limit})")
    emit({"phase": "agreement", "policies": list(policies), "histogram_total": int(ref_h.sum()),
          "kmeans_counts": ref_n.tolist(), "kmeans_max_center_error": err})
    return launches


def kernel_checks(x_hist, x_km, seed: int, launches: dict) -> list[dict]:
    """Each kernel at the main path's per-task shape, against its plain version."""
    from repro_torch.core.apps.kmeans import _init_centers
    from repro_torch.kernels import partition_reduce as pr

    out = []
    ids = x_hist.blocks_at(0)
    blocks = [x_hist.block(b) for b in ids]
    st = torch.stack(blocks)
    stack_ms = cuda_ms(lambda: torch.stack(blocks))
    nb, rows, d = st.shape
    got = pr.partition_histogramdd(st, bins=HIST_BINS)
    want = pr.partition_histogramdd_ref(st, bins=HIST_BINS)
    check(torch.equal(got, want), "partition_histogramdd equals its plain version")
    big = pr.partition_histogramdd(st, bins=16)  # 2**20 cells: the global-atomic variant
    check(torch.equal(big, pr.partition_histogramdd_ref(st, bins=16)),
          "partition_histogramdd (2**20 cells) equals its plain version")
    ms = cuda_ms(lambda: pr.partition_histogramdd(st, bins=HIST_BINS))
    plain_ms = cuda_ms(lambda: pr.partition_histogramdd_ref(st, bins=HIST_BINS))
    big_ms = cuda_ms(lambda: pr.partition_histogramdd(st, bins=16))
    bound_ms, bound_by = bound(st.numel() * 4 + HIST_BINS**d * 4, 3 * st.numel())
    out.append({
        "name": "partition_histogramdd", "route": "cuda",
        "source": "src/repro_torch/csrc/partition_histogramdd.cu",
        "replaces": "src/repro/kernels/partition_reduce.py:146",
        "launches": launches["partition_histogramdd"],
        "max_abs_err": int((got - want).abs().max()), "tolerance": "bit-exact",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "library": "none: no single PyTorch call computes it",
        "shape": [nb, rows, d], "bins": HIST_BINS, "stack_ms": stack_ms,
        "ms_2pow20_cells": big_ms,
    })

    ids = x_km.blocks_at(0)
    blocks = [x_km.block(b) for b in ids]
    st = torch.stack(blocks)
    stack_ms = cuda_ms(lambda: torch.stack(blocks))
    nb, rows, d = st.shape
    c = _init_centers(seed, KM_K, KM_D, torch.float32, st.device)
    sums, cnt = pr.partition_kmeans(st, c)
    rsums, rcnt = pr.partition_kmeans_ref(st, c)
    check(torch.equal(cnt, rcnt), "partition_kmeans counts equal its plain version")
    check(torch.allclose(sums, rsums, rtol=1e-4, atol=1e-3),
          "partition_kmeans sums within 1e-4 of its plain version")
    x64, c64 = st.reshape(-1, d).double(), c.double()
    d2 = torch.sort((c64 * c64).sum(1)[None, :] - 2.0 * x64 @ c64.T, dim=1).values
    near_ties = int(((d2[:, 1] - d2[:, 0]) <= 1e-4).sum())
    check(near_ties == 0, f"no float64 near-tie rows ({near_ties})")
    del x64, d2
    ms = cuda_ms(lambda: pr.partition_kmeans(st, c))
    plain_ms = cuda_ms(lambda: pr.partition_kmeans_ref(st, c))
    n = nb * rows
    bound_ms, bound_by = bound(
        st.numel() * 4 + 2 * KM_K * d * 4 + KM_K * 4, n * KM_K * (2 * d + 1) + n * d
    )
    out.append({
        "name": "partition_kmeans", "route": "cuda",
        "source": "src/repro_torch/csrc/partition_kmeans.cu",
        "replaces": "src/repro/kernels/partition_reduce.py:211",
        "launches": launches["partition_kmeans"],
        "max_abs_err": float((sums - rsums).abs().max()),
        "max_rel_err": float(((sums - rsums).abs() / rsums.abs().clamp_min(1.0)).max()),
        "tolerance": "counts exact, sums rtol 1e-4",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "library": "none: no single PyTorch call computes it",
        "shape": [nb, rows, d], "k": KM_K, "near_tie_rows": near_ties, "stack_ms": stack_ms,
    })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3, help="timed runs after one warm-up")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' products in f32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core.blocked import BlockedArray, round_robin_placement
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libraries = _build.build(verbose=True)  # prints registers/spills per kernel
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [p.name for p in libraries.values()]})

    dev = torch.device("cuda", 0)
    hist, km, means, label_counts = make_data(args.seed, dev)
    x_hist, x_km = (
        BlockedArray.from_array(a, BLOCK_ROWS, num_locations=LOCATIONS,
                                policy=round_robin_placement, device=dev)
        for a in (hist, km)
    )
    launches = main_path(x_hist, x_km, means, label_counts, args.seed, args.repeats)
    check(all(v > 0 for v in launches.values()), f"every kernel launched: {launches}")
    kernels = kernel_checks(x_hist, x_km, args.seed, launches)
    emit({"kernels": kernels})
    torch.cuda.synchronize()
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
