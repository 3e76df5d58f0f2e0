"""Readings that the correctness limits are set from, at a cell's own size.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--control]

For each seed: the cell's rows from the seed, the set-up's warm pass and one
job through the timed path (the window's entry and executor), then the
program's readings against the plain reference: the lower readings.  With
``--control`` also the control's: the reference computed in the precision
below the configuration's, put in the program's place (the upper readings).
One JSON line per seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from portbench import generator, harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = harness.load_benchmark(ROOT)
    cell = next(c for c in bench["workloads"] if c["name"] == args.workload)
    cfg, traffic = harness.cell_files(ROOT, cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        app = harness.app_class(cfg["app"])(cfg, traffic, seed, device)
        ex = generator.executor(traffic)
        app.warm(ex)
        app.job(ex, 0)
        torch.cuda.synchronize(device)
        ex.close()
        del ex
        gc.collect()
        t1 = time.perf_counter()
        ref = app.reference()
        torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed,
                "program": app.compare(app.answer(), ref),
                "program_s": t1 - t0, "reference_s": t2 - t1}
        if args.control:
            line["control"] = app.compare(app.reference(control=True), ref)
        print(json.dumps(line), flush=True)
        del app, ref
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
