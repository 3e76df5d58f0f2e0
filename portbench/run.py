"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  It needs as many CUDA devices as the cell asks
for, and the program under ``src/``, and keeps to one CPU.  The last line of
standard output is the result, one JSON object; the last lines of standard
error are the numbers compared, each beside its limit.  A run that finds JAX
or the JAX package loaded once the window has closed prints no result and
exits with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # One CPU for the whole process, the last it may use, set before torch
    # starts a thread: the host's work per pass is a fifth of a histogram pass,
    # and runs left free to move between cores spread 2.5 times as wide.
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    # every cache of the run at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    sys.path.insert(0, str(ROOT / "src"))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from portbench import harness

    chips = next((c["chips"] for c in harness.load_benchmark(ROOT)["workloads"]
                  if c["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         device=torch.device("cuda", 0), root=ROOT, t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
