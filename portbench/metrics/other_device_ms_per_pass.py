"""other_device_ms_per_pass: device time per pass of every device operation
but the partition kernels that ``portbench/work/`` counts (the wrappers'
copies, the merges, the centers' update, memsets and copies)."""

from pathlib import Path

from portbench.harness import work_module
from portbench.trace import kernel_seconds


def read(w):
    if w.trace is None or not w.passes:
        return None
    kernels = [n for p in sorted(Path(__file__).parents[1].joinpath("work").glob("*.py"))
               if not p.name.startswith("_") for n in work_module(p.stem).KERNELS]
    return 1e3 * (w.trace.device_s - kernel_seconds(w.trace, kernels)) / w.passes
