"""Published peaks of the chips the benchmark runs on.

NVIDIA H100 SXM5 (NVIDIA's H100 Tensor Core GPU data sheet, SXM column, dense
rates, at the full 700 W power limit): HBM3 bandwidth and the arithmetic peak
of each precision a kernel may compute in.  float32 outside the tensor cores
is 67 TFLOP/s; the tensor cores' rates are for kernels that use them.
"""

from __future__ import annotations

import subprocess

__all__ = ["PEAKS", "peak_for", "power_limit"]

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "flops_per_s": {
            "float32": 67e12,
            "tf32": 495e12,
            "bfloat16": 989e12,
            "float16": 989e12,
            "fp8": 1979e12,
        },
    },
}


def peak_for(kind: str) -> dict | None:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None for a card the table does not hold."""
    return PEAKS.get(kind)


def power_limit(index: int = 0) -> str | None:
    """Card ``index``'s name and power limit as ``nvidia-smi`` reads them (a
    card set below 700 W runs slower under load than its peaks say), or None
    where they cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 and out.stdout.strip() else None
