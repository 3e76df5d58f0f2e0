"""Shared helpers of the benchmark's CPU tests: small sizes of each cell."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: Rows of each configuration at the tests' size: 64 rows a block under the
#: fragmented mix, and a whole number of blocks under every mix.
SMALL_ROWS = {"histogram-d5-b8": 8 * 64 * 64, "kmeans-d20-k8": 8 * 64 * 64}
