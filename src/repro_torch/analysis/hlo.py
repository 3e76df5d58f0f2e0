"""HLO text analysis: collective-op operand bytes, op census.

``cost_analysis()`` does not expose collective traffic, so we parse the
SPMD-partitioned module text: every ``all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute`` instruction's *operand*
bytes are summed (the spec's definition of collective_bytes).  The
partitioned module is per-device, so the sum is per-chip wire traffic.

Caveat handled upstream (roofline.py): instructions inside a ``while`` body
execute trip-count times but appear once in the text — the roofline uses
unrolled probe compiles, and this parser is also used to *verify* the probe
fit against trip-count-scaled scanned modules.

Copied from ``repro/analysis/hlo.py`` (it holds no JAX).  The port has no
HLO: its dry-run (``repro_torch.launch.dryrun_lib``) fills the same
:class:`CollectiveStats` from a census its collectives record as they run
(``repro_torch.distributed.spmd.collective_census``), under XLA's kind
names, so both packages' records read alike.
"""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16, "token": 0,
}

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# `%name = f32[8,128]{1,0} op-name(...)` (also matches tuple-free defs)
_DEF_RE = re.compile(r"%?([\w.\-]+)\s*=\s*\(?([a-z0-9_]+)\[([\d,]*)\]")
_INSTR_RE = re.compile(
    r"%?([\w.\-]+)\s*=\s*(.+?)\s+(" + "|".join(COLLECTIVES) + r")(?:-start|-done)?\("
)


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


@dataclasses.dataclass
class CollectiveStats:
    """Per-kind operand/result bytes of collectives in one HLO module."""

    operand_bytes: dict[str, int]
    result_bytes: dict[str, int]
    counts: dict[str, int]

    @property
    def total_operand_bytes(self) -> int:
        return sum(self.operand_bytes.values())

    @property
    def total_result_bytes(self) -> int:
        return sum(self.result_bytes.values())

    def as_dict(self) -> dict:
        return {
            "operand_bytes": dict(self.operand_bytes),
            "result_bytes": dict(self.result_bytes),
            "counts": dict(self.counts),
            "total_operand_bytes": self.total_operand_bytes,
            "total_result_bytes": self.total_result_bytes,
        }


def parse_collectives(hlo_text: str) -> CollectiveStats:
    # first pass: instruction name -> byte size of its (first) result shape
    sizes: dict[str, int] = {}
    for m in _DEF_RE.finditer(hlo_text):
        name, dtype, dims = m.groups()
        if dtype in _DTYPE_BYTES:
            sizes[name] = _shape_bytes(dtype, dims)

    operand_bytes: dict[str, int] = defaultdict(int)
    result_bytes: dict[str, int] = defaultdict(int)
    counts: dict[str, int] = defaultdict(int)

    for line in hlo_text.splitlines():
        line = line.strip()
        mm = None
        kind = None
        for c in COLLECTIVES:
            # match ` <kind>(` or `<kind>-start(` as the op of this line
            m2 = re.search(r"\s(" + c + r")(?:-start)?\(", line)
            if m2 and "=" in line.split(m2.group(0))[0]:
                mm, kind = m2, c
                break
        if not mm:
            continue
        counts[kind] += 1
        # result bytes: shape(s) on the LHS
        lhs = line.split("=", 1)[0]
        rhs_from_op = line[mm.end():]
        head = line.split("=", 1)[1]
        for ms in re.finditer(r"([a-z0-9_]+)\[([\d,]*)\]", head.split(mm.group(0))[0]):
            dt, dims = ms.groups()
            if dt in _DTYPE_BYTES:
                result_bytes[kind] += _shape_bytes(dt, dims)
        # operand bytes: resolve %refs inside the call parens
        depth = 0
        args = ""
        for ch in rhs_from_op:
            if ch == "(":
                depth += 1
            elif ch == ")":
                if depth == 0:
                    break
                depth -= 1
            args += ch
        for ref in re.finditer(r"%?([\w.\-]+)", args):
            nm = ref.group(1)
            if nm in sizes:
                operand_bytes[kind] += sizes[nm]

    return CollectiveStats(
        operand_bytes=dict(operand_bytes),
        result_bytes=dict(result_bytes),
        counts=dict(counts),
    )
