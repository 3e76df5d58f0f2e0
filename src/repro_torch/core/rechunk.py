"""rechunk — the materializing competitor (paper §3.2.1, §4.2).

``rechunk(x, new_block_rows)`` builds a **new** :class:`BlockedArray` whose
blocks have a different size.  Unlike the SplIter it materializes data:
rows generally cross location boundaries, so the operation *moves bytes
between locations* and temporarily doubles the footprint — exactly the costs
the paper charges against Dask's ``rechunk``.

:class:`RechunkStats` counts inter-location traffic (bytes whose source and
destination locations differ) and the materialized footprint, so benchmarks
can report them next to wall-clock.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.blocked import BlockedArray, contiguous_placement, PlacementPolicy

__all__ = ["rechunk", "RechunkStats"]


@dataclasses.dataclass(frozen=True)
class RechunkStats:
    """Cost accounting for one rechunk operation."""

    bytes_total: int        # full materialized size (the 2x footprint term)
    bytes_moved: int        # inter-location traffic (src loc != dst loc)
    blocks_before: int
    blocks_after: int

    @property
    def is_noop(self) -> bool:
        return self.bytes_moved == 0 and self.blocks_before == self.blocks_after


def rechunk(
    x: BlockedArray,
    new_block_rows: int,
    *,
    policy: PlacementPolicy = contiguous_placement,
) -> tuple[BlockedArray, RechunkStats]:
    """Materialize ``x`` at a new block size (global order preserved).

    Returns the new collection plus the traffic/footprint accounting.  The
    data path is a genuine gather + re-split (not a metadata trick), matching
    Dask semantics: the result is a standalone array with its own placement.
    """
    assert new_block_rows >= 1
    n = x.num_rows
    nb_new = math.ceil(n / new_block_rows)
    new_placements = policy(nb_new, x.num_locations)

    # --- movement accounting (row-granular, before touching data) ---------
    row_bytes = int(np.prod(x.row_shape)) * x.dtype.itemsize if x.row_shape else x.dtype.itemsize
    src_loc = np.repeat(x.placements, np.asarray(x.block_rows))          # (n,)
    dst_block = np.minimum(np.arange(n) // new_block_rows, nb_new - 1)
    dst_loc = new_placements[dst_block]                                   # (n,)
    moved_rows = int(np.sum(src_loc != dst_loc))
    stats = RechunkStats(
        bytes_total=n * row_bytes,
        bytes_moved=moved_rows * row_bytes,
        blocks_before=x.num_blocks,
        blocks_after=nb_new,
    )

    # --- the materialization itself ---------------------------------------
    if nb_new == x.num_blocks and all(r == new_block_rows for r in x.block_rows[:-1]):
        # Same chunking: Dask's rechunk is a no-op; keep the original buffers.
        return x.with_placements(new_placements, x.num_locations), stats

    # collect() resolves chunk-backed blocks — rechunk IS the materializing
    # competitor, so an out-of-core source pays a full gather here.
    full = x.collect()
    blocks = tuple(
        full[i * new_block_rows : min((i + 1) * new_block_rows, n)] for i in range(nb_new)
    )
    return (
        BlockedArray(blocks, new_placements, x.num_locations),
        stats,
    )
