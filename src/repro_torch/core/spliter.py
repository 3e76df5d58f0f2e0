"""SplIter — split a blocked collection into locality partitions, then iterate.

This is the paper's contribution (§4).  ``spliter(x)`` queries the placement
of every block of ``x`` and yields :class:`Partition` objects:

* a partition groups blocks that live on a **single location** (locality —
  paper: "Each partition is located in a single node");
* grouping is **logical**: a partition holds *references* to the original
  block buffers — zero data movement, zero transformation (the key contrast
  with ``rechunk``);
* the number of partitions adapts to the *computing capability* of the
  environment (paper: nodes × cores) via ``partitions_per_location``;
* ordering metadata is carried along (paper §4.1): ``get_indexes()`` returns
  the global block ids, ``get_item_indexes()`` the global row ids.

A partition can optionally be **materialized** (paper §7 future work): its
blocks are concatenated *locally* — an intra-location copy with no
inter-node transfer.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.blocked import BlockedArray

__all__ = ["Partition", "spliter", "split", "stripe_local_blocks"]


@dataclasses.dataclass(frozen=True)
class Partition:
    """A logical, single-location group of blocks of a :class:`BlockedArray`.

    Holds references, never copies.  ``block_ids`` are *global* block indices
    in ascending order, mirroring the paper's partition construction.
    """

    source: BlockedArray
    location: int
    block_ids: tuple[int, ...]

    # -- iteration (the "Iter" in SplIter) ----------------------------------

    def __iter__(self) -> Iterator[torch.Tensor]:
        for b in self.block_ids:
            yield self.source.block(b)

    def __len__(self) -> int:
        return len(self.block_ids)

    @property
    def blocks(self) -> list[torch.Tensor]:
        return [self.source.block(b) for b in self.block_ids]

    @property
    def num_rows(self) -> int:
        return int(sum(self.source.block_rows[b] for b in self.block_ids))

    # -- ordering metadata (paper §4.1) --------------------------------------

    def get_indexes(self) -> list[int]:
        """Global block indices of this partition's blocks (paper Fig. 4)."""
        return list(self.block_ids)

    def get_item_indexes(self) -> np.ndarray:
        """Global row indices of every element, concatenated in block order."""
        offs = self.source.row_offsets()
        rows = self.source.block_rows
        return np.concatenate(
            [np.arange(offs[b], offs[b] + rows[b], dtype=np.int64) for b in self.block_ids]
        )

    # -- materialization (paper §7) ------------------------------------------

    def materialize(self) -> torch.Tensor:
        """Local concat of the partition's blocks.  Intra-location copy only."""
        return torch.cat(self.blocks, dim=0)

    def stacked(self) -> torch.Tensor:
        """Stack (uniform blocks) into ``(k, block_rows, *row_shape)`` — the
        input of the fused per-partition task."""
        return torch.stack(self.blocks, dim=0)


def stripe_local_blocks(
    local: Sequence[int], partitions_per_location: int
) -> list[tuple[int, ...]]:
    """Balanced striping of one location's block ids into sub-partitions.

    The single source of truth for how ``partitions_per_location`` divides a
    location's blocks: :func:`spliter` and the executors' regroup-without-
    resplit path must agree block-for-block.
    """
    k = min(partitions_per_location, len(local))
    return [tuple(local[s::k]) for s in range(k)]


def spliter(
    x: BlockedArray,
    *,
    partitions_per_location: int = 1,
) -> list[Partition]:
    """Split ``x`` into locality partitions (the paper's ``split()``).

    Returns partitions ordered by (location, sub-partition).  Locations that
    hold no blocks yield no partitions.  Every block appears in exactly one
    partition.
    """
    assert partitions_per_location >= 1
    parts: list[Partition] = []
    for loc in range(x.num_locations):
        local = x.blocks_at(loc)
        if not local:
            continue
        for ids in stripe_local_blocks(local, partitions_per_location):
            parts.append(Partition(source=x, location=loc, block_ids=ids))
    return parts


# The paper's listings call it ``split(experiment)``; keep that alias.
split = spliter
