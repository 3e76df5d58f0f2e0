"""Blocked distributed collections — the substrate the SplIter operates on.

The paper's frameworks (COMPSs+dataClay, Dask) hold a dataset as a set of
*blocks* distributed across *nodes*.  Here a :class:`BlockedArray` holds a
dataset as a sequence of row-blocks (torch tensors), each with an explicit
*placement* — a logical location id that models "which node/backend holds
this block".  The task engine (``repro_torch.core.engine``) dispatches work
per block / per partition and uses placements for locality.

Blocks are dense ``(block_rows, *row_shape)`` tensors.  The *global order*
of rows (paper §4.1) is ``block_id``-major: row ``r`` of block ``b`` has
global index ``offset[b] + r``.  :meth:`BlockedArray.from_array` cuts the
blocks as views of the input: no copy.

**Devices.**  The card is the default: ``from_array`` and ``from_blocks``
put the data on ``device="cuda"`` and raise when no GPU is present, so a
CPU run is always one the caller asked for (``device="cpu"``).  Everything
downstream follows the blocks' device.

**Out-of-core blocks.**  A block may also be a
:class:`~repro_torch.api.chunkstore.ChunkRef` — a metadata handle (same
``shape``/``dtype``/``nbytes`` surface as a tensor) whose buffer lives in a
store and materializes only at dispatch time.  All geometry here is
metadata-only; anything that needs buffer contents goes through
:meth:`BlockedArray.block` / :meth:`BlockedArray.iter_blocks`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = [
    "BlockedArray",
    "PlacementPolicy",
    "resolve_device",
    "round_robin_placement",
    "contiguous_placement",
]

# A placement policy maps (num_blocks, num_locations) -> per-block location ids.
PlacementPolicy = Callable[[int, int], np.ndarray]


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device must exist.

    The port never falls back to the CPU on its own: a CUDA request on a
    host without a GPU raises, and the caller who wants the CPU says so.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``; a numpy input is copied (it may be read-only)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.array(x), device=device)


def round_robin_placement(num_blocks: int, num_locations: int) -> np.ndarray:
    """Block *b* lives on location ``b % L`` — models Dask's default scatter."""
    return np.arange(num_blocks, dtype=np.int32) % num_locations


def contiguous_placement(num_blocks: int, num_locations: int) -> np.ndarray:
    """Consecutive runs of blocks per location — models dislib/dataClay fills."""
    per = math.ceil(num_blocks / num_locations)
    return (np.arange(num_blocks, dtype=np.int32) // per).clip(0, num_locations - 1)


@dataclasses.dataclass(frozen=True)
class BlockedArray:
    """A row-blocked dataset with explicit block placement.

    Attributes:
      blocks: tuple of ``(rows_b, *row_shape)`` tensors — or
        :class:`~repro_torch.api.chunkstore.ChunkRef` handles to store-held
        buffers — in global order.
      placements: int32 array ``(num_blocks,)`` — logical location per block.
      num_locations: number of logical locations (nodes/backends/devices).
    """

    blocks: tuple
    placements: np.ndarray
    num_locations: int

    def __post_init__(self):
        assert len(self.blocks) == len(self.placements), (
            len(self.blocks),
            len(self.placements),
        )
        assert len(self.blocks) > 0, "empty BlockedArray"
        row_shape = self.blocks[0].shape[1:]
        for b in self.blocks:
            assert b.shape[1:] == row_shape, "inconsistent row shapes"

    # -- construction ------------------------------------------------------

    @classmethod
    def from_array(
        cls,
        x,
        block_rows: int,
        *,
        num_locations: int = 1,
        policy: PlacementPolicy = contiguous_placement,
        store=None,
        device: str | torch.device = "cuda",
    ) -> "BlockedArray":
        """Split ``x`` (tensor or ndarray) along axis 0 into row blocks.

        ``x`` is first placed on ``device``; the blocks are views of it.
        The final block may be short (ragged tail), exactly like a Dask
        array whose shape is not a multiple of the chunk size.  With
        ``store`` each block is ``put`` into the store and the collection
        holds :class:`~repro_torch.api.chunkstore.ChunkRef` handles.
        """
        x = _as_tensor(x, resolve_device(device))
        n = x.shape[0]
        assert block_rows >= 1
        nb = math.ceil(n / block_rows)
        blocks = tuple(x[i * block_rows : (i + 1) * block_rows] for i in range(nb))
        if store is not None:
            blocks = tuple(store.put(b) for b in blocks)
        return cls(blocks, policy(nb, num_locations), num_locations)

    @classmethod
    def from_blocks(
        cls,
        blocks: Sequence,
        placements: Sequence[int] | np.ndarray,
        num_locations: int,
        *,
        device: str | torch.device = "cuda",
    ) -> "BlockedArray":
        """Wrap existing blocks (tensors or ndarrays) with their placements.

        Numpy blocks are accepted so a layout built elsewhere — ragged
        tails and custom placements included — can be carried over block
        for block.
        """
        dev = resolve_device(device)
        return cls(
            tuple(_as_tensor(b, dev) for b in blocks),
            np.asarray(placements, np.int32),
            num_locations,
        )

    # -- geometry ----------------------------------------------------------

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    @property
    def row_shape(self) -> tuple[int, ...]:
        return tuple(self.blocks[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    @property
    def block_rows(self) -> tuple[int, ...]:
        return tuple(b.shape[0] for b in self.blocks)

    @property
    def num_rows(self) -> int:
        return sum(self.block_rows)

    @property
    def nbytes(self) -> int:
        return sum(int(np.prod(b.shape)) * b.dtype.itemsize for b in self.blocks)

    @property
    def uniform(self) -> bool:
        """True when every block has the same number of rows."""
        rows = self.block_rows
        return all(r == rows[0] for r in rows)

    def row_offsets(self) -> np.ndarray:
        """Global row index of the first row of each block (paper §4.1)."""
        return np.concatenate([[0], np.cumsum(self.block_rows)[:-1]]).astype(np.int64)

    def blocks_at(self, location: int) -> list[int]:
        """The block ids resident at ``location`` — the `who_has` query."""
        return [int(i) for i in np.nonzero(self.placements == location)[0]]

    # -- buffer access (resolves chunk refs) --------------------------------

    def block(self, i: int) -> torch.Tensor:
        """Block ``i``'s buffer, resolving a chunk ref if necessary."""
        from repro_torch.api.chunkstore import resolve_chunk

        return resolve_chunk(self.blocks[i])

    def iter_blocks(self):
        """Yield resolved block buffers in global order, one at a time."""
        for i in range(len(self.blocks)):
            yield self.block(i)

    @property
    def is_chunked(self) -> bool:
        """True when any block is a store-held chunk reference."""
        from repro_torch.api.chunkstore import ChunkRef

        return any(isinstance(b, ChunkRef) for b in self.blocks)

    def to_store(self, store) -> "BlockedArray":
        """Move every block into ``store``; same blocking, ref-backed."""
        from repro_torch.api.chunkstore import resolve_chunk

        refs = tuple(store.put(resolve_chunk(b)) for b in self.blocks)
        return BlockedArray(refs, self.placements, self.num_locations)

    # -- conversions -------------------------------------------------------

    def collect(self) -> torch.Tensor:
        """Concatenate all blocks in global order (a full gather)."""
        return torch.cat(list(self.iter_blocks()), dim=0)

    def stacked(self) -> torch.Tensor:
        """Stack uniform blocks into ``(num_blocks, block_rows, *row_shape)``."""
        assert self.uniform, "stacked() requires uniform block sizes"
        return torch.stack(list(self.iter_blocks()), dim=0)

    def with_placements(self, placements: np.ndarray, num_locations: int) -> "BlockedArray":
        return BlockedArray(self.blocks, np.asarray(placements, np.int32), num_locations)
