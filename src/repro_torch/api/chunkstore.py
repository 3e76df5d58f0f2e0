"""Chunk storage — block buffers behind references, resolved at dispatch time.

Following the chunks-and-tasks model (Rubensson & Rudberg, 2012 — tasks
name *chunk identifiers*, the runtime manages where chunk data lives), a
block of a :class:`~repro_torch.core.blocked.BlockedArray` may be a
:class:`ChunkRef`: a tiny metadata handle (shape/dtype/device + a store id)
whose buffer a store materializes only when a task's operands are built.
Everything metadata-only — placement scans, splits, regroups, lowering —
keeps working on refs without touching bytes.

This module holds what lowering and the executors import:
:class:`ChunkRef`, :func:`resolve_chunk`, :func:`chunk_stores` and the
degenerate :class:`InMemoryStore` (chunks are resident tensors; no budget,
no spill).  Executors snapshot each store's :class:`StoreStats` around an
execution and report the deltas as ``EngineReport.bytes_loaded`` /
``bytes_spilled`` / ``prefetch_hits``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterable

import numpy as np
import torch

__all__ = [
    "ChunkRef",
    "ChunkStoreError",
    "InMemoryStore",
    "StoreStats",
    "resolve_chunk",
    "chunk_stores",
]


class ChunkStoreError(RuntimeError):
    """A chunk operation failed (unknown ref, closed store, ...)."""


class ChunkRef:
    """A reference to one block held by a chunk store.

    Mirrors the metadata surface of a tensor (``shape``, ``dtype``,
    ``device``, ``nbytes``) so geometry code works on refs without
    resolving them.  The buffer materializes only through :meth:`resolve`.
    """

    __slots__ = ("store", "chunk_id", "shape", "dtype", "device", "__weakref__")

    def __init__(self, store, chunk_id: int, shape: tuple, dtype: torch.dtype,
                 device: torch.device):
        self.store = store
        self.chunk_id = chunk_id
        self.shape = tuple(shape)
        self.dtype = dtype
        self.device = device

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.dtype.itemsize

    def resolve(self) -> torch.Tensor:
        """Materialize the chunk's buffer."""
        return self.store.get(self)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"ChunkRef(id={self.chunk_id}, shape={self.shape}, "
            f"dtype={self.dtype}, store={type(self.store).__name__})"
        )


def resolve_chunk(block):
    """``block`` if it is already a tensor, else the resolved chunk buffer."""
    if isinstance(block, ChunkRef):
        return block.resolve()
    return block


def chunk_stores(arrays: Iterable) -> list:
    """Distinct stores backing any chunk-ref blocks of ``arrays``."""
    out: list = []
    for a in arrays:
        for b in getattr(a, "blocks", ()):
            if isinstance(b, ChunkRef) and b.store not in out:
                out.append(b.store)
    return out


@dataclasses.dataclass
class StoreStats:
    """Counters over one store's lifetime (executors report window deltas)."""

    loads: int = 0               # spill-file reads (disk -> resident)
    bytes_loaded: int = 0
    spills: int = 0              # spill-file writes (first eviction only)
    bytes_spilled: int = 0
    evictions: int = 0           # residency-cache drops (incl. free re-drops)
    prefetch_hits: int = 0       # get() served by an earlier prefetch()
    resident_bytes: int = 0
    peak_resident_bytes: int = 0

    def snapshot(self) -> "StoreStats":
        return dataclasses.replace(self)


class InMemoryStore:
    """Chunks as permanently-resident tensors.

    No budget, no spill, no accounting beyond ``resident_bytes``: a plan
    over an ``InMemoryStore``-backed collection behaves (and reports)
    exactly like one over raw block tensors.

    >>> import torch
    >>> store = InMemoryStore()
    >>> ref = store.put(torch.arange(4.0))
    >>> ref.shape, ref.nbytes, float(resolve_chunk(ref).sum())
    ((4,), 16, 6.0)
    """

    def __init__(self):
        self.stats = StoreStats()
        self._chunks: dict[int, torch.Tensor] = {}
        self._next_id = 0
        self._lock = threading.Lock()

    def put(self, array: torch.Tensor) -> ChunkRef:
        with self._lock:
            cid = self._next_id
            self._next_id += 1
            self._chunks[cid] = array
            self.stats.resident_bytes += array.nbytes
            self.stats.peak_resident_bytes = max(
                self.stats.peak_resident_bytes, self.stats.resident_bytes
            )
        return ChunkRef(self, cid, array.shape, array.dtype, array.device)

    def get(self, ref: ChunkRef) -> torch.Tensor:
        try:
            return self._chunks[ref.chunk_id]
        except KeyError:
            raise ChunkStoreError(f"unknown or released chunk {ref.chunk_id}") from None

    def pin(self, ref: ChunkRef) -> None:  # resident forever: nothing to guard
        pass

    def unpin(self, ref: ChunkRef) -> None:
        pass

    def prefetch(self, refs: Iterable[ChunkRef]) -> None:  # already resident
        pass

    def trim(self) -> None:  # in-memory chunks cannot be dropped
        pass

    def close(self) -> None:
        with self._lock:
            self._chunks.clear()
            self.stats.resident_bytes = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
