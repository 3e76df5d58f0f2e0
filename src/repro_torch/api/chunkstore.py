"""Chunk storage — block buffers behind references, resolved at dispatch time.

Following the chunks-and-tasks model (Rubensson & Rudberg, 2012 — tasks
name *chunk identifiers*, the runtime manages where chunk data lives), a
block of a :class:`~repro_torch.core.blocked.BlockedArray` may be a
:class:`ChunkRef`: a tiny metadata handle (shape/dtype/device + a store id)
whose buffer a :class:`ChunkStore` materializes only when a task's operands
are built.  Everything metadata-only — placement scans, splits, regroups,
lowering — keeps working on refs without touching bytes (asserted via
``StoreStats``).

Two stores:

:class:`InMemoryStore`
    Chunks are resident tensors; no budget, no spill, zero accounting.
:class:`DiskStore`
    Out-of-core store with an LRU *residency budget* in bytes on its
    device (the card by default): resident chunks are compact tensors
    there, up to ``residency_bytes``; eviction spills a never-written chunk
    to a ``.npy`` file (spill-on-eviction — a chunk that is never evicted
    never touches disk) and later accesses reload it, disk → pinned host
    buffer → card on a side CUDA stream.  ``pin``/``unpin`` (refcounted)
    protect the chunks a running task resolves from eviction; evicting a
    pinned chunk is refused with :class:`ChunkPinnedError`.

Example — a 64 KiB dataset streamed through a 16 KiB budget::

    >>> import numpy as np
    >>> store = DiskStore(residency_bytes=16 * 1024, device="cpu")
    >>> blocks = [np.full((1024,), i, np.float32) for i in range(16)]  # 4 KiB each
    >>> refs = [store.put(b) for b in blocks]
    >>> store.stats.resident_bytes <= 16 * 1024
    True
    >>> float(refs[0].resolve()[0])        # reloads the spilled chunk
    0.0
    >>> store.stats.bytes_spilled > 0 and store.stats.bytes_loaded > 0
    True
    >>> store.close()                      # removes every spill file

Accounting flows upward: executors snapshot each store's
:class:`StoreStats` around an execution and report the deltas as
``EngineReport.bytes_loaded`` / ``bytes_spilled`` / ``prefetch_hits``.

The handoff half — the store ``uid``, :class:`ChunkHandle`,
:class:`StoreManifest`, :class:`AttachedStore` and
:meth:`DiskStore.handle`/:meth:`DiskStore.manifest` — is how a cluster
worker process reads another process's store: chunks resident on the card
export as shared-memory descriptors (one copy to the host), spilled ones by
their files, and the worker's :class:`AttachedStore` puts each chunk on its
own device.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import shutil
import tempfile
import threading
import weakref
from typing import Iterable, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.api.shm import (
    ShmAttachments,
    dtype_str_of,
    torch_dtype,
)
from repro_torch.core.blocked import resolve_device

__all__ = [
    "ChunkRef",
    "ChunkHandle",
    "ChunkStore",
    "ChunkStoreError",
    "ChunkPinnedError",
    "InMemoryStore",
    "DiskStore",
    "AttachedStore",
    "StoreManifest",
    "StoreStats",
    "resolve_chunk",
    "chunk_stores",
]

# Store uids are process-scoped: a manifest shipped to a worker names its
# origin store, and the worker maps uid -> AttachedStore.  The pid prefix
# keeps uids unambiguous across a parent and its spawned workers.
_store_uid_lock = threading.Lock()
_store_uid_seq = 0


def _new_store_uid() -> str:
    global _store_uid_seq
    with _store_uid_lock:
        _store_uid_seq += 1
        return f"store-{os.getpid()}-{_store_uid_seq}"


class ChunkStoreError(RuntimeError):
    """A chunk operation failed (unknown ref, closed store, ...)."""


class ChunkPinnedError(ChunkStoreError):
    """Refused to evict a chunk that is pinned by a running task."""


class ChunkRef:
    """A reference to one block held by a :class:`ChunkStore`.

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
        """Materialize the chunk's buffer (loading from spill if needed)."""
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


@dataclasses.dataclass(frozen=True)
class ChunkHandle:
    """A picklable, store-independent pointer to one chunk.

    What crosses a process boundary instead of a :class:`ChunkRef` (whose
    ``store`` attribute holds locks and finalizers): the origin store's
    uid plus the chunk id and geometry.  A worker resolves a handle
    against the :class:`AttachedStore` it built from that store's
    :class:`StoreManifest` — bytes never transit the control channel.
    ``dtype_str`` follows :mod:`~repro_torch.api.shm`'s convention (a numpy
    type string, or ``"bfloat16"``).
    """

    store_uid: str
    chunk_id: int
    shape: tuple
    dtype_str: str

    @property
    def nbytes(self) -> int:
        size = torch_dtype(self.dtype_str).itemsize
        return int(np.prod(self.shape)) * size if self.shape else size


@dataclasses.dataclass(frozen=True)
class StoreManifest:
    """The handoff half of store attach: where every chunk's bytes live.

    Produced by :meth:`DiskStore.manifest` and consumed worker-side by
    :class:`AttachedStore`.  Picklable by construction; each entry is a
    tagged tuple naming its transport:

    ``("shm", ShmBlockRef)``
        The chunk was resident driver-side (on the card: copied to the
        host once) and exported into a shared memory segment.  The
        preferred path: no disk write, no pipe bytes.
    ``("file", path, shape, dtype_str)``
        The chunk has a spill file (it was evicted, or the shm budget was
        exhausted): workers read the ``.npy``, whose elements are the raw
        bits of ``dtype_str`` as integers of its size.

    Manifests of a grown store are **incremental**: ``manifest(known=...)``
    returns only the chunks the caller has not seen, and
    :meth:`AttachedStore.merge` folds the delta into an existing attach.
    """

    uid: str
    spill_dir: str
    chunks: dict  # chunk_id -> ("shm", ShmBlockRef) | ("file", path, shape, dtype_str)


class AttachedStore:
    """A worker-side, read-only view of another process's DiskStore.

    Resolves :class:`ChunkHandle`\\ s against the manifest's tagged entries
    onto the caller's device: ``shm`` chunks from the origin's segments
    (attached once per segment, cached; on the card, one host-to-device
    copy), ``file`` chunks by reading the spill files.  There is no
    residency budget and no cache: every resolve returns a fresh tensor the
    caller owns, so no queued kernel can see its block reused by the store.
    ``stats.bytes_loaded`` bills only the *disk* reads — shm resolution
    moves no bytes the parent has not already paid for (billed once as
    ``shm_bytes``).
    """

    def __init__(self, manifest: StoreManifest):
        self.manifest = manifest
        self.stats = StoreStats()
        self._shm = ShmAttachments()

    @property
    def uid(self) -> str:
        return self.manifest.uid

    def merge(self, delta: StoreManifest) -> None:
        """Fold a grown store's incremental manifest into this attach."""
        if delta.uid != self.uid:
            raise ChunkStoreError(f"manifest for store {delta.uid} merged into {self.uid}")
        self.manifest.chunks.update(delta.chunks)

    def get(self, chunk_id: int, device: torch.device | str = "cpu") -> torch.Tensor:
        entry = self.manifest.chunks.get(chunk_id)
        if entry is None:
            raise ChunkStoreError(f"chunk {chunk_id} not in manifest of store {self.uid}")
        device = torch.device(device)
        if entry[0] == "shm":
            return self._shm.tensor(entry[1], device)
        _tag, path, _shape, dtype_str = entry
        mm = np.load(path, mmap_mode="r")
        bits = torch.from_numpy(np.array(mm))  # copy out of the mmap, then free it
        del mm
        arr = bits.view(torch_dtype(dtype_str)).to(device)
        self.stats.loads += 1
        self.stats.bytes_loaded += arr.nbytes
        return arr

    def resolve(self, handle: ChunkHandle, device: torch.device | str = "cpu") -> torch.Tensor:
        if handle.store_uid != self.uid:
            raise ChunkStoreError(
                f"handle for store {handle.store_uid} resolved against {self.uid}"
            )
        return self.get(handle.chunk_id, device)

    def close(self) -> None:
        self._shm.close()


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


@runtime_checkable
class ChunkStore(Protocol):
    """The storage contract blocks-as-references rely on.

    ``put`` registers a buffer and returns its :class:`ChunkRef`; ``get``
    materializes a ref (the dispatch-time resolve); ``pin``/``unpin`` are
    refcounted eviction guards around a task's lifetime; ``prefetch``
    loads ahead of use (a later ``get`` of a still-resident prefetched
    chunk counts as a ``prefetch_hit``); ``trim`` sheds all unpinned
    residency (executors call it when a prepared dataset falls out of the
    cache); ``close`` releases every resource, including spill files.

    >>> isinstance(InMemoryStore(), ChunkStore)
    True
    >>> isinstance(DiskStore(residency_bytes=1 << 20, device="cpu"), ChunkStore)
    True
    """

    stats: StoreStats

    def put(self, array) -> ChunkRef: ...

    def get(self, ref: ChunkRef) -> torch.Tensor: ...

    def pin(self, ref: ChunkRef) -> None: ...

    def unpin(self, ref: ChunkRef) -> None: ...

    def prefetch(self, refs: Iterable[ChunkRef]) -> None: ...

    def trim(self) -> None: ...

    def close(self) -> None: ...


class InMemoryStore:
    """Chunks as permanently-resident tensors.

    No budget, no spill, no accounting beyond ``resident_bytes``: a plan
    over an ``InMemoryStore``-backed collection behaves (and reports)
    exactly like one over raw block tensors.

    >>> store = InMemoryStore()
    >>> ref = store.put(torch.arange(4.0))
    >>> ref.shape, ref.nbytes, float(resolve_chunk(ref).sum())
    ((4,), 16, 6.0)
    """

    def __init__(self):
        self.uid = _new_store_uid()
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


#: the integer type a spill file stores each element's bits as, by size
_BITS_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


class DiskStore:
    """LRU-budgeted residency on a device over ``.npy`` spill blocks.

    Args:
      residency_bytes: target bound on resident chunk bytes on ``device``.
        Eviction keeps unpinned residency under the budget; pinned chunks
        are never evicted, so the *peak* can transiently exceed the budget
        by the pinned working set (a streaming executor pins at most the
        current and the prefetched partition — the double buffer).
      device: where resident chunks live (default the card; raises, as
        :func:`~repro_torch.core.blocked.resolve_device` does, on a host
        without one unless ``device="cpu"``).
      spill_dir: directory for spill files.  Default: a fresh temp dir,
        removed on :meth:`close` (and by a GC/atexit finalizer if the
        store is never closed — no temp-file leaks).

    Lifecycle of a chunk: ``put`` → a compact copy resident on ``device``
    (dirty, no file; a view's parent is never kept alive) → eviction spills
    it to ``chunk<id>.npy`` once (two-phase: the tensor moves to a pending
    queue under the lock, the copy to the host and the ``np.save`` run
    outside it, so spill I/O never blocks concurrent gets or prefetch
    inserts) → later ``get``/``prefetch`` reload it → further evictions are
    free drops.  Files hold each element's raw bits as an integer of its
    size, the torch dtype stays in the chunk's metadata: every dtype
    (bf16 included) round-trips bit for bit.

    On a CUDA device a reload reads the file into a pinned host buffer and
    copies it to the card without blocking on a side stream owned by the
    store; the side stream is synchronised before the load counts as done.
    A spill copies the tensor to a pinned host buffer on the same stream,
    after the event its ``put`` recorded.

    **Stream order.**  A kernel that reads a chunk may still be queued on
    the consumer's stream when eviction drops the store's last reference.
    The caching allocator then hands the block to the next allocation on
    the stream that allocated it — for a reloaded chunk, this store's side
    stream, whose next reload would overwrite the block under the queued
    kernel.  So every :meth:`get` of a CUDA chunk calls
    ``record_stream(torch.cuda.current_stream())``: the allocator reuses
    the block only after the work queued on the consumer's stream at the
    time of the free.  It costs nothing on the consumer's stream and needs
    no bookkeeping in the store.
    """

    def __init__(
        self,
        residency_bytes: int,
        *,
        device: str | torch.device = "cuda",
        spill_dir: str | None = None,
    ):
        if residency_bytes < 1:
            raise ValueError(f"residency_bytes must be >= 1, got {residency_bytes}")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.uid = _new_store_uid()
        self.device = dev
        self.residency_bytes = int(residency_bytes)
        self._own_dir = spill_dir is None
        self._dir = (
            tempfile.mkdtemp(prefix="repro-torch-chunks-") if spill_dir is None else spill_dir
        )
        os.makedirs(self._dir, exist_ok=True)
        self.stats = StoreStats()
        # resident: chunk_id -> tensor, LRU order (oldest first)
        self._resident: collections.OrderedDict[int, torch.Tensor] = collections.OrderedDict()
        self._meta: dict[int, tuple[tuple, torch.dtype, str | None]] = {}  # shape, dtype, path
        self._pins: collections.Counter = collections.Counter()
        self._prefetched: set[int] = set()
        # Two-phase eviction: _shrink only MOVES a dirty victim here (under
        # the lock); the write happens in _flush_spills OUTSIDE the lock.
        self._pending_spills: dict[int, torch.Tensor] = {}
        self._spilling: set[int] = set()  # cids with a write in flight
        self._manifested: set[int] = set()  # cids covered by some manifest()
        # CUDA only: the event each put's copy recorded (a spill waits for
        # it), and the side stream reloads and spills run on.
        self._put_events: dict[int, torch.cuda.Event] = {}
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._next_id = 0
        self._lock = threading.RLock()
        self._closed = False
        # GC/interpreter-exit safety net: a store that is never close()d
        # must still not leak its spill directory.
        self._finalizer = (
            weakref.finalize(self, shutil.rmtree, self._dir, True)
            if self._own_dir
            else None
        )

    # -- introspection (tests / diagnostics) --------------------------------

    @property
    def spill_dir(self) -> str:
        return self._dir

    @property
    def closed(self) -> bool:
        return self._closed

    def resident_ids(self) -> list[int]:
        with self._lock:
            return list(self._resident)

    def spill_files(self) -> list[str]:
        if not os.path.isdir(self._dir):
            return []
        return sorted(f for f in os.listdir(self._dir) if f.endswith(".npy"))

    def is_pinned(self, ref: ChunkRef) -> bool:
        with self._lock:
            return self._pins[ref.chunk_id] > 0

    # -- the store contract --------------------------------------------------

    def put(self, array) -> ChunkRef:
        """Store a compact copy of ``array`` (tensor or ndarray) on the device."""
        if self._closed:
            raise ChunkStoreError("put() on a closed DiskStore")
        arr = self._compact(array)
        event = None
        if arr.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        with self._lock:
            cid = self._next_id
            self._next_id += 1
            self._meta[cid] = (tuple(arr.shape), arr.dtype, None)
            if event is not None:
                self._put_events[cid] = event
            self._insert_resident(cid, arr)
        self._flush_spills()
        return ChunkRef(self, cid, arr.shape, arr.dtype, self.device)

    def get(self, ref: ChunkRef) -> torch.Tensor:
        cid = ref.chunk_id
        with self._lock:
            if self._closed:
                raise ChunkStoreError("get() on a closed DiskStore")
            if cid not in self._meta:
                raise ChunkStoreError(f"unknown chunk {cid}")
            arr = self._resident.get(cid)
            if arr is not None:
                self._resident.move_to_end(cid)
                if cid in self._prefetched:
                    self._prefetched.discard(cid)
                    self.stats.prefetch_hits += 1
                return _guard(arr)
            pending = self._pending_spills.get(cid)
            if pending is not None:
                # Evicted but its spill write hasn't landed yet: the tensor
                # is still on the device — serve it (no disk read, no reinsert).
                return _guard(pending)
        # Not resident: load outside the lock so a concurrent prefetch
        # thread never serializes behind this read (and vice versa).
        arr = self._load(cid)
        with self._lock:
            raced = self._resident.get(cid)
            if raced is not None:  # a concurrent load won; keep one copy
                self._resident.move_to_end(cid)
                return _guard(raced)
            self._insert_resident(cid, arr)
        # Only the miss path flushes: a cold load's insert may have
        # deferred a dirty victim.  The hit path never pays a write.
        self._flush_spills()
        return _guard(arr)

    def pin(self, ref: ChunkRef) -> None:
        with self._lock:
            self._pins[ref.chunk_id] += 1

    def unpin(self, ref: ChunkRef) -> None:
        with self._lock:
            cid = ref.chunk_id
            if self._pins[cid] > 0:
                self._pins[cid] -= 1
            released = self._pins[cid] == 0
            # Spill-on-release: dropping the last pin is the moment a
            # streamed partition stops being needed — shed any overshoot.
            if released:
                self._shrink()
        if released:
            # Only a release writes: an unpin that leaves the chunk pinned
            # evicted nothing, and must not pick up another thread's spill
            # (a StreamExecutor's compute thread unpins its dispatch pins).
            self._flush_spills()

    def prefetch(self, refs: Iterable[ChunkRef]) -> None:
        """Load ``refs`` ahead of use; their next ``get`` is a prefetch hit."""
        for ref in refs:
            cid = ref.chunk_id
            with self._lock:
                if self._closed or cid not in self._meta:
                    continue
                if cid in self._resident:
                    self._resident.move_to_end(cid)
                    self._prefetched.add(cid)
                    continue
                if cid in self._pending_spills:
                    # Evicted with its spill write still in flight: gets are
                    # served from pending — loading now would race the writer.
                    continue
            arr = self._load(cid)
            with self._lock:
                if cid not in self._resident:
                    self._insert_resident(cid, arr)
                # The insert's own _shrink may have evicted the chunk again
                # (budget saturated by pins): only a chunk that is STILL
                # resident may carry the marker.
                if cid in self._resident:
                    self._prefetched.add(cid)
            # Write each deferred victim before the next load: at most one
            # chunk's spill waits on the device at a time.
            self._flush_spills()
        self._flush_spills()

    def evict(self, ref: ChunkRef) -> None:
        """Explicitly evict one chunk; refused while it is pinned."""
        with self._lock:
            cid = ref.chunk_id
            if self._pins[cid] > 0:
                raise ChunkPinnedError(
                    f"chunk {cid} is pinned ({self._pins[cid]} pins); eviction refused"
                )
            if cid in self._resident:
                self._evict_one(cid)
        self._flush_spills()

    def trim(self) -> None:
        """Drop every unpinned resident chunk (spilling unwritten ones)."""
        with self._lock:
            for cid in [c for c in self._resident if self._pins[c] == 0]:
                self._evict_one(cid)
        self._flush_spills()

    def handle(self, ref: ChunkRef) -> ChunkHandle | None:
        """Picklable :class:`ChunkHandle` for ``ref``, if workers can read it.

        A chunk is handle-able once it has a spill file OR has appeared in
        a :meth:`manifest` (whose shm entries workers resolve without any
        file).  Returns None otherwise — callers (the cluster payload
        builder) then ship the bytes inline/exported instead.
        """
        with self._lock:
            meta = self._meta.get(ref.chunk_id)
            if meta is None or (meta[2] is None and ref.chunk_id not in self._manifested):
                return None
        return ChunkHandle(
            store_uid=self.uid,
            chunk_id=ref.chunk_id,
            shape=ref.shape,
            dtype_str=dtype_str_of(ref.dtype),
        )

    def manifest(self, *, export=None, known: Iterable[int] = ()) -> StoreManifest:
        """Handoff projection for worker attach — shm-first, incremental.

        Args:
          export: ``callable(chunk_id, tensor) -> ShmBlockRef | None`` — the
            executor's shared-memory exporter.  Chunks that are resident
            (or eviction-pending) hand off as ``("shm", ref)`` entries
            with **no disk write** (a chunk on the card is copied to the
            host once, into the segment); only when the exporter declines
            (shm budget exhausted, or ``export is None``) does the chunk
            force-spill to a ``("file", ...)`` entry.  Chunks that already
            have a spill file always reuse it.
          known: chunk ids the caller has already received — the returned
            manifest contains only the REST, so a store that grew
            mid-session yields a cheap delta instead of re-shipping (and
            re-exporting) the world.

        Billing: only a genuinely new spill *write* counts as
        ``stats.spills``/``bytes_spilled``.  Shm handoffs and chunks whose
        file already exists bill nothing — a second manifest of an
        unchanged store is free.
        """
        self._flush_spills()  # settle any deferred eviction writes first
        known = set(known)
        chunks: dict = {}
        while True:
            with self._lock:
                if self._closed:
                    raise ChunkStoreError("manifest() on a closed DiskStore")
                cid = next(
                    (
                        c
                        for c, (_s, _d, p) in self._meta.items()
                        if p is None
                        and c not in known
                        and c not in chunks
                        and c not in self._spilling
                    ),
                    None,
                )
                if cid is None:
                    for c, (s, d, p) in self._meta.items():
                        if p is not None and c not in known and c not in chunks:
                            chunks[c] = ("file", p, s, dtype_str_of(d))
                    self._manifested.update(chunks)
                    return StoreManifest(uid=self.uid, spill_dir=self._dir, chunks=chunks)
                arr = self._resident.get(cid)
                if arr is None:
                    arr = self._pending_spills.get(cid)
                shape, dtype, _ = self._meta[cid]
                event = self._put_events.get(cid)
            if event is not None:
                event.synchronize()  # the put's copy has landed
            # Shm-first: the resident tensor hands off as a segment
            # descriptor — the residency cache stays warm, nothing is
            # written, nothing is billed.
            if export is not None:
                ref = export(cid, arr)
                if ref is not None:
                    chunks[cid] = ("shm", ref)
                    continue
            # Fallback: force-spill (exporter declined / shm disabled).
            # The write happens outside the lock; _spilling claims the
            # chunk against a concurrent flusher.
            with self._lock:
                if cid in self._spilling:
                    continue  # a flusher claimed it meanwhile: re-scan
                self._spilling.add(cid)
            path = self._path(cid)
            np.save(path, self._host_bits(arr, None))
            with self._lock:
                self._spilling.discard(cid)
                if self._closed or cid not in self._meta:
                    raise ChunkStoreError("DiskStore closed during manifest()")
                _s, _d, existing = self._meta[cid]
                self._meta[cid] = (shape, dtype, path)
                self._put_events.pop(cid, None)
                if existing is None:  # bill only a genuinely NEW spill write
                    self.stats.spills += 1
                    self.stats.bytes_spilled += self._nbytes(cid)
                self._pending_spills.pop(cid, None)

    def close(self) -> None:
        """Release resident chunks and delete the spill directory."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._resident.clear()
            self._meta.clear()
            self._prefetched.clear()
            self._pins.clear()
            self._pending_spills.clear()
            self._put_events.clear()
            self._manifested.clear()
            self.stats.resident_bytes = 0
        if self._finalizer is not None:
            self._finalizer()  # rmtree now, exactly once
        elif self._own_dir:  # pragma: no cover — finalizer covers own dirs
            shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- internals (call with lock held unless noted) ------------------------

    def _path(self, cid: int) -> str:
        return os.path.join(self._dir, f"chunk{cid}.npy")

    def _nbytes(self, cid: int) -> int:
        shape, dtype, _ = self._meta[cid]
        return int(np.prod(shape)) * dtype.itemsize

    def _compact(self, array) -> torch.Tensor:
        """A contiguous copy of ``array`` on the device, with storage of its own."""
        if isinstance(array, torch.Tensor):
            src = array.detach()
        else:
            src = torch.from_numpy(np.array(array, order="C"))  # the input may be read-only
        if src.element_size() not in _BITS_OF_SIZE:
            raise TypeError(f"DiskStore cannot spill dtype {src.dtype}")
        if not isinstance(array, torch.Tensor) and self.device.type == "cpu":
            return src  # already a copy of its own
        if src.device == self.device:
            return src.clone(memory_format=torch.contiguous_format)
        return src.to(self.device, memory_format=torch.contiguous_format)

    def _insert_resident(self, cid: int, arr: torch.Tensor) -> None:
        self._resident[cid] = arr
        self.stats.resident_bytes += self._nbytes(cid)
        # Peak tracks the resident CACHE; a deferred spill buffer is a
        # transient I/O buffer (every mutating store call flushes before
        # returning), not cached residency.
        self.stats.peak_resident_bytes = max(
            self.stats.peak_resident_bytes, self.stats.resident_bytes
        )
        self._shrink()

    def _shrink(self) -> None:
        """Evict LRU unpinned chunks until residency fits the budget."""
        while self.stats.resident_bytes > self.residency_bytes:
            victim = next((c for c in self._resident if self._pins[c] == 0), None)
            if victim is None:
                return  # everything resident is pinned: overshoot, recorded in peak
            self._evict_one(victim)

    def _evict_one(self, cid: int) -> None:
        """Drop ``cid`` from residency; a dirty chunk's write is DEFERRED."""
        arr = self._resident.pop(cid)
        _shape, _dtype, path = self._meta[cid]
        if path is None:  # spill-on-eviction: first eviction writes the file
            self._pending_spills[cid] = arr
        self.stats.evictions += 1
        self.stats.resident_bytes -= self._nbytes(cid)
        self._prefetched.discard(cid)

    def _flush_spills(self) -> None:
        """Write deferred spills to disk.  Call with the lock RELEASED.

        Entries stay servable from ``_pending_spills`` until their file
        path is recorded, so a reader can never observe "not resident, not
        pending, no file".  Multiple threads may flush concurrently;
        ``_spilling`` claims a chunk per writer.
        """
        while True:
            with self._lock:
                cid = next(
                    (c for c in self._pending_spills if c not in self._spilling), None
                )
                if cid is None or self._closed:
                    return
                arr = self._pending_spills[cid]
                event = self._put_events.get(cid)
                self._spilling.add(cid)
                shape, dtype, _ = self._meta[cid]
            path = self._path(cid)
            try:
                np.save(path, self._host_bits(arr, event))
            except OSError:
                # close() raced us and removed the spill dir; nothing left
                # to persist.
                with self._lock:
                    self._spilling.discard(cid)
                return
            with self._lock:
                self._spilling.discard(cid)
                if self._closed or cid not in self._meta:
                    return
                self._meta[cid] = (shape, dtype, path)
                self._put_events.pop(cid, None)
                self.stats.spills += 1
                self.stats.bytes_spilled += self._nbytes(cid)
                self._pending_spills.pop(cid, None)

    def _host_bits(self, arr: torch.Tensor, event) -> np.ndarray:
        """``arr``'s raw bits on the host, as integers of its element size."""
        bits = arr.view(_BITS_OF_SIZE[arr.element_size()])
        if not bits.is_cuda:
            return bits.numpy()
        host = torch.empty(bits.shape, dtype=bits.dtype, pin_memory=True)
        with torch.cuda.stream(self._stream):
            if event is not None:
                self._stream.wait_event(event)  # the put's copy has landed
            host.copy_(bits, non_blocking=True)
        self._stream.synchronize()
        return host.numpy()

    def _load(self, cid: int) -> torch.Tensor:
        """Read one spilled chunk back (no lock held: file and copy I/O)."""
        with self._lock:
            meta = self._meta.get(cid)
        if meta is None:
            raise ChunkStoreError(f"unknown chunk {cid}")
        shape, dtype, path = meta
        if path is None:
            # Unreachable in practice: a dirty chunk is resident or pending
            # (both checked before _load), and the flusher records the file
            # path BEFORE removing the pending entry.
            raise ChunkStoreError(f"chunk {cid} has no resident copy and no spill file")
        mm = np.load(path, mmap_mode="r")
        if self._stream is None:
            arr = torch.from_numpy(np.array(mm)).view(dtype)
        else:
            host = torch.empty(mm.shape, dtype=_BITS_OF_SIZE[dtype.itemsize],
                               pin_memory=True)
            np.copyto(host.numpy(), mm)  # the disk read
            with torch.cuda.stream(self._stream):
                bits = torch.empty(host.shape, dtype=host.dtype, device=self.device)
                bits.copy_(host, non_blocking=True)
            self._stream.synchronize()  # resident only once the copy landed
            arr = bits.view(dtype)
        del mm
        with self._lock:
            self.stats.loads += 1
            self.stats.bytes_loaded += int(np.prod(shape)) * dtype.itemsize
        return arr


def _guard(t: torch.Tensor) -> torch.Tensor:
    """``t``, marked in use by the caller's current CUDA stream (see
    :class:`DiskStore`, "Stream order")."""
    if t.is_cuda:
        t.record_stream(torch.cuda.current_stream(t.device))
    return t
