"""Shared-memory data plane — block transport for the cluster backend.

The control channel of :class:`~repro_torch.api.cluster_executor.ClusterExecutor`
is a ~64KB OS pipe: every operand and partial that crosses it as pickled
bytes is billed to ``EngineReport.ipc_bytes`` and paid twice (serialize +
copy).  DuctTeip's split — *tiny task descriptors on the control channel,
out-of-band data movement for blocks* — is reproduced here with POSIX
shared memory (``multiprocessing.shared_memory``, ``/dev/shm`` on Linux):

:class:`ShmBlockRef`
    A picklable ``(segment, offset, shape, dtype)`` descriptor.  The parent
    writes a block into a segment once; what crosses the pipe is this
    ~100-byte handle, and the worker resolves it against an attachment of
    the same segment — the block bytes never cross the pipe.
:class:`ShmStore`
    The driver-side arena allocator: bump-allocates exported blocks into
    fixed-size segments under a byte budget, caches exports by object
    identity (an iterative app re-dispatching the same blocks pays ONE
    copy total — for a block on the card, one copy to the host), and
    evicts least-recently-used unpinned segments when the budget fills —
    callers fall back to the pickled/spill-file path when ``export``
    returns ``None``.  Also a full
    :class:`~repro_torch.api.chunkstore.ChunkStore` on the host.
:class:`ShmAttachments`
    The reader-side cache (workers, and the parent consuming worker
    partials): attaches segments by name, exposes read-only ``np.ndarray``
    views, and builds tensors from them on a device (:meth:`~ShmAttachments.tensor`:
    a host-to-device copy for the card, a host copy for the CPU — a tensor
    never aliases a segment whose attachment may close).
:func:`pack_tree` / :func:`unpack_tree`
    Reply-payload transport: a worker packs every large leaf of a result
    tree into ONE fresh segment and ships descriptors; the parent copies
    the leaves out and unlinks the segment — a strict per-reply lifecycle
    with no refcounting across messages.

Element types: a descriptor's ``dtype_str`` is the numpy type string of
the bytes, except for ``"bfloat16"``, which numpy lacks: such a block is
stored as its raw 16-bit patterns and read back as ``torch.bfloat16``.

Cleanup contract: the DRIVER owns every unlink — on :meth:`ShmStore.close`,
on consuming or discarding a reply, and by prefix sweep
(:func:`sweep_segments`) when a worker dies with undelivered replies.
``resource_tracker`` bookkeeping balances itself: the spawn tree shares ONE
tracker whose cache is a name set, ``SharedMemory`` registers on create and
attach alike, and ``unlink()`` unregisters exactly once.  Tests assert
:func:`leaked_segments` is empty afterwards.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import OrderedDict
from multiprocessing import shared_memory
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch._pytree import tree_leaves, tree_map

__all__ = [
    "ShmBlockRef",
    "ShmStore",
    "ShmAttachments",
    "SegmentLease",
    "shm_available",
    "host_array",
    "dtype_str_of",
    "torch_dtype",
    "to_tensor",
    "pack_tree",
    "unpack_tree",
    "discard_tree",
    "tree_lease",
    "attach_tree",
    "unlink_segments",
    "sweep_segments",
    "leaked_segments",
]

#: every segment name this module creates starts with this; leak checks
#: list /dev/shm for it.
SEGMENT_PREFIX = "rtshm"

_ALIGN = 64  # offsets cache-line aligned; keeps resolved views aligned too

#: element types numpy lacks: descriptor name -> (torch dtype, bits type)
_TORCH_ONLY = {"bfloat16": (torch.bfloat16, torch.int16)}

_seq_lock = threading.Lock()
_prefix_seq = 0


def _next_prefix() -> str:
    """A process-unique segment-name prefix: ``rtshm<pid>x<n>``."""
    global _prefix_seq
    with _seq_lock:
        _prefix_seq += 1
        return f"{SEGMENT_PREFIX}{os.getpid()}x{_prefix_seq}"


def _aligned(n: int) -> int:
    return (int(n) + _ALIGN - 1) & ~(_ALIGN - 1)


def _np_dtype(dtype_str: str) -> np.dtype:
    """The numpy type of a descriptor's stored bytes."""
    if dtype_str in _TORCH_ONLY:
        return np.dtype(np.int16)
    return np.dtype(dtype_str)


def host_array(x) -> tuple[np.ndarray, str]:
    """``x`` (tensor on any device, or array-like) as ``(host ndarray, dtype_str)``.

    A CUDA tensor is copied to the host (once: callers cache by identity);
    a ``bfloat16`` tensor comes back as its 16-bit patterns.

    >>> arr, tag = host_array(torch.ones(2, dtype=torch.bfloat16))
    >>> arr.dtype, tag
    (dtype('int16'), 'bfloat16')
    """
    if isinstance(x, torch.Tensor):
        t = x.detach()
        tag = str(t.dtype).removeprefix("torch.")
        if tag in _TORCH_ONLY:
            t = t.view(_TORCH_ONLY[tag][1])
        else:
            tag = None
        arr = t.cpu().numpy()
        return arr, tag if tag is not None else arr.dtype.str
    arr = np.asarray(x)
    return arr, arr.dtype.str


def dtype_str_of(dtype: torch.dtype) -> str:
    """The descriptor type string of a tensor element type.

    >>> dtype_str_of(torch.float32), dtype_str_of(torch.bfloat16)
    ('<f4', 'bfloat16')
    """
    name = str(dtype).removeprefix("torch.")
    if name in _TORCH_ONLY:
        return name
    return torch.empty(0, dtype=dtype).numpy().dtype.str


def torch_dtype(dtype_str: str) -> torch.dtype:
    """The tensor element type a descriptor's bytes hold."""
    if dtype_str in _TORCH_ONLY:
        return _TORCH_ONLY[dtype_str][0]
    return torch.from_numpy(np.zeros(0, np.dtype(dtype_str))).dtype


def to_tensor(arr: np.ndarray, dtype_str: str, device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` holding ``arr``'s values, never aliasing it."""
    if device.type == "cuda":
        # A synchronous copy from pageable memory: the source is consumed
        # when ``to`` returns, so the segment may close right after.
        t = torch.from_numpy(arr) if arr.flags.writeable else torch.from_numpy(arr.copy())
        t = t.to(device)
    else:
        t = torch.from_numpy(np.array(arr))
    if dtype_str in _TORCH_ONLY:
        t = t.view(_TORCH_ONLY[dtype_str][0])
    return t


def shm_available() -> bool:
    """Can this host create + attach POSIX shared memory segments?"""
    try:
        probe = shared_memory.SharedMemory(create=True, size=64)
    except (OSError, ValueError, FileNotFoundError):
        return False
    probe.close()
    probe.unlink()
    return True


@dataclasses.dataclass(frozen=True)
class ShmBlockRef:
    """A picklable descriptor of one block inside a shared-memory segment.

    What crosses the control channel instead of the block's bytes: the
    receiver attaches ``segment`` (cached per segment, not per block) and
    builds a view at ``offset``.

    >>> import pickle
    >>> ref = ShmBlockRef("rtshm1x1a0", 128, (4, 2), "<f4")
    >>> pickle.loads(pickle.dumps(ref)) == ref
    True
    >>> ref.nbytes
    32
    """

    segment: str
    offset: int
    shape: tuple
    dtype_str: str

    @property
    def nbytes(self) -> int:
        size = _np_dtype(self.dtype_str).itemsize
        return int(np.prod(self.shape)) * size if self.shape else size


class _Segment:
    """One arena segment: a SharedMemory plus bump cursor and guards."""

    __slots__ = ("name", "shm", "size", "cursor", "pins", "locks", "last_use", "keys")

    def __init__(self, name: str, shm: shared_memory.SharedMemory, size: int):
        self.name = name
        self.shm = shm
        self.size = size
        self.cursor = 0
        self.pins = 0        # in-flight dispatches referencing this segment
        self.locks = 0       # manifest entries: never evict while > 0
        self.last_use = 0
        self.keys: list = []  # export-cache keys allocated here (for eviction)


class ShmStore:
    """Driver-side shared-memory arena + :class:`ChunkStore` implementation.

    Args:
      budget_bytes: cap on total allocated segment bytes.  When a new
        export would exceed it, least-recently-used unpinned, unlocked
        segments are evicted (unlinked; their cached exports drop); if
        nothing is evictable, :meth:`export` returns ``None`` and the
        caller falls back to the pickle/spill path.
      segment_bytes: arena segment size; blocks larger than one segment
        get a dedicated segment of their own size.
      min_bytes: blocks smaller than this are not worth a segment round
        trip — :meth:`export` declines them (``put`` ignores the floor).

    Export caching: keyed by ``id(obj)`` (with a keepalive reference so
    ids cannot be recycled under us) or an explicit ``key`` (no keepalive:
    a chunk store's tensor on the card stays the store's to evict).  An iterative
    workload dispatching the same blocks every iteration copies each block
    into shared memory exactly once; ``bytes_exported`` counts only
    genuine copies, which is what ``EngineReport.shm_bytes`` bills.

    >>> att = ShmAttachments()
    >>> with ShmStore(min_bytes=0) as arena:
    ...     x = torch.arange(8.0)
    ...     (ref, wrote), (_, again) = arena.export(x), arena.export(x)
    ...     wrote, again, ref.shape, att.tensor(ref, torch.device("cpu")).tolist()[:3]
    (32, 0, (8,), [0.0, 1.0, 2.0])
    >>> att.close()
    """

    def __init__(
        self,
        *,
        budget_bytes: int = 256 << 20,
        segment_bytes: int = 4 << 20,
        min_bytes: int = 1024,
        prefix: str | None = None,
    ):
        self.budget_bytes = int(budget_bytes)
        self.segment_bytes = int(segment_bytes)
        self.min_bytes = int(min_bytes)
        self.prefix = prefix or _next_prefix()
        self.uid = f"shm-{os.getpid()}-{self.prefix}"
        self.bytes_exported = 0  # genuine copies into shared memory
        self.export_seconds = 0.0  # their time (a card block: its copy to the host too)
        self.allocated_bytes = 0
        # ChunkStore accounting (imported lazily: chunkstore imports us)
        from repro_torch.api.chunkstore import StoreStats

        self.stats = StoreStats()
        self._segments: OrderedDict[str, _Segment] = OrderedDict()
        self._open: _Segment | None = None  # current bump-allocation target
        self._exports: dict[Any, tuple[ShmBlockRef, _Segment]] = {}
        self._keepalive: dict[Any, Any] = {}
        self._chunks: dict[int, ShmBlockRef] = {}  # ChunkStore: cid -> ref
        self._next_cid = 0
        self._seg_seq = 0
        self._use_seq = 0
        self._lock = threading.RLock()

    # -- the export API (the cluster data plane) ------------------------------

    def export(
        self,
        obj,
        *,
        key: Any = None,
        min_bytes: int | None = None,
        lock: bool = False,
        materialize: Callable[[], Any] | None = None,
    ) -> tuple[ShmBlockRef | None, int]:
        """``obj`` as a shared block: ``(ref, bytes_copied)`` or ``(None, 0)``.

        ``bytes_copied`` is 0 on a cache hit — the block is already in a
        segment and only the descriptor ships again.  ``materialize``
        defers producing the value (resolving a chunk ref, copying a
        tensor off the card) until the size/cache checks pass.
        ``lock=True`` marks the segment never-evictable (manifest entries,
        whose descriptors outlive any single dispatch).
        """
        explicit = key
        key = key if key is not None else id(obj)
        floor = self.min_bytes if min_bytes is None else min_bytes
        size_hint = getattr(obj, "nbytes", None)
        if size_hint is not None and size_hint < floor:
            return None, 0
        with self._lock:
            hit = self._exports.get(key)
            if hit is not None:
                ref, seg = hit
                self._use_seq += 1
                seg.last_use = self._use_seq
                if lock:
                    seg.locks += 1
                return ref, 0
        t0 = time.perf_counter()
        arr, dtype_str = host_array(materialize() if materialize is not None else obj)
        if arr.nbytes < floor or arr.nbytes == 0:
            return None, 0
        arr = np.ascontiguousarray(arr)
        with self._lock:
            seg, offset = self._alloc(_aligned(arr.nbytes))
            if seg is None:
                return None, 0
            view = np.ndarray(arr.shape, arr.dtype, buffer=seg.shm.buf, offset=offset)
            view[...] = arr
            ref = ShmBlockRef(seg.name, offset, tuple(arr.shape), dtype_str)
            self._exports[key] = (ref, seg)
            if explicit is None:  # an id key must not be recycled under us
                self._keepalive[key] = obj
            seg.keys.append(key)
            self._use_seq += 1
            seg.last_use = self._use_seq
            if lock:
                seg.locks += 1
            self.bytes_exported += arr.nbytes
            self.export_seconds += time.perf_counter() - t0
            return ref, arr.nbytes

    def pin_refs(self, refs: Iterable[ShmBlockRef]) -> None:
        """Guard the refs' segments against eviction for an in-flight unit."""
        with self._lock:
            for name in {r.segment for r in refs}:
                seg = self._segments.get(name)
                if seg is not None:
                    seg.pins += 1

    def unpin_refs(self, refs: Iterable[ShmBlockRef]) -> None:
        with self._lock:
            for name in {r.segment for r in refs}:
                seg = self._segments.get(name)
                if seg is not None and seg.pins > 0:
                    seg.pins -= 1

    def live_segments(self) -> list[str]:
        with self._lock:
            return list(self._segments)

    def pinned_segments(self) -> dict[str, int]:
        """Segment name → live pin count (pins > 0 only).

        After a drain settles — steals, preemptions, deaths included —
        every dispatch-scoped pin must have been released exactly once, so
        this must be empty (``locks``, the manifest guards, are separate).
        """
        with self._lock:
            return {name: seg.pins for name, seg in self._segments.items() if seg.pins > 0}

    # -- allocation internals (lock held) -------------------------------------

    def _alloc(self, need: int) -> tuple[_Segment | None, int]:
        seg = self._open
        if seg is not None and seg.size - seg.cursor >= need:
            offset = seg.cursor
            seg.cursor += need
            return seg, offset
        size = max(self.segment_bytes, need)
        while self.allocated_bytes + size > self.budget_bytes:
            if not self._evict_one():
                return None, 0
        self._seg_seq += 1
        name = f"{self.prefix}a{self._seg_seq}"
        try:
            shm = shared_memory.SharedMemory(name=name, create=True, size=size)
        except OSError:  # /dev/shm itself is full: decline, caller falls back
            return None, 0
        seg = _Segment(name, shm, size)
        self._segments[name] = seg
        self._open = seg
        self.allocated_bytes += size
        offset = seg.cursor
        seg.cursor += need
        return seg, offset

    def _evict_one(self) -> bool:
        """Unlink the LRU unpinned, unlocked, non-open segment.  False: none."""
        victims = sorted(
            (
                s
                for s in self._segments.values()
                if s.pins == 0 and s.locks == 0 and s is not self._open
            ),
            key=lambda s: s.last_use,
        )
        if not victims:
            return False
        self._drop_segment(victims[0])
        return True

    def _drop_segment(self, seg: _Segment) -> None:
        for key in seg.keys:
            self._exports.pop(key, None)
            self._keepalive.pop(key, None)
        self._segments.pop(seg.name, None)
        if self._open is seg:
            self._open = None
        self.allocated_bytes -= seg.size
        seg.shm.close()
        try:
            seg.shm.unlink()
        except FileNotFoundError:  # pragma: no cover — already swept
            pass

    # -- the ChunkStore contract ----------------------------------------------

    def put(self, array):
        """Store one chunk in shared memory; raises when the budget is out."""
        from repro_torch.api.chunkstore import ChunkRef, ChunkStoreError

        with self._lock:
            cid = self._next_cid
            self._next_cid += 1
            ref, _wrote = self.export(array, key=("chunk", cid), min_bytes=0, lock=True)
            if ref is None:
                raise ChunkStoreError(
                    f"ShmStore budget exhausted ({self.budget_bytes} bytes); "
                    f"cannot store a {getattr(array, 'nbytes', '?')}-byte chunk"
                )
            self._chunks[cid] = ref
            self.stats.resident_bytes += ref.nbytes
            self.stats.peak_resident_bytes = max(
                self.stats.peak_resident_bytes, self.stats.resident_bytes
            )
        return ChunkRef(self, cid, ref.shape, torch_dtype(ref.dtype_str), torch.device("cpu"))

    def get(self, ref) -> torch.Tensor:
        from repro_torch.api.chunkstore import ChunkStoreError

        with self._lock:
            blk = self._chunks.get(ref.chunk_id)
            if blk is None:
                raise ChunkStoreError(f"unknown or released chunk {ref.chunk_id}")
            seg = self._segments.get(blk.segment)
            if seg is None:  # pragma: no cover — put-chunks lock their segment
                raise ChunkStoreError(f"segment {blk.segment} gone for {ref.chunk_id}")
            view = np.ndarray(
                blk.shape, _np_dtype(blk.dtype_str), buffer=seg.shm.buf, offset=blk.offset
            )
            return to_tensor(view, blk.dtype_str, torch.device("cpu"))

    def handle(self, ref) -> ShmBlockRef | None:
        """The picklable descriptor for a stored chunk (the cluster payload)."""
        with self._lock:
            return self._chunks.get(ref.chunk_id)

    def pin(self, ref) -> None:
        with self._lock:
            blk = self._chunks.get(ref.chunk_id)
            if blk is not None:
                self.pin_refs((blk,))

    def unpin(self, ref) -> None:
        with self._lock:
            blk = self._chunks.get(ref.chunk_id)
            if blk is not None:
                self.unpin_refs((blk,))

    def prefetch(self, refs) -> None:  # segments are memory: nothing to stage
        pass

    def trim(self) -> None:  # chunks have no backing tier to shed to
        pass

    def close(self) -> None:
        """Unlink every segment and reset to an empty, reusable store."""
        with self._lock:
            for seg in list(self._segments.values()):
                self._drop_segment(seg)
            self._segments.clear()
            self._open = None
            self._exports.clear()
            self._keepalive.clear()
            self._chunks.clear()
            self.allocated_bytes = 0
            self.stats.resident_bytes = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ShmAttachments:
    """Reader-side segment cache: name → attached ``SharedMemory``.

    :meth:`view` returns a read-only ndarray over the attached segment's
    buffer; :meth:`tensor` a tensor on a device built from it (a copy, so
    the tensor outlives the attachment).  The cache is LRU-capped: a closed
    attachment only releases this process's mapping — unlink stays the
    driver's job.
    """

    def __init__(self, *, max_segments: int = 64):
        self.max_segments = max_segments
        self._segs: OrderedDict[str, shared_memory.SharedMemory] = OrderedDict()
        self._lock = threading.Lock()

    def _segment(self, name: str) -> shared_memory.SharedMemory:
        """The attachment of segment ``name`` (lock held)."""
        seg = self._segs.get(name)
        if seg is None:
            seg = self._segs[name] = shared_memory.SharedMemory(name=name)
            while len(self._segs) > self.max_segments:
                _, old = self._segs.popitem(last=False)
                old.close()
        else:
            self._segs.move_to_end(name)
        return seg

    def view(self, ref: ShmBlockRef) -> np.ndarray:
        with self._lock:
            seg = self._segment(ref.segment)
        out = np.ndarray(
            ref.shape, _np_dtype(ref.dtype_str), buffer=seg.buf, offset=ref.offset
        )
        out.flags.writeable = False
        return out

    def tensor(self, ref: ShmBlockRef, device: torch.device) -> torch.Tensor:
        """The block as a tensor on ``device`` (the card: one host-to-device
        copy out of the segment's pageable pages)."""
        with self._lock:  # the mapping must not close under the copy
            seg = self._segment(ref.segment)
            src = np.ndarray(  # read by the copy, never written
                ref.shape, _np_dtype(ref.dtype_str), buffer=seg.buf, offset=ref.offset
            )
            return to_tensor(src, ref.dtype_str, device)

    def close(self) -> None:
        with self._lock:
            for seg in self._segs.values():
                seg.close()
            self._segs.clear()


# ---------------------------------------------------------------------------
# reply-payload transport: one fresh segment per reply
# ---------------------------------------------------------------------------


def pack_tree(tree, *, threshold: int, name: str):
    """Move large ndarray leaves of ``tree`` into ONE fresh segment.

    Returns ``(tree_with_refs, segment_name | None, bytes_copied)``; the
    name is ``None`` (tree untouched) when no leaf clears ``threshold`` or
    the segment cannot be created (e.g. ``/dev/shm`` full) — the caller
    then ships the values inline (non-ndarray leaves always do).  The
    creator's mapping is closed immediately; the receiver owns the
    unlink (:func:`unpack_tree` / :func:`discard_tree`).
    """
    big = [
        leaf
        for leaf in tree_leaves(tree)
        if isinstance(leaf, np.ndarray) and leaf.nbytes >= threshold
    ]
    if not big:
        return tree, None, 0
    total = sum(_aligned(a.nbytes) for a in big)
    try:
        seg = shared_memory.SharedMemory(name=name, create=True, size=total)
    except OSError:
        return tree, None, 0
    cursor = 0
    wrote = 0

    def place(leaf):
        nonlocal cursor, wrote
        if not (isinstance(leaf, np.ndarray) and leaf.nbytes >= threshold):
            return leaf
        arr = np.ascontiguousarray(leaf).reshape(leaf.shape)  # a 0-d leaf stays 0-d
        view = np.ndarray(arr.shape, arr.dtype, buffer=seg.buf, offset=cursor)
        view[...] = arr
        ref = ShmBlockRef(name, cursor, tuple(arr.shape), arr.dtype.str)
        cursor += _aligned(arr.nbytes)
        wrote += arr.nbytes
        return ref

    packed = tree_map(place, tree)
    seg.close()
    return packed, name, wrote


def unpack_tree(tree):
    """Copy :class:`ShmBlockRef` leaves back to ndarrays; unlink their segments.

    Returns ``(tree, segment_names)``.  The consume half of the reply
    contract: after this, the segments are gone from ``/dev/shm``.
    """
    segs: dict[str, shared_memory.SharedMemory] = {}

    def take(leaf):
        if not isinstance(leaf, ShmBlockRef):
            return leaf
        seg = segs.get(leaf.segment)
        if seg is None:
            seg = segs[leaf.segment] = shared_memory.SharedMemory(name=leaf.segment)
        return np.array(
            np.ndarray(
                leaf.shape, _np_dtype(leaf.dtype_str), buffer=seg.buf, offset=leaf.offset
            )
        )

    out = tree_map(take, tree)
    for seg in segs.values():
        seg.close()
        try:
            seg.unlink()
        except FileNotFoundError:  # pragma: no cover — a sweep raced us
            pass
    return out, list(segs)


@dataclasses.dataclass(frozen=True)
class SegmentLease:
    """Ownership record for a published reply (DESIGN.md §16).

    A partial *published* into a named segment that a sibling attaches
    directly is not copied-and-unlinked on receipt: the driver records the
    segment names and the bytes they hold, and stays the owner of the
    unlink until the consuming fold completes or a failure path sweeps it.
    """

    segments: tuple[str, ...]
    nbytes: int


def tree_lease(tree) -> SegmentLease | None:
    """The :class:`SegmentLease` over a packed tree's ref leaves (or None)."""
    refs = [leaf for leaf in tree_leaves(tree) if isinstance(leaf, ShmBlockRef)]
    if not refs:
        return None
    return SegmentLease(
        segments=tuple(sorted({r.segment for r in refs})),
        nbytes=sum(r.nbytes for r in refs),
    )


def attach_tree(tree, attachments: ShmAttachments):
    """Resolve a packed tree's ref leaves to read-only views (no unlink)."""
    return tree_map(
        lambda leaf: attachments.view(leaf) if isinstance(leaf, ShmBlockRef) else leaf,
        tree,
    )


def discard_tree(tree) -> None:
    """Unlink the segments of a reply that will never be consumed.

    Stale/duplicate replies (a salvaged result landing after its unit was
    replayed) still carry live segments; dropping the message without this
    would leak them.
    """
    names = {leaf.segment for leaf in tree_leaves(tree) if isinstance(leaf, ShmBlockRef)}
    unlink_segments(names)


# ---------------------------------------------------------------------------
# cleanup helpers (tests, worker-death sweeps)
# ---------------------------------------------------------------------------


def unlink_segments(names: Iterable[str]) -> None:
    """Best-effort unlink of segments by name (missing ones are fine)."""
    for name in names:
        try:
            seg = shared_memory.SharedMemory(name=name)
        except FileNotFoundError:
            continue
        seg.close()
        try:
            seg.unlink()
        except FileNotFoundError:  # pragma: no cover
            pass


def leaked_segments(prefix: str = SEGMENT_PREFIX) -> list[str]:
    """Live ``/dev/shm`` segment names starting with ``prefix`` (Linux).

    On hosts without a browsable ``/dev/shm`` this returns ``[]``.
    """
    shm_dir = "/dev/shm"
    if not os.path.isdir(shm_dir):
        return []
    try:
        return sorted(n for n in os.listdir(shm_dir) if n.startswith(prefix))
    except OSError:  # pragma: no cover
        return []


def sweep_segments(prefix: str) -> int:
    """Unlink every live segment under ``prefix``; returns how many.

    The backstop for segments whose owner can no longer unlink them: a
    dead worker's unsent reply segments, or a whole executor's arena on
    ``close()``.
    """
    names = leaked_segments(prefix)
    unlink_segments(names)
    return len(names)
