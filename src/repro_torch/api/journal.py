"""Write-ahead job journal — the durable half of the JobServer (DESIGN.md §12).

An append-only record log with the same crash posture as the checkpoint
layout (:mod:`repro_torch.checkpoint.checkpointer`): every record is framed as
``[4-byte big-endian length][4-byte CRC32][pickled payload]`` and the file
is fsynced after each append, so the tail of the file after a crash is
either a complete record or torn garbage that :meth:`JobJournal.replay`
detects (short frame or CRC mismatch) and drops — a torn tail never
poisons the records before it, exactly like a ``.tmp`` step directory
never shadows a COMMITTED checkpoint.

The frame format is the JAX package's, byte for byte: a journal of host
records (tuples, strings, bytes, numpy arrays) that either package wrote
replays in the other's reader.

What the :class:`~repro_torch.api.jobserver.JobServer` writes through it:

``("job", ...)``
    One submission record per accepted job: id, tenant, weight, the
    :func:`~repro_torch.api.lowering.plan_fingerprint`, and — when the plan
    is durable (fn/combine referencable via :mod:`repro_torch.api.fnref`,
    inputs resident) — the encoded replay payload.
``("start", ...)``
    The RESOLVED policy a job's first unit ran under (``SplIter("auto")``
    pins its granularity here), so a resume re-lowers to the *same* unit
    decomposition the completion records are keyed against.
``("unit", ...)``
    One record per completed unit: the restart-stable unit key plus the
    pickled host copy of the partial result (numpy arrays) — what lets a
    resumed job skip the unit instead of recomputing it.
``("done" | "failed", ...)``
    Terminal records carrying the job's serialized
    :class:`~repro_torch.core.engine.EngineReport` / error summary.

Replay is full-file: the journal is the authoritative event history and
the checkpoint snapshots are an optimization layered on top (scheduler
fairness state, aggregated report segments), never the other way around.
"""

from __future__ import annotations

import os
import pickle
import struct
import zlib
from typing import Any, Iterator

__all__ = ["JobJournal"]

_HEADER = struct.Struct(">II")  # payload length, CRC32(payload)


class JobJournal:
    """Append-only, torn-tail-tolerant record log (one file).

    ``fsync=True`` (the default) makes every append durable before it
    returns — the write-ahead contract: a unit's completion record hits
    disk before the server acts on the completion.  Tests that hammer the
    journal may pass ``fsync=False`` and accept losing the OS-buffered
    tail on a *machine* crash (a killed process still keeps it).
    """

    def __init__(self, path: str, *, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "ab")

    # ------------------------------------------------------------ write --

    def append(self, record: Any) -> None:
        payload = pickle.dumps(record)
        self._f.write(_HEADER.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "JobJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- read --

    @classmethod
    def replay(cls, path: str) -> Iterator[Any]:
        """Yield every intact record in append order; stop at a torn tail.

        A record is *torn* when the file ends mid-frame or the payload
        fails its CRC — both are what a crash mid-append leaves behind.
        Records before the tear are yielded normally; nothing after a
        tear is trusted (frame boundaries are unrecoverable past it).
        Missing file ⇒ empty history.
        """
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            while True:
                header = f.read(_HEADER.size)
                if len(header) < _HEADER.size:
                    return  # clean EOF or torn header
                length, crc = _HEADER.unpack(header)
                payload = f.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    return  # torn or corrupt tail
                yield pickle.loads(payload)
