"""Blocked batch pipeline — the SplIter's L2 substrate (DESIGN.md §2).

The global batch is produced as a *blocked collection*: ``num_blocks``
microbatch blocks per optimizer step, stacked ``(nb, mb, seq)``.  Placement
on the mesh follows the data-parallel sharding, so each DP shard's local
blocks form exactly one SplIter partition; the fused train step loops over
them on the device (``repro_torch.optim.grad_accum``).

The pipeline is deterministic and *resumable*: :class:`PipelineState` is a
single cursor (step) checkpointed alongside the model, and documents are
counter-indexed (see datasets.py), so a restarted run replays bit-identical
batches — the checkpoint/restart integration test depends on this.

Background prefetch (one thread, bounded queue) overlaps host batch
assembly with device compute.

Port of ``repro/data/pipeline.py``, unchanged: numpy batches on the host
(the trainer moves a step's batch to the card once).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.data.datasets import SyntheticTextDataset


@dataclasses.dataclass
class PipelineState:
    step: int = 0

    def to_json(self) -> dict:
        return {"step": self.step}

    @classmethod
    def from_json(cls, d: dict) -> "PipelineState":
        return cls(step=int(d["step"]))


class BlockedBatchPipeline:
    """Yields blocked batches {tokens,labels}: (num_blocks, mb, seq) int32."""

    def __init__(
        self,
        *,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        num_blocks: int,
        seed: int = 0,
        state: PipelineState | None = None,
        prefetch: int = 2,
    ):
        assert global_batch % num_blocks == 0, (global_batch, num_blocks)
        self.ds = SyntheticTextDataset(vocab_size, seq_len + 1, seed)
        self.global_batch = global_batch
        self.num_blocks = num_blocks
        self.mb = global_batch // num_blocks
        self.seq_len = seq_len
        self.state = state or PipelineState()
        self._prefetch = prefetch
        self._q: queue.Queue | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ---- deterministic batch assembly ------------------------------------

    def _assemble(self, step: int) -> dict[str, np.ndarray]:
        base = step * self.global_batch
        ids = np.arange(base, base + self.global_batch, dtype=np.int64)
        flat = self.ds.batch(ids)
        return {
            k: v.reshape(self.num_blocks, self.mb, self.seq_len)
            for k, v in flat.items()
        }

    def peek(self, step: int) -> dict[str, np.ndarray]:
        """Batch for an arbitrary step (no state change) — resume testing."""
        return self._assemble(step)

    # ---- prefetching iterator ---------------------------------------------

    def _worker(self, start_step: int, q: queue.Queue, stop: threading.Event):
        # q/stop are passed in (not read off self) so a superseded worker
        # keeps draining against ITS queue/event and can never be revived
        # by a later re-iteration swapping the attributes underneath it.
        s = start_step
        while not stop.is_set():
            item = (s, self._assemble(s))
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        # Re-iterating must not leak the previous prefetch worker: stop and
        # join it first, then start a fresh worker bound to a fresh
        # queue/event pair at the current cursor.
        self.close()
        self._stop = threading.Event()
        self._q = queue.Queue(maxsize=self._prefetch)
        self._thread = threading.Thread(
            target=self._worker,
            args=(self.state.step, self._q, self._stop),
            daemon=True,
        )
        self._thread.start()
        # Bind this iteration's queue/event locally: a superseded iterator
        # must drain its own buffer and stop — never steal from (or advance
        # the cursor of) a newer iteration that rebound the attributes.
        q, stop = self._q, self._stop
        while True:
            try:
                step, batch = q.get(timeout=0.1)
            except queue.Empty:
                if stop.is_set():
                    return
                continue
            if not stop.is_set():
                self.state.step = step + 1
            yield batch

    def close(self):
        """Stop the prefetch worker.  Idempotent; safe with no worker."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)
