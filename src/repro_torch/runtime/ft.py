"""Fault-tolerance machinery: heartbeats, straggler detection, restart policy.

On a real multi-host deployment these hooks wire into the cluster manager
(GKE/Borg preemption signals, torch.distributed heartbeats).  The logic itself
is host-agnostic and is exercised by simulation in tests:

* :class:`HeartbeatMonitor` — per-worker last-seen timestamps; workers that
  miss ``timeout`` are declared dead → the runner triggers
  checkpoint-restore on the survivor set (elastic restore path).
* :class:`StragglerDetector` — per-step wall-time EWMA + k·MAD outlier
  rule.  On sustained straggle it recommends a re-split: the SplIter's
  ``partitions_per_location`` map is rebuilt with the slow worker's
  capacity discounted — the paper's "computing capability" input made
  dynamic (DESIGN.md §5).
* :class:`PreemptionGuard` — converts SIGTERM/SIGINT into a
  checkpoint-then-exit request the training loop polls between steps.

Port of ``repro/runtime/ft.py``, unchanged (it is host code).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from collections import deque


class HeartbeatMonitor:
    def __init__(self, workers: list[str], timeout: float = 60.0):
        self.timeout = timeout
        self.last_seen = {w: time.monotonic() for w in workers}

    def beat(self, worker: str, now: float | None = None) -> None:
        self.last_seen[worker] = now if now is not None else time.monotonic()

    def dead_workers(self, now: float | None = None) -> list[str]:
        now = now if now is not None else time.monotonic()
        return [w for w, t in self.last_seen.items() if now - t > self.timeout]

    def remove(self, worker: str) -> None:
        self.last_seen.pop(worker, None)


@dataclasses.dataclass
class StragglerVerdict:
    is_straggler: bool
    worker: str | None
    ratio: float  # slowest / median


class StragglerDetector:
    """Flags a worker whose step time exceeds median · threshold for
    ``patience`` consecutive steps."""

    def __init__(self, workers: list[str], threshold: float = 1.5, patience: int = 3):
        self.threshold = threshold
        self.patience = patience
        self.history: dict[str, deque] = {w: deque(maxlen=16) for w in workers}
        self._strikes: dict[str, int] = {w: 0 for w in workers}

    def record_step(self, times: dict[str, float]) -> StragglerVerdict:
        for w, t in times.items():
            self.history[w].append(t)
        med = sorted(times.values())[len(times) // 2]
        worst = max(times, key=times.get)
        ratio = times[worst] / max(med, 1e-9)
        for w in times:
            if w == worst and ratio > self.threshold:
                self._strikes[w] += 1
            else:
                self._strikes[w] = 0
        if self._strikes[worst] >= self.patience:
            return StragglerVerdict(True, worst, ratio)
        return StragglerVerdict(False, None, ratio)

    def capacity_weights(self, workers: list[str]) -> dict[str, float]:
        """Relative capacity per worker (1/EWMA step time, normalized) —
        feeds SplIter's partitions_per_location for the re-split."""
        inv = {}
        for w in workers:
            h = self.history[w]
            inv[w] = 1.0 / (sum(h) / len(h)) if h else 1.0
        s = sum(inv.values())
        return {w: v / s * len(workers) for w, v in inv.items()}


class PreemptionGuard:
    """SIGTERM/SIGINT → graceful checkpoint request (poll ``should_stop``)."""

    def __init__(self, install: bool = True):
        self._stop = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, self._handler)

    def _handler(self, signum, frame):
        self._stop = True

    def request_stop(self) -> None:  # testable without raising signals
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
