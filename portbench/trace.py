"""Reduction of a profiler trace to device busy time, op times and idle gaps.

The profiler's events are first read into plain tuples ``(name, on_device,
start_s, end_s)`` (:func:`events_of`), so that the reduction
(:func:`reduce_events`) runs on any list of them.  The window is the span of
the host event named ``WINDOW``, which the harness opens around the measured
loop.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re

__all__ = ["WINDOW", "Trace", "events_of", "reduce_events", "kernel_seconds"]

WINDOW = "portbench.window"
#: Host events looked at, backwards from a gap's end, to name its parts.
_LOOKBACK = 512
#: Characters of an event's name that are kept (a kernel's name holds its
#: template arguments and its parameters).
_NAME = 96
#: Prefix of the harness's own spans (one job each), which may outlast that.
_SPANS = "portbench."


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s: float                  # sum of every device op's time (not a union)
    op_s: dict[str, float]           # device time by op name
    gap_s: dict[str, float]          # idle device time by the host event it fell in


def events_of(prof) -> list[tuple[str, bool, float, float]]:
    """The events of a finished ``torch.profiler.profile`` as plain tuples."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        if on_device and e.is_user_annotation():
            continue  # a host span's shadow on the device's timeline, not an operation
        start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        out.append((e.name()[:_NAME], on_device, start, start + dur))
    return out


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _host_split(host: list, starts: list[float], spans: list, span_starts: list[float],
                a: float, b: float, into: dict[str, float]) -> None:
    """Add each part of the idle interval ``[a, b]`` to the innermost host
    event running in it (the latest started that has not ended).  ``spans``
    are the harness's own long spans, looked at whatever their age."""
    i, j = bisect.bisect_right(starts, b), bisect.bisect_right(span_starts, b)
    near = [e for e in host[max(0, i - _LOOKBACK):i] + spans[max(0, j - 2):j] if e[3] > a]
    near.sort(key=lambda e: e[2])
    cuts = sorted({a, b, *(t for e in near for t in (e[2], e[3]) if a < t < b)})
    for u, v in zip(cuts, cuts[1:]):
        inner = next((e[0] for e in reversed(near) if e[2] <= u and e[3] >= v),
                     "(no host event)")
        into[inner] += v - u


def reduce_events(events: list[tuple[str, bool, float, float]]) -> Trace | None:
    """Busy time, op times and idle gaps inside the ``WINDOW`` host event;
    None where the trace holds no window or no device op in it."""
    windows = [(a, b) for name, dev, a, b in events if not dev and name == WINDOW]
    if not windows:
        return None
    w0, w1 = windows[0]
    device = [(n, max(a, w0), min(b, w1)) for n, dev, a, b in events
              if dev and b > w0 and a < w1]
    if not device:
        return None
    op_s: dict[str, float] = collections.Counter()
    for n, a, b in device:
        op_s[n] += b - a
    busy = _union([(a, b) for _, a, b in device])
    host = sorted((e for e in events if not e[1] and e[0] != WINDOW), key=lambda e: e[2])
    spans = [e for e in host if e[0].startswith(_SPANS)]
    host = [e for e in host if not e[0].startswith(_SPANS)]
    starts, span_starts = [e[2] for e in host], [e[2] for e in spans]
    gap_s: dict[str, float] = collections.Counter()
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            _host_split(host, starts, spans, span_starts, edge, a, gap_s)
        edge = max(edge, b)
    return Trace(window_s=w1 - w0, busy_s=sum(b - a for a, b in busy),
                 device_s=sum(op_s.values()), op_s=dict(op_s), gap_s=dict(gap_s))


def kernel_seconds(trace: Trace, names) -> float:
    """Device time of the ops whose name holds one of ``names`` as a word."""
    pattern = re.compile("|".join(rf"\b{re.escape(n)}\b" for n in names))
    return sum(s for op, s in trace.op_s.items() if pattern.search(op))
