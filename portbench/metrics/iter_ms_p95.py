"""iter_ms_p95: the 95th percentile of every execute's ``EngineReport.wall_s``
in the window (one per k-means iteration; it includes the synchronise)."""

from portbench.harness import percentile


def read(w):
    walls = [r.wall_s for r in w.reports]
    return 1e3 * percentile(walls, 95) if walls else None
