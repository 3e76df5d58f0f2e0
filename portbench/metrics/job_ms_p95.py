"""job_ms_p95: the 95th percentile of every job's wall time in the window,
on the host's clock around the call and the device's synchronise."""

from portbench.harness import percentile


def read(w):
    return 1e3 * percentile(w.job_s, 95) if w.job_s else None
