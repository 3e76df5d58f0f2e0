"""Block functions and probes the cluster tests ship to worker processes.

A cluster worker rebuilds a task's function by importing the module that
defines it, so these live in a module that imports only torch and the
port: a worker running them never imports ``jax`` or ``repro`` (the test
modules themselves import both, to compare the packages).
"""

from __future__ import annotations

import sys

import torch


def row_sum(b):
    return torch.sum(b, dim=0)


def double(b):
    return b * 2.0


def partial(b, c):
    return (b * c).sum(dim=0)


def combine(a, b):
    return a + b


def big_partial(b):
    """A 256 KB partial (the column sums tiled): it clears the peer
    exchange's ``"auto"`` gate."""
    return torch.sum(b, dim=0).repeat(65536 // b.shape[1])


def colsum_and_one(b):
    """A partial with a 0-d leaf."""
    return torch.sum(b, dim=0), torch.ones(())


# -- the iterative plan of tests/test_pipeline.py: partials -> merge -> map --


def pipe_partial(b, c):
    return (b * c).sum(0), torch.ones(())


def pipe_combine(a, b):
    return a[0] + b[0], a[1] + b[1]


def pipe_boom(b, c):
    raise ValueError("injected unit failure")


def module_roots():
    """The top-level package names this process has imported."""
    return sorted({name.split(".")[0] for name, mod in sys.modules.items() if mod is not None})


def launch_counts():
    """This process's launch counts of the partition kernels' wrappers."""
    from repro_torch.kernels import partition_reduce as pr

    return {
        "partition_histogramdd": pr.partition_histogramdd.launches,
        "partition_kmeans": pr.partition_kmeans.launches,
    }


def bury_when_mute(ex, wid: int) -> None:
    """Make the supervisor see worker ``wid``'s silence pass the timeout as
    soon as its log records the injected mute — the clock-free stand-in for
    ``heartbeat_timeout_s`` of real silence."""
    check = ex._check_workers

    def checked():
        handle = ex._workers.get(wid)
        if handle is not None and "FAULT: muting" in _read(handle.log_path):
            ex._silence[wid] = ex.heartbeat_timeout_s
            ex._last_pump -= 1e-3  # the next tick adds observed silence
        check()

    ex._check_workers = checked


def _read(path) -> str:
    try:
        with open(path) as f:
            return f.read()
    except FileNotFoundError:
        return ""
