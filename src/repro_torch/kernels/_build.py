"""Build the CUDA sources under ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface; no PyTorch header is
included, so a build takes seconds.  Libraries land in ``build/repro_torch/``
at the root of the checkout, named by a hash of the source, of every shared
header ``csrc/*.cuh`` and of the flags, so a changed source or header
rebuilds and an unchanged one is reused.  Nothing is
built when a module is imported: the first launch of a kernel builds it,
and :func:`build` compiles several sources at once (one ``nvcc`` process
each, all started together).

A kernel launched through ctypes is invisible to PyTorch's dispatcher, so
an operation counter (``torch.utils.flop_counter``, the dry-run's
``count_cost``) would count a step without it.  :func:`recording_costs`
collects, per thread, the ``(name, flops, bytes)`` that each kernel wrapper
reports for a launch on the card or a call on ``meta`` (the wrappers'
shape-only route); outside it a wrapper's only extra work is the check of
:func:`cost_sink`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["REPORTS", "SOURCES", "build", "cost_sink", "count_launch", "kernel_function",
           "records_grad", "recording_costs", "refuse_grad"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = (
    "flash_attention", "partition_histogram", "partition_histogramdd", "partition_kmeans",
    "ssd_scan",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_costs = threading.local()
#: The compiler's report (``-Xptxas -v``: registers, spills, stack per
#: kernel) of each library that :func:`build` compiled with ``verbose``.
REPORTS: dict[str, str] = {}


def _nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, *, verbose: bool = False) -> dict[str, Path]:
    """Compile every missing library of ``names`` in parallel; return paths.

    ``verbose`` compiles every library of ``names`` again with ``-Xptxas
    -v``, prints each compiler report (registers, static shared memory,
    stack and spills per kernel) and keeps it in :data:`REPORTS`.
    """
    targets = {name: _target(name) for name in names}
    missing = {n: t for n, t in targets.items() if verbose or not t.exists()}
    if not missing:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, target in missing.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ))
    failures = []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{out}{err}")
            tmp.unlink(missing_ok=True)
            continue
        if verbose:
            REPORTS[name] = f"{out}{err}"
            print(f"[build {name}] {out}{err}".rstrip())
        os.replace(tmp, missing[name])  # atomic: concurrent builders agree
    if failures:
        raise RuntimeError("\n".join(failures))
    return targets


def kernel_function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of library ``name``, built on first use.

    Every entry point returns the ``cudaError_t`` of its launch as an int.
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build((name,))[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def count_launch(fn, counter: str = "launches") -> None:
    """Add one to the launch count ``fn.<counter>`` of a kernel wrapper.

    Wrappers run on executor worker threads too, and ``+=`` on an attribute
    is a read and a write that two threads can interleave, losing a count.
    """
    with _count_lock:
        setattr(fn, counter, getattr(fn, counter) + 1)


def cost_sink() -> list | None:
    """The list this thread's kernel wrappers append their ``(name, flops,
    bytes)`` to, or None outside :func:`recording_costs`."""
    return getattr(_costs, "sink", None)


@contextlib.contextmanager
def recording_costs():
    """Collect the costs the kernel wrappers of this thread report (the
    module's docstring) into the list it yields; nests."""
    outer, _costs.sink = cost_sink(), []
    try:
        yield _costs.sink
    finally:
        _costs.sink = outer


def records_grad(*tensors) -> bool:
    """Whether autograd records an operation on ``tensors``: grad mode is on
    and one of them requires a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    )


def refuse_grad(name: str, *operands) -> None:
    """Raise where a kernel wrapper would take part in a gradient.

    A wrapper fills its output through ctypes, so the output has no
    ``grad_fn`` and autograd would take it for a constant: every weight
    upstream would get a zero gradient without a word.  No backward kernel
    exists, in this package or in the JAX package (whose Pallas kernels
    have no ``custom_vjp``), so the caller must take the plain route
    (``repro_torch.models`` does so whenever autograd records).  Both the
    CUDA and the CPU route raise, so a CPU run sees what a card run would.
    """
    if records_grad(*operands):
        raise RuntimeError(
            f"{name}: an operand requires a gradient, and the kernel has no backward "
            "(none exists in either package); call it under torch.no_grad() or take "
            "the plain route"
        )
