"""Build the CUDA sources under ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface; no PyTorch header is
included, so a build takes seconds.  Libraries land in ``build/repro_torch/``
at the root of the checkout, named by a hash of the source and the flags,
so a changed source rebuilds and an unchanged one is reused.  Nothing is
built when a module is imported: the first launch of a kernel builds it,
and :func:`build` compiles several sources at once (one ``nvcc`` process
each, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "build", "kernel_function"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("partition_histogramdd", "partition_kmeans")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


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
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES, *, verbose: bool = False) -> dict[str, Path]:
    """Compile every missing library of ``names`` in parallel; return paths.

    ``verbose`` adds ``-Xptxas -v`` and prints each compiler report
    (registers, shared memory and spills per kernel).
    """
    targets = {name: _target(name) for name in names}
    missing = {n: t for n, t in targets.items() if not t.exists()}
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
