"""Mesh construction: production meshes and small test meshes.

Port of ``repro/launch/mesh.py``.  Functions, not module-level constants:
importing this module touches no device.

Single pod: 16×16 = 256 ranks, axes (data, model).
Multi-pod:  2×16×16 = 512 ranks, axes (pod, data, model) — the leading
"pod" axis is the slow (DCN/inter-pod) dimension; gradient reductions are
hierarchical across it.

A rank is a position of the mesh's device array, and a device may fill
several (:mod:`repro_torch.distributed.spmd`): ``devices=None`` means the
visible cards, repeated in order (rank *r* on card *r mod n*) to fill the
mesh, as passed devices are.  A host without a card raises unless devices
are passed, as :class:`~repro_torch.api.mesh_executor.MeshExecutor` does.
The production meshes are metadata for the sharding rules; nothing here
runs 256 ranks.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from repro_torch.distributed.spmd import Mesh

__all__ = ["compat_make_mesh", "make_production_mesh", "make_test_mesh"]

log = logging.getLogger(__name__)


def compat_make_mesh(shape, axes, devices=None) -> Mesh:
    """``jax.make_mesh`` for the port: a mesh of ``shape`` with ``axes``
    over ``devices`` (default: the visible cards), the first ``size`` of
    them, or all of them repeated in order when there are fewer (their
    count must divide the mesh's size; the repetition is logged)."""
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "compat_make_mesh(devices=None) means the visible CUDA devices and this "
                "host has none; pass devices=(torch.device('cpu'),) to build the mesh on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("compat_make_mesh needs at least one device")
    if len(devices) < size:
        if size % len(devices):
            raise ValueError(f"{len(devices)} devices do not tile a mesh of {size} ranks")
        log.info("mesh %s %s: %d devices repeated, %d ranks on each", shape, tuple(axes),
                 len(devices), size // len(devices))
    arr = np.empty(size, dtype=object)
    for r in range(size):
        arr[r] = devices[r % len(devices)]
    return Mesh(arr.reshape(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_make_mesh(shape, axes, devices)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), devices=None) -> Mesh:
    """Small mesh for the distribution tests."""
    return compat_make_mesh(shape, axes, devices)
