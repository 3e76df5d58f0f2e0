"""Partition-kernel registry — fused hand-written implementations of block fns.

The generic SplIter lowering fuses a partition's per-block work into one
task that folds the blocks in order (paper Listing 5).  For block functions
with a hand-written partition kernel (``repro_torch.kernels.partition_reduce``)
the lowering can do strictly better: ONE kernel launch over the partition's
stacked blocks, with the reduction kept on chip.

The registry maps a *base* block function to a factory.  App modules
register their kernels at import time (``repro_torch/core/apps/histogram.py``,
``.../kmeans.py``); the lowering pass resolves ``spec.fn`` — unwrapping
``functools.partial`` layers so e.g. ``partial(histogramdd_block, bins=8)``
finds the histogram kernel with the right static parameters — and emits a
``partition_pallas`` task when the policy's ``fusion`` knob and the backend
capabilities allow it (the task kind keeps the JAX package's name, so the
two packages describe the same plan with the same text).  Contract: for a
stacked run ``(nblocks, rows, *row)`` the kernel's result equals folding
``block_fn`` over the blocks with the plan's ``combine`` (up to float
reassociation), so fused and generic lowerings are interchangeable.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Hashable

import torch

__all__ = [
    "PartitionKernel",
    "register_partition_kernel",
    "partition_kernel_for",
    "kernel_ref",
    "kernel_from_ref",
    "pallas_interpret",
]


def pallas_interpret(operand: torch.Tensor) -> bool:
    """Whether a kernel wrapper runs its plain PyTorch version on ``operand``.

    The hand-written kernel launches iff the operand lies on a CUDA device;
    on the CPU the wrapper runs the plain version of the same function.
    Any other device raises — there is no silent fallback.

    >>> import torch
    >>> pallas_interpret(torch.zeros(2))
    True
    """
    kind = operand.device.type
    if kind == "cuda":
        return False
    if kind == "cpu":
        return True
    raise ValueError(f"partition kernels run on cuda or cpu tensors, not {kind}")


@dataclasses.dataclass(frozen=True)
class PartitionKernel:
    """A fused per-partition implementation of one block fn + combine.

    Attributes:
      name: human-readable kernel name (shows up in ``TaskGraph`` dumps).
      key: stable task-cache key — must encode every static parameter baked
        into ``fn`` (e.g. ``("hist_dd", bins, lo, hi)``) so two plans with
        different statics never share a registered task.
      fn: ``fn(stacked, *extra_args) -> partial`` where ``stacked`` is the
        partition's same-shape blocks ``(nblocks, rows, *row_shape)`` and
        the result matches the block-fn/combine fold over those blocks.
      supports: optional shape guard ``(stacked_shape, extra_args) -> bool``;
        returning False falls back to the generic fold lowering.
    """

    name: str
    key: Hashable
    fn: Callable
    supports: Callable[[tuple, tuple], bool] | None = None

    def supported(self, stacked_shape: tuple, extra_args: tuple) -> bool:
        return self.supports is None or bool(self.supports(stacked_shape, extra_args))


# base block fn -> factory(partial_args, partial_kwargs) -> PartitionKernel | None
_REGISTRY: dict[Callable, Callable[[tuple, dict], PartitionKernel | None]] = {}
# registry NAME -> factory, and base fn -> registry name: the by-name lookup
# surface a worker process rehydrates kernels through.
_BY_NAME: dict[str, Callable[[tuple, dict], PartitionKernel | None]] = {}
_NAMES: dict[Callable, str] = {}


def register_partition_kernel(
    block_fn: Callable,
    factory: Callable[[tuple, dict], PartitionKernel | None],
    *,
    name: str | None = None,
) -> None:
    """Register a fused-kernel factory for ``block_fn``.

    ``factory(args, kwargs)`` receives the positional/keyword arguments
    accumulated on any ``functools.partial`` wrappers around ``block_fn``
    (empty when the fn is used bare) and returns a
    :class:`PartitionKernel`, or None when those statics have no fused
    implementation.  ``name`` defaults to ``"module:qualname"`` of
    ``block_fn``, which doubles as the import spec that triggers the
    registration in a fresh process.
    """
    if name is None:
        name = f"{block_fn.__module__}:{block_fn.__qualname__}"
    _REGISTRY[block_fn] = factory
    _BY_NAME[name] = factory
    _NAMES[block_fn] = name


def _unwrap(fn: Callable) -> tuple[Callable, tuple, dict]:
    """Peel ``functools.partial`` layers, merging their args/kwargs."""
    args: tuple = ()
    kwargs: dict = {}
    while isinstance(fn, functools.partial):
        args = fn.args + args
        kwargs = {**fn.keywords, **kwargs}
        fn = fn.func
    return fn, args, kwargs


def partition_kernel_for(fn: Callable) -> PartitionKernel | None:
    """Resolve the registered fused kernel for a (possibly partial) block fn."""
    base, args, kwargs = _unwrap(fn)
    factory = _REGISTRY.get(base)
    if factory is None:
        return None
    return factory(args, kwargs)


def kernel_ref(fn: Callable) -> tuple | None:
    """Picklable by-name reference for the kernel a block fn resolves to.

    ``(name, args, sorted_kwargs)``, or None when ``fn`` has no registered
    kernel or carries unhashable statics.
    """
    base, args, kwargs = _unwrap(fn)
    name = _NAMES.get(base)
    if name is None:
        return None
    statics = (tuple(args), tuple(sorted(kwargs.items())))
    try:
        hash(statics)
    except TypeError:
        return None
    return (name, *statics)


def kernel_from_ref(ref: tuple) -> PartitionKernel | None:
    """Rebuild a kernel from :func:`kernel_ref` output.

    Importing the module half of the registry name runs its
    ``register_partition_kernel`` calls, so a fresh process finds the
    factory without any extra bootstrapping.
    """
    import importlib

    name, args, kw = ref
    if name not in _BY_NAME:
        importlib.import_module(name.split(":", 1)[0])
    factory = _BY_NAME.get(name)
    if factory is None:
        return None
    return factory(tuple(args), dict(kw))
