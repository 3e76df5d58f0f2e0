"""Async, atomic checkpointing of tensor trees.

Layout of one checkpoint step directory (the JAX package's, file for file)::

    <root>/step_000000123/
        MANIFEST.json     # leaf paths, shapes, dtypes, extras
        leaf_00000.npy    # one file per tree leaf, on the host
        ...
    <root>/step_000000123.COMMITTED   # atomic commit marker (written last)

* **atomicity** — writers fill a ``.tmp`` directory, fsync the manifest,
  rename, and only then drop the COMMITTED marker; a crashed save can never
  be mistaken for a valid checkpoint (restore scans for the newest
  COMMITTED step).
* **async** — ``save(..., blocking=False)`` copies every leaf to the host
  (a copy to the CPU waits for the card's queued work on it) before it
  returns and hands the file IO to a writer thread; ``wait()`` joins
  before the next save or exit.
* **trees** — nested dicts, lists, tuples and registered dataclasses of
  tensors (the port's :mod:`repro_torch._pytree`; the optimizer's
  ``AdamWState``).  Leaves flatten in the JAX package's order: dict keys
  sorted, sequences in order, a dataclass's fields in declaration order,
  so leaf ``i`` of a step is the same leaf whichever package wrote it; a
  field's path element is ``.<name>``, as ``jax.tree_util`` names it
  (``1/.m/embed`` for ``(params, opt)``).
* **bf16** — numpy has no bfloat16.  A bf16 leaf is stored as its 16-bit
  patterns in a two-byte void array (``'<V2'``), with the manifest's
  ``dtype`` saying ``bfloat16``: the bytes the JAX package's ``np.save``
  writes for an ``ml_dtypes.bfloat16`` leaf.
* **self-describing** — :meth:`load_manifest` reads a step without a
  template; :meth:`restore` rebuilds the template's structure and puts each
  leaf on the template leaf's device and dtype.
* **elastic** — a :class:`~repro_torch.distributed.spmd.ShardedTensor`
  leaf is saved as its full value, and ``restore(..., shardings=...)``
  places each leaf by its sharding on the current mesh, whatever layout
  it was saved from (8 ranks restore onto 2).

>>> import tempfile, torch
>>> ckpt = Checkpointer(tempfile.mkdtemp())
>>> ckpt.save(3, {"w": torch.ones(2, dtype=torch.bfloat16)}, extras={"note": "x"})
>>> tree, extras, step = ckpt.restore({"w": torch.zeros(2, dtype=torch.bfloat16)})
>>> tree["w"], extras, step
(tensor([1., 1.], dtype=torch.bfloat16), {'note': 'x'}, 3)
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch._pytree import dataclass_fields
from repro_torch.distributed.spmd import ShardedTensor

__all__ = ["Checkpointer"]

_COMMIT_SUFFIX = ".COMMITTED"


def _flatten_with_paths(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` in the JAX package's leaf order."""
    names = dataclass_fields(tree)
    if names is not None:
        return [
            item
            for n in names
            for item in _flatten_with_paths(getattr(tree, n), prefix + (f".{n}",))
        ]
    if isinstance(tree, dict):
        return [
            item
            for k in sorted(tree)
            for item in _flatten_with_paths(tree[k], prefix + (k,))
        ]
    if isinstance(tree, (list, tuple)):
        return [
            item
            for i, t in enumerate(tree)
            for item in _flatten_with_paths(t, prefix + (i,))
        ]
    return [(prefix, tree)]


def _unflatten(template: Any, leaves) -> Any:
    """Rebuild ``template``'s structure from ``leaves`` (an iterator)."""
    names = dataclass_fields(template)
    if names is not None:
        return type(template)(**{n: _unflatten(getattr(template, n), leaves) for n in names})
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(t, leaves) for t in template)
    return next(leaves)


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _host(leaf) -> np.ndarray:
    """A leaf's host copy as the array the leaf file holds (a copy even of a
    CPU tensor: the caller may mutate its tensors once ``save`` returns)."""
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.full("cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _save_leaf(path: str, arr: np.ndarray) -> None:
    """``np.save``, except that a bf16 leaf's header says ``'<V2'`` as the
    JAX package's (``ml_dtypes.bfloat16``) does, where numpy's own void
    type would say ``'|V2'``: the two files are then byte for byte equal."""
    if arr.dtype.kind != "V":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        header = {"descr": "<V2", "fortran_order": False, "shape": arr.shape}
        np.lib.format.write_array_header_1_0(f, header)
        f.write(np.ascontiguousarray(arr).tobytes())


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """The tensor a stored leaf holds (bf16 from its 16-bit patterns)."""
    arr = np.asarray(arr, order="C")
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._writer: threading.Thread | None = None

    # ------------------------------------------------------------- save --

    def save(
        self,
        step: int,
        tree: Any,
        *,
        extras: dict[str, Any] | None = None,
        blocking: bool = True,
    ) -> None:
        """Snapshot ``tree`` (a tree of tensors) + JSON-able ``extras``."""
        self.wait()
        flat = _flatten_with_paths(tree)
        # host snapshot NOW, so the caller may mutate its tensors after we return
        host_leaves = [_host(leaf) for _, leaf in flat]
        manifest = {
            "step": step,
            "treedef": None,
            "paths": ["/".join(str(k) for k in path) for path, _ in flat],
            "leaves": [
                {
                    "shape": list(h.shape),
                    "dtype": _dtype_name(leaf.dtype)
                    if isinstance(leaf, (torch.Tensor, ShardedTensor))
                    else str(h.dtype),
                }
                for (_, leaf), h in zip(flat, host_leaves)
            ],
            "extras": extras or {},
            "time": time.time(),
        }

        def write():
            name = f"step_{step:09d}"
            tmp = os.path.join(self.root, name + ".tmp")
            final = os.path.join(self.root, name)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for i, arr in enumerate(host_leaves):
                _save_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            # commit marker LAST — crash before this line = checkpoint absent
            with open(final + _COMMIT_SUFFIX, "w") as f:
                f.write(name)

        if blocking:
            write()
        else:
            self._writer = threading.Thread(target=write, daemon=True)
            self._writer.start()

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    # ---------------------------------------------------------- restore --

    def latest_step(self) -> int | None:
        steps = []
        for f in os.listdir(self.root):
            if f.endswith(_COMMIT_SUFFIX):
                steps.append(int(f[len("step_") : -len(_COMMIT_SUFFIX)]))
        return max(steps) if steps else None

    def load_manifest(self, step: int | None = None) -> tuple[dict[str, Any], int]:
        """Read a committed step's MANIFEST.json without loading leaves.

        The template-free inspection path: a
        :class:`~repro_torch.api.jobserver.JobServer` snapshots scheduler
        state as pure-JSON ``extras``, so resume only needs the manifest.
        Returns ``(manifest, step)``; raises ``FileNotFoundError`` when no
        committed step exists — a ``.tmp`` directory or a step directory
        without its COMMITTED marker is never considered.
        """
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {self.root}")
        d = os.path.join(self.root, f"step_{step:09d}")
        if not os.path.exists(d + _COMMIT_SUFFIX):
            raise FileNotFoundError(f"uncommitted checkpoint {d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            return json.load(f), step

    def restore(
        self, template: Any, *, step: int | None = None, shardings: Any | None = None
    ) -> tuple[Any, dict[str, Any], int]:
        """Restore into the structure of ``template`` (shapes must match).

        Each leaf takes the template leaf's dtype and goes onto its device;
        a leaf whose template lies on the ``meta`` device (a shape-only
        template, as ``jax.eval_shape`` gives the JAX package) goes onto the
        host.  ``shardings`` (a tree like ``template`` of
        :class:`~repro_torch.distributed.spmd.NamedSharding`, ``None``
        leaves left to the template) places every leaf as a
        :class:`~repro_torch.distributed.spmd.ShardedTensor` on the current
        mesh — the elastic-restart path; a ``ShardedTensor`` template leaf
        without one keeps its own sharding.  Returns ``(tree, extras, step)``.
        """
        self.wait()
        step = step if step is not None else self.latest_step()
        assert step is not None, f"no committed checkpoint under {self.root}"
        d = os.path.join(self.root, f"step_{step:09d}")
        assert os.path.exists(d + _COMMIT_SUFFIX), f"uncommitted checkpoint {d}"
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)

        flat = _flatten_with_paths(template)
        assert len(flat) == len(manifest["leaves"]), (len(flat), len(manifest["leaves"]))
        placements = (
            [s for _, s in _flatten_with_paths(shardings)]
            if shardings is not None
            else [None] * len(flat)
        )
        assert len(placements) == len(flat), (len(placements), len(flat))
        out_leaves = []
        for i, ((_, tmpl), meta) in enumerate(zip(flat, manifest["leaves"])):
            arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
            assert list(arr.shape) == list(meta["shape"])
            assert tuple(arr.shape) == tuple(tmpl.shape), (
                manifest["paths"][i],
                arr.shape,
                tmpl.shape,
            )
            value = _from_host(arr, meta["dtype"]).to(dtype=tmpl.dtype)
            placement = placements[i]
            if placement is None and isinstance(tmpl, ShardedTensor):
                placement = tmpl.sharding
            if placement is not None:
                out_leaves.append(ShardedTensor.from_global(value, placement))
                continue
            device = "cpu" if tmpl.device.type == "meta" else tmpl.device
            out_leaves.append(value.to(device=device))
        tree = _unflatten(template, iter(out_leaves))
        return tree, manifest["extras"], step

    # ------------------------------------------------------------- gc ----

    def keep_last(self, n: int) -> None:
        """Delete all but the newest ``n`` committed checkpoints."""
        steps = sorted(
            int(f[len("step_") : -len(_COMMIT_SUFFIX)])
            for f in os.listdir(self.root)
            if f.endswith(_COMMIT_SUFFIX)
        )
        for s in steps[:-n] if n else steps:
            name = os.path.join(self.root, f"step_{s:09d}")
            os.remove(name + _COMMIT_SUFFIX)
            shutil.rmtree(name, ignore_errors=True)
