"""Single-controller SPMD over a mesh of device positions.

The port's stand-in for what ``jax.sharding`` and ``shard_map`` give the
JAX package: a :class:`Mesh`, :class:`PartitionSpec` (``P``),
:class:`NamedSharding`, a :class:`ShardedTensor` that holds one local
tensor per rank, :func:`device_put`, :func:`shard_map` with collectives
inside its body, the data-parallel and tensor-parallel train steps built on
them, and the tensor-parallel serving steps (:func:`sharded_prefill`,
:func:`sharded_decode_step`).

**Why one process.**  The JAX package is single-controller: one process
drives every device of a mesh, and its tests force 8 host devices.
``torch.distributed`` runs one process per rank, NCCL refuses two ranks on
one card, and a host may have one card or none.  So the port keeps the
reference's model, as :class:`~repro_torch.api.mesh_executor.MeshExecutor`
does: one process drives every rank, and a rank is a position of a device
array that may repeat a device (8 ranks on ``cuda:0``, or on ``cpu``).

**shard_map.**  The body runs once per rank, in one thread per rank (a
one-rank mesh runs it in the caller's thread; the threads are kept and
reused across calls).  The ranks take turns: rank *r* runs until its next
collective and hands over to rank *r + 1*, so one rank thread runs at a
time, in rank order between collectives (:class:`_Rendezvous` says why).
Each thread runs with the caller's grad mode and, on a card, the caller's
current stream of that device, so the ranks of one card queue their work
on one stream in the order the host queues it: a collective reads the
tensors other ranks queued before they reached it.  Inputs are split into rank-local shards by
``in_specs``; a rank whose device holds the input gets a *view* of it, so
an in-place write in the body lands in the caller's tensor (the decode
cache's sharded write relies on this).  Outputs are assembled by
``out_specs`` into global tensors on rank 0's device; a replicated output
axis takes rank 0 of that axis, as JAX does with ``check_vma=False``.
``check_vma`` is accepted for the reference's signature and checks
nothing.

**Collectives** (:func:`psum`, :func:`pmax`, :func:`psum_scatter`,
:func:`all_gather`, :func:`ppermute`, :func:`axis_index`, :func:`axis_size`)
are rendezvous of the rank threads: every rank of the mesh deposits its
operand, and once all have, each computes its result with torch ops on its
own device.

* Reductions fold in rank order (position order within the group), never
  arrival order, so a result does not depend on thread timing; bf16 and
  f16 operands are summed in f32 and rounded once.
* ``psum`` and ``all_gather`` are computed once per group and device, and
  the group's ranks on that device receive views of the same storage:
  treat a collective's result as read-only, as JAX's values are.
* They are differentiable by their transposes, as JAX's are: the
  cotangent of a ``psum`` passes to the rank's operand (Megatron's
  ``g``), that of an ``all_gather`` is ``psum_scatter``-ed and that of a
  ``psum_scatter`` all-gathered; :func:`pvary` is the identity whose
  cotangent is ``psum``-ed (Megatron's ``f``); ``pmax`` carries no
  gradient.  A backward that calls a collective must run in the rank's
  thread: in a rank body ``repro_torch.optim.value_and_grad`` runs it in
  segments (:func:`backward_segments`), as it must on a card, where
  PyTorch runs a graph's backward on the card's own autograd thread.
* ``ppermute`` gives zeros to a rank that no pair targets.
* A rank that raises wakes the others into ``BrokenBarrierError``, and
  the caller gets the raising rank's exception.  Ranks that call different
  collectives (or one rank returns while another waits in one) raise
  ``RuntimeError`` rather than hang.

**A mesh of ``meta`` positions is shape-only** (the dry-run's production
meshes: one ``meta`` device over 256 or 512 positions).  There is no value
to compute, so ``shard_map`` runs one representative rank, rank 0, in the
caller's thread, and each collective returns an empty tensor of its
result's shape without a rendezvous; the other ranks are taken to run the
same program, as the ranks of a data-parallel step do.  An operation
counter entered in the caller's thread therefore sees the whole rank
program (a counter sees only its own thread's operations).

**Tensor-parallel serving.**  PyTorch has no GSPMD to partition a step by
its shardings, so the serving steps are rank programs written out: each
rank keeps its ``model`` shards of the params (heads, MLP columns,
vocabulary rows, as ``params_shardings`` places them) and its block of the
cache, gathers only the ``fsdp`` dims, and runs ``Model.prefill`` or
``decode_step`` with :class:`TensorParallel` set for its thread
(:func:`tensor_parallel`), which the model's layers read to call the
``model`` collectives (``models/layers.py``).  The dry-run traces the
same body (:func:`serving_body`).

**Tensor-parallel training** under ``train_rules``
(:func:`tensor_parallel_gradients`, ``sharded_train_step(..., rules=...)``,
:func:`training_step_body`): each rank keeps its ``model`` shards of the
params and both AdamW moments, gathers the ``fsdp`` dims once a step, runs
``accumulate_gradients(model.loss, ...)`` on its rows with the
vocabulary-parallel loss and the backward in segments, sums the
gradients over the data-parallel axes (the ``fsdp`` dims by the gather's
transpose, so the rank keeps its shard) and updates its shards, the
clip factor from one ``psum`` of the shards' squares.  Every config of
the repo with the onehot MoE (``Model.tensor_parallel_training_refusal``
refuses the ragged dispatch).  Under ``train_rules_sp`` the same program
holds the residual stream between blocks as each rank's rows of the
sequence over ``model`` (:attr:`TensorParallel.seq_res`, Megatron's
sequence parallelism: a reduce-scatter and an all-gather where
``train_rules`` has an all-reduce); other rule sets are refused.

**Census.**  Inside :func:`collective_census` every collective that rank 0
calls adds one to its kind's count and its operand and result bytes to its
kind's sums, under XLA's kind names (``all-reduce``, ``reduce-scatter``,
``all-gather``, ``collective-permute``).  A call over a tree of tensors is
one collective.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import queue
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch._pytree import dataclass_fields, tree_leaves, tree_map

__all__ = [
    "Mesh",
    "PartitionSpec",
    "P",
    "NamedSharding",
    "ShardedTensor",
    "device_put",
    "shard_map",
    "psum",
    "pmax",
    "psum_scatter",
    "all_gather",
    "ppermute",
    "axis_index",
    "axis_size",
    "collective_census",
    "gathered",
    "data_parallel_gradients",
    "data_parallel_scope",
    "sharded_train_step",
    "tensor_parallel_gradients",
    "training_gradients_body",
    "training_step_body",
    "pvary",
    "backward_segments",
    "model_parallel",
    "tensor_parallel_scope",
    "MODEL_AXIS",
    "TensorParallel",
    "tensor_parallel",
    "sharded_prefill",
    "sharded_decode_step",
]


# ---------------------------------------------------------------------------
# mesh, specs, shardings
# ---------------------------------------------------------------------------


def _device(d) -> torch.device:
    """``d`` as a torch.device with an index on CUDA (``cuda`` means the
    current card), so that two spellings of one card compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _axes(axis_name) -> tuple[str, ...]:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) else (axis_name,)


class Mesh:
    """An n-d array of device positions with named axes.

    ``devices`` is an array (or nested sequence) of devices whose shape is
    the mesh's; a device may appear more than once.  Rank *r* is position
    *r* of ``devices`` in row-major order.  ``shape`` maps each axis name to
    its size, as ``jax.sharding.Mesh.shape`` does.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-d device array for axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {axis_names}")
        self._devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self._devices[idx] = _device(arr[idx])
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))
        self.device_list = tuple(self._devices.flat)
        #: every position on ``meta``: shard_map runs one representative rank
        self.shape_only = bool(self.device_list) and all(
            d.type == "meta" for d in self.device_list)
        self._coords = [tuple(int(c) for c in np.unravel_index(r, arr.shape))
                        for r in range(arr.size)] if arr.size else []
        self._group_cache: dict[tuple[str, ...], dict] = {}
        self._lock = threading.Lock()

    @property
    def devices(self) -> np.ndarray:
        return self._devices

    @property
    def size(self) -> int:
        return len(self.device_list)

    def coords(self, rank: int) -> tuple[int, ...]:
        return self._coords[rank]

    def axis_size(self, axis_name) -> int:
        return math.prod(self.shape[a] for a in _axes(axis_name))

    def position(self, rank: int, axes: tuple[str, ...]) -> int:
        """The rank's index along ``axes`` (row-major over them, in the
        order given)."""
        c = self._coords[rank]
        pos = 0
        for a in axes:
            i = self.axis_names.index(a)
            pos = pos * self.shape[a] + c[i]
        return pos

    def groups(self, axes: tuple[str, ...]) -> dict[int, tuple[tuple[int, ...], int]]:
        """rank -> (its group's ranks in position order, its position), for
        collectives over ``axes``: a group is the ranks that share their
        coordinates on every other axis."""
        with self._lock:
            hit = self._group_cache.get(axes)
            if hit is not None:
                return hit
            for a in axes:
                if a not in self.shape:
                    raise ValueError(f"axis {a!r} is not in the mesh's axes {self.axis_names}")
            others = [i for i, a in enumerate(self.axis_names) if a not in axes]
            by_key: dict[tuple, list[int]] = {}
            for r, c in enumerate(self._coords):
                by_key.setdefault(tuple(c[i] for i in others), []).append(r)
            groups = [tuple(sorted(rs, key=lambda r: self.position(r, axes)))
                      for rs in by_key.values()]
            of = {r: (g, g.index(r)) for g in groups for r in g}
            self._group_cache[axes] = of
            return of

    def _key(self):
        return self.axis_names, tuple(self.shape.values()), self.device_list

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.device_list})
        return f"Mesh({self.shape}, devices={devs})"


def _entry(e):
    """A spec entry as JAX normalizes it: a one-axis tuple is the axis."""
    if isinstance(e, (tuple, list)):
        return e[0] if len(e) == 1 else tuple(e)
    return e


class PartitionSpec(tuple):
    """Per-dimension mesh axes: ``None`` (replicated), an axis name, or a
    tuple of axis names (the dim split over their product, row-major in the
    order given; a one-axis tuple is that axis, as in JAX).  Dims past the
    spec's length are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + (tuple.__repr__(self) if len(self) != 1 else f"({self[0]!r})")


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` over a :class:`Mesh`."""

    mesh: Mesh
    spec: PartitionSpec

    def __post_init__(self):
        object.__setattr__(self, "spec", PartitionSpec(*self.spec))
        seen: list[str] = []
        for e in self.spec:
            for a in _axes(e) if e is not None else ():
                if a not in self.mesh.shape:
                    raise ValueError(f"spec {self.spec}: no axis {a!r} in {self.mesh}")
                if a in seen:
                    raise ValueError(f"spec {self.spec} names axis {a!r} twice")
                seen.append(a)

    @property
    def num_devices(self) -> int:
        """The mesh's rank count, as ``jax.sharding.NamedSharding.num_devices``."""
        return self.mesh.size

    def _entry(self, d: int):
        return self.spec[d] if d < len(self.spec) else None

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        out = []
        for d, n in enumerate(shape):
            e = self._entry(d)
            parts = 1 if e is None else self.mesh.axis_size(e)
            if n % parts:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {e} ({parts})")
            out.append(n // parts)
        return tuple(out)

    def index(self, rank: int, shape: Sequence[int]) -> tuple[slice, ...]:
        """The slices of a global tensor of ``shape`` that rank ``rank`` holds."""
        local = self.shard_shape(shape)
        out = []
        for d, n in enumerate(local):
            e = self._entry(d)
            i = 0 if e is None else self.mesh.position(rank, _axes(e))
            out.append(slice(i * n, (i + 1) * n))
        return tuple(out)

    def owners(self) -> list[int]:
        """One rank per distinct shard: the ranks at coordinate 0 of every
        axis the spec does not name."""
        named = {a for e in self.spec if e is not None for a in _axes(e)}
        free = [i for i, a in enumerate(self.mesh.axis_names) if a not in named]
        return [r for r in range(self.mesh.size)
                if all(self.mesh.coords(r)[i] == 0 for i in free)]


def _assemble(shape, sharding: NamedSharding, locals_: Sequence[torch.Tensor],
              device=None, *, copy: bool = False) -> torch.Tensor:
    """The global tensor whose rank shards are ``locals_`` (by ``sharding``);
    a replicated one is rank 0's tensor itself unless ``copy``."""
    device = _device(device) if device is not None else sharding.mesh.device_list[0]
    owners = sharding.owners()
    if len(owners) == 1:  # every dim replicated
        return locals_[owners[0]].to(device, copy=copy)
    out = torch.empty(tuple(shape), dtype=locals_[0].dtype, device=device)
    for r in owners:
        out[sharding.index(r, shape)] = locals_[r].to(device)
    return out


class ShardedTensor:
    """A global tensor laid out by a :class:`NamedSharding`: one local
    tensor per rank, on that rank's device (``shards[r]``)."""

    def __init__(self, shape, sharding: NamedSharding, shards: Sequence[torch.Tensor]):
        self.shape = torch.Size(shape)
        self.sharding = sharding
        self.shards = tuple(shards)
        if len(self.shards) != sharding.mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of {sharding.mesh.size}")

    @classmethod
    def from_global(cls, x: torch.Tensor, sharding: NamedSharding) -> "ShardedTensor":
        """``x`` split by ``sharding``, each rank's shard a copy on its device."""
        shards = [x[sharding.index(r, x.shape)].to(dev, copy=True)
                  for r, dev in enumerate(sharding.mesh.device_list)]
        return cls(x.shape, sharding, shards)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def full(self, device=None) -> torch.Tensor:
        """The global value on ``device`` (default: rank 0's)."""
        return _assemble(self.shape, self.sharding, self.shards, device, copy=True)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.sharding.spec}, mesh={self.sharding.mesh})")


def device_put(tree: Any, shardings: Any) -> Any:
    """Place every tensor leaf of ``tree`` by its sharding (a tree like
    ``tree``, or one :class:`NamedSharding` for every leaf) as a
    :class:`ShardedTensor`; a ``ShardedTensor`` leaf is gathered first."""

    def put(x, s):
        if s is None:
            return x
        if isinstance(x, ShardedTensor):
            x = x.full()
        return ShardedTensor.from_global(x, s)

    if isinstance(shardings, NamedSharding):
        return tree_map(lambda x: put(x, shardings), tree)
    return tree_map(put, tree, shardings)


# ---------------------------------------------------------------------------
# the rank threads and their rendezvous
# ---------------------------------------------------------------------------


class _Rendezvous:
    """The collectives' meeting point for one ``shard_map`` call, and the
    turn that lets one rank thread run at a time.

    Rank *r* runs until its next collective, deposits its operand, and
    hands the turn to rank *r + 1*; the last rank's deposit completes the
    collective (it checks that every rank called the same one) and hands
    the turn back to rank 0, which reads the result and runs on to the next
    collective.  So the ranks run one at a time, in rank order, between
    collectives: each reads a collective only after every rank deposited
    into it, the host queues their work in the same order on every run,
    and no two rank threads contend for the interpreter lock: on an H100's
    host, 8 threads launching 50 small operations each at once took 45.6 ms,
    one thread launching the 400 4.19 ms, and 8 ranks taking turns 6.55 ms
    (``chip_smoke.py``, the ``distributed`` phase's ``rank_threads`` row).  Collective *k* uses slot buffer ``k % 2``: a rank
    deposits into collective *k + 1* only after every rank has read
    collective *k − 1* from that buffer.
    """

    def __init__(self, mesh: Mesh):
        n = mesh.size
        self.mesh = mesh
        self._slots = ([None] * n, [None] * n)
        self._memo: tuple[dict, dict] = ({}, {})
        self._mismatch: list[list[str] | None] = [None, None]
        self._calls = [0] * n
        self._go = [threading.Semaphore(1 if r == 0 else 0) for r in range(n)]
        self._broken = False

    def wait_turn(self, rank: int) -> None:
        self._go[rank].acquire()
        if self._broken:
            raise threading.BrokenBarrierError

    def pass_turn(self, rank: int) -> None:
        self._go[(rank + 1) % len(self._go)].release()

    def abort(self) -> None:
        """Wake every waiting rank into ``BrokenBarrierError``."""
        self._broken = True
        for go in self._go:
            go.release()

    def exchange(self, rank: int, tag: tuple, value: Any) -> tuple[list, dict]:
        """Deposit ``value``; wait until every rank has; return every rank's
        value (rank order) and this collective's shared results."""
        k = self._calls[rank]
        self._calls[rank] += 1
        buf = k % 2
        self._slots[buf][rank] = (tag, value)
        if rank == len(self._go) - 1:  # the collective is complete
            tags = {slot[0] for slot in self._slots[buf]}
            self._mismatch[buf] = None if len(tags) == 1 else sorted(map(repr, tags))
            self._memo[buf].clear()
        self.pass_turn(rank)
        self.wait_turn(rank)
        if self._mismatch[buf] is not None:
            raise RuntimeError(f"shard_map ranks disagree on collective #{k}: "
                               f"{', '.join(self._mismatch[buf])}")
        return [slot[1] for slot in self._slots[buf]], self._memo[buf]


class _RankThreads:
    """Idle threads that run rank jobs, reused across ``shard_map`` calls
    (starting 8 threads took 2.54 ms on an H100's host, an 8-rank call with
    an empty body 1.22 ms with the threads kept: the ``rank_threads`` row).  A call that finds too few idle
    threads starts more, so a ``shard_map`` inside a rank's body gets its
    own.  The threads are daemons blocked on their queues when idle."""

    def __init__(self):
        self._idle: list[queue.SimpleQueue] = []
        self._lock = threading.Lock()

    def run(self, jobs: Sequence[Callable[[], None]]) -> None:
        """Run every job (each catches its own exceptions), one thread
        each; return when all have finished."""
        with self._lock:
            take = min(len(jobs), len(self._idle))
            queues = [self._idle.pop() for _ in range(take)]
        while len(queues) < len(jobs):
            q: queue.SimpleQueue = queue.SimpleQueue()
            threading.Thread(target=self._serve, args=(q,), name="shard_map-rank",
                             daemon=True).start()
            queues.append(q)
        done: queue.SimpleQueue = queue.SimpleQueue()
        for q, job in zip(queues, jobs):
            q.put((job, done))
        for _ in jobs:
            done.get()

    def _serve(self, q: queue.SimpleQueue) -> None:
        while True:
            job, done = q.get()
            try:
                job()
            finally:
                job = None  # an idle thread keeps no call's arguments alive
                with self._lock:
                    self._idle.append(q)
                done.put(None)


_THREADS = _RankThreads()


@dataclasses.dataclass
class _RankContext:
    mesh: Mesh
    rendezvous: _Rendezvous | None  # None: the shape-only representative rank
    rank: int

    @property
    def device(self) -> torch.device:
        return self.mesh.device_list[self.rank]


_TLS = threading.local()


def _context() -> _RankContext:
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        raise RuntimeError("collectives run only inside a shard_map body")
    return ctx


def _on_device(device: torch.device, streams: dict):
    stack = contextlib.ExitStack()
    if device.type == "cuda":
        stack.enter_context(torch.cuda.device(device))
        stack.enter_context(torch.cuda.stream(streams[device]))
    return stack


def _run_ranks(mesh: Mesh, body: Callable, rank_args: Sequence[tuple]) -> list:
    """``body(*rank_args[r])`` for every rank, one thread per rank, the
    ranks taking turns (:class:`_Rendezvous`); the per-rank results.
    Re-raises the lowest raising rank's exception."""
    n = mesh.size
    if mesh.shape_only:  # the module's docstring: one representative rank
        outer = getattr(_TLS, "ctx", None)
        _TLS.ctx = _RankContext(mesh, None, 0)
        try:
            return [body(*rank_args[0])] * n
        finally:
            _TLS.ctx = outer
    rv = _Rendezvous(mesh)
    results: list = [None] * n
    errors: list[BaseException | None] = [None] * n
    grad = torch.is_grad_enabled()
    streams = {d: torch.cuda.current_stream(d) for d in set(mesh.device_list)
               if d.type == "cuda"}

    def one(r: int) -> None:
        outer = getattr(_TLS, "ctx", None)
        _TLS.ctx = _RankContext(mesh, rv, r)
        try:
            rv.wait_turn(r)
            with torch.set_grad_enabled(grad), _on_device(mesh.device_list[r], streams):
                results[r] = body(*rank_args[r])
            rv.exchange(r, ("return",), None)
            rv.pass_turn(r)  # let the next rank return too
        except BaseException as err:  # handed to the caller below
            errors[r] = err
            rv.abort()
        finally:
            _TLS.ctx = outer

    if n == 1:
        one(0)
    else:
        _THREADS.run([functools.partial(one, r) for r in range(n)])
    raised = [(r, e) for r, e in enumerate(errors) if e is not None]
    if raised:
        first = [(r, e) for r, e in raised if not isinstance(e, threading.BrokenBarrierError)]
        r, err = (first or raised)[0]
        err.add_note(f"raised by rank {r} of {n} of a shard_map over {mesh}")
        raise err
    return results


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------


def _is_spec(s) -> bool:
    return isinstance(s, PartitionSpec) or s is None


def _spec_tree(specs: Any, tree: Any) -> Any:
    """``specs`` (a prefix of ``tree``) broadcast to ``tree``'s leaves."""
    if _is_spec(specs):
        return tree_map(lambda _: specs, tree)
    names = dataclass_fields(tree)
    if names is not None:
        return type(tree)(**{n: _spec_tree(getattr(specs, n), getattr(tree, n)) for n in names})
    if isinstance(tree, (tuple, list)):
        if len(specs) != len(tree):
            raise ValueError(f"{len(specs)} specs for {len(tree)} subtrees")
        return type(tree)(_spec_tree(s, t) for s, t in zip(specs, tree))
    if isinstance(tree, dict):
        return {k: _spec_tree(specs[k], tree[k]) for k in tree}
    raise ValueError(f"spec tree {specs!r} does not match {type(tree).__name__}")


def _local_args(mesh: Mesh, args: tuple, in_specs: Any) -> list[tuple]:
    """Every rank's arguments: each tensor leaf split by its spec (a view
    where the rank's device holds it), other leaves as they are."""
    specs = _spec_tree(in_specs if _is_spec(in_specs) else tuple(in_specs), args)
    per_leaf: list[list] = []  # one list of rank values per leaf, in tree order
    ranks = range(1 if mesh.shape_only else mesh.size)  # shape-only: rank 0's alone

    def split(x, spec) -> None:
        if spec is None or not isinstance(x, (torch.Tensor, ShardedTensor)):
            per_leaf.append([x] * len(ranks))
            return
        sh = NamedSharding(mesh, spec)
        if isinstance(x, ShardedTensor):
            if x.sharding.mesh == mesh and x.sharding.spec == sh.spec:
                per_leaf.append(list(x.shards))
                return
            x = x.full()
        per_leaf.append([x[sh.index(r, x.shape)].to(mesh.device_list[r]) for r in ranks])

    tree_map(split, args, specs)
    out = []
    for r in ranks:
        it = iter(values[r] for values in per_leaf)
        out.append(tree_map(lambda _: next(it), args))
    return out


def _global_outputs(mesh: Mesh, outs: list, out_specs: Any) -> Any:
    """The ranks' outputs assembled by ``out_specs`` (non-tensor leaves:
    rank 0's)."""
    its = [iter(tree_leaves(o)) for o in outs]

    def one(_, spec):
        locals_ = [next(i) for i in its]
        if not isinstance(locals_[0], torch.Tensor):
            return locals_[0]
        sh = NamedSharding(mesh, spec if spec is not None else P())
        shape = [n if sh._entry(d) is None else n * mesh.axis_size(sh._entry(d))
                 for d, n in enumerate(locals_[0].shape)]
        if mesh.shape_only:
            return torch.empty(shape, dtype=locals_[0].dtype, device="meta")
        return _assemble(shape, sh, locals_)

    return tree_map(one, outs[0], _spec_tree(out_specs, outs[0]))


def shard_map(f: Callable, *, mesh: Mesh, in_specs: Any, out_specs: Any,
              check_vma: bool = True) -> Callable:
    """``jax.shard_map`` for the port (the module's docstring): ``f`` runs
    once per rank, on rank-local shards of the global arguments (tensors or
    :class:`ShardedTensor`s) split by ``in_specs``, and the outputs are
    assembled by ``out_specs`` (prefix trees of :class:`PartitionSpec`)."""
    del check_vma  # the reference's signature; nothing is checked

    @functools.wraps(f)
    def call(*args):
        outs = _run_ranks(mesh, f, _local_args(mesh, args, in_specs))
        return _global_outputs(mesh, outs, out_specs)

    return call


# ---------------------------------------------------------------------------
# collectives (inside a shard_map body)
# ---------------------------------------------------------------------------


_CENSUS: list[dict[str, dict[str, int]]] = []
_census_lock = threading.Lock()


@contextlib.contextmanager
def collective_census():
    """Count the collectives rank 0 calls inside the block (the module's
    docstring) into the dict it yields: ``counts``, ``operand_bytes`` and
    ``result_bytes``, each by kind; nests."""
    stats: dict[str, dict[str, int]] = {"counts": {}, "operand_bytes": {}, "result_bytes": {}}
    with _census_lock:
        _CENSUS.append(stats)
    try:
        yield stats
    finally:
        with _census_lock:
            _CENSUS.remove(stats)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _noted(ctx: _RankContext, kind: str, x, result):
    """``result``, after adding the collective to the open censuses (rank 0's)."""
    if _CENSUS and ctx.rank == 0:
        operand, out = _nbytes(x), _nbytes(result)
        with _census_lock:
            for st in _CENSUS:
                for key, n in (("counts", 1), ("operand_bytes", operand), ("result_bytes", out)):
                    st[key][kind] = st[key].get(kind, 0) + n
    return result


def _group(axis_name) -> tuple[_RankContext, tuple[str, ...], tuple[int, ...], int]:
    ctx = _context()
    axes = _axes(axis_name)
    members, pos = ctx.mesh.groups(axes)[ctx.rank]
    return ctx, axes, members, pos


def _fold(tensors: Sequence[torch.Tensor], device: torch.device,
          combine: Callable = torch.add) -> torch.Tensor:
    """``tensors`` combined on ``device`` (summed, or by ``combine``, e.g.
    ``torch.maximum``) in the order given; bf16 and f16 operands in f32,
    rounded once at the end."""
    dt = tensors[0].dtype
    wide = torch.float32 if dt in (torch.bfloat16, torch.float16) else dt
    acc = tensors[0].to(device, wide, copy=True)
    for t in tensors[1:]:
        combine(acc, t.to(device, wide), out=acc)
    return acc.to(dt)


def _shared(memo: dict, key, compute: Callable) -> Any:
    """``compute()`` once per ``key`` among the ranks of this collective
    (the ranks take turns, so no two compute at once)."""
    if key not in memo:
        memo[key] = compute()
    return memo[key]


def axis_size(axis_name) -> int:
    """The product of the named axes' sizes (inside a shard_map body)."""
    return _context().mesh.axis_size(axis_name)


def axis_index(axis_name) -> int:
    """This rank's index along the named axis (row-major over a tuple)."""
    ctx = _context()
    return ctx.mesh.position(ctx.rank, _axes(axis_name))


def _differentiable(x: Any, out: Any, transpose: Callable, collective: bool = False) -> Any:
    """``out``, a collective's result (a tensor or a tree) computed from
    ``x`` without autograd, made differentiable by ``transpose`` (a leaf's
    cotangent to that of its operand) where autograd records ``x``: cut
    from ``x``'s graph onto the thread's tape (:func:`backward_segments`),
    every recorded leaf in one cut so that their backward runs as one
    segment, or, without a tape, each wrapped in a :class:`_Transposed`
    node.  ``collective``: the transpose calls a collective (it must run in
    the rank's own thread)."""
    if not torch.is_grad_enabled():
        return out
    xs, outs = tree_leaves(x), tree_leaves(out)
    live = [i for i, t in enumerate(xs) if isinstance(t, torch.Tensor) and t.requires_grad]
    if not live:
        return out
    tape = getattr(_TLS, "tape", None)
    got = list(outs)
    if tape is not None:
        ys = [outs[i].detach().requires_grad_() for i in live]
        tape.cut_many([xs[i] for i in live], ys,
                      lambda cts, _leaves: ([transpose(ct) for ct in cts], None))
        for i, y in zip(live, ys):
            got[i] = y
    else:
        for i in live:
            got[i] = _Transposed.apply(xs[i], outs[i], transpose, collective)
    it = iter(got)
    return tree_map(lambda _: next(it), out)


class _Transposed(torch.autograd.Function):
    """A collective's result as an autograd node whose backward is its
    transpose.  A transpose that calls a collective must run in the rank's
    thread: the backward of a CPU graph does (``torch.autograd.grad`` runs it
    in the calling thread), that of a CUDA graph runs on the card's own
    autograd thread and raises here (:func:`backward_segments` is the route
    there)."""

    @staticmethod
    def forward(ctx, x, out, transpose, collective):
        ctx.transpose, ctx.collective = transpose, collective
        ctx.rank_ctx = getattr(_TLS, "ctx", None)
        return out.detach()

    @staticmethod
    def backward(ctx, g):
        if ctx.collective and getattr(_TLS, "ctx", None) is not ctx.rank_ctx:
            raise RuntimeError(
                f"the backward of a collective ran in thread {threading.current_thread().name!r}, "
                f"not its rank's (autograd runs a CUDA graph's backward on the card's own "
                f"thread): differentiate a rank body with repro_torch.optim.accumulate_gradients "
                f"or value_and_grad, whose backward runs in segments")
        return ctx.transpose(g), None, None, None


def psum(x: Any, axis_name) -> Any:
    """Sum of ``x`` (a tensor or a tree of tensors) over the named axes'
    group, folded in rank order.  A Python number is multiplied by the
    group's size without a rendezvous (the reference's ``psum(1, axis)``).
    Differentiable: the cotangent of the sum passes to the rank's own
    operand, as Megatron's ``g`` and JAX's transpose of a ``psum`` whose
    result every rank holds alike."""
    if isinstance(x, (int, float)):
        return x * axis_size(axis_name)
    ctx, axes, members, _ = _group(axis_name)
    with torch.no_grad():
        if ctx.rendezvous is None:
            out = tree_map(torch.empty_like, x)
        else:
            vals, memo = ctx.rendezvous.exchange(ctx.rank, ("psum", axes), x)
            out = tree_map(torch.Tensor.detach, _shared(
                memo, (members, ctx.device), lambda: tree_map(
                    lambda *leaves: _fold(leaves, ctx.device), *[vals[r] for r in members])))
    return _differentiable(x, _noted(ctx, "all-reduce", x, out), lambda g: g)


def pvary(x: torch.Tensor, axis_name) -> torch.Tensor:
    """``x``, a value every rank of the named axes' group holds alike,
    entering work that the ranks split (Megatron's ``f``, JAX's
    ``pvary``): the identity, whose cotangent is the group's ``psum`` of the
    ranks' partial cotangents.  Outside autograd, or over a group of one,
    it is ``x`` itself."""
    if not (torch.is_grad_enabled() and x.requires_grad) or axis_size(axis_name) == 1:
        return x
    return _differentiable(x, x, lambda g: psum(g, axis_name), collective=True)


def pmax(x: Any, axis_name) -> Any:
    """Elementwise maximum of ``x`` (a tensor or a tree of tensors) over the
    named axes' group (``jax.lax.pmax``; an ``all-reduce`` in the census).
    The result carries no gradient."""
    ctx, axes, members, _ = _group(axis_name)
    with torch.no_grad():
        if ctx.rendezvous is None:
            return _noted(ctx, "all-reduce", x, tree_map(torch.empty_like, x))
        vals, memo = ctx.rendezvous.exchange(ctx.rank, ("pmax", axes), x)
        return _noted(ctx, "all-reduce", x, tree_map(torch.Tensor.detach, _shared(
            memo, (members, ctx.device), lambda: tree_map(
                lambda *leaves: _fold(leaves, ctx.device, torch.maximum),
                *[vals[r] for r in members]))))


def psum_scatter(x: torch.Tensor, axis_name, *, scatter_dimension: int = 0,
                 tiled: bool = False) -> torch.Tensor:
    """The group's sum, of which the rank at position *i* keeps part *i*
    along ``scatter_dimension``: with ``tiled=False`` that dim's size must
    equal the group's and is removed; with ``tiled=True`` it is split into
    equal parts and kept.  Its transpose is the :func:`all_gather` of the
    cotangent."""
    ctx, axes, members, pos = _group(axis_name)
    n, d = len(members), scatter_dimension % x.ndim
    size = x.shape[d]
    if tiled and size % n:
        raise ValueError(f"psum_scatter: dim {d} of size {size} over {n} ranks")
    if not tiled and size != n:
        raise ValueError(f"psum_scatter(tiled=False): dim {d} has size {size}, the group {n}")

    def part(t):
        return t.narrow(d, pos * (size // n), size // n) if tiled else t.select(d, pos)

    with torch.no_grad():
        if ctx.rendezvous is None:
            out = torch.empty_like(part(x))
        else:
            vals, _ = ctx.rendezvous.exchange(
                ctx.rank, ("psum_scatter", axes, scatter_dimension, tiled), x)
            out = _fold([part(vals[r]) for r in members], ctx.device)
    return _differentiable(x, _noted(ctx, "reduce-scatter", x, out),
                           lambda g: all_gather(g, axis_name, axis=d, tiled=tiled), True)


def all_gather(x: torch.Tensor, axis_name, *, axis: int = 0, tiled: bool = False,
               invariant: bool = False) -> torch.Tensor:
    """The group's operands in position order, stacked along a new dim
    ``axis`` (``tiled=False``) or concatenated along ``axis`` (``tiled=True``).
    Its transpose is the :func:`psum_scatter` of the cotangent: each rank
    gets the sum of the ranks' cotangents of its part.  ``invariant``: the
    result is a value every rank then holds alike, with the cotangent every
    rank holds alike too (JAX's ``all_gather_invariant``), so the transpose
    keeps the rank's own part of it, with no sum and no collective."""
    ctx, axes, members, pos = _group(axis_name)
    d = axis % (x.ndim if tiled else x.ndim + 1)
    with torch.no_grad():
        if ctx.rendezvous is None:
            shape = list(x.shape)
            if tiled:
                shape[d] *= len(members)
            else:
                shape.insert(d, len(members))
            out = x.new_empty(shape)
        else:
            vals, memo = ctx.rendezvous.exchange(ctx.rank, ("all_gather", axes, axis, tiled), x)
            join = torch.cat if tiled else torch.stack
            out = _shared(memo, (members, ctx.device),
                          lambda: join([vals[r].to(ctx.device) for r in members], dim=d)).detach()
    if invariant:
        return _differentiable(x, _noted(ctx, "all-gather", x, out), lambda g: g.narrow(
            d, pos * x.shape[d], x.shape[d]) if tiled else g.select(d, pos))
    return _differentiable(x, _noted(ctx, "all-gather", x, out), lambda g: psum_scatter(
        g, axis_name, scatter_dimension=d, tiled=tiled), True)


def ppermute(x: Any, axis_name, perm: Sequence[tuple[int, int]]) -> Any:
    """Send ``x`` (a tensor or a tree) along ``(source, destination)``
    position pairs of the named axis; a rank that no pair targets gets
    zeros like its own operand."""
    perm = [(int(s), int(d)) for s, d in perm]
    if len({s for s, _ in perm}) != len(perm) or len({d for _, d in perm}) != len(perm):
        raise ValueError(f"ppermute: a position sends or receives twice in {perm}")
    ctx, axes, members, pos = _group(axis_name)
    if ctx.rendezvous is None:
        return _noted(ctx, "collective-permute", x, tree_map(torch.empty_like, x))
    vals, _ = ctx.rendezvous.exchange(ctx.rank, ("ppermute", axes, tuple(perm)), x)
    src = [s for s, d in perm if d == pos]
    if not src:
        return _noted(ctx, "collective-permute", x, tree_map(torch.zeros_like, x))
    return _noted(ctx, "collective-permute", x,
                  tree_map(lambda t: t.to(ctx.device, copy=True), vals[members[src[0]]]))


# ---------------------------------------------------------------------------
# autograd in a rank body: the backward in segments
# ---------------------------------------------------------------------------


class _Sums:
    """Running sums of cotangents, one per slot: a slot's first
    contribution is kept as autograd gave it, the second added into a new
    tensor, which later ones are added into in place."""

    def __init__(self, n: int):
        self.values: list[torch.Tensor | None] = [None] * n
        self._owned: set[int] = set()

    def add(self, i: int, g: torch.Tensor | None) -> None:
        if g is None:
            return
        held = self.values[i]
        if held is None:
            self.values[i] = g
        elif i in self._owned:
            held.add_(g)
        else:
            self.values[i] = held + g
            self._owned.add(i)

    def take(self, i: int) -> torch.Tensor | None:
        self._owned.discard(i)
        held, self.values[i] = self.values[i], None
        return held


class _Tape:
    """The cuts of one rank's forward, in the order it made them.

    Each entry is ``(xs, ys, vjp)``: the leaves ``ys`` stand for values
    computed from ``xs`` (a collective's results, or the input of a decoder
    period), and ``vjp(cts, leaves)`` gives the cotangents of ``xs`` from
    those of ``ys``, and any gradient of ``leaves`` it found on the way (a
    recomputed period's).  :meth:`backward` hands a ``vjp`` the ``ys`` of
    the entries before its own after the leaves, so that a recomputed
    period which closes over an earlier value (the decoder's
    cross-attention memory, the encoder's output) returns that value's
    cotangent, which is then summed into those entries' cotangents and
    carried back through them.  No autograd node of the rank's graph calls a
    collective: :meth:`backward` runs ``torch.autograd.grad`` one segment at
    a time in the rank's own thread, and calls the collectives' transposes
    itself between segments, in the reverse of the forward's order, the
    same on every rank."""

    def __init__(self):
        self.entries: list[tuple[list, list, Callable]] = []

    def cut_many(self, xs: list, ys: list, vjp: Callable) -> None:
        self.entries.append((xs, ys, vjp))

    def cut(self, x: torch.Tensor, y: torch.Tensor, vjp: Callable) -> None:
        """One value's cut: ``vjp(ct, leaves) -> (cx, found)``."""

        def many(cts, leaves):
            cx, found = vjp(cts[0], leaves)
            return [cx], found

        self.entries.append(([x], [y], many))

    def boundary(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` cut as the input of a segment (a layer's residual stream),
        so that no later segment's backward runs past it."""
        if not (torch.is_grad_enabled() and x.requires_grad):
            return x
        xl = x.detach().requires_grad_()
        self.cut(x, xl, lambda ct, _leaves: (ct, None))
        return xl

    def period(self, body: Callable, x: torch.Tensor, *, recompute: bool) -> torch.Tensor:
        """``body(x)`` as one segment of the backward (a decoder period):
        its input is cut, so that no segment's backward runs past it into
        the earlier periods.  ``recompute``: the forward keeps only ``x``
        and ``body``'s output, and the backward runs ``body`` on ``x`` again,
        its collectives included, and that run's own segments
        (``cfg.remat == "full"``).  A value ``body`` closes over that autograd
        records (the memory of whisper's cross layers) is read as it is in
        both passes; the recomputation gives its cotangent to the
        :meth:`backward` that runs it, which carries it to the entries
        before the period."""
        if not (torch.is_grad_enabled() and x.requires_grad):
            return body(x)
        if not recompute:
            return body(self.boundary(x))
        with torch.no_grad():
            y = body(x).detach().requires_grad_()
        value = x.detach()

        def vjp(ct, leaves):
            xl = value.detach().requires_grad_()
            inner = _Tape()
            outer = getattr(_TLS, "tape", None)
            _TLS.tape = inner
            try:
                with torch.enable_grad():
                    out = body(xl)
            finally:
                _TLS.tape = outer
            *grads, cx = inner.backward([out], [ct], [*leaves, xl])
            return cx, grads

        self.cut(x, y, vjp)
        return y

    def backward(self, outs: Sequence[torch.Tensor], cts: Sequence[torch.Tensor] | None,
                 leaves: Sequence[torch.Tensor]) -> list[torch.Tensor | None]:
        """``torch.autograd.grad(outs, leaves, cts)`` over the cut graph
        (None for a leaf the outputs do not reach); empties the tape."""
        n = len(leaves)
        ys = [y for _, entry_ys, _ in self.entries for y in entry_ys]
        starts, at = [], 0
        for _, entry_ys, _ in self.entries:
            starts.append(at)
            at += len(entry_ys)
        grads, cot = _Sums(n), _Sums(len(ys))

        def pull(outs, cts, upto: int) -> None:
            pairs = [(o, c) for o, c in zip(outs, cts or [None] * len(outs)) if o.requires_grad]
            if not pairs:
                return
            got = torch.autograd.grad([o for o, _ in pairs], [*leaves, *ys[:upto]],
                                      grad_outputs=None if cts is None else [c for _, c in pairs],
                                      allow_unused=True, retain_graph=True)
            for i, g in enumerate(got[:n]):
                grads.add(i, g)
            for k, g in enumerate(got[n:]):
                cot.add(k, g)

        pull(outs, cts, len(ys))
        for k in range(len(self.entries) - 1, -1, -1):
            xs, entry_ys, vjp = self.entries[k]
            at = starts[k]
            ct = [cot.take(at + i) for i in range(len(entry_ys))]
            ct = [torch.zeros_like(y) if c is None else c for c, y in zip(ct, entry_ys)]
            cxs, found = vjp(ct, [*leaves, *ys[:at]])
            for i, g in enumerate(found or ()):
                if i < n:
                    grads.add(i, g)
                else:  # an earlier entry's value that a recomputed period closed over
                    cot.add(i - n, g)
            pull(xs, cxs, at)
        self.entries.clear()
        return grads.values


@contextlib.contextmanager
def backward_segments():
    """A fresh :class:`_Tape` for the calling rank thread's forward, or None
    outside a ``shard_map`` body (and where autograd records nothing).

    Inside a body the collectives cut their results onto it (and
    ``Model.forward`` each decoder period), so that
    ``tape.backward([loss], None, leaves)`` runs the backward in segments
    in this thread.  The collectives' autograd nodes (:class:`_Transposed`)
    cannot do that on a card: PyTorch runs a CUDA graph's backward on the
    card's own autograd thread, which the rank threads of one card share
    and where no rank's rendezvous can wait.  ``repro_torch.optim``'s
    ``value_and_grad`` (and so ``accumulate_gradients``) uses it.  The
    data-parallel program's ranks (a :class:`TensorParallel` not
    ``over_model``) get one only where their body calls a collective
    (``segmented``: the MoE layer's token gather over the data axes);
    the others hold every param whole, call none, and take PyTorch's
    one-pass backward and ``torch.utils.checkpoint``'s recomputation."""
    tp = getattr(_TLS, "tp", None)
    if getattr(_TLS, "ctx", None) is None or not torch.is_grad_enabled() or (
            tp is not None and not (tp.over_model or tp.segmented)):
        yield None
        return
    outer = getattr(_TLS, "tape", None)
    _TLS.tape = tape = _Tape()
    try:
        yield tape
    finally:
        _TLS.tape = outer


def recording_tape() -> _Tape | None:
    """The calling thread's tape while a rank's forward records one."""
    return getattr(_TLS, "tape", None)


# ---------------------------------------------------------------------------
# the data-parallel train step
# ---------------------------------------------------------------------------


def _dp_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def gathered(x: torch.Tensor, spec: PartitionSpec) -> torch.Tensor:
    """A rank's shard gathered to the global value inside a body (the
    reference's FSDP all-gather): one tiled ``all_gather`` per sharded dim."""
    for d, e in enumerate(spec):
        if e is not None:
            x = all_gather(x, e, axis=d, tiled=True)
    return x


def _spec_of(x) -> PartitionSpec:
    return x.sharding.spec if isinstance(x, ShardedTensor) else P()


def data_parallel_scope(loss_fn: Callable, dp: tuple[str, ...], n_dp: int) -> TensorParallel:
    """The :class:`TensorParallel` of a data-parallel train rank of
    ``loss_fn`` over the axes ``dp`` (``n_dp`` ranks): it names only the
    batch's axes, so that an MoE layer groups the whole batch's tokens, and
    is ``segmented`` where the rank's forward calls a collective under
    autograd: a Model's loss with capacity-bucketed MoE layers, whose token
    gather over ``dp`` is cut onto the rank's tape (:func:`backward_segments`),
    on more than one rank.  Elsewhere the ranks call no collective and keep
    PyTorch's one-pass backward."""
    cfg = getattr(getattr(loss_fn, "__self__", None), "cfg", None)
    moe = cfg is not None and cfg.moe_impl == "onehot" and any(
        s.mlp == "moe" for seg in cfg.segments() for s in seg.period)
    return TensorParallel(batch_axes=dp, over_model=False, segmented=moe and n_dp > 1)


def data_parallel_gradients(loss_fn: Callable, params: Any, blocks: dict[str, torch.Tensor], *,
                            mesh: Mesh) -> tuple[torch.Tensor, Any]:
    """Mean loss and mean f32 gradients of ``loss_fn`` over ``blocks``
    (leaves ``(nblocks, mb, ...)``), data-parallel over the mesh's ``pod``
    and ``data`` axes.

    PyTorch has no GSPMD, so this is the port's counterpart of
    ``jax.jit(step, in_shardings=...)`` under ``train_rules``, by data
    parallelism only: every rank takes its share of every block's rows
    (``mb`` split over ``(pod, data)``), gathers the params it needs from
    their layouts (:class:`ShardedTensor` leaves, e.g. by
    ``params_shardings``; a plain tensor is replicated) and runs
    :func:`repro_torch.optim.accumulate_gradients` (``spliter``).  The ranks' losses and
    gradients are summed over ``(pod, data)`` by
    :func:`~repro_torch.distributed.collectives.psum_pod_hierarchical`
    (a flat ``psum`` on a mesh without a ``pod`` axis) and divided by the
    data-parallel rank count.  The ranks of one ``(pod, data)`` position
    compute the same gradients (:func:`tensor_parallel_gradients` splits
    the work over ``model``).  The body runs under a :class:`TensorParallel`
    that names only the batch's axes (:func:`data_parallel_scope`), so that
    an MoE layer groups the whole batch's tokens, as the reference's
    ``jax.jit`` does, its backward in segments where it gathers them.
    Returns the loss and the gradients as global tensors on rank 0's
    device.
    """
    from repro_torch.distributed.collectives import psum_pod_hierarchical
    from repro_torch.optim import accumulate_gradients

    dp = _dp_axes(mesh)
    n_dp = mesh.axis_size(dp)
    p_specs = tree_map(_spec_of, params)
    b_specs = {k: P(None, dp) for k in blocks}

    tp = data_parallel_scope(loss_fn, dp, n_dp)

    def body(local_params, local_blocks):
        full = tree_map(gathered, local_params, p_specs)
        with tensor_parallel_scope(tp):
            loss, grads = accumulate_gradients(loss_fn, full, local_blocks)
        return loss.reshape(1), grads

    outs = _run_ranks(mesh, body, _local_args(mesh, (params, blocks), (p_specs, b_specs)))
    replicated = NamedSharding(mesh, P())
    it = [iter(tree_leaves(o)) for o in outs]
    per_rank = tree_map(lambda leaf: ShardedTensor(leaf.shape, replicated,
                                                   [next(i) for i in it]), outs[0])
    if "pod" in dp and "data" in dp:
        total = psum_pod_hierarchical(per_rank, mesh)
    else:
        total = shard_map(lambda t: psum(t, dp), mesh=mesh, in_specs=(P(),), out_specs=P(),
                          check_vma=False)(per_rank)
    loss, grads = tree_map(
        lambda t: t / torch.full((), n_dp, dtype=t.dtype, device=t.device), total)
    return loss.reshape(()), grads


def sharded_train_step(loss_fn: Callable, params: Any, opt: Any, blocks: dict[str, torch.Tensor],
                       *, mesh: Mesh, lr, rules: Any = None) -> tuple[Any, Any, torch.Tensor]:
    """One optimizer step.  ``rules=train_rules(mesh)`` or
    ``train_rules_sp(mesh)`` (other rules are refused): the tensor-parallel
    program (:func:`tensor_parallel_gradients` and AdamW on each rank's
    shards, :func:`training_step_body`), which writes the new params and
    moments into the shards passed in, as ``adamw_update`` does, and returns
    them as :class:`ShardedTensor` leaves in the params' layouts (plain
    moments are placed so first).  Without ``rules``: the data-parallel
    program, :func:`data_parallel_gradients`, then
    :func:`repro_torch.optim.adamw_update` on the gathered params, which go
    back to the layouts they came in (a plain tensor stays plain).
    Returns ``(params, opt, loss)``."""
    from repro_torch.optim import adamw_update

    if rules is not None:
        return _tensor_parallel_step(loss_fn, params, opt, blocks, mesh=mesh, lr=lr, rules=rules)
    loss, grads = data_parallel_gradients(loss_fn, params, blocks, mesh=mesh)
    full = tree_map(lambda p: p.full() if isinstance(p, ShardedTensor) else p, params)
    full, opt = adamw_update(full, grads, opt, lr=lr)
    new = tree_map(lambda p, f: ShardedTensor.from_global(f, p.sharding)
                   if isinstance(p, ShardedTensor) else f, params, full)
    return new, opt, loss


# ---------------------------------------------------------------------------
# the tensor-parallel train step
# ---------------------------------------------------------------------------


def _named(spec: PartitionSpec) -> set[str]:
    return {a for e in spec if e is not None for a in _axes(e)}


def _data_parallel_sum(x: torch.Tensor, dp: tuple[str, ...]) -> torch.Tensor:
    """``x`` summed over the data-parallel axes inside a body:
    hierarchically (reduce-scatter over ``data``, all-reduce over ``pod``,
    all-gather over ``data``) where both remain, else one ``psum``."""
    from repro_torch.distributed.collectives import hierarchical_psum

    if not dp:
        return x
    if "pod" in dp and "data" in dp:
        return hierarchical_psum(x.reshape(-1), fast_axis="data",
                                 slow_axis="pod").reshape(x.shape)
    return psum(x, dp)


def _reduced_gradient(g: torch.Tensor, gather: PartitionSpec, dp: tuple[str, ...]) -> torch.Tensor:
    """A rank's gradient of a param it gathered over ``gather``'s axes (the
    ``fsdp`` dims) summed over the data-parallel ranks, as its own shard:
    the gather's transpose (a tiled ``psum_scatter`` per gathered dim) sums
    over those axes, and the rest of ``dp`` is summed whole."""
    for d, e in enumerate(gather):
        if e is not None:
            g = psum_scatter(g, e, scatter_dimension=d, tiled=True)
    return _data_parallel_sum(g, tuple(a for a in dp if a not in _named(gather)))


def _sharded_norm(grads: Any, specs: Any) -> torch.Tensor:
    """The global norm of gradients held as the ranks' shards laid out by
    ``specs``: one ``psum`` over every mesh axis of the squares each rank
    owns, a shard counted on the ranks at coordinate 0 of every axis its
    spec does not name (a leaf replicated over ``model`` on one model rank)."""
    ctx = _context()
    owned: list[torch.Tensor] = []

    def one(g, spec):
        if all(axis_index(a) == 0 for a in ctx.mesh.axis_names if a not in _named(spec)):
            owned.append(g)

    tree_map(one, grads, specs)
    total = torch.zeros((), dtype=torch.float32, device=tree_leaves(grads)[0].device)
    for g in owned:
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(psum(total, ctx.mesh.axis_names))


def _training_model(loss_fn: Callable, mesh: Mesh) -> Any:
    model = getattr(loss_fn, "__self__", None)
    if model is None or not hasattr(model, "tensor_parallel_training_refusal"):
        raise TypeError("tensor-parallel training takes a Model's bound loss (model.loss)")
    refusal = model.tensor_parallel_training_refusal()
    if refusal is not None:
        raise NotImplementedError(f"{model.cfg.name}: {refusal}")
    if MODEL_AXIS not in mesh.shape:
        raise ValueError(f"tensor-parallel training needs a {MODEL_AXIS!r} axis in {mesh}")
    return model


def _residual_axis(rules: Any, mesh: Mesh) -> str | None:
    """The mesh axis the train program ``rules`` name splits the residual
    stream's sequence over between blocks: None under ``train_rules``,
    :data:`MODEL_AXIS` under ``train_rules_sp`` (None too where that axis
    is one rank); any other rule set is refused, since the tensor-parallel
    train step runs those two programs only."""
    from repro_torch.distributed.sharding import train_rules, train_rules_sp

    programs = {"train_rules": train_rules(mesh).logical,
                "train_rules_sp": train_rules_sp(mesh).logical}
    if dict(rules.logical) not in programs.values():
        raise ValueError(f"the tensor-parallel train step runs {' or '.join(programs)} on "
                         f"{mesh}, not the rules {dict(rules.logical)}")
    axis = rules.logical["seq_res"]
    return axis if axis is not None and mesh.axis_size(axis) > 1 else None


def training_gradients_body(model: Any, mesh: Mesh, params: Any, param_specs: Any, rules: Any, *,
                            accum_mode: str = "spliter", hoist: bool = False) -> Callable:
    """The body of a tensor-parallel training rank of ``model`` on ``mesh``
    (the models ``Model.tensor_parallel_training_refusal`` admits), its
    ``params`` laid out by ``param_specs``, under ``rules``: ``train_rules``,
    or ``train_rules_sp``, whose residual stream between blocks the rank
    holds as its rows of the sequence, split over ``model`` where the axis
    divides the length (:attr:`TensorParallel.seq_res`; ``models/lm.py``);
    other rules are refused.

    ``body(params, blocks) -> (loss, grads)`` takes the rank's shards and
    its rows of the blocks (leaves ``(nblocks, mb / dp, ...)``): it gathers
    each param over its axes other than :data:`MODEL_AXIS` (the ``fsdp``
    dims) and keeps its model shard, runs
    ``accumulate_gradients(model.loss, ...)`` under ``rules`` with a
    :class:`TensorParallel` whose ``batch_axes`` are the rules' ``batch``
    (the layers' model collectives, ``pvary`` where a value every rank
    holds enters split work, the vocabulary-parallel loss; the backward in
    segments, :func:`backward_segments`), then sums the loss and the
    gradients over the data-parallel axes (the ``fsdp`` dims by the
    gather's transpose, a ``psum_scatter``, which leaves the rank its
    shard; the rest hierarchically over ``(pod, data)``, as
    ``psum_pod_hierarchical`` does, or by one ``psum``) and divides them by
    the data-parallel rank count.  The gradients come out as the rank's
    shards in the params' layouts."""
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.optim import accumulate_gradients

    seq_res = _residual_axis(rules, mesh)
    dp = _axes(rules.logical.get("batch") or ())
    n_dp = mesh.axis_size(dp) if dp else 1
    gather = tree_map(lambda _, s: _gather_spec(s), params, param_specs)
    tp = TensorParallel(batch_axes=dp, seq_res=seq_res)

    def mean(t: torch.Tensor) -> torch.Tensor:
        return t / torch.full((), n_dp, dtype=t.dtype, device=t.device)

    def body(params_l, blocks_l):
        full = tree_map(gathered, params_l, gather)
        with tensor_parallel_scope(tp), use_rules(rules):
            loss, grads = accumulate_gradients(model.loss, full, blocks_l, mode=accum_mode,
                                               hoist=hoist)
        loss = mean(_data_parallel_sum(loss, dp))
        grads = tree_map(lambda g, s: mean(_reduced_gradient(g, s, dp)), grads, gather)
        return loss, grads

    return body


def training_step_body(model: Any, mesh: Mesh, params: Any, param_specs: Any, rules: Any, *, lr,
                       accum_mode: str = "spliter", hoist: bool = False) -> Callable:
    """:func:`training_gradients_body` and AdamW on the rank's shards:
    ``body(params, opt, blocks) -> (params, opt, loss)``.  The clip factor
    of ``adamw_update``'s default ``clip_norm=1.0`` comes from the whole
    gradient's norm (:func:`_sharded_norm`); the update writes into the
    rank's shards of the params and moments."""
    from repro_torch.optim import adamw_update

    gradients = training_gradients_body(model, mesh, params, param_specs, rules,
                                        accum_mode=accum_mode, hoist=hoist)

    def body(params_l, opt_l, blocks_l):
        loss, grads = gradients(params_l, blocks_l)
        gnorm = _sharded_norm(grads, param_specs)
        scale = torch.clamp(torch.full_like(gnorm, 1.0) / torch.clamp(gnorm, min=1e-12), max=1.0)
        grads = tree_map(lambda g: g * scale, grads)
        new_p, new_opt = adamw_update(params_l, grads, opt_l, lr=lr, clip_norm=math.inf)
        return new_p, new_opt, loss

    return body


def _as_sharded(outs: list, like: Any, mesh: Mesh) -> Any:
    """The ranks' outputs (a tree like ``like`` per rank) as
    :class:`ShardedTensor` leaves laid out as ``like``'s (a plain tensor:
    replicated)."""
    its = [iter(tree_leaves(o)) for o in outs]

    def one(x):
        sharding = x.sharding if isinstance(x, ShardedTensor) else NamedSharding(mesh, P())
        return ShardedTensor(x.shape, sharding, [next(i) for i in its])

    return tree_map(one, like)


def tensor_parallel_gradients(loss_fn: Callable, params: Any, blocks: dict[str, torch.Tensor], *,
                              mesh: Mesh, rules: Any) -> tuple[torch.Tensor, Any]:
    """Mean loss and mean f32 gradients of ``loss_fn`` (a Model's bound
    ``loss``) over ``blocks`` (leaves ``(nblocks, mb, ...)``), tensor-parallel
    over ``model`` and data-parallel over the rules' ``batch`` axes: the
    port's counterpart of the reference's ``jax.jit(step, in_shardings=...)``
    under ``train_rules`` or ``train_rules_sp`` (the residual stream between
    blocks split by sequence over ``model``); other rules are refused.

    ``params`` are :class:`ShardedTensor` leaves placed by
    ``params_shardings(..., fsdp_axis="data")`` (a plain tensor is
    replicated); each rank gathers only their ``fsdp`` dims and keeps its
    heads, kv heads (where they divide the axis), SSM heads, MLP columns,
    experts and vocabulary rows, and runs :func:`training_gradients_body`.
    Returns the loss and the gradients as :class:`ShardedTensor` leaves in
    the params' layouts: no leaf is gathered whole over ``model``."""
    model = _training_model(loss_fn, mesh)
    p_specs = tree_map(_spec_of, params)
    b_specs = {k: P(None, _axes(rules.logical.get("batch") or ()) or None) for k in blocks}
    body = training_gradients_body(model, mesh, params, p_specs, rules)
    outs = _run_ranks(mesh, body, _local_args(mesh, (params, blocks), (p_specs, b_specs)))
    return outs[0][0], _as_sharded([o[1] for o in outs], params, mesh)


def _tensor_parallel_step(loss_fn: Callable, params: Any, opt: Any, blocks: dict, *, mesh: Mesh,
                          lr, rules: Any) -> tuple[Any, Any, torch.Tensor]:
    model = _training_model(loss_fn, mesh)

    def place(t, p):  # a plain moment laid out as its param
        if isinstance(t, ShardedTensor) or not isinstance(p, ShardedTensor):
            return t
        return ShardedTensor.from_global(t, p.sharding)

    opt = dataclasses.replace(opt, m=tree_map(place, opt.m, params),
                              v=tree_map(place, opt.v, params))
    p_specs = tree_map(_spec_of, params)
    o_specs = dataclasses.replace(opt, step=P(), m=p_specs, v=p_specs)
    b_specs = {k: P(None, _axes(rules.logical.get("batch") or ()) or None) for k in blocks}
    body = training_step_body(model, mesh, params, p_specs, rules, lr=lr)
    outs = _run_ranks(mesh, body, _local_args(mesh, (params, opt, blocks),
                                               (p_specs, o_specs, b_specs)))
    new_p = _as_sharded([o[0] for o in outs], params, mesh)
    m = _as_sharded([o[1].m for o in outs], opt.m, mesh)
    v = _as_sharded([o[1].v for o in outs], opt.v, mesh)
    return new_p, dataclasses.replace(opt, step=outs[0][1].step, m=m, v=v), outs[0][2]


# ---------------------------------------------------------------------------
# tensor-parallel serving
# ---------------------------------------------------------------------------


#: the mesh axis that tensor-parallel serving splits heads, MLP columns and
#: vocabulary rows over, as the sharding rules name it
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A serving rank's tensor-parallel context, which the model's layers
    read inside the body of :func:`sharded_prefill` and
    :func:`sharded_decode_step` (``models/layers.py``, ``models/mla.py``,
    ``models/ssm.py``, ``models/moe.py``, ``models/lm.py``): how the
    attention layers' decode cache lies: ``kv_seq_axis``, the mesh axis its
    sequence (and MLA's latent rows) is split over for context-parallel
    decode, :data:`MODEL_AXIS` under ``decode_rules``
    (``cache_shardings(layout="seq")``), ``"data"`` under
    ``long_decode_rules`` (``cache_shardings(long_context=True)``, the heads
    split over ``model`` beside it), None where every rank holds every row;
    or, under ``layout="heads"``, ``kv_heads_split``, the kv heads of
    ``k``/``v`` over ``model``, and ``latent_split``, the latent (and rope)
    dim of MLA's ``ckv``/``krope``; and ``batch_axes``, the axes the batch
    rows are split over, as the rules' ``batch`` names them (none under
    ``long_decode_rules``, whose batch of one is replicated): the MoE layer
    groups the tokens of the whole batch, as the reference's ``jax.jit``
    does.  ``over_model``: the params are split over :data:`MODEL_AXIS`
    (:func:`model_parallel`); False in the data-parallel train program,
    whose ranks hold every param whole and read only ``batch_axes``, and
    run their backward in segments where ``segmented``
    (:func:`data_parallel_scope`).

    In the tensor-parallel train program under ``train_rules_sp``,
    ``seq_res`` is the mesh axis (:data:`MODEL_AXIS`) the residual stream's
    sequence is split over between blocks; ``rows`` says how the input of
    the layer being run lies, as ``models/lm.py`` sets it per layer:
    ``"whole"``, every rank holds every row alike (serving, ``train_rules``,
    and a stream whose length the axis does not divide); ``"split"``, the
    rank holds its rows, which a layer gathers over ``seq_res`` before its
    split work and whose partial output it reduce-scatters back to them;
    ``"gathered"``, those rows gathered by the caller, which takes the
    partial output (command-r's parallel block)."""

    kv_seq_axis: str | None = None
    kv_heads_split: bool = False
    batch_axes: tuple[str, ...] = ()
    latent_split: bool = False
    over_model: bool = True
    segmented: bool = False
    seq_res: str | None = None
    rows: str = "whole"


def first_rank() -> bool:
    """Whether the calling rank is its mesh's first (every coordinate 0):
    the one that records what the ranks computed alike."""
    return _context().rank == 0


def tensor_parallel() -> TensorParallel | None:
    """The calling rank thread's :class:`TensorParallel`; None outside a
    rank program that sets one."""
    return getattr(_TLS, "tp", None)


def model_parallel() -> TensorParallel | None:
    """The calling rank thread's :class:`TensorParallel` where its params
    are split over :data:`MODEL_AXIS`; None elsewhere, where the layers
    compute as they always do."""
    tp = getattr(_TLS, "tp", None)
    return tp if tp is not None and tp.over_model else None


@contextlib.contextmanager
def tensor_parallel_scope(tp: TensorParallel):
    """``tp`` as the calling rank thread's :func:`tensor_parallel` inside
    the block."""
    outer = getattr(_TLS, "tp", None)
    _TLS.tp = tp
    try:
        yield
    finally:
        _TLS.tp = outer


def _gather_spec(spec: PartitionSpec, keep: tuple[str, ...] = ()) -> PartitionSpec:
    """The dims a tensor-parallel rank all-gathers of a leaf laid out by
    ``spec``: every axis but :data:`MODEL_AXIS` (the rank keeps its part)
    and those of ``keep`` (a cache's batch rows).  A dim that the model axis
    does not divide was already replicated by ``param_pspec`` and
    ``cache_shardings``, as the reference drops the axis."""
    gather = []
    for d, e in enumerate(spec):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        if MODEL_AXIS in axes and len(axes) > 1:
            raise ValueError(f"dim {d} of {spec} splits the model axis with {axes}: a rank "
                             f"cannot keep its model part alone")
        gathered_axes = tuple(a for a in axes if a not in keep and a != MODEL_AXIS)
        if gathered_axes and len(gathered_axes) != len(axes):
            raise ValueError(f"dim {d} of {spec} mixes kept and gathered axes")
        gather.append(gathered_axes or None)
    return P(*gather)


def _kv_cache_layout(cache: Any, cache_specs: Any) -> tuple[str | None, bool, bool]:
    """(the sequence's axis, kv heads split, latent split) of the attention
    layers' ``k`` leaves (``(.., B, S, Hkv, Dh)``) and the MLA layers'
    ``ckv``/``krope`` leaves (``(.., B, S, R)``) laid out by
    ``cache_specs``: the mesh axis their sequence is split over (None where
    it is whole), and whether the kv heads, or MLA's latent and rope dims
    under ``layout="heads"``, are split over the model axis; (None, False,
    False) for a cache with none.  The leaves must all lie alike: a layer
    whose cache is whole beside one whose cache is split, or a latent split
    beside a rope dim kept whole, is refused."""
    from repro_torch.distributed.sharding import _map_with_path

    found: dict[tuple, list[str]] = {}
    kinds: set[str] = set()
    specs: list = []
    tree_map(lambda _, spec: specs.append(spec), cache, cache_specs)
    it = iter(specs)

    def one(path, leaf):
        spec = next(it)
        name = path[-1] if path else None
        base = {"k": 4, "ckv": 3, "krope": 3}.get(name)
        if base is None:
            return
        kinds.add("k" if name == "k" else "latent")
        nb = len(leaf.shape) - base
        entry = lambda d: spec[d] if d < len(spec) else None  # noqa: E731
        split = (entry(nb + 1), entry(nb + 2) == MODEL_AXIS)
        found.setdefault(split, []).append("/".join(map(str, path)))

    _map_with_path(one, cache)
    if len(found) > 1:
        raise ValueError(f"the attention layers' caches lie differently over the mesh "
                         f"(sequence axis, heads or latent split: leaves): {found}")
    seq, heads = next(iter(found)) if found else (None, False)
    return seq, heads and "k" in kinds, heads and "latent" in kinds


def serving_body(model: Any, mesh: Mesh, params: Any, param_specs: Any, cache: Any,
                 cache_specs: Any, step: Callable, rules: Any) -> Callable:
    """The body of a tensor-parallel serving rank of ``model`` on ``mesh``,
    its ``params`` and ``cache`` laid out by ``param_specs`` and
    ``cache_specs``; raises for what it does not run.

    ``body(params, batch, cache) -> (logits, cache)`` takes the rank's
    shards: it gathers each param over its axes other than
    :data:`MODEL_AXIS` (the ``fsdp`` dims), keeps it split over the model
    axis, keeps the cache block the rank's own, and runs
    ``step(params, batch, cache)`` under ``rules`` with a
    :class:`TensorParallel` as the thread's :func:`tensor_parallel`.  The
    logits are the rank's rows and vocabulary columns, ``P(batch,
    "model")`` for the rules' ``batch`` axes: ``P(None, "model")`` under
    ``long_decode_rules``, whose batch of one every rank holds.

    It runs the models ``Model.tensor_parallel_refusal`` admits: attention
    (windowed or not, the encoder's too), MLA, cross-attention and Mamba2
    mixers, with SwiGLU, capacity-bucketed MoE (``moe_impl="onehot"``) or
    no MLPs (the refusal names what else it refuses), under
    ``decode_rules``, ``decode_rules_headsharded`` or
    ``long_decode_rules``.  The cache must lie as the rules say: the
    sequence of the attention and MLA caches over the rules' ``kv_seq``
    axis or whole, its other dims over ``model`` or the rules' ``batch``
    axes (``cache_shardings``; with ``long_context=True`` under
    ``long_decode_rules``: the sequence over ``data``, every kv head and
    the whole latent on each rank).  A cache laid out for other rules is
    refused."""
    from repro_torch.distributed.sharding import use_rules

    refusal = model.tensor_parallel_refusal()
    if refusal is not None:
        raise NotImplementedError(f"{model.cfg.name}: {refusal}")
    if MODEL_AXIS not in mesh.shape:
        raise ValueError(f"tensor-parallel serving needs a {MODEL_AXIS!r} axis in {mesh}")
    kv_seq = rules.logical.get("kv_seq")
    long_context = kv_seq not in (None, MODEL_AXIS)  # the sequence over a batch axis
    batch = _axes(rules.logical.get("batch") or ())

    gather = tree_map(lambda _, s: _gather_spec(s), params, param_specs)
    keep = batch + ((kv_seq,) if long_context else ())
    if any(tree_leaves(tree_map(lambda _, s: any(_gather_spec(s, keep)), cache, cache_specs))):
        raise ValueError(f"a tensor-parallel rank writes its own cache block: under these "
                         f"rules the cache may be split over {(MODEL_AXIS, *keep)} only")
    seq_axis, heads_split, latent_split = _kv_cache_layout(cache, cache_specs)
    if seq_axis not in (None, kv_seq) or (long_context and (heads_split or latent_split)):
        laid = (f"its sequence over {seq_axis!r}" if seq_axis is not None
                else "its heads or latent over 'model'")
        raise ValueError(f"the cache is laid out for other rules ({laid}); these rules put the "
                         f"KV sequence over {kv_seq!r}: lay it out by cache_shardings"
                         f"{'(long_context=True)' if long_context else ''}")
    if seq_axis is not None and mesh.shape[seq_axis] == 1:
        seq_axis = None  # one block holds every row
    if mesh.shape[MODEL_AXIS] == 1:  # one rank holds every head: no model collective
        heads_split = latent_split = False
    tp = TensorParallel(seq_axis, heads_split, batch, latent_split)

    def body(params_l, batch_l, cache_l):
        full = tree_map(gathered, params_l, gather)
        with tensor_parallel_scope(tp), use_rules(rules):
            logits, _ = step(full, batch_l, cache_l)
        return logits, cache_l

    return body


def _serve(model: Any, params: Any, batch: dict, cache: Any, step: Callable, *, mesh: Mesh,
           rules: Any) -> tuple[torch.Tensor, Any]:
    for leaf in tree_leaves(cache):
        if not (isinstance(leaf, ShardedTensor) and leaf.sharding.mesh == mesh):
            raise ValueError("the cache must be placed on the mesh (device_put with "
                             "cache_shardings), so that each rank writes its own block")
    rows = rules.logical.get("batch") or None  # the batch's axes; None: replicated
    p_specs = tree_map(_spec_of, params)
    c_specs = tree_map(_spec_of, cache)
    b_specs = {k: P(rows) for k in batch}
    body = serving_body(model, mesh, params, p_specs, cache, c_specs, step, rules)
    outs = _run_ranks(mesh, body, _local_args(mesh, (params, batch, cache),
                                              (p_specs, b_specs, c_specs)))
    return _global_outputs(mesh, [o[0] for o in outs], P(rows, MODEL_AXIS)), cache


def sharded_prefill(model: Any, params: Any, batch: dict[str, torch.Tensor], cache: Any, *,
                    mesh: Mesh, rules: Any) -> tuple[torch.Tensor, Any]:
    """``model.prefill`` tensor-parallel over the mesh's ``model`` axis: the
    port's counterpart of the reference's ``jax.jit(model.prefill,
    in_shardings=..., out_shardings=(P(batch, "model"), ...))`` under
    ``rules`` (``decode_rules``, ``decode_rules_headsharded`` or
    ``long_decode_rules``).

    ``params`` are :class:`ShardedTensor` leaves placed by
    ``params_shardings`` (a plain tensor is replicated), ``cache`` is placed
    by ``cache_shardings(layout="seq" | "heads")`` on ``mesh`` (under
    ``long_decode_rules`` by ``cache_shardings(long_context=True)``: its
    rows over ``data``), and the batch's leaves (``tokens``, and whisper's
    ``frames`` or the vlm's ``image_embeds``) are split over the rules'
    ``batch`` axes, ``(pod, data)`` (replicated under
    ``long_decode_rules``, a batch of one).  Each rank gathers only the
    ``fsdp`` dims of its params and runs the model on its shards: its
    heads, its MLP columns, its experts and its vocabulary rows, with the
    ``model`` collectives in the layers (``models/layers.py``, ``mla.py``,
    ``ssm.py``, ``moe.py``), and writes its own block of the cache in place
    (under ``long_decode_rules`` every data rank runs the whole prompt and
    writes its block of the rows).  Returns the last position's logits,
    assembled from the ranks' ``P(batch, "model")`` blocks on rank 0's
    device, and the cache.
    """
    return _serve(model, params, batch, cache, lambda p, b, c: model.prefill(p, b, c),
                  mesh=mesh, rules=rules)


def sharded_decode_step(model: Any, params: Any, cache: Any, token: torch.Tensor, pos: int,
                        memory: torch.Tensor | None = None, *, mesh: Mesh,
                        rules: Any) -> tuple[torch.Tensor, Any]:
    """``model.decode_step`` tensor-parallel over the mesh's ``model``
    axis, as :func:`sharded_prefill` runs the prefill: the token ``(B, 1)``
    and ``memory`` (B, M, Dm), the vlm's ``image_embeds`` that the
    reference's server passes every step, split over the rules' ``batch``
    axes; the cache updated in place.  Under the ``seq`` layout decode
    attention is context-parallel over ``model`` (each rank attends with
    every head to its own cache rows and the ranks combine their softmax
    partials); under ``heads`` each rank attends with its own heads (MLA:
    its heads over the latent all-gathered); under ``long_decode_rules``
    each rank attends with its own heads to its own rows and the ``data``
    ranks combine their partials."""
    batch = {"token": token} if memory is None else {"token": token, "memory": memory}
    return _serve(model, params, batch, cache,
                  lambda p, b, c: model.decode_step(p, c, b["token"], pos, b.get("memory")),
                  mesh=mesh, rules=rules)
