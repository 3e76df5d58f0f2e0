"""Worker-process main loop for :class:`~repro_torch.api.cluster_executor.ClusterExecutor`.

Each worker is a **spawn**-started process (a parent that holds a CUDA
context must never fork) that owns one logical *location* of the cluster
and computes on the device its units name: a card plan's units run on the
card in this process's own CUDA context, where the registered partition
kernels launch; a CPU plan's run on the CPU.  It drains a byte-framed
pickle protocol from its command connection and writes replies to its own
reply connection — per-worker pipes, NOT a shared queue, because a worker
that dies mid-write (exactly what fault injection does) must only be able
to corrupt *its own* channel: the parent reads the torn end as EOF and
buries that worker, while every other worker's replies keep flowing.

parent → worker (either one bare message, or ``("batch", [messages])`` —
the parent coalesces a scheduling sweep's commands into one send)
    ``("attach", StoreManifest)`` — build an
    :class:`~repro_torch.api.chunkstore.AttachedStore` so later units can
    resolve :class:`~repro_torch.api.chunkstore.ChunkHandle` payloads; a
    second attach for the same store is a *delta* of a grown store and
    merges into the existing attach;
    ``("unit", epoch, TaskSpec, attempt[, publish])`` — execute one task
    descriptor; with ``publish`` (peer exchange, DESIGN.md §16) the whole
    partial is left in a segment of that name for a sibling's fold;
    ``("fold", epoch, index, attempt, combine_ref, key, trees, device)`` —
    fold the members' published partials (their packed ref trees) with
    the combine's :func:`~repro_torch.api.lowering.stacked_fold` chain on
    ``device``;
    ``("call", epoch, call_id, fn_ref, args, devices, key)`` — execute one
    driver-level task RPC (the ``executor.task()`` path), each tensor
    argument rebuilt on its device;
    ``("steal", token, ((epoch, index), ...))`` — a steal probe: grant
    every listed unit still sitting *unstarted* in the local queue back
    to the parent (reply ``steal_ok``); anything already started or
    finished is silently kept — exactly-once by construction;
    ``("stop",)`` — exit cleanly.

Work stealing (DESIGN.md §15): a batched send can park several units in
the worker's local queue, so the main loop keeps a pending deque and
polls the command channel between unit executions — that poll is where
steal probes are answered, bounding probe latency by one unit's wall time.

worker → parent, over the worker's own reply connection (each message
pre-pickled so the parent can bill exact ``ipc_bytes``)
    ``("ready", wid, pid)``, ``("hb", wid, t)`` — liveness;
    ``("unit_done", wid, epoch, index, result, loaded, shm_wrote)`` /
    ``("unit_error", wid, epoch, index, err)`` — unit outcomes;
    ``("call_done", wid, epoch, call_id, result, shm_wrote)`` /
    ``("call_error", wid, epoch, call_id, err)`` — RPC outcomes.

The data plane (:mod:`repro_torch.api.shm`): operand payloads may arrive
as ``ShmBlockRef`` descriptors, copied out of the parent's segments onto
the unit's device (on the card: one host-to-device copy from pageable
memory).  Results come back to the host; leaves above ``result_min_bytes``
travel packed into ONE fresh segment per reply named
``<result_prefix><seq>`` (the parent unlinks it on consume, or sweeps the
prefix if this worker dies first); ``shm_wrote`` bills the copied bytes to
the parent's ``EngineReport.shm_bytes``.

Determinism: the worker rebuilds exactly the operands + function the
in-process lowering would have dispatched — the fused kernel takes the
partition's blocks as they are, the generic fold a ``torch.stack`` of
them, a materialized partition their ``torch.cat`` — on the same device,
so a replayed unit, or the same unit on a different worker, produces
bit-identical partials.  A fold unit runs the driver's merge chain for
its location (the same association, on the plan's device), so a peer
merged execute is bit-identical to a driver merged one.  There is no
fallback: a card unit whose kernel cannot build or launch, or a fold that
cannot run on the card, fails with its error.

Fault injection (tests and chip runs): ``kill_after`` makes the worker
``os._exit`` on *receiving* its nth dispatch (the unit is lost in flight);
``kill_on_retry`` does the same on receiving an already-replayed unit;
``mute_after`` silences heartbeats and hangs (the heartbeat-timeout path,
the process stays alive); ``slow_s`` sleeps before every unit — the
straggler hook.  Dispatch counts are per unit/call message, so a fault
keyed on "the nth dispatch" fires identically whether the commands arrived
batched or one by one.
"""

from __future__ import annotations

import collections
import os
import pickle
import threading
import time
import traceback

__all__ = ["worker_main", "unit_stats"]

#: exit codes used by injected faults (visible in worker logs / waitpid)
KILLED_EXIT = 23
RETRY_KILLED_EXIT = 24

#: this process's unit timings, summed: building the operands (for a card
#: unit, the copies from shared memory to the card), the function up to its
#: device's completion, and the reply (results to the host, packed, sent);
#: fold units are counted apart, with their whole time (attach, fold, reply)
_ZERO = {"units": 0, "operands_s": 0.0, "compute_s": 0.0, "reply_s": 0.0,
         "folds": 0, "fold_s": 0.0}
_STATS = dict(_ZERO)


def unit_stats(reset: bool = False) -> dict:
    """This worker's unit timings so far (a driver reads them with
    ``ClusterExecutor.call_workers(unit_stats)``); ``reset`` zeroes them."""
    out = dict(_STATS)
    if reset:
        _STATS.update(_ZERO)
    return out


def _log_line(log, wid: int, msg: str) -> None:
    if log is not None:
        log.write(f"[w{wid} +{time.monotonic():.3f}] {msg}\n")
        log.flush()


def _resolve_fn(fn_ref: tuple, cache: dict):
    """Rehydrate a task function from its picklable reference (cached)."""
    fn = cache.get(fn_ref)
    if fn is not None:
        return fn
    from repro_torch.api.fnref import decode_fn

    kind = fn_ref[0]
    if kind == "scan":
        from repro_torch.api.lowering import _partition_body

        _, efn, ecomb, n_in = fn_ref
        fn = _partition_body(decode_fn(efn), decode_fn(ecomb), n_in)
    elif kind == "fold":
        # A peer-exchange merge chain: the driver's merge task's fold body.
        from repro_torch.api.lowering import stacked_fold

        fn = stacked_fold(decode_fn(fn_ref[1]))
    elif kind == "kernel":
        from repro_torch.api.kernels import kernel_from_ref

        kernel = kernel_from_ref(fn_ref[1])
        if kernel is None:
            raise RuntimeError(f"no registered kernel for {fn_ref[1]!r}")
        fn = kernel.fn
    elif kind == "fn":
        fn = decode_fn(fn_ref[1])
    else:
        raise RuntimeError(f"unknown fn_ref kind {kind!r}")
    cache[fn_ref] = fn
    return fn


def _resolve(payload, device, stores: dict, shm_att):
    """One payload → its value on ``device``; ``(value, disk bytes read)``."""
    import numpy as np
    import torch

    from repro_torch.api.chunkstore import ChunkHandle, ChunkStoreError
    from repro_torch.api.shm import ShmBlockRef, to_tensor

    if isinstance(payload, ChunkHandle):
        store = stores.get(payload.store_uid)
        if store is None:
            raise ChunkStoreError(f"store {payload.store_uid} not attached")
        entry = store.manifest.chunks.get(payload.chunk_id)
        loaded = payload.nbytes if entry is not None and entry[0] == "file" else 0
        return store.resolve(payload, device), loaded
    if isinstance(payload, ShmBlockRef):
        return shm_att.tensor(payload, device), 0
    if isinstance(payload, np.ndarray):
        return to_tensor(payload, payload.dtype.str, device), 0
    if isinstance(payload, torch.Tensor):
        return payload.to(device), 0
    return payload, 0  # a plain python extra


def _build_operands(spec, stores: dict, shm_att):
    """Payloads → operand tuple, mirroring the in-process lowering exactly.

    ``partition_pallas`` passes each input's blocks as a tuple (the kernel
    reads them in place), ``partition_scan`` stacks them on a new leading
    axis, ``partition_materialized`` concatenates, ``block`` passes the
    single block through.  Returns the operands plus the chunk bytes read
    from spill files (billed upstream as ``bytes_loaded``).
    """
    import torch

    device = torch.device(spec.device)
    loaded = 0

    def resolve(payload):
        nonlocal loaded
        value, n = _resolve(payload, device, stores, shm_att)
        loaded += n
        return value

    ops = []
    for blocks in spec.data:
        arrs = [resolve(b) for b in blocks]
        if spec.kind == "partition_pallas":
            ops.append(tuple(arrs))
        elif spec.kind == "partition_scan":
            ops.append(torch.stack(arrs, dim=0))
        elif spec.kind == "partition_materialized":
            ops.append(torch.cat(arrs, dim=0))
        else:
            ops.append(arrs[0])
    ops.extend(resolve(e) for e in spec.extras)
    return tuple(ops), loaded


def _fold_operand(trees, device):
    """The members' published partials, stacked on ``device``.

    Each packed ref tree's segments are attached read-only, copied onto the
    device and released at once: unlinking stays with the driver's lease.
    """
    import torch

    from repro_torch._pytree import tree_map
    from repro_torch.api import shm as shm_mod

    att = shm_mod.ShmAttachments()
    try:
        partials = [
            tree_map(lambda leaf: _resolve(leaf, device, {}, att)[0], tree) for tree in trees
        ]
    finally:
        att.close()
    return tree_map(lambda *xs: torch.stack(xs, 0), *partials)


def _to_host(tree):
    """Result tensors → host values that pickle only their own elements."""
    import torch

    from repro_torch._pytree import tree_map
    from repro_torch.api.lowering import _inline

    return tree_map(lambda x: _inline(x) if isinstance(x, torch.Tensor) else x, tree)


def worker_main(
    worker_id: int,
    location: int,
    conn,
    reply_conn,
    *,
    heartbeat_s: float = 0.2,
    kill_after: int | None = None,
    kill_on_retry: bool = False,
    mute_after: int | None = None,
    slow_s: float | None = None,
    log_path: str | None = None,
    result_prefix: str | None = None,
    result_min_bytes: int = 1024,
) -> None:
    """Entry point of one cluster worker process."""
    log = open(log_path, "a") if log_path else None
    _log_line(log, worker_id, f"start pid={os.getpid()} location={location}")

    reply_lock = threading.Lock()  # main thread + heartbeat thread share the pipe

    def reply(msg) -> None:
        payload = pickle.dumps(msg)
        with reply_lock:
            reply_conn.send_bytes(payload)

    stop_beat = threading.Event()

    def beat() -> None:
        while not stop_beat.is_set():
            try:
                reply(("hb", worker_id, time.time()))
            except (OSError, ValueError):  # parent gone / pipe torn down
                return
            stop_beat.wait(heartbeat_s)

    threading.Thread(target=beat, name="hb", daemon=True).start()
    reply(("ready", worker_id, os.getpid()))

    from repro_torch.api import shm as shm_mod

    shm_att = shm_mod.ShmAttachments()
    fns: dict = {}
    stores: dict = {}
    dispatches = 0
    reply_seq = 0

    def pack(tree, *, publish=None):
        """Large reply leaves → one fresh segment; (tree, bytes_copied).

        ``publish`` names the segment and drops the size floor to 0: a
        published partial (peer exchange) lands at the name the driver
        derived from the unit's epoch, index and attempt — never from the
        worker — so a replay or a steal publishes to the same place, and
        every leaf is packed, since a sibling attaches the segment instead
        of reading the reply.
        """
        nonlocal reply_seq
        if result_prefix is None:
            return tree, 0
        if publish is not None:
            packed, _seg, wrote = shm_mod.pack_tree(tree, threshold=0, name=publish)
            return packed, wrote
        reply_seq += 1
        packed, _seg, wrote = shm_mod.pack_tree(
            tree, threshold=result_min_bytes, name=f"{result_prefix}{reply_seq}"
        )
        return packed, wrote

    #: unit/call messages received but not yet executed — the local queue
    #: steal probes are answered against.
    pending: collections.deque = collections.deque()

    def handle_steal(msg) -> None:
        """Grant every probed unit still unstarted in the local queue,
        except its head.

        Exactly-once hinges on ordering: a unit is granted only while its
        message is still in ``pending`` — removal here happens before any
        of its work runs, and a unit already popped (running or finished)
        is silently kept, so the parent's grant list and this worker's
        execution set can never overlap.  The head of the queue counts as
        started, as the parent counts it (a victim's backlog is its window
        less one): a probe that lands before the worker began its batch
        still leaves it a unit to run, so two idle workers can never trade
        a batch back and forth without either running any of it.
        """
        _, token, wants = msg
        want = set(wants)
        granted = []
        kept: collections.deque = collections.deque()
        for i, qm in enumerate(pending):
            key = (
                (qm[1], qm[2].index) if qm[0] == "unit"
                else (qm[1], qm[2]) if qm[0] == "fold" else None
            )
            if i > 0 and key in want:
                granted.append(key)
            else:
                kept.append(qm)
        pending.clear()
        pending.extend(kept)
        reply(("steal_ok", worker_id, token, tuple(granted)))
        _log_line(
            log, worker_id,
            f"steal probe token={token} wants={len(wants)} granted={len(granted)}",
        )

    def handle(msg) -> None:
        """Execute one unit/call message."""
        nonlocal dispatches
        kind = msg[0]

        dispatches += 1
        if mute_after is not None and dispatches >= mute_after:
            _log_line(log, worker_id, "FAULT: muting heartbeats and hanging")
            stop_beat.set()
            while True:  # injected hang: only the parent's timeout saves us
                time.sleep(3600)
        if kill_after is not None and dispatches >= kill_after:
            _log_line(log, worker_id, f"FAULT: killing on dispatch #{dispatches}")
            os._exit(KILLED_EXIT)

        if kind == "unit":
            _, epoch, spec, attempt = msg[:4]
            publish = msg[4] if len(msg) > 4 else None
            if kill_on_retry and attempt > 0:
                _log_line(log, worker_id, f"FAULT: killing on retried unit {spec.index}")
                os._exit(RETRY_KILLED_EXIT)
            _log_line(log, worker_id, f"unit {spec.index} start attempt={attempt}")
            if slow_s:
                time.sleep(slow_s)  # injected straggler
            try:
                fn = _resolve_fn(spec.fn_ref, fns)
                t0 = time.perf_counter()
                ops, loaded = _build_operands(spec, stores, shm_att)
                t1 = time.perf_counter()
                result = fn(*ops)
                if spec.device.startswith("cuda"):
                    import torch

                    torch.cuda.synchronize(spec.device)
                t2 = time.perf_counter()
                out, wrote = pack(_to_host(result), publish=publish)
                reply(("unit_done", worker_id, epoch, spec.index, out, loaded, wrote))
                _STATS["units"] += 1
                _STATS["operands_s"] += t1 - t0
                _STATS["compute_s"] += t2 - t1
                _STATS["reply_s"] += time.perf_counter() - t2
                _log_line(
                    log, worker_id,
                    f"unit {spec.index} kind={spec.kind} blocks={spec.block_ids} "
                    f"device={spec.device} attempt={attempt} ok"
                    + (f" published={publish}" if publish else ""),
                )
            except Exception:  # the unit fails; the worker goes on
                err = traceback.format_exc()
                _log_line(log, worker_id, f"unit {spec.index} FAILED\n{err}")
                reply(("unit_error", worker_id, epoch, spec.index, err))
        elif kind == "fold":
            # Peer exchange (DESIGN.md §16): fold a location's published
            # partials in place with the driver's chain, on the plan's device.
            _, epoch, index, attempt, combine_ref, key_repr, trees, device = msg
            if kill_on_retry and attempt > 0:
                _log_line(log, worker_id, f"FAULT: killing on retried fold {index}")
                os._exit(RETRY_KILLED_EXIT)
            _log_line(log, worker_id, f"fold {index} start attempt={attempt}")
            if slow_s:
                time.sleep(slow_s)
            try:
                import torch

                t0 = time.perf_counter()
                fold = _resolve_fn(("fold", combine_ref), fns)
                result = fold(_fold_operand(trees, torch.device(device)))
                if device.startswith("cuda"):
                    torch.cuda.synchronize(device)
                out, wrote = pack(_to_host(result))
                reply(("unit_done", worker_id, epoch, index, out, 0, wrote))
                _STATS["folds"] += 1
                _STATS["fold_s"] += time.perf_counter() - t0
                _log_line(
                    log, worker_id,
                    f"fold {index} key={key_repr} fan_in={len(trees)} device={device} "
                    f"attempt={attempt} ok",
                )
            except Exception:  # the fold fails; the worker goes on
                err = traceback.format_exc()
                _log_line(log, worker_id, f"fold {index} FAILED\n{err}")
                reply(("unit_error", worker_id, epoch, index, err))
        elif kind == "call":
            _, epoch, call_id, fn_ref, args, devices, key = msg
            try:
                import torch

                fn = _resolve_fn(fn_ref, fns)
                ops = [
                    _resolve(a, torch.device(d), stores, shm_att)[0]
                    if d else a
                    for a, d in zip(args, devices)
                ]
                out, wrote = pack(_to_host(fn(*ops)))
                reply(("call_done", worker_id, epoch, call_id, out, wrote))
                _log_line(log, worker_id, f"call {call_id} key={key} ok")
            except Exception:  # the call fails; the worker goes on
                err = traceback.format_exc()
                _log_line(log, worker_id, f"call {call_id} key={key} FAILED\n{err}")
                reply(("call_error", worker_id, epoch, call_id, err))
        else:
            _log_line(log, worker_id, f"unknown message {kind!r}; ignoring")

    def ingest(payload) -> bool:
        """Route one received message; False means stop was seen.

        Control traffic (attach, steal probes, stop) is handled inline so
        it takes effect ahead of queued work; unit/call messages append to
        ``pending`` in arrival order.
        """
        msg = pickle.loads(payload)
        for m in msg[1] if msg[0] == "batch" else (msg,):
            kind = m[0]
            if kind == "stop":
                _log_line(log, worker_id, "stop")
                return False
            if kind == "attach":
                manifest = m[1]
                from repro_torch.api.chunkstore import AttachedStore

                store = stores.get(manifest.uid)
                if store is not None:
                    store.merge(manifest)  # a grown store's delta
                else:
                    stores[manifest.uid] = AttachedStore(manifest)
                _log_line(
                    log, worker_id,
                    f"attach store={manifest.uid} chunks={len(manifest.chunks)}",
                )
            elif kind == "steal":
                handle_steal(m)
            else:
                pending.append(m)
        return True

    running = True
    while running:
        if pending:
            # Between units: drain whatever control traffic has arrived —
            # this is where steal probes are answered.
            try:
                while running and conn.poll(0):
                    running = ingest(conn.recv_bytes())
            except (EOFError, OSError):
                _log_line(log, worker_id, "command channel closed; exiting")
                break
            if not running or not pending:
                continue
            handle(pending.popleft())
        else:
            try:
                payload = conn.recv_bytes()
            except EOFError:
                _log_line(log, worker_id, "command channel closed; exiting")
                break
            running = ingest(payload)

    stop_beat.set()
    shm_att.close()  # release our mappings; unlink stays the parent's job
    for store in stores.values():
        store.close()
    if log is not None:
        log.close()
