"""Parity of the PyTorch port's plan, lowering and engine layers with JAX.

The port must lower every plan to the same TaskGraph text as the reference,
fold partials in the same order, serialize the same EngineReport, and count
traces the same way.
"""

import dataclasses
import functools
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.api.lowering as jlow
import repro.core.engine as jengine
import repro_torch.api as tapi
import repro_torch.api.lowering as tlow
import repro_torch.core.engine as tengine
from repro.core import blocked as jblocked
from repro.core.apps.histogram import histogramdd_block as j_hist_block
from repro_torch.core import blocked as tblocked
from repro_torch.core.apps.histogram import histogramdd_block as t_hist_block

POLICIES = [
    "Baseline()",
    "SplIter()",
    "SplIter(partitions_per_location=2)",
    "SplIter(partitions_per_location=3, materialize=True)",
    "SplIter(materialize=True)",
    "SplIter(fusion='pallas')",
    "SplIter(partitions_per_location=2, fusion='pallas')",
    "SplIter(fusion='scan')",
    "Rechunk()",
    "Rechunk(target_rows=17)",
]
DATASETS = [(40, 8, 2, "round_robin_placement"), (97, 12, 3, "contiguous_placement")]


def _policy(api, text):
    return eval(text, {k: getattr(api, k) for k in ("Baseline", "SplIter", "Rechunk")})


def _pair(rows, block_rows, locs, placement, d=2, seed=0):
    pts = np.random.default_rng(seed).random((rows, d)).astype(np.float32)
    jx = jblocked.BlockedArray.from_array(
        jnp.asarray(pts), block_rows, num_locations=locs,
        policy=getattr(jblocked, placement),
    )
    tx = tblocked.BlockedArray.from_array(
        pts, block_rows, num_locations=locs,
        policy=getattr(tblocked, placement), device="cpu",
    )
    return jx, tx


def _combine(a, b):
    return a + b


def _describe(api, block_fn, x, pol_text, reduce=True):
    c = api.Collection.from_blocked(x).split(_policy(api, pol_text)).map_blocks(block_fn)
    if reduce:
        c = c.reduce(_combine)
    plan = c.plan()
    return plan.describe(), api.LocalExecutor().lower(plan).describe()


@pytest.mark.parametrize("ds", DATASETS, ids=lambda d: f"n{d[0]}l{d[2]}")
@pytest.mark.parametrize("pol", POLICIES)
def test_describe_equals_reference(pol, ds):
    """Plan and TaskGraph text are equal, fused kernel tasks included."""
    jx, tx = _pair(*ds)
    jfn = functools.partial(j_hist_block, bins=4, lo=0.0, hi=1.0)
    tfn = functools.partial(t_hist_block, bins=4, lo=0.0, hi=1.0)
    assert _describe(tapi, tfn, tx, pol) == _describe(japi, jfn, jx, pol)


@pytest.mark.parametrize("pol", ["Baseline()", "SplIter(partitions_per_location=2)"])
def test_unreduced_describe_equals_reference(pol):
    jx, tx = _pair(97, 12, 3, "round_robin_placement")
    jfn = functools.partial(j_hist_block, bins=4, lo=0.0, hi=1.0)
    tfn = functools.partial(t_hist_block, bins=4, lo=0.0, hi=1.0)
    assert _describe(tapi, tfn, tx, pol, reduce=False) == _describe(
        japi, jfn, jx, pol, reduce=False
    )


def test_describe_golden():
    """The reference's golden text (tests/test_api.py), produced by the port."""
    _, tx = _pair(40, 8, 2, "round_robin_placement", d=3)

    def moments(b):
        return torch.sum(b, 0)

    def combine(a, b):
        return a + b

    def describe(pol):
        plan = tapi.Collection.from_blocked(tx).split(pol).map_blocks(moments).reduce(combine)
        return tapi.LocalExecutor().lower(plan.plan()).describe()

    assert describe(tapi.SplIter(partitions_per_location=2)) == "\n".join([
        "[0] loc=0 partition_scan blocks=(0, 4)",
        "[1] loc=0 partition_scan blocks=(2,)",
        "[2] loc=1 partition_scan blocks=(1,)",
        "[3] loc=1 partition_scan blocks=(3,)",
        "[merge] combine=combine",
    ])
    assert describe(tapi.Rechunk()) == "\n".join([
        "[0] loc=0 block blocks=(0,)",
        "[1] loc=1 block blocks=(1,)",
        "[merge] combine=combine",
    ])


def test_policy_values_equal_reference():
    for text in POLICIES:
        tp, jp = _policy(tapi, text), _policy(japi, text)
        assert repr(tp) == repr(jp) and tp.mode_name == jp.mode_name
    for mode in ("baseline", "spliter", "spliter_mat", "spliter_auto", "rechunk"):
        assert repr(tapi.as_policy(mode, partitions_per_location=3)) == repr(
            japi.as_policy(mode, partitions_per_location=3)
        )


def test_engine_report_fields_and_json_round_trip():
    assert [f.name for f in dataclasses.fields(tengine.EngineReport)] == [
        f.name for f in dataclasses.fields(jengine.EngineReport)
    ]
    assert tengine._FIELD_RULES == jengine._FIELD_RULES
    rep = tengine.EngineReport(mode="spliter", dispatches=5, merges=1, traces=2,
                               bytes_moved=7, wall_s=0.25, granularity=2)
    assert tengine.EngineReport.from_json(rep.to_json()) == rep
    # the JSON is the reference's format: each package reads the other's
    assert jengine.EngineReport.from_json(rep.to_json()).as_row() == rep.as_row()
    assert tengine.EngineReport.from_json(
        jengine.EngineReport(mode="x", retries=3).to_json()
    ).retries == 3
    assert tengine.EngineReport.from_json('{"mode": "m", "future_counter": 9}').mode == "m"


def test_engine_report_merge_rules():
    a = tengine.EngineReport(mode="a", dispatches=2, granularity=4, wall_s=1.0)
    b = tengine.EngineReport(mode="b", dispatches=3, granularity=0, wall_s=0.5)
    m = a.merge(b)
    assert (m.mode, m.dispatches, m.granularity, m.wall_s) == ("a+b", 5, 4, 1.5)
    assert a.dispatches == 2  # inputs untouched


def _order_combine(a, b):
    """Non-commutative and non-associative: the result encodes fold order."""
    return a * 3 + b


def test_stacked_fold_order_matches_reference():
    vals = np.arange(1, 8, dtype=np.int64)
    t = tlow.stacked_fold(_order_combine)(torch.as_tensor(vals))
    j = jlow.stacked_fold(_order_combine)(jnp.asarray(vals, jnp.int32))
    assert int(t) == int(j)


def test_stacked_fold_over_pytrees():
    parts = (torch.arange(6).reshape(3, 2), {"c": torch.tensor([1, 2, 3])})
    out = tlow.stacked_fold(lambda a, b: (a[0] + b[0], {"c": a[1]["c"] * b[1]["c"]}))(parts)
    assert out[0].tolist() == [6, 9] and int(out[1]["c"]) == 6


@pytest.mark.parametrize("entries", [
    [(0, 1), (1, 1), (2, 0), (3, 0)],
    [(0, 0), (1, 1), (2, 0), (3, 1), (4, 0)],
    [(0, 2)],
])
def test_fold_plan_and_planned_fold_match_reference(entries):
    plan = tlow.fold_plan(entries)
    assert plan == jlow.fold_plan(entries)
    groups = tuple(m for _, m in plan)
    vals = np.arange(1, len(entries) + 1, dtype=np.int64)
    t = tlow.planned_fold(_order_combine, groups)(torch.as_tensor(vals))
    j = jlow.planned_fold(_order_combine, groups)(jnp.asarray(vals, jnp.int32))
    assert int(t) == int(j)


def test_cross_iteration_edges_match_reference():
    jx, tx = _pair(97, 12, 3, "round_robin_placement")

    def graphs(api, x, block_fn, ppls):
        ex = api.LocalExecutor()
        return [
            ex.lower(api.Collection.from_blocked(x).split(api.SplIter(partitions_per_location=p))
                     .map_blocks(block_fn).reduce(_combine).plan())
            for p in ppls
        ]

    tg = graphs(tapi, tx, functools.partial(t_hist_block, bins=2, lo=0.0, hi=1.0), (1, 1, 2))
    jg = graphs(japi, jx, functools.partial(j_hist_block, bins=2, lo=0.0, hi=1.0), (1, 1, 2))
    assert tlow.cross_iteration_edges(tg[0], tg[1]) == jlow.cross_iteration_edges(jg[0], jg[1])
    assert tlow.cross_iteration_edges(tg[1], tg[2]) == jlow.cross_iteration_edges(jg[1], jg[2])


def test_stable_task_key_survives_rebuilds():
    k1 = tlow.stable_task_key(functools.partial(t_hist_block, bins=8, lo=0.0, hi=1.0))
    k2 = tlow.stable_task_key(functools.partial(t_hist_block, bins=8, lo=0.0, hi=1.0))
    k3 = tlow.stable_task_key(functools.partial(t_hist_block, bins=4, lo=0.0, hi=1.0))
    assert k1 == k2 and k1 != k3

    def make_merge():  # a fresh lambda per call, as apps build them
        return lambda a, b: a + b

    assert make_merge() is not make_merge()
    assert tlow.stable_task_key(make_merge()) == tlow.stable_task_key(make_merge())


def test_remote_lowering_is_not_ported():
    """Remote lowering is ported: under ``Capabilities(remote=True)`` every
    task carries the reference's kind of code reference and projects to a
    picklable TaskSpec whose payloads are the blocks' host bytes (no
    exporter) and whose device is the blocks' device."""
    jx, tx = _pair(40, 8, 2, "round_robin_placement")
    plan = tapi.Collection.from_blocked(tx).split(tapi.SplIter()).map_blocks(torch.sum)
    spec = plan.reduce(_combine).plan().spec
    jplan = japi.Collection.from_blocked(jx).split(japi.SplIter()).map_blocks(jnp.sum)
    jspec = jplan.reduce(_combine).plan().spec
    groups = [tlow.PlacedGroup(0, (0, 2)), tlow.PlacedGroup(1, (1, 3))]
    jgroups = [jlow.PlacedGroup(0, (0, 2)), jlow.PlacedGroup(1, (1, 3))]
    graph = tlow.lower(spec, spec.inputs, groups, tlow.Capabilities(remote=True))
    jgraph = jlow.lower(jspec, jspec.inputs, jgroups, jlow.Capabilities(remote=True))
    assert [t.fn_ref[0] for t in graph.tasks] == [t.fn_ref[0] for t in jgraph.tasks] == [
        "scan", "scan"]
    for t, jt in zip(graph.tasks, jgraph.tasks):
        ts, js = t.spec(), jt.spec()
        assert (ts.kind, ts.block_ids, ts.n_data, ts.device) == (js.kind, js.block_ids,
                                                               js.n_data, "cpu")
        for tb, jb in zip(ts.data[0], js.data[0]):
            np.testing.assert_array_equal(tb, np.asarray(jb))
    local = tlow.lower(spec, spec.inputs, groups, tlow.Capabilities())
    assert all(t.fn_ref is None and t.remote_operands is None for t in local.tasks)


def test_trace_accounting_per_report_window():
    eng = tengine.TaskEngine()
    eng.new_report("a")
    f = eng.task(lambda v: v + 1, key="inc")
    assert f(1) == 2 and eng.task(lambda v: v + 1, key="inc") is f
    assert (eng.report.traces, eng.report.dispatches) == (1, 1)
    eng.new_report("b")
    f(2)
    assert (eng.report.traces, eng.report.dispatches) == (0, 1)


def test_bind_report_is_thread_local():
    eng = tengine.TaskEngine()
    eng.new_report("main")
    f = eng.task(lambda: None, key="noop")
    bound = tengine.EngineReport(mode="bound")
    seen = []

    def worker():
        with eng.bind_report(bound):
            f()
            seen.append(eng.current_report is bound)

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and seen == [True]
    f()
    assert (bound.dispatches, eng.report.dispatches) == (1, 1)


def test_scope_accumulates_one_report():
    _, tx = _pair(40, 8, 2, "round_robin_placement")
    ex = tapi.LocalExecutor()
    plan = tapi.Collection.from_blocked(tx).split(tapi.SplIter()).map_blocks(torch.sum)
    with ex.scope("both") as rep:
        plan.reduce(_combine).compute(executor=ex)
        plan.reduce(_combine).compute(executor=ex)
        ex.task(lambda v: v, key="extra")(1)
    assert (rep.mode, rep.dispatches, rep.merges) == ("both", 7, 2)
    assert rep.wall_s > 0


@pytest.mark.parametrize("pol", ["SplIter(partitions_per_location=2)", "SplIter()"])
def test_cpu_plan_ignores_a_card_on_the_host(pol, monkeypatch):
    """Under fusion "auto" the kernel route follows the blocks' device, not
    the host: a CPU collection lowers as the reference's CPU plan does even
    where ``torch.cuda.is_available()`` is true."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    jx, tx = _pair(97, 12, 3, "round_robin_placement")
    jfn = functools.partial(j_hist_block, bins=4, lo=0.0, hi=1.0)
    tfn = functools.partial(t_hist_block, bins=4, lo=0.0, hi=1.0)
    got = _describe(tapi, tfn, tx, pol)
    assert got == _describe(japi, jfn, jx, pol)
    assert "partition_scan" in got[1] and "partition_pallas" not in got[1]


@pytest.mark.parametrize("pol", ["SplIter(fusion='pallas')",
                                 "SplIter(partitions_per_location=2, fusion='pallas')"])
def test_fused_kernel_reads_blocks_in_place(pol):
    """A partition_pallas task's data operand is the BlockedArray's own
    block tensors (the same objects, the same storage: no copy), while a
    partition_scan task still stacks its run into one new tensor."""
    _, tx = _pair(97, 12, 3, "round_robin_placement")
    tfn = functools.partial(t_hist_block, bins=4, lo=0.0, hi=1.0)
    plan = tapi.Collection.from_blocked(tx).split(_policy(tapi, pol)).map_blocks(tfn) \
        .reduce(_combine).plan()
    graph = tapi.LocalExecutor().lower(plan)
    fused = [t for t in graph.tasks if t.kind == "partition_pallas"]
    assert fused
    for task in fused:
        (blocks,) = task.operands()
        assert isinstance(blocks, tuple) and len(blocks) == len(task.block_ids)
        for b, t in zip(task.block_ids, blocks):
            assert t is tx.blocks[b] and t.data_ptr() == tx.blocks[b].data_ptr()
    scan = tapi.LocalExecutor().lower(
        tapi.Collection.from_blocked(tx).split(tapi.SplIter(fusion="scan")).map_blocks(tfn)
        .reduce(_combine).plan())
    for task in scan.tasks:
        (stacked,) = task.operands()
        assert isinstance(stacked, torch.Tensor) and stacked.shape[0] == len(task.block_ids)
        assert all(stacked.data_ptr() != tx.blocks[b].data_ptr() for b in task.block_ids)


def test_fused_histogram_of_block_lists_equals_reference():
    """The kernel's plain version, fed the block lists the fused lowering
    passes, gives the JAX package's histogram and EngineReport."""
    jx, tx = _pair(97, 12, 3, "round_robin_placement", d=3, seed=4)
    jfn = functools.partial(j_hist_block, bins=4, lo=0.0, hi=1.0)
    tfn = functools.partial(t_hist_block, bins=4, lo=0.0, hi=1.0)
    jr = japi.Collection.from_blocked(jx).split(japi.SplIter(fusion="pallas")).map_blocks(jfn) \
        .reduce(_combine).compute(executor=japi.LocalExecutor())
    tr = tapi.Collection.from_blocked(tx).split(tapi.SplIter(fusion="pallas")).map_blocks(tfn) \
        .reduce(_combine).compute(executor=tapi.LocalExecutor())
    np.testing.assert_array_equal(tr.value.numpy(), np.asarray(jr.value))
    keys = ("dispatches", "traces", "bytes_moved", "granularity", "merges")
    assert {k: getattr(tr.report, k) for k in keys} == {k: getattr(jr.report, k) for k in keys}
