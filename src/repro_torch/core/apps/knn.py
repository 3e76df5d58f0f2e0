"""k-Nearest Neighbors (paper §5.4) — two-stage, order-sensitive, consolidation.

*fit*: build one lookup structure per fit-block (Baseline) or one per
partition (SplIter — consolidation decouples the number of intermediate
structures from the blocking, paper Figs 7/8).  Both cases are ONE
``map_partitions`` plan: under Baseline every block is its own
single-block partition, so the policy object carries the entire mode
difference.

*kneighbors*: every query block is looked up against every structure and
the per-structure top-k results are merged — #tasks = #structures × #query
blocks, so consolidation shrinks both the task count and the merge fan-in
(Table 1 / Fig 21).

As in the JAX package, a structure is the consolidated candidate matrix
and a lookup is one distance product plus one top-k.  The product goes to
``torch.matmul`` in f32, which the top-k then orders: on a card it must
not run in TF32 (``torch.backends.cuda.matmul.allow_tf32`` False and the
float32 matmul precision ``"highest"``, PyTorch's defaults).

Order sensitivity: returned neighbor ids are **global** row ids of the fit
dataset — exactly what ``PartitionView.item_indexes`` provides (§4.1) —
and equal distances keep the lower id first, as ``lax.top_k`` orders ties
(:func:`repro_torch._topk.top_k` sorts stably; ``torch.topk`` promises no
tie order).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._topk import top_k
from repro_torch.api import Collection, Executor, ExecutionPolicy, SplIter, as_policy
from repro_torch.api.executors import _default_local, _synchronize
from repro_torch.core.blocked import BlockedArray
from repro_torch.core.engine import EngineReport

__all__ = ["knn", "KNNResult"]


@dataclasses.dataclass
class KNNResult:
    distances: torch.Tensor  # (n_queries, k) squared distances, ascending
    indices: torch.Tensor    # (n_queries, k) GLOBAL fit-row ids (int32)
    report: EngineReport


def _lookup(fit_x: torch.Tensor, fit_ids: torch.Tensor, q: torch.Tensor, k: int):
    """Distances of ``q`` against one structure → per-query top-k (d², id)."""
    d2 = (
        torch.sum(q * q, 1)[:, None]
        - 2.0 * q @ fit_x.T
        + torch.sum(fit_x * fit_x, 1)[None, :]
    )
    neg, pos = top_k(-d2, k)  # smallest distances
    return -neg, fit_ids[pos]


def _merge(d1, i1, d2, i2, k: int):
    """Merge two top-k candidate sets (the paper's _merge_kqueries)."""
    d = torch.cat([d1, d2], dim=1)
    i = torch.cat([i1, i2], dim=1)
    neg, pos = top_k(-d, k)
    return -neg, torch.take_along_dim(i, pos, dim=1)


def knn(
    fit: BlockedArray,
    queries: BlockedArray,
    *,
    k: int = 8,
    policy: ExecutionPolicy | str = SplIter(),
    executor: Executor | None = None,
) -> KNNResult:
    pol = as_policy(policy)
    ex = executor if executor is not None else _default_local()

    with ex.scope(pol.mode_name) as report:
        build_task = ex.task(lambda *bs: torch.cat(bs, 0), key=("knn_fit",))

        def build_structure(view):
            # ONE consolidated structure per partition (paper Fig. 8); a
            # single-block "partition" under Baseline.  Global row ids come
            # from the view's item_indexes (paper §4.1).
            pts = build_task(*view.blocks)
            ids = torch.as_tensor(view.item_indexes, dtype=torch.int32, device=pts.device)
            return pts, ids

        # ---- fit stage: build the lookup structures ----------------------
        structures = (
            Collection.from_blocked(fit)
            .split(pol)
            .map_partitions(build_structure)
            .compute(executor=ex)
            .value
        )

        # ---- kneighbors stage --------------------------------------------
        lookup_task = ex.task(lambda f, ids, q: _lookup(f, ids, q, k), key=("lk", k))
        merge_task = ex.task(lambda a, b, c, d: _merge(a, b, c, d, k), key=("mg", k))

        out_d, out_i = [], []
        for qb in queries.iter_blocks():
            cand = None
            for pts, ids in structures:
                r = lookup_task(pts, ids, qb)
                if cand is None:
                    cand = r
                else:
                    cand = merge_task(cand[0], cand[1], r[0], r[1])
                    report.merges += 1
            out_d.append(cand[0])
            out_i.append(cand[1])

        distances, indices = _synchronize((torch.cat(out_d, 0), torch.cat(out_i, 0)))
    return KNNResult(distances=distances, indices=indices, report=report)
