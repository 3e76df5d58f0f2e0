"""Cascade SVM (paper §5.3, after Graf et al.) — compute-bound, order-sensitive.

Each cascade level trains an SVM per data group and keeps its support
vectors; pairs of SV sets are unioned and retrained until one set remains;
the global loop feeds the final SVs back (few iterations).

Order sensitivity: the labels ``y`` are a *separate* blocked collection that
must stay aligned with the points ``x`` (the paper's ``get_indexes``, §4.1).
``Collection.zip(x, y)`` carries both arrays through one plan, so every
:class:`~repro_torch.api.PartitionView` yields block-aligned (points,
labels) buffers; the level-0 group list is a single ``map_partitions``
whose granularity (per block, per partition, per rechunked block) is the
policy's decision.

As in the JAX package, the SVM is a bias-free RBF kernel SVM trained by
projected gradient ascent on the dual (O(n² d) kernel matrix, O(n²) per
step), and the "support vectors" are the top ``num_sv`` points by dual
coefficient.  Projected ascent clips many coefficients to exactly 0 or
``c``, so the choice among equal coefficients decides which points are
kept: :func:`repro_torch._topk.top_k` keeps the lower index first, as ``lax.top_k`` does.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._topk import top_k
from repro_torch.api import Collection, Executor, ExecutionPolicy, SplIter, as_policy
from repro_torch.api.executors import _default_local, _synchronize
from repro_torch.core.blocked import BlockedArray
from repro_torch.core.engine import EngineReport

__all__ = ["cascade_svm", "svc_train", "CascadeSVMResult"]


def _rbf(a: torch.Tensor, b: torch.Tensor, gamma: float) -> torch.Tensor:
    d2 = (
        torch.sum(a * a, 1)[:, None]
        - 2.0 * a @ b.T
        + torch.sum(b * b, 1)[None, :]
    )
    return torch.exp(-gamma * d2)


def svc_train(
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    c: float = 1.0,
    gamma: float = 0.5,
    steps: int = 200,
    num_sv: int,
):
    """Train a bias-free RBF-SVM; return the ``num_sv`` strongest SVs.

    Dual projected gradient:  α ← clip(α + η(1 − Q α), 0, C) with
    Q = (y yᵀ) ⊙ K and η = 1 / (‖Q‖∞ + 1e-6).  Returns
    ``(sv_x, sv_y, sv_alpha)``.
    """
    n = x.shape[0]
    q = _rbf(x, x, gamma) * (y[:, None] * y[None, :])
    eta = 1.0 / (q.abs().sum(1).max() + 1e-6)  # the max-row-sum (inf) norm
    alpha = torch.zeros((n,), dtype=x.dtype, device=x.device)
    for _ in range(steps):
        g = 1.0 - q @ alpha
        alpha = torch.clamp(alpha + eta * g, 0.0, c)
    _, top = top_k(alpha, min(num_sv, n))
    return x[top], y[top], alpha[top]


@dataclasses.dataclass
class CascadeSVMResult:
    sv_x: torch.Tensor
    sv_y: torch.Tensor
    sv_alpha: torch.Tensor
    report: EngineReport

    def decision(self, q: torch.Tensor, gamma: float = 0.5) -> torch.Tensor:
        return _rbf(q, self.sv_x, gamma) @ (self.sv_alpha * self.sv_y)


def cascade_svm(
    x: BlockedArray,
    y: BlockedArray,
    *,
    num_sv: int = 32,
    c: float = 1.0,
    gamma: float = 0.5,
    steps: int = 200,
    iterations: int = 2,
    policy: ExecutionPolicy | str = SplIter(),
    executor: Executor | None = None,
) -> CascadeSVMResult:
    """Run the cascade under an execution policy.

    ``Baseline``: level-0 trains one task per *block* (paper Listing 8).
    ``SplIter``: level-0 trains one task per *partition* on the
    locally-concatenated blocks (paper Listing 9).  ``Rechunk``:
    materialize one block per location first (traffic).
    """
    assert x.num_blocks == y.num_blocks
    pol = as_policy(policy)
    ex = executor if executor is not None else _default_local()

    def train_task(bx, by, feed_x, feed_y):
        ax = torch.cat([bx, feed_x], 0)
        ay = torch.cat([by, feed_y], 0)
        return svc_train(ax, ay, c=c, gamma=gamma, steps=steps, num_sv=num_sv)

    def merge_task(x1, y1, x2, y2):
        return svc_train(
            torch.cat([x1, x2], 0),
            torch.cat([y1, y2], 0),
            c=c,
            gamma=gamma,
            steps=steps,
            num_sv=num_sv,
        )

    with ex.scope(pol.mode_name) as report:
        # Level-0 group list: aligned (points, labels) buffers per task —
        # one plan, granularity decided by the policy.
        groups = (
            Collection.zip(Collection.from_blocked(x), Collection.from_blocked(y))
            .split(pol)
            .map_partitions(lambda view: view.materialized)
            .compute(executor=ex)
            .value
        )

        d = x.row_shape[0]
        feed_x = torch.zeros((0, d), dtype=x.dtype, device=x.device)
        feed_y = torch.zeros((0,), dtype=y.dtype, device=y.device)

        for _ in range(iterations):
            t = ex.task(train_task, key=("train", tuple(feed_x.shape)))
            level = [t(bx, by, feed_x, feed_y) for bx, by in groups]
            # Binary cascade: union pairs of SV sets and retrain (Graf et al.).
            while len(level) > 1:
                nxt = []
                mt = ex.task(merge_task, key="merge")
                for i in range(0, len(level) - 1, 2):
                    (x1, y1, _), (x2, y2, _) = level[i], level[i + 1]
                    nxt.append(mt(x1, y1, x2, y2))
                    report.merges += 1
                if len(level) % 2:
                    nxt.append(level[-1])
                level = nxt
            sv_x, sv_y, sv_a = level[0]
            feed_x, feed_y = sv_x, sv_y  # feedback loop

        # Final model: retrain on the winning SV set keeping ALL its points
        # (Graf et al.: the last cascade level's full solution is the model).
        refit = ex.task(
            lambda fx, fy: svc_train(
                fx, fy, c=c, gamma=gamma, steps=steps, num_sv=int(sv_x.shape[0])
            ),
            key=("refit", int(sv_x.shape[0])),
        )
        sv_x, sv_y, sv_a = _synchronize(refit(sv_x, sv_y))
    return CascadeSVMResult(sv_x=sv_x, sv_y=sv_y, sv_alpha=sv_a, report=report)
