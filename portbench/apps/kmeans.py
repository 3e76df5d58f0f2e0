"""k-means cells: ``repro_torch.core.apps.kmeans.kmeans`` in a closed loop.

A job is one ``kmeans()`` call of ``iters`` Lloyd iterations from centers
drawn from the job's seed; each iteration is one pass.  The comparison takes
the last job's final centers and its last iteration's counts against the
plain reference run from the same seed's centers, which it draws again:

* ``centers_gap``: the largest difference of a center's coordinate, over the
  largest coordinate of the reference's centers;
* ``counts_gap``: the largest difference of a center's count, over that
  center's count in the reference (at least 1).

``kmeans()`` returns the centers only; the last iteration's counts are read
from the result of the executor's last ``execute``, the merged partials
``(sums, counts)``.
"""

from __future__ import annotations

import torch

from portbench import generator
from portbench.reference.kmeans import lloyd
from portbench.reference.threefry import uniform_f32


class App:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg = cfg
        self.seed = seed
        self.rows = generator.make_rows(cfg, seed, device)
        self.x = generator.blocked(self.rows, cfg, traffic)
        self.policy = generator.policy(traffic)
        self.last = None
        self.merged = None
        self.hooked = set()

    def _hook(self, ex) -> None:
        """Keep the value of each of ``ex``'s executes: the merged partials."""
        if id(ex) in self.hooked:
            return
        execute = ex.execute

        def keep(plan):
            res = execute(plan)
            self.merged = res.value
            return res

        ex.execute = keep
        self.hooked.add(id(ex))

    def warm(self, ex) -> None:
        from repro_torch.core.apps.kmeans import kmeans

        self._hook(ex)
        kmeans(self.x, k=self.cfg["k"], iters=1, seed=generator.job_seed(self.seed, -1),
               policy=self.policy, executor=ex)

    def job(self, ex, index: int) -> tuple[int, list]:
        from repro_torch.core.apps.kmeans import kmeans

        self._hook(ex)
        c = self.cfg
        self.merged = None
        jseed = generator.job_seed(self.seed, index)
        res = kmeans(self.x, k=c["k"], iters=c["iters"], seed=jseed, policy=self.policy,
                     executor=ex)
        self.last = (jseed, res.centers, self.merged)
        return res.iterations, list(res.reports)

    def answer(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        _, centers, merged = self.last
        counts = None if merged is None else merged[1].to(torch.float64)
        return centers.to(torch.float32), counts

    def reference(self, control: bool = False):
        c = self.cfg
        jseed = self.last[0]
        init = uniform_f32(jseed, (c["k"], c["d"]), device=self.rows.device)
        centers, counts = lloyd(self.rows, init, c["iters"], tf32=control)
        return centers, counts.to(torch.float64)

    @staticmethod
    def compare(answer, ref) -> dict[str, float]:
        centers, counts = answer
        rc, rn = ref
        out = {"centers_gap": float("inf"), "counts_gap": float("inf")}
        if centers.shape == rc.shape and bool(torch.isfinite(centers).all()):
            scale = float(rc.abs().max().clamp(min=1e-30))
            out["centers_gap"] = float((centers - rc).abs().max()) / scale
        if counts is not None and counts.shape == rn.shape:
            out["counts_gap"] = float(((counts - rn).abs() / rn.clamp(min=1)).max())
        return out
