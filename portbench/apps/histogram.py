"""Histogram cells: ``repro_torch.core.apps.histogram.histogram`` in a closed loop.

A job is one ``histogram()`` call, one pass over every row.  The comparison
takes the last pass's counts, all ``bins**d`` of them, against the plain
reference: ``cells_off`` counts the cells that differ (exact: limit 0).
"""

from __future__ import annotations

import torch

from portbench import generator
from portbench.reference.histogram import histogram_counts


class App:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg = cfg
        self.rows = generator.make_rows(cfg, seed, device)
        self.x = generator.blocked(self.rows, cfg, traffic)
        self.policy = generator.policy(traffic)
        self.last = None

    def warm(self, ex) -> None:
        self.job(ex, -1)

    def job(self, ex, index: int) -> tuple[int, list]:
        from repro_torch.core.apps.histogram import histogram

        c = self.cfg
        counts, report = histogram(self.x, bins=c["bins"], lo=c["lo"], hi=c["hi"],
                                   policy=self.policy, executor=ex)
        self.last = counts
        return 1, [report]

    def answer(self) -> torch.Tensor:
        return self.last.reshape(-1).to(torch.int64)

    def reference(self, control: bool = False) -> torch.Tensor:
        c = self.cfg
        return histogram_counts(self.rows, bins=c["bins"], lo=c["lo"], hi=c["hi"],
                                dtype=torch.bfloat16 if control else torch.float32)

    @staticmethod
    def compare(answer: torch.Tensor, ref: torch.Tensor) -> dict[str, float]:
        if answer.shape != ref.shape:
            return {"cells_off": float(ref.numel())}
        return {"cells_off": float((answer != ref).sum())}
