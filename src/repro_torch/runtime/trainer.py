"""Fault-tolerant training loop with SplIter-fused gradient accumulation.

Port of ``repro/runtime/trainer.py``.  The Trainer owns the train step in
the paper's three execution strategies on identical math, the optimizer,
the resumable data pipeline, preemption-safe checkpointing and the
straggler hooks:

  spliter       a loop over the step's microbatch blocks on the device (1 dispatch/step)
  per_block     1 dispatch per microbatch + accumulation by the host loop (baseline)
  materialized  single fused microbatch (rechunk-equivalent, max memory)

**What a dispatch is in the port.**  The reference jits each step function
and counts one dispatch per jitted call.  The port runs eagerly: a dispatch
is one call from the host loop into the step's compute, after which the
host has control again.  ``spliter`` and ``materialized`` make one per
step (the blocks' loop, the f32 gradient sum, the loss and the update stay
on the device, nothing is read back between blocks); ``per_block`` makes
one per block and one for the update (``nb + 1``), as the reference does.
Neither waits for the card inside a step; ``run`` reads the step's loss
once, after it.  ``train_step`` returns the reference's counts.

The params are f32 master weights (``Model.init(master=True)``: every leaf
in ``cfg.param_dtype``) and the moments f32; the model computes in
``model_cfg.dtype``.  A step's blocked batch goes to the device once, at
the start of the step.  ``adamw_update`` updates params and moments in
place, as the reference donates them to XLA: a step's inputs are consumed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch._pytree import tree_leaves, tree_map
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.core.blocked import resolve_device
from repro_torch.data.pipeline import BlockedBatchPipeline, PipelineState
from repro_torch.models import build_model
from repro_torch.optim import accumulate_gradients, adamw_init, adamw_update, cosine_schedule
from repro_torch.optim.grad_accum import value_and_grad
from repro_torch.runtime.ft import PreemptionGuard, StragglerDetector


@dataclasses.dataclass
class TrainConfig:
    global_batch: int = 16
    num_blocks: int = 4          # microbatch blocks per step (the blocking)
    seq_len: int = 64
    steps: int = 50
    peak_lr: float = 3e-3
    warmup_steps: int = 10
    weight_decay: float = 0.1
    accum_mode: str = "spliter"  # spliter | per_block | materialized
    seed: int = 0
    ckpt_dir: str | None = None
    ckpt_every: int = 0          # 0 = only on preemption
    keep_ckpts: int = 2


class Trainer:
    def __init__(self, model_cfg: ModelConfig, cfg: TrainConfig, *,
                 device: str | torch.device = "cuda"):
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(model_cfg)
        self.pipeline = BlockedBatchPipeline(
            vocab_size=model_cfg.vocab_size,
            seq_len=cfg.seq_len,
            global_batch=cfg.global_batch,
            num_blocks=cfg.num_blocks,
            seed=cfg.seed,
        )
        self.ckpt = Checkpointer(cfg.ckpt_dir) if cfg.ckpt_dir else None
        self.straggler = StragglerDetector(["self"])

    # ------------------------------------------------------------------
    def lr(self, step: torch.Tensor) -> torch.Tensor:
        """The learning rate of the update that follows ``step`` updates
        (the optimizer state's step, read before its increment, as the
        reference reads it: the first update's rate is 0)."""
        cfg = self.cfg
        return cosine_schedule(step, peak_lr=cfg.peak_lr, warmup_steps=cfg.warmup_steps,
                               total_steps=cfg.steps)

    def _update(self, params, opt, grads):
        return adamw_update(params, grads, opt, lr=self.lr(opt.step),
                            weight_decay=self.cfg.weight_decay)

    # ------------------------------------------------------------------
    def init_state(self, generator: torch.Generator | None = None):
        """f32 master params drawn from ``generator`` (default: one on the
        device seeded with ``cfg.seed``) and a zero AdamW state."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        params = self.model.init(generator, device=self.device, master=True)
        return params, adamw_init(params)

    def gradients(self, params, blocks: dict[str, torch.Tensor]):
        """The step's mean loss and mean gradients over ``blocks`` (on the
        device) in the configured accumulation mode, and the step's
        dispatches counting the update: ``(loss, grads, n_dispatches)``."""
        mode = self.cfg.accum_mode
        if mode in ("spliter", "materialized"):
            loss, grads = accumulate_gradients(self.model.loss, params, blocks, mode=mode)
            return loss, grads, 1
        if mode != "per_block":
            raise ValueError(f"unknown accum_mode {mode!r}")
        nb = tree_leaves(blocks)[0].shape[0]
        loss_sum, grad_acc = 0.0, None
        for i in range(nb):  # paper baseline: one dispatch per block
            loss, g = value_and_grad(self.model.loss, params, {k: v[i] for k, v in blocks.items()})
            loss_sum = loss_sum + loss
            grad_acc = g if grad_acc is None else tree_map(torch.add, grad_acc, g)
        # divisors on the device: CUDA divides by a host scalar through its
        # reciprocal, which rounds differently from the reference's division
        grads = tree_map(lambda g: g / torch.full((), nb, dtype=g.dtype, device=g.device),
                         grad_acc)
        return loss_sum / torch.full_like(loss_sum, nb), grads, nb + 1

    def train_step(self, params, opt, blocks: dict[str, np.ndarray]):
        """One optimizer step in the configured accumulation mode; ``params``
        and ``opt`` are updated in place.

        Returns (params, opt, loss, n_dispatches), the loss a 0-d f32
        tensor on the device."""
        blocks = {k: torch.as_tensor(v).to(self.device) for k, v in blocks.items()}
        loss, grads, n_dispatches = self.gradients(params, blocks)
        params, opt = self._update(params, opt, grads)
        return params, opt, loss, n_dispatches

    # ------------------------------------------------------------------
    def run(
        self,
        *,
        steps: int | None = None,
        resume: bool = True,
        guard: PreemptionGuard | None = None,
        on_step: Callable[[int, float], None] | None = None,
    ) -> dict[str, Any]:
        """Train; preemption-safe; resumes from the newest checkpoint."""
        cfg = self.cfg
        steps = steps if steps is not None else cfg.steps
        params, opt = self.init_state()
        start = 0

        if resume and self.ckpt and self.ckpt.latest_step() is not None:
            (params, opt), extras, start = self.ckpt.restore((params, opt))
            self.pipeline.state = PipelineState.from_json(extras["pipeline"])
            start = int(extras["next_step"])

        losses = []
        dispatches = 0
        it = iter(self.pipeline)
        t_total0 = time.perf_counter()
        for step in range(start, steps):
            t0 = time.perf_counter()
            blocks = next(it)
            params, opt, loss, nd = self.train_step(params, opt, blocks)
            loss = float(loss)
            dt = time.perf_counter() - t0
            self.straggler.record_step({"self": dt})
            losses.append(loss)
            dispatches += nd
            if on_step:
                on_step(step, loss)

            want_ckpt = cfg.ckpt_every and (step + 1) % cfg.ckpt_every == 0
            preempted = guard is not None and guard.should_stop
            if self.ckpt and (want_ckpt or preempted):
                self.ckpt.save(
                    step + 1,
                    (params, opt),
                    extras={
                        "pipeline": self.pipeline.state.to_json(),
                        "next_step": step + 1,
                        "loss": loss,
                    },
                    blocking=preempted,  # async for periodic, sync on exit
                )
                self.ckpt.keep_last(cfg.keep_ckpts)
            if preempted:
                self.pipeline.close()
                return {
                    "params": params,
                    "opt": opt,
                    "losses": losses,
                    "stopped_at": step + 1,
                    "dispatches": dispatches,
                    "preempted": True,
                }
        self.pipeline.close()
        if self.ckpt:
            self.ckpt.wait()
        return {
            "params": params,
            "opt": opt,
            "losses": losses,
            "stopped_at": steps,
            "dispatches": dispatches,
            "preempted": False,
            "wall_s": time.perf_counter() - t_total0,
        }
