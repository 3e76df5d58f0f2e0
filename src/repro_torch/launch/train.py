"""End-to-end training driver.

Port of ``repro/launch/train.py``: runs the fault-tolerant Trainer on any
architecture's reduced smoke config (``--arch ... --smoke``) or on the
named presets (``lm1m``, ``lm20m``, ``lm100m``, the reference's widths),
on the card by default (``--device cpu`` for the host).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-72b --smoke \
        --steps 50 --global-batch 16 --num-blocks 4 --seq-len 64
    PYTHONPATH=src python -m repro_torch.launch.train --preset lm100m --steps 300
    PYTHONPATH=src python -m repro_torch.launch.train --preset lm1m --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --preset lm20m --steps 300 \
        --ckpt-dir ckpt --ckpt-every 50       # preemption-safe + resume

``--accum-mode`` sweeps the paper's three execution strategies on identical
math: ``spliter`` (one dispatch per step, a loop over the microbatch blocks
on the device), ``per_block`` (the baseline: one dispatch per block),
``materialized`` (fused giant microbatch — the on-device rechunk analogue).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.runtime.trainer import TrainConfig, Trainer

# ----------------------------------------------------------------------------
# presets for the runnable examples (CPU-sized but real transformers)
# ----------------------------------------------------------------------------


def _preset(name: str) -> ModelConfig:
    common = dict(
        family="dense",
        source="[example preset]",
        num_kv_heads=4,
        qk_norm=False,
        rope_theta=1e4,
        vocab_pad_multiple=128,
        remat="none",
    )
    if name == "lm1m":  # integration-test size
        return ModelConfig(
            name="lm1m", num_layers=2, d_model=64, num_heads=4, d_ff=256,
            vocab_size=512, **common,
        )
    if name == "lm20m":  # a few hundred steps in minutes on CPU
        return ModelConfig(
            name="lm20m", num_layers=6, d_model=384, num_heads=6, d_ff=1536,
            vocab_size=8192, **{**common, "num_kv_heads": 6},
        )
    if name == "lm100m":  # the ~100M end-to-end deliverable configuration
        return ModelConfig(
            name="lm100m", num_layers=12, d_model=768, num_heads=12, d_ff=3072,
            vocab_size=32000, **{**common, "num_kv_heads": 12},
        )
    raise KeyError(f"unknown preset {name!r}")


PRESETS = ("lm1m", "lm20m", "lm100m")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--arch", choices=list(ARCH_IDS))
    g.add_argument("--preset", choices=PRESETS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config for --arch")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=4,
                    help="microbatch blocks per step (the blocking)")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--peak-lr", type=float, default=3e-3)
    ap.add_argument("--warmup-steps", type=int, default=20)
    ap.add_argument("--accum-mode", default="spliter",
                    choices=("spliter", "per_block", "materialized"))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out-json", default=None, help="write the loss curve here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.arch:
        if not args.smoke:
            ap.error("--arch requires --smoke (full configs are exercised "
                     "by chip_smoke.py, not by this driver)")
        model_cfg = get_smoke_config(args.arch)
    else:
        model_cfg = _preset(args.preset)

    n_params = model_cfg.param_counts()["total"]
    print(f"model={model_cfg.name}  params={n_params/1e6:.1f}M  "
          f"mode={args.accum_mode}", flush=True)

    cfg = TrainConfig(
        global_batch=args.global_batch,
        num_blocks=args.num_blocks,
        seq_len=args.seq_len,
        steps=args.steps,
        peak_lr=args.peak_lr,
        warmup_steps=args.warmup_steps,
        accum_mode=args.accum_mode,
        seed=args.seed,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
    )
    trainer = Trainer(model_cfg, cfg, device=args.device)

    t_last = [time.perf_counter()]

    def on_step(step: int, loss: float) -> None:
        if (step + 1) % args.log_every == 0 or step == 0:
            now = time.perf_counter()
            dt = (now - t_last[0]) / (1 if step == 0 else args.log_every)
            t_last[0] = now
            tps = cfg.global_batch * cfg.seq_len / dt
            print(f"step {step + 1:5d}  loss {loss:8.4f}  "
                  f"{dt * 1e3:8.1f} ms/step  {tps:9.0f} tok/s", flush=True)

    out = trainer.run(resume=not args.no_resume, on_step=on_step)
    print(f"done: steps={out['stopped_at']}  dispatches={out['dispatches']}  "
          f"final_loss={out['losses'][-1]:.4f}  wall={out.get('wall_s', 0):.1f}s",
          flush=True)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(
                {
                    "model": model_cfg.name,
                    "params_m": n_params / 1e6,
                    "config": dataclasses.asdict(cfg),
                    "losses": out["losses"],
                    "dispatches": out["dispatches"],
                    "wall_s": out.get("wall_s"),
                },
                f,
                indent=1,
            )


if __name__ == "__main__":
    main()
