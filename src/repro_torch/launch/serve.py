"""Batched serving from the command line.

Draws random weights for a smoke-sized architecture on the device, or
restores a trainer's checkpoint (``--ckpt-dir``: the params of ``(params,
opt)``, in f32 as the trainer keeps them), and serves batched generation
requests: prefill once, then one decode step per token for the whole
batch.  Port of ``repro/launch/serve.py``.  The audio
family is served stubbed frame embeddings (B, encoder_seq, d_model), the
vlm family stubbed image embeddings (B, image_tokens, image_embed_dim),
both drawn from ``--seed`` and served in bf16, as in the reference.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b \
        --batch 8 --prompt-len 16 --steps 32 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny --steps 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b --ckpt-dir ckpt
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._pytree import tree_map
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core.blocked import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import adamw_init
from repro_torch.runtime.server import Server


def restore_params(ckpt_dir: str, params):
    """The params of the newest checkpoint under ``ckpt_dir``, restored as
    the reference restores them: ``(params, opt)`` against a template of
    ``(params, adamw_init(params))``.  The moments' template lies on the
    ``meta`` device (no memory, as ``jax.eval_shape`` gives), so they are
    read to the host and dropped.  ``params`` is the template: a trainer's
    checkpoint holds f32 master weights, so pass f32 leaves
    (``Model.init(master=True)``) to restore them unrounded.  Returns
    ``(params, step)``."""
    opt_tmpl = adamw_init(tree_map(lambda p: torch.empty_like(p, device="meta"), params))
    (params, _opt), _extras, step = Checkpointer(ckpt_dir).restore((params, opt_tmpl))
    return params, step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--sample", action="store_true", help="sample instead of greedy")
    ap.add_argument("--ckpt-dir", default=None, help="restore params from here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    device = resolve_device(args.device)
    params = build_model(cfg).init(torch.Generator(device=device).manual_seed(args.seed),
                                   device=device, master=bool(args.ckpt_dir))
    if args.ckpt_dir:
        params, step = restore_params(args.ckpt_dir, params)
        print(f"restored step {step} from {args.ckpt_dir}")

    n_params = cfg.param_counts()["total"]
    print(f"serving {cfg.name} ({n_params / 1e6:.1f}M params) "
          f"batch={args.batch} prompt={args.prompt_len} steps={args.steps}",
          flush=True)

    server = Server(cfg, max_len=args.max_len, device=device)
    server.load(params)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    extras: dict[str, torch.Tensor] = {}
    if cfg.family == "audio":
        extras["frames"] = torch.from_numpy(
            rng.standard_normal((args.batch, cfg.encoder_seq, cfg.d_model))
        ).to(device=device, dtype=torch.bfloat16)
    if cfg.family == "vlm":
        extras["image_embeds"] = torch.from_numpy(
            rng.standard_normal((args.batch, cfg.image_tokens, cfg.image_embed_dim))
        ).to(device=device, dtype=torch.bfloat16)

    t0 = time.perf_counter()
    tokens, stats = server.generate(prompts, steps=args.steps, greedy=not args.sample,
                                    extras=extras)
    wall = time.perf_counter() - t0
    print(f"prefill {stats.prefill_s * 1e3:.1f} ms   "
          f"decode {stats.decode_s * 1e3:.1f} ms "
          f"({stats.decode_s / args.steps * 1e3:.2f} ms/tok)   "
          f"dispatches={stats.dispatches}   "
          f"throughput={stats.tokens_out / wall:.1f} tok/s", flush=True)
    print("first request's tokens:", tokens[0].tolist())


if __name__ == "__main__":
    main()
