"""Batched serving: prefill once, then one decode step per token.

Port of ``repro/runtime/server.py``.  A batch of same-length prompts is
prefilled in one call, then the decode loop runs ONE step for the whole
batch per token (the serving analogue of SplIter's fused accumulation):
``ServeStats.dispatches`` counts ``1 + steps``, as the reference does.

Where the reference jits both entry points and donates the cache, the port
calls them eagerly and they update the cache in place.  Greedy decoding is
``argmax``; sampling at decode step ``i`` is the reference's
``jax.random.categorical(jax.random.key(i), logits)``, drawn with the same
Threefry bits on the device (:func:`repro_torch._threefry.categorical`),
in the logits' type as the reference draws it, so a seed gives the same
tokens in both packages.  As in the reference, the first token is the
prefill's argmax.  Generated tokens stay on the device until the loop ends.

``extras`` (the stubbed frontends' outputs: ``frames`` for the audio
family, ``image_embeds`` for the vlm) go into the prefill's batch, and
``image_embeds`` is every decode step's cross-attention memory, as the
reference passes it; the audio family decodes from the memory its prefill
projected into the cache.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch._threefry import categorical
from repro_torch.configs.base import ModelConfig
from repro_torch.core.blocked import resolve_device
from repro_torch.models import build_model


@dataclasses.dataclass
class ServeStats:
    prefill_s: float
    decode_s: float
    dispatches: int
    tokens_out: int


class Server:
    def __init__(self, cfg: ModelConfig, *, max_len: int = 256,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.model = build_model(cfg)
        self.max_len = max_len
        self.device = resolve_device(device)

    def load(self, params: Any) -> None:
        self.params = params

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def generate(
        self,
        prompts: np.ndarray,  # (B, P) int
        *,
        steps: int = 32,
        greedy: bool = True,
        extras: dict[str, Any] | None = None,
        return_logits: bool = False,
    ):
        """Serve ``steps`` tokens for each prompt → ``(tokens (B, steps), stats)``.

        ``extras`` maps batch keys to arrays or tensors, moved to the device
        in their own type.  ``return_logits`` adds a third result: the
        logits of the prefill and of every decode step, ``(B, 1 + steps,
        Vp)`` on the device.
        """
        b, p = prompts.shape
        if p + steps > self.max_len:
            raise ValueError(f"prompt {p} + steps {steps} exceed max_len {self.max_len}")
        # cache in the model's compute dtype (fp32 models get fp32 caches)
        cache = self.model.init_cache(b, self.max_len, dtype=getattr(torch, self.cfg.dtype),
                                      device=self.device)
        tokens = torch.as_tensor(np.asarray(prompts, np.int64), device=self.device)
        extras = {k: torch.as_tensor(v, device=self.device) for k, v in (extras or {}).items()}
        self._sync()
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(self.params, {"tokens": tokens, **extras}, cache)
        self._sync()
        t_prefill = time.perf_counter() - t0

        memory = extras.get("image_embeds")

        kept = [logits] if return_logits else None
        out = []
        dispatches = 1
        tok = torch.argmax(logits, -1)[:, None]
        t0 = time.perf_counter()
        for i in range(steps):
            out.append(tok[:, 0])
            logits, cache = self.model.decode_step(self.params, cache, tok, p + i, memory)
            dispatches += 1
            if return_logits:
                kept.append(logits)
            if greedy:
                tok = torch.argmax(logits, -1)[:, None]
            else:
                tok = categorical(i, logits)[:, None]
        self._sync()
        t_decode = time.perf_counter() - t0
        served = torch.stack(out, 1).cpu().numpy().astype(np.int32)
        stats = ServeStats(t_prefill, t_decode, dispatches, b * steps)
        if return_logits:
            return served, stats, torch.stack(kept, 1)
        return served, stats
