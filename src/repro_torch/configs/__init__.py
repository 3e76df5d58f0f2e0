"""Architecture registry: ``--arch <id>`` → ModelConfig.

``get_config(id)`` returns the full assigned config; ``get_smoke_config(id)``
the reduced same-family config used by CPU smoke tests.  IDs use dashes
(CLI-style); module names use underscores.  The registry holds the
architectures the port runs so far; the JAX package's registry lists the
rest.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, LayerSpec, ModelConfig, Segment, ShapeCell

_MODULES: dict[str, str] = {
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1p3b",
}

ARCH_IDS: tuple[str, ...] = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).smoke()


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "LayerSpec",
    "ModelConfig",
    "Segment",
    "ShapeCell",
    "get_config",
    "get_smoke_config",
]
