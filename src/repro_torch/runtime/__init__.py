"""Runtime: fault-tolerant training loop, batched serving, FT machinery."""

from repro_torch.runtime.server import Server, ServeStats
from repro_torch.runtime.trainer import Trainer, TrainConfig

__all__ = ["Server", "ServeStats", "Trainer", "TrainConfig"]
