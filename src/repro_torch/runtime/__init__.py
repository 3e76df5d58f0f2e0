"""Runtime: batched serving (the trainer arrives with the training slice)."""

from repro_torch.runtime.server import Server, ServeStats

__all__ = ["Server", "ServeStats"]
