"""The one traffic generator: data, blocks and job seeds from a cell's files.

A configuration gives the rows, their width and the locations; a traffic mix
gives the blocks per location, their placement, the policy, the executor and
the clients.  From ``--seed`` the generator makes the rows on the device (one
``torch.rand`` call on a generator of that device: uniform in [0, 1)), cuts
them into equal blocks as views, and draws each job's seed.  The same seed
gives the same rows and the same job seeds; every seed gives the same sizes.
"""

from __future__ import annotations

import hashlib

import torch

__all__ = ["make_rows", "blocked", "job_seed", "policy", "executor"]


def make_rows(cfg: dict, seed: int, device: torch.device) -> torch.Tensor:
    """``(rows, d)`` float32 uniform in ``[0, 1)`` on ``device`` from ``seed``."""
    if cfg["dtype"] != "float32":
        raise ValueError(f"the generator makes float32 rows, not {cfg['dtype']}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    return torch.rand((cfg["rows"], cfg["d"]), generator=gen, device=device,
                      dtype=torch.float32)


def blocked(rows: torch.Tensor, cfg: dict, traffic: dict):
    """The program's ``BlockedArray`` over ``rows``: equal blocks, as views."""
    from repro_torch.core import blocked as program_blocked

    nblocks = cfg["locations"] * traffic["blocks_per_location"]
    if rows.shape[0] % nblocks:
        raise ValueError(f"{rows.shape[0]} rows do not cut into {nblocks} equal blocks")
    placement = getattr(program_blocked, f"{traffic['placement']}_placement")
    return program_blocked.BlockedArray.from_array(
        rows, rows.shape[0] // nblocks, num_locations=cfg["locations"],
        policy=placement, device=rows.device)


def job_seed(seed: int, index: int) -> int:
    """Job ``index``'s seed: a hash of the run's seed, in ``[0, 2**31)``."""
    digest = hashlib.sha256(f"{seed}:{index}".encode()).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF


def policy(traffic: dict):
    """The program's execution policy the traffic mix names."""
    from repro_torch import api

    spec = traffic["policy"]
    return getattr(api, spec["name"])(**spec["args"])


def executor(traffic: dict):
    """A fresh program executor of the backend the traffic mix names."""
    from repro_torch.api import engine

    return engine(traffic["executor"])
