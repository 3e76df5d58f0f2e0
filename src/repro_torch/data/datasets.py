"""Synthetic datasets: deterministic, seekable token streams.

The "corpus" is a counter-based PRNG over (seed, document_id) — any document
is reconstructible from its id alone, so the pipeline can resume after a
restart by remembering a single cursor (no data server, no epochs of state).
A Zipf-ish marginal over the vocab plus a short induction pattern makes the
loss *learnable* (a model that trains shows loss < ln(V) quickly), which the
end-to-end tests rely on.

Port of ``repro/data/datasets.py``, unchanged: the same counter-based
draws give the same tokens, byte for byte.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticTextDataset:
    vocab_size: int
    seq_len: int
    seed: int = 0

    def document(self, doc_id: int) -> np.ndarray:
        """Deterministic (seq_len,) int32 token sequence for ``doc_id``."""
        rng = np.random.default_rng((self.seed << 32) ^ (doc_id & 0xFFFFFFFF))
        v = self.vocab_size
        # Zipf-ish marginal
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(v, size=self.seq_len, p=probs).astype(np.int32)
        # induction pattern: token t repeated after a fixed lag — learnable
        lag = 1 + (doc_id % 7)
        idx = np.arange(lag, self.seq_len, 2 * lag)
        toks[idx] = toks[idx - lag]
        return toks

    def batch(self, doc_ids: np.ndarray) -> dict[str, np.ndarray]:
        toks = np.stack([self.document(int(i)) for i in doc_ids])
        return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def synthetic_lm_batch(
    vocab_size: int, batch: int, seq_len: int, *, seed: int = 0, step: int = 0
) -> dict[str, np.ndarray]:
    """One deterministic batch (convenience for examples/benchmarks)."""
    ds = SyntheticTextDataset(vocab_size, seq_len + 1, seed)
    ids = np.arange(step * batch, (step + 1) * batch, dtype=np.int64)
    return ds.batch(ids)
