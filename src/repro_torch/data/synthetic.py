"""Deterministic synthetic LM data (seeded, shardable, restartable); a
re-statement of ``repro.data.synthetic``, which uses no framework.

Shards are indexed (shard_id, step) -> batch, so the iterator state is
just two integers — exactly what rides in checkpoint meta for exact
resume — and any host can regenerate any other host's shard (which is
what makes bulk-stealing shards between hosts trivially consistent).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

__all__ = ["synth_batch", "SynthDataset"]


def synth_batch(seed: int, shard: int, step: int, batch: int, seq: int,
                vocab: int) -> Dict[str, np.ndarray]:
    """Markov-ish token stream: deterministic in (seed, shard, step)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, shard, step]))
    # zipf-flavored marginals so the loss curve is non-trivial
    base = rng.zipf(1.3, size=(batch, seq + 1)) % vocab
    tokens = base[:, :-1].astype(np.int32)
    labels = base[:, 1:].astype(np.int32)
    return {"tokens": tokens, "labels": labels}


class SynthDataset:
    """Per-host shard view with explicit, checkpointable state."""

    def __init__(self, *, seed: int, shard: int, n_shards: int, batch: int,
                 seq: int, vocab: int, step: int = 0):
        self.seed, self.shard, self.n_shards = seed, shard, n_shards
        self.batch, self.seq, self.vocab = batch, seq, vocab
        self.step = step

    def state(self) -> dict:
        return {"seed": self.seed, "shard": self.shard, "step": self.step}

    @classmethod
    def from_state(cls, state: dict, **kw) -> "SynthDataset":
        return cls(seed=state["seed"], shard=state["shard"],
                   step=state["step"], **kw)

    def next(self) -> Dict[str, np.ndarray]:
        b = synth_batch(self.seed, self.shard, self.step, self.batch,
                        self.seq, self.vocab)
        self.step += 1
        return b

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()
