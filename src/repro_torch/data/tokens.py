"""Deterministic synthetic LM token pipeline.

The port of ``repro.data.tokens``.  Batches are a pure function of (seed,
step) — the property fault-tolerant training needs: a restart from
checkpoint step k regenerates exactly the batches k, k+1, ...  The stream
has first-order Markov structure so small LMs have real signal to learn.
The generator is the reference's numpy code, so ``batch_at`` gives the
reference's tokens bit for bit, as an int32 CPU tensor.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class TokenStream:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    n_states: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # block-diagonal-ish Markov chain over token buckets
        self._trans = rng.dirichlet(np.full(self.n_states, 0.3),
                                    size=self.n_states).astype(np.float64)
        self._emit_base = rng.integers(
            0, self.vocab_size, size=self.n_states)

    def batch_at(self, step: int) -> torch.Tensor:
        """(batch, seq_len) int32 tokens for a given step — pure function."""
        rng = np.random.default_rng((self.seed * 1_000_003 + step) & 0x7FFFFFFF)
        out = np.empty((self.batch, self.seq_len), np.int32)
        state = rng.integers(0, self.n_states, self.batch)
        for t in range(self.seq_len):
            u = rng.random(self.batch)
            cdf = np.cumsum(self._trans[state], axis=1)
            state = (u[:, None] < cdf).argmax(axis=1)
            jitter = rng.integers(0, 7, self.batch)
            out[:, t] = (self._emit_base[state] + jitter) % self.vocab_size
        return torch.from_numpy(out)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
