"""The one traffic generator: every mix is a data file that it reads.

A serving mix gives the distributions of prompt and output lengths.  The
lengths of a round of ``round`` requests are that many fixed quantiles of
each distribution, so every seed sends the same sizes: runs on different
seeds do the same work, and the seed shuffles them within each round and
draws the token ids.  A training mix gives the batch and sequence length;
each step's token ids are drawn uniformly over the vocabulary on the
device from the seed and the step, so step ``k``'s batch can be drawn
again alone.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch


def mix(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's ``seed`` (``tags`` name the
    use), for ``torch.Generator.manual_seed``."""
    h = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & (2 ** 63 - 1)


def quantiles(dist: dict, n: int) -> list:
    """``n`` lengths at the midpoints of ``n`` equal slices of ``dist``:
    {"dist": "uniform" | "loguniform", "low", "high"} or {"dist":
    "fixed", "value"}."""
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        kind = dist["dist"]
        if kind == "fixed":
            x = dist["value"]
        elif kind == "uniform":
            x = dist["low"] + u * (dist["high"] - dist["low"])
        elif kind == "loguniform":
            lo, hi = math.log(dist["low"]), math.log(dist["high"])
            x = math.exp(lo + u * (hi - lo))
        else:
            raise ValueError(f"unknown length distribution {kind!r}")
        out.append(int(round(x)))
    return out


class RequestStream:
    """The serving mix's requests in the order they arrive:
    (prompt ids (int32), number of output tokens)."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        self.rng = np.random.default_rng(mix(seed, "requests"))
        self.vocab = vocab
        self.n = int(traffic["round"])
        self.prompts = quantiles(traffic["prompt_len"], self.n)
        self.outputs = quantiles(traffic["output_len"], self.n)
        self._queue = []

    def next(self) -> tuple:
        if not self._queue:
            self._queue = list(zip(self.rng.permutation(self.prompts),
                                   self.rng.permutation(self.outputs)))
        plen, out = self._queue.pop(0)
        ids = self.rng.integers(0, self.vocab, int(plen)).astype(np.int32)
        return ids, int(out)

    def staggered(self, n: int) -> list:
        """Fractions in (0, 1] of their outputs that ``n`` requests admitted
        together still have to produce: midpoints of ``n`` equal slices, in
        a seeded order, so that they end one after another."""
        return list(self.rng.permutation([(i + 0.5) / n for i in range(n)]))


def train_batch(traffic: dict, vocab: int, seed: int, step: int,
                device) -> torch.Tensor:
    """Step ``step``'s (batch, seq_len) int32 token ids, uniform over the
    vocabulary, drawn on ``device`` from the seed and the step."""
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, "train", step))
    return torch.randint(0, vocab, (traffic["batch"], traffic["seq_len"]),
                         generator=g, device=device, dtype=torch.int64) \
        .to(torch.int32)
