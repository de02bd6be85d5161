"""Deterministic LM token pipeline (numpy copy of the reference's
``data/tokens.py``).

An infinite iterator of global batches, deterministic in (seed, step) so
a restart resumes bit-identically at any step.  A tiny synthetic
"language" (an order-2 Markov chain over the vocab) gives the loss a
learnable structure.  The batches are int32 numpy arrays, equal to the
reference's bit for bit; the trainer moves them to its device.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class TokenPipeline:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, order: int = 2, n_states: int = 64):
        self.V = vocab_size
        self.S = seq_len
        self.B = global_batch
        self.seed = seed
        rng = np.random.default_rng(seed)
        # sparse-ish transition structure: each state strongly prefers a few
        # successors -> learnable
        self.n_states = min(n_states, vocab_size)
        probs = rng.dirichlet(np.full(self.n_states, 0.1),
                              size=self.n_states)
        self.cum = np.cumsum(probs, axis=1)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for `step` (restart-safe)."""
        rng = np.random.default_rng((self.seed, step))
        u = rng.random((self.B, self.S))
        toks = np.zeros((self.B, self.S), np.int64)
        toks[:, 0] = rng.integers(0, self.n_states, self.B)
        for t in range(1, self.S):
            state = toks[:, t - 1] % self.n_states
            toks[:, t] = (self.cum[state] < u[:, t, None]).sum(axis=1)
        toks = toks % self.V
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.from_step(0)

    def from_step(self, start: int) -> Iterator[Dict[str, np.ndarray]]:
        step = start
        while True:
            yield self.batch(step)
            step += 1


__all__ = ["TokenPipeline"]
