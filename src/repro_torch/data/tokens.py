"""Synthetic LM token pipeline (deterministic, learnable structure).

Sequences follow a seeded order-1 Markov chain with sparse transitions,
so a model can actually reduce loss (used by the end-to-end training
example); labels are next-token targets with -1 on the final position.
A copy of ``repro.data.tokens`` (numpy only): its batches equal the
reference's bit for bit.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class SyntheticTokens:
    def __init__(
        self,
        vocab: int,
        seq_len: int,
        batch: int,
        *,
        seed: int = 0,
        branching: int = 4,
        num_steps: int | None = None,
    ) -> None:
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.num_steps = num_steps
        rng = np.random.default_rng(seed)
        # sparse transition table: each token has `branching` successors
        self._succ = rng.integers(0, vocab, (vocab, branching), dtype=np.int32)
        self._seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self._seed, step))
        toks = np.empty((self.batch, self.seq_len), dtype=np.int32)
        cur = rng.integers(0, self.vocab, self.batch, dtype=np.int32)
        choices = rng.integers(0, self._succ.shape[1], (self.batch, self.seq_len))
        for t in range(self.seq_len):
            toks[:, t] = cur
            cur = self._succ[cur, choices[:, t]]
        labels = np.concatenate(
            [toks[:, 1:], np.full((self.batch, 1), -1, np.int32)], axis=1
        )
        return {"tokens": toks, "labels": labels}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while self.num_steps is None or step < self.num_steps:
            yield self.batch_at(step)
            step += 1
