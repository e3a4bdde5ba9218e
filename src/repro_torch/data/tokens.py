"""Synthetic LM token stream (deterministic, seedable, shard-aware; mirrors
:mod:`repro.data.tokens`, whose arrays it equals for every seed, step and
shard).

Markov-chain tokens rather than uniform noise so the training example has
learnable structure (loss visibly decreases within hundreds of steps).
``shard`` / ``num_shards`` give each data-parallel rank a disjoint stream —
the determinism is what makes step-level restart reproducible.  numpy on
the host; the caller moves a batch to its device.
"""
from __future__ import annotations

import numpy as np


class MarkovTokenStream:
    def __init__(self, vocab: int, *, order_states: int = 257, seed: int = 0,
                 shard: int = 0, num_shards: int = 1):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.states = order_states
        # sparse-ish transition: each state prefers ~32 tokens
        prefs = rng.integers(0, vocab, size=(order_states, 32))
        self.prefs = prefs
        self.shard = shard
        self.num_shards = num_shards
        self._step = 0

    def next_batch(self, batch: int, seq: int) -> dict:
        # a tuple of ints hashes the same in every process (no hash seed)
        rng = np.random.default_rng(
            hash((self._step, self.shard, self.num_shards)) % (2**32)
        )
        self._step += 1
        state = rng.integers(0, self.states, size=(batch,))
        toks = np.zeros((batch, seq), np.int32)
        for t in range(seq):
            choice = rng.integers(0, 32, size=(batch,))
            toks[:, t] = self.prefs[state, choice]
            state = (state * 31 + toks[:, t]) % self.states
        return {"tokens": toks, "labels": toks.copy()}
