"""The benchmark's token stream: a frozen copy of the port's synthetic
language-model stream, so that the program's copy may change without
moving the yardstick.

A fixed random Markov chain over ``order_states`` states, each state
emitting one of 4 tokens; the chain is drawn from
``np.random.default_rng(seed)`` and batch ``step`` from
``np.random.default_rng((seed, step))``, so a batch is a pure function of
the seed and the step.
"""
from __future__ import annotations

import numpy as np


class MarkovStream:
    """``batch(step)`` -> ``{"tokens", "labels"}``, (batch, seq) int32
    numpy arrays; ``labels`` are the tokens shifted by one."""

    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int, order_states: int = 64):
        self.vocab_size, self.seq_len = vocab_size, seq_len
        self.batch_size, self.seed = batch_size, seed
        self.order_states = order_states
        rng = np.random.default_rng(seed)
        s = order_states
        logits = rng.normal(size=(s, s)) * 2.0
        self._trans = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        self._emit = rng.integers(0, vocab_size, size=(s, 4))

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        b, t, s = self.batch_size, self.seq_len, self.order_states
        states = np.zeros((b, t + 1), np.int64)
        states[:, 0] = rng.integers(0, s, size=b)
        u = rng.random((b, t))
        cdf = np.cumsum(self._trans, axis=-1)
        for i in range(t):
            states[:, i + 1] = np.argmax(cdf[states[:, i]] > u[:, i:i + 1],
                                         axis=-1)
        emit_choice = rng.integers(0, self._emit.shape[1], size=(b, t + 1))
        tokens = self._emit[states, emit_choice].astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
