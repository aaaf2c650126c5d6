"""Deterministic synthetic LM stream (counterpart of ``repro.data.pipeline``).

A fixed random Markov chain over 64 states, each state emitting one of 4
tokens; batches are a pure function of ``(seed, step)`` drawn from
``np.random.default_rng``, so they are bitwise those of the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SyntheticLMDataset:
    """Markov-chain token stream. ``batch(step)`` -> dict of numpy arrays;
    :func:`to_device` moves one onto a torch device."""

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    order_states: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        s = self.order_states
        logits = rng.normal(size=(s, s)) * 2.0
        self._trans = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        self._emit = rng.integers(0, self.vocab_size, size=(s, 4))

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


def to_device(batch: dict, device) -> dict:
    """numpy int batch -> int64 torch tensors on ``device``."""
    return {k: torch.from_numpy(np.array(v, dtype=np.int64)).to(device)
            for k, v in batch.items()}
