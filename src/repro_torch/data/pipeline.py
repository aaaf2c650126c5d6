"""Deterministic synthetic LM stream (counterpart of ``repro.data.pipeline``).

A fixed random Markov chain over 64 states, each state emitting one of 4
tokens; batches are a pure function of ``(seed, step)`` drawn from
``np.random.default_rng``, so they are bitwise those of the reference.

:func:`synthetic_batch` is one random batch with the frontend stubs'
embeddings.  The reference draws it from ``jax.random``, whose numbers
torch cannot reproduce, so it has the reference's keys, shapes, dtypes and
ranges but not its values; parity tests feed the reference's arrays to
both packages.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import FRONTEND_AUDIO, FRONTEND_VISION


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


def synthetic_batch(cfg, batch_size: int, seq_len: int, seed: int = 0, *,
                    device=None) -> dict:
    """One random batch with the frontend-stub extras an arch needs:
    ``tokens`` and ``labels`` (B, S) int32 in [0, vocab); an audio arch's
    ``frame_embeds`` (B, S, d), a vision arch's ``patch_embeds`` (B,
    n_prefix_embeds, d), float32 N(0, 1) draws times 0.02.  Drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default the
    CPU)."""
    device = torch.device(device if device is not None else "cpu")
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (batch_size, seq_len)
    batch = {k: torch.randint(0, cfg.vocab_size, shape, generator=gen,
                              device=device, dtype=torch.int32)
             for k in ("tokens", "labels")}
    extra = {FRONTEND_AUDIO: ("frame_embeds", seq_len),
             FRONTEND_VISION: ("patch_embeds", cfg.n_prefix_embeds)}
    if cfg.frontend in extra:
        key, n = extra[cfg.frontend]
        batch[key] = 0.02 * torch.randn((batch_size, n, cfg.d_model),
                                        generator=gen, device=device)
    return batch


def make_batch_specs(cfg, shape, device="meta") -> dict:
    """Allocation-free stand-ins (tensors on ``device``, the ``meta``
    device by default) for every model input of a workload ``shape``
    (`repro_torch.configs.InputShape`), the reference's
    ``make_batch_specs``: tokens (and training labels) (B, S) int64, the
    audio stub's ``frame_embeds`` (B, S, d) and the vision stub's
    ``patch_embeds`` (B, P, d) f32; a decode step's one new token (B, 1)."""
    b = shape.global_batch
    if shape.kind not in ("train", "prefill"):
        return {"tokens": torch.empty((b, 1), dtype=torch.long,
                                      device=device)}
    s = shape.seq_len
    specs = {"tokens": torch.empty((b, s), dtype=torch.long, device=device)}
    if shape.kind == "train":
        specs["labels"] = torch.empty((b, s), dtype=torch.long, device=device)
    if cfg.frontend == FRONTEND_AUDIO:
        specs["frame_embeds"] = torch.empty((b, s, cfg.d_model),
                                            device=device)
    if cfg.frontend == FRONTEND_VISION:
        specs["patch_embeds"] = torch.empty(
            (b, cfg.n_prefix_embeds, cfg.d_model), device=device)
    return specs
