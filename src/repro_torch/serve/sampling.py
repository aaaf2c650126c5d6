"""Token sampling policies for the serving path (counterpart of
``repro.serve.sampling``).

Greedy is the default everywhere (``SampleConfig()`` is greedy).  Sampled
decoding takes the argmax of the scaled (optionally top-k truncated) logits
plus Gumbel noise, which is how the reference's
``jax.random.categorical`` draws.  The noise comes from a
``torch.Generator`` or is handed in as ``gumbel=`` (the reference's own
draws, in the parity tests): ``jax.random`` bits cannot be reproduced.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class SampleConfig:
    """temperature <= 0 means greedy (argmax); top_k == 0 means no top-k
    truncation (sample the full distribution)."""

    temperature: float = 0.0
    top_k: int = 0

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 argmax tokens (the first of a tie)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def gumbel_noise(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, u uniform in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=gen, device=device).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, sc: SampleConfig,
                  gen: torch.Generator | None = None, *,
                  gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """(B, V) last-position logits -> (B,) int32 tokens.

    Greedy configs use neither ``gen`` nor ``gumbel``; sampled configs
    scale by the temperature, optionally keep only the top-k logits (the
    rest set to NEG_INF) and add the noise ``gumbel`` (B, V) or, without
    it, fresh draws from ``gen``."""
    if sc.is_greedy:
        return greedy_tokens(logits)
    scaled = logits.float() / sc.temperature
    if 0 < sc.top_k < logits.shape[-1]:
        kth = torch.sort(scaled, dim=-1).values[:, -sc.top_k][:, None]
        scaled = torch.where(scaled >= kth, scaled,
                             torch.full((), NEG_INF, device=scaled.device))
    if gumbel is None:
        if gen is None:
            raise ValueError("sampled decoding needs a generator or gumbel=")
        gumbel = gumbel_noise(scaled.shape, gen, scaled.device)
    return torch.argmax(gumbel + scaled, dim=-1).to(torch.int32)
