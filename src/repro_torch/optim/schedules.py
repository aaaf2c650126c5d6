"""Learning-rate schedules, including the paper's theorem-prescribed rates
(counterpart of ``repro.optim.schedules``).

A schedule maps the optimizer's step count to the rate.  The reference
evaluates its schedules in float32 (an int32 count, ``jnp.cos``,
``jnp.pi``), so these compute in ``np.float32`` too, every constant
rounded to float32 before it is used; only ``np.cos`` against XLA's cosine
may differ in the last bit.
"""
from __future__ import annotations

import math

import numpy as np

_F = np.float32


def constant(lr: float):
    """Constant schedule; the rate is rounded to float32 once, as the
    reference materializes it as an f32 array."""
    value = float(_F(lr))
    return lambda step: value


def cosine_decay(base: float, total_steps: int, final_frac: float = 0.1):
    """``base * (final_frac + (1 - final_frac) * (1 + cos(pi t)) / 2)``
    with ``t = clip(step / total_steps, 0, 1)``."""
    b, ff, rest = _F(base), _F(final_frac), _F(1 - final_frac)

    def fn(step):
        t = np.clip(_F(step) / _F(total_steps), _F(0.0), _F(1.0))
        cos = _F(0.5) * (_F(1.0) + np.cos(_F(np.pi) * t))
        return _F(b * (ff + rest * cos))
    return fn


def warmup_cosine(base: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup over ``warmup`` steps, then :func:`cosine_decay` over
    the remaining ``total_steps - warmup``."""
    cos = cosine_decay(base, max(total_steps - warmup, 1), final_frac)
    span = _F(max(warmup, 1))

    def fn(step):
        w = np.minimum(_F(step) / span, _F(1.0))
        return _F(w * cos(max(int(step) - warmup, 0)))
    return fn


def paper_nonconvex_lr(T: int, p: int = 1):
    """Theorem 2 (p=1) / Theorem 3 (parallel steps): alpha = sqrt(p/T)."""
    return constant((p / T) ** 0.5)


def paper_strongly_convex_lr(T: int, c: float, p: int = 1):
    """Theorem 4/5: alpha = 2(log T + log p)/(cT)."""
    return constant(2 * (math.log(T) + math.log(p)) / (c * T))
