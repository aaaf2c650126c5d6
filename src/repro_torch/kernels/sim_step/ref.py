"""Plain PyTorch versions of the simulator-step kernels (counterpart of
``repro.kernels.sim_step.ref``), batched over a leading case axis B.

``a`` is (d, d) for every case or (G, d, d), with ``x_star`` (G, d), one
entry per group of ``B // G`` consecutive cases, as the kernels take it.
"""
from __future__ import annotations

import torch


def _per_case(t: torch.Tensor, b: int, ndim: int) -> torch.Tensor:
    """Broadcast a shared or per-group problem tensor to one per case."""
    if t.ndim == ndim:
        return t
    return t.repeat_interleave(b // t.shape[0], dim=0)


def delivery_step_plain(v, x, a, x_star, noise, u, defer=None):
    """v, noise, defer (B, p, d); x (B, d); u (B, m, p) with the step scale
    folded in.  Returns ``(x', v', defer' or None, sq)``: ``G = (v - x*) a
    + noise``, ``P = u G``, ``x' = x - P[0]``, ``v' = v - P[1:1+p]`` (minus
    ``defer``), ``defer' = P[1+p:1+2p]`` and ``sq[b, i] = sum((x' -
    v'_i)^2)``."""
    b, p, _ = v.shape
    a = _per_case(a, b, 2)
    xs = _per_case(x_star, b, 1)
    xs = xs[None, None] if xs.ndim == 1 else xs[:, None]
    g = torch.matmul(v - xs, a) + noise
    rows = torch.matmul(u, g)
    x_new = x - rows[:, 0]
    v_new = v - rows[:, 1:1 + p]
    defer_new = None
    if defer is not None:
        v_new = v_new - defer
        defer_new = rows[:, 1 + p:1 + 2 * p]
    sq = (x_new[:, None] - v_new).square().sum(2)
    return x_new, v_new, defer_new, sq


def sync_step_plain(x, a, x_star, nsum, c):
    """x, nsum (B, d); c (B,).  ``x - c * ((x - x*) a) - nsum``: under
    ``sync`` the p views equal x exactly, so one product carries the
    step."""
    b = x.shape[0]
    a = _per_case(a, b, 2)
    xs = _per_case(x_star, b, 1)
    diff = (x - xs)[:, None]
    base = torch.matmul(diff, a)[:, 0]
    return x - c[:, None] * base - nsum
