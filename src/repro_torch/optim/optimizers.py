"""Optimizers over flat leaf lists (counterpart of ``repro.optim``).

An :class:`Optimizer` is an ``(init, update)`` pair.  ``update`` takes the
gradient leaves, the state and the param leaves and returns the update
leaves and the new state, with the reference's arithmetic and rounding
order:

* momentum: ``mu = beta * mu + g``, ``u = (-lr) * mu`` (nesterov:
  ``u = (-lr) * (g + beta * mu)``);
* adam: ``m = b1 * m + (1 - b1) * g``, ``v = b2 * v + (1 - b2) * g^2``,
  ``bc = 1 - b ** count`` in float32 and ``u = (-lr) * ((m / bc1) /
  (sqrt(v / bc2) + eps) [+ wd * p])``.

The state's ``count`` is a Python int and the schedule is read at the
count before the step.  ``mu``, ``m`` and ``v`` are f32 leaves updated in
place; :func:`apply_updates` adds ``u`` to the params in place.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import trace


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def _lr_at(lr, count: int) -> float:
    return float(lr(count)) if callable(lr) else float(lr)


def _zeros_f32(params):
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


def sgd(lr) -> Optimizer:
    def init(params):
        return {"count": 0}

    def update(grads, state, params=None):
        a = _lr_at(lr, state["count"])
        return [g * -a for g in grads], {"count": state["count"] + 1}

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    """SGD with heavy-ball (or Nesterov) momentum; ``mu`` is updated in
    place."""

    def init(params):
        return {"count": 0, "mu": _zeros_f32(params)}

    def update(grads, state, params=None):
        mu = state["mu"]
        for m, g in zip(mu, grads):
            m.mul_(beta).add_(g)
        a = _lr_at(lr, state["count"])
        if nesterov:
            updates = [(g + m * beta) * -a for m, g in zip(mu, grads)]
        else:
            updates = [u * -a for u in mu]
        return updates, {"count": state["count"] + 1, "mu": mu}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam with bias correction and optional decoupled ``weight_decay``
    (added to the normalized step, as the reference does); ``m`` and ``v``
    are updated in place."""

    def init(params):
        return {"count": 0, "m": _zeros_f32(params), "v": _zeros_f32(params)}

    def update(grads, state, params=None):
        c = state["count"] + 1
        ms, vs = state["m"], state["v"]
        for m, v, g in zip(ms, vs, grads):
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(torch.square(g) * (1 - b2))
        bc = [np.float32(1.0) - np.float32(b) ** np.float32(c)
              for b in (b1, b2)]
        a = _lr_at(lr, state["count"])
        # divisors as device tensors: CUDA turns division by a host scalar
        # into a product with its reciprocal; each copy from pageable host
        # memory waits for the stream
        divisors = []
        for x in bc:
            with trace.span("wait.bias_correction"):
                divisors.append(torch.tensor(x, device=ms[0].device))
        bc1, bc2 = divisors
        updates = []
        for i, (m, v) in enumerate(zip(ms, vs)):
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and params is not None:
                upd = upd + params[i] * weight_decay
            updates.append(upd * -a)
        return updates, {"count": c, "m": ms, "v": vs}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    """``p += u`` for every leaf, in place."""
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))
    return params


def global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def clip_by_global_norm(grads, max_norm: float):
    """``(grads * min(1, max_norm / (norm + 1e-12)), norm)``; the scale
    stays on the device."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return [g * scale for g in grads], norm
