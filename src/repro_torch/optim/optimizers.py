"""Optimizers over flat leaf lists (counterpart of ``repro.optim``).

An :class:`Optimizer` is an ``(init, update)`` pair.  ``update`` takes the
gradient leaves, the state and the param leaves and returns the update
leaves and the new state, with the reference's arithmetic and rounding
order: momentum ``mu = beta * mu + g`` and ``u = (-lr) * mu``;
:func:`apply_updates` adds ``u`` to the params in place.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def _lr_at(lr, count: int) -> float:
    return float(lr(count)) if callable(lr) else float(lr)


def sgd(lr) -> Optimizer:
    def init(params):
        return {"count": 0}

    def update(grads, state, params=None):
        a = _lr_at(lr, state["count"])
        return [g * -a for g in grads], {"count": state["count"] + 1}

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9) -> Optimizer:
    """SGD with heavy-ball momentum; ``mu`` is updated in place."""

    def init(params):
        return {"count": 0,
                "mu": [torch.zeros_like(p, dtype=torch.float32)
                       for p in params]}

    def update(grads, state, params=None):
        mu = state["mu"]
        for m, g in zip(mu, grads):
            m.mul_(beta).add_(g)
        a = _lr_at(lr, state["count"])
        updates = [u * -a for u in mu]
        return updates, {"count": state["count"] + 1, "mu": mu}

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
