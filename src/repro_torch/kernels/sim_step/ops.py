"""Dispatch for the fused simulator step (counterpart of
``repro.kernels.sim_step.ops``).

A CPU tensor takes the plain version; a CUDA tensor takes the kernel, which
raises on what it does not take.  There is no ``impl`` switch and no
fallback.  The whole-run delivery tensors come from
``repro_torch.core.delivery.delivery_tensors``.
"""
from __future__ import annotations

from repro_torch.kernels.sim_step.kernel import delivery_step, sync_step
from repro_torch.kernels.sim_step.ref import (delivery_step_plain,
                                              sync_step_plain)

#: Relaxation kinds with a fused step.  ``sync`` collapses to one product
#: (all views equal x exactly); the others are delivery-tensor kinds.
FUSED_KINDS = ("sync", "crash", "crash_subst", "elastic_variance")


def supports_fused(problem, relax) -> bool:
    """The fused path needs a quadratic problem (dense ``A`` and ``x_star``
    in its ``sim_data``) and a fused kind."""
    if relax.kind not in FUSED_KINDS or not hasattr(problem, "sim_data"):
        return False
    data = problem.sim_data()
    return "A" in data and "x_star" in data


def fused_delivery_step(v, x, a, x_star, noise, u, defer=None):
    """One fused step for B cases: v (B, p, d); x (B, d); u (B, m, p) with
    the step scale folded in; defer (B, p, d) or None.  Returns
    ``(x', v', defer' or None, sq)`` with ``sq`` (B, p) the squared
    distance of each view to x'."""
    if v.is_cuda:
        return delivery_step(v, x, a, x_star, noise, u, defer)
    return delivery_step_plain(v, x, a, x_star, noise, u, defer)


def fused_sync_step(x, a, x_star, nsum, c):
    """One fused sync step for B cases: x, nsum (B, d), nsum pre-scaled by
    alpha/p; c (B,) the collapsed gradient weight alpha."""
    if x.is_cuda:
        return sync_step(x, a, x_star, nsum, c)
    return sync_step_plain(x, a, x_star, nsum, c)
