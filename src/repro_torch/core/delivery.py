"""Delay rings and tau schedules (counterpart of ``repro.core.delivery``).

* **Fixed-capacity delay rings** — a ring of ``capacity`` slots indexed by
  ``step % capacity``: a message produced at step ``t`` with delay
  ``d < capacity`` is deposited into slot ``(t + d) % capacity`` and taken
  (and the slot zeroed) at step ``t + d``.  The torch ring ops update the
  ring in place (the reference donates the state, so no caller sees the
  old ring).
* **Per-worker staleness schedules** — :func:`make_tau_schedule` pre-draws
  the oblivious-adversary delay table ``tau(t, worker)`` from
  ``np.random.default_rng``; tables are bitwise those of the reference.
* :func:`delivery_plan` routes one step's fresh messages to accumulator
  slots; it reads the host-side tau table, so it never waits on the device.
"""
from __future__ import annotations

import numpy as np
import torch

#: Sentinel in a tau schedule: the worker is crashed at this step.
DROPPED = -1

#: Named staleness schedules understood by :func:`make_tau_schedule`.
TAU_SCHEDULES = ("constant", "uniform", "roundrobin", "straggler", "crash",
                 "rejoin")


# ---------------------------------------------------------------------------
# fixed-capacity delay rings (in place)
# ---------------------------------------------------------------------------

def ring_init(capacity: int, shape, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """A zeroed delay ring of ``capacity`` slots of ``shape``."""
    return torch.zeros((capacity, *shape), dtype=dtype, device=device)


def ring_deposit(ring: torch.Tensor, slot: int, value) -> torch.Tensor:
    """Accumulate ``value`` into ``slot`` (several messages may share it)."""
    ring[slot] += value
    return ring


def ring_take(ring: torch.Tensor, slot: int):
    """Consume ``slot``: returns ``(value, ring)`` with the slot zeroed."""
    value = ring[slot].clone()
    ring[slot].zero_()
    return value, ring


def ring_put(ring: torch.Tensor, slot: int, value) -> torch.Tensor:
    """Overwrite ``slot`` (publish/replace semantics)."""
    ring[slot].copy_(value)
    return ring


def tree_ring_init(capacity: int, leaves, dtype=torch.float32, device=None):
    return [ring_init(capacity, tuple(a.shape), dtype, device) for a in leaves]


def tree_ring_deposit(rings, slot: int, values):
    return [ring_deposit(r, slot, v) for r, v in zip(rings, values)]


def tree_ring_take(rings, slot: int):
    taken = [ring_take(r, slot)[0] for r in rings]
    return taken, rings


def delivery_plan(taus: np.ndarray, step: int, cap: int):
    """Per-worker delivery plan for step ``step``'s fresh messages.

    Returns ``(w_live (n,) float32, slots (n,) int32)`` as numpy arrays:
    the 0/1 aliveness weights of this step's n messages and the
    accumulator slot each lands in, ``(step + clip(tau, 0, cap-1)) % cap``
    (a DROPPED message gets weight 0 and slot ``step % cap``).
    """
    horizon = taus.shape[0]
    tau = np.asarray(taus[step % horizon])
    w_live = (tau >= 0).astype(np.float32)
    slots = np.mod(step + np.clip(tau, 0, cap - 1), cap).astype(np.int32)
    return w_live, slots


# ---------------------------------------------------------------------------
# per-worker staleness schedules
# ---------------------------------------------------------------------------

def make_tau_schedule(schedule: str, p: int, T: int, tau_max: int,
                      seed: int = 0) -> np.ndarray:
    """Pre-draw the (T, p) int32 delay table ``tau(t, worker)``.

    Schedules: ``constant`` (all ``tau_max``), ``uniform`` (iid over
    ``{0..tau_max}``), ``roundrobin`` (``(t + w) % (tau_max + 1)``),
    ``straggler`` (last worker at ``tau_max``), ``crash`` (uniform, the last
    ``max(1, p // 4)`` workers DROPPED from ``T // 2``) and ``rejoin`` (the
    same workers DROPPED only inside ``[T // 3, max(T//3 + 1, 2T // 3))``).
    """
    if tau_max < 0:
        raise ValueError(f"tau_max must be >= 0, got {tau_max}")
    rng = np.random.default_rng(seed)
    t_idx = np.arange(T)[:, None]
    w_idx = np.arange(p)[None, :]
    if schedule == "constant":
        taus = np.full((T, p), tau_max)
    elif schedule == "uniform":
        taus = rng.integers(0, tau_max + 1, size=(T, p))
    elif schedule == "roundrobin":
        taus = (t_idx + w_idx) % (tau_max + 1)
    elif schedule == "straggler":
        taus = np.where(w_idx == p - 1, tau_max, 0) + 0 * t_idx
    elif schedule == "crash":
        taus = rng.integers(0, tau_max + 1, size=(T, p))
        n_crash = max(1, p // 4) if p > 1 else 0
        if n_crash:
            taus[T // 2:, p - n_crash:] = DROPPED
    elif schedule == "rejoin":
        taus = rng.integers(0, tau_max + 1, size=(T, p))
        n_crash = max(1, p // 4) if p > 1 else 0
        if n_crash:
            down = T // 3
            back = max(down + 1, (2 * T) // 3)
            taus[down:back, p - n_crash:] = DROPPED
    else:
        raise ValueError(
            f"unknown tau schedule {schedule!r}; one of {TAU_SCHEDULES}")
    return taus.astype(np.int32)


def validate_tau_table(taus: np.ndarray, tau_max: int) -> np.ndarray:
    """Check a (T, p) delay table against the delivery contract: integer,
    every entry in ``[0, tau_max]`` or exactly DROPPED.  Returns it as
    int32; raises ``ValueError`` on any violation."""
    taus = np.asarray(taus)
    if taus.ndim != 2:
        raise ValueError(f"tau table must be (T, p), got shape {taus.shape}")
    if not np.issubdtype(taus.dtype, np.integer):
        raise ValueError(f"tau table must be integer, got {taus.dtype}")
    if tau_max < 0:
        raise ValueError(f"tau_max must be >= 0, got {tau_max}")
    bad = (taus != DROPPED) & ((taus < 0) | (taus > tau_max))
    if bad.any():
        t, w = np.argwhere(bad)[0]
        raise ValueError(
            f"tau[{t}, {w}] = {taus[t, w]} outside [0, {tau_max}] "
            f"and not DROPPED ({np.count_nonzero(bad)} bad entries)")
    return taus.astype(np.int32)
