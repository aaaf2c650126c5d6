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
* The simulator's delivery machinery: :func:`delay_masks` (one-hot
  per-delay masks of the ``async`` kind), :func:`taus_to_message_delays`
  (a per-worker tau table as per-message delays) and
  :func:`delivery_tensors` (the fused step's whole-run (T, m, p) delivery
  weights).  All three are 0/1 and integer arithmetic, equal to the
  reference's exactly.
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


def tree_ring_init(capacity: int, leaves, dtype=None, device=None):
    """Per-leaf :func:`ring_init`; ``dtype``/``device`` None keep each
    leaf's own."""
    return [ring_init(capacity, tuple(a.shape),
                      a.dtype if dtype is None else dtype,
                      a.device if device is None else device)
            for a in leaves]


def tree_ring_put(rings, slot: int, values):
    """Per-leaf :func:`ring_put` (overwrite)."""
    return [ring_put(r, slot, v) for r, v in zip(rings, values)]


def tree_ring_read(rings, slot: int):
    """Read ``slot`` of every ring without consuming it (a version ring is
    read many times)."""
    return [r[slot] for r in rings]


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


# ---------------------------------------------------------------------------
# per-message delay masks (simulator async kind)
# ---------------------------------------------------------------------------

def delay_masks(delays, n_levels: int) -> torch.Tensor:
    """One-hot delay masks: (..., p, p) int delays -> (n_levels, ..., p, p)
    f32.  Level ``l`` is the messages delayed by exactly ``l`` steps; for
    delays in ``[0, n_levels)`` the levels partition the messages (each is
    delivered exactly once), and a DROPPED (-1) message is in no level."""
    delays = torch.as_tensor(delays)
    return torch.stack([(delays == lv).float() for lv in range(n_levels)])


def taus_to_message_delays(taus: np.ndarray) -> np.ndarray:
    """Broadcast a per-worker (T, p) delay table to the simulator's
    per-message (T, p, p) ``delays[t, receiver, sender]`` layout: every
    receiver sees sender ``j``'s step-``t`` gradient after ``tau(t, j)``
    steps, except a worker's own gradient, which is always immediate
    (diagonal zero).  DROPPED senders stay DROPPED off the diagonal."""
    taus = np.asarray(taus, np.int32)
    t_len, p = taus.shape
    delays = np.broadcast_to(taus[:, None, :], (t_len, p, p)).copy()
    idx = np.arange(p)
    delays[:, idx, idx] = 0
    return delays


# ---------------------------------------------------------------------------
# whole-run delivery tensors (fused simulator step)
# ---------------------------------------------------------------------------

def delivery_tensors(kind: str, p: int, T: int, per_step: dict,
                     per_run: dict, knobs: dict, device=None):
    """Precompute the whole run's delivery tensors, vectorized over T.

    Returns (U (T, m, p) float32, new_alive (T, p) bool or None) on
    ``device``.  Row 0 of each U[t] weights the x update, rows 1..p the view
    updates (rows of dead workers are zero), rows p+1..2p
    (``elastic_variance`` only) the deferred-correction update.  The step
    scale alpha/p is NOT folded in here.  Schedule arrays may be numpy
    arrays or tensors; ``per_run["rejoin_step"]`` (p,), where present, lets
    crashed workers re-enter the sender and receiver sets.
    """
    as_t = lambda a: torch.as_tensor(a, device=device)
    eye = torch.eye(p, dtype=torch.bool, device=device)
    if kind in ("crash", "crash_subst"):
        ts = torch.arange(T, device=device)[:, None]
        crash_step = as_t(per_run["crash_step"])[None, :]   # (1, p)
        alive = crash_step >= ts                             # (T, p)
        crashing = crash_step == ts
        new_alive = alive & ~crashing
        if "rejoin_step" in per_run:
            rejoined = ts >= as_t(per_run["rejoin_step"])[None, :]
            alive = alive | rejoined
            new_alive = new_alive | rejoined
        base = alive[:, :, None] & alive[:, None, :]
        heard = (as_t(per_run["hear_u"]).T[None] < 0.5) \
            & new_alive[:, :, None] & ~eye[None]
        recv = torch.where(crashing[:, None, :], heard, base)
        in_recv = recv.any(dim=1)                            # (T, p)
        w_v = recv.float() * new_alive[:, :, None]
        if kind == "crash_subst":
            missed = ((~recv) & in_recv[:, None, :]).sum(dim=2)
            w_v = w_v + eye[None] * (missed.float() * new_alive)[:, :, None]
        u = torch.cat([in_recv.float()[:, None], w_v], dim=1)
        return u, new_alive
    if kind == "elastic_variance":
        drop = (as_t(per_step["drop_u"]) < float(knobs["drop_prob"])) \
            & ~eye[None]
        nd = drop.sum(dim=2).float()                         # (T, p)
        diag_nd = eye[None] * nd[:, :, None]
        w_v = torch.ones((T, p, p), device=device) + diag_nd - drop.float()
        w_d = drop.float() - diag_nd
        u = torch.cat([torch.ones((T, 1, p), device=device), w_v, w_d],
                      dim=1)
        return u, None
    raise ValueError(f"no delivery tensor for kind {kind!r}")
