"""Shared contract between the two simulator engines (`sim_ref`,
`sim_engine`), counterpart of ``repro.core.sim_types``.

This module owns what both engines must agree on exactly:

  * :class:`Relaxation` / :class:`SimResult` — the public API types,
  * :func:`make_schedule` / :func:`make_shared_memory_schedule` — the
    *oblivious-adversary* scheduling randomness, pre-drawn into dense numpy
    arrays from ``np.random.default_rng(seed)``, bitwise the reference's.

Gradient randomness is a separate stream: each problem's
``presample_grads(gen, T, p)`` draws a whole run's noise (or minibatch
indices) from a ``torch.Generator`` seeded ``seed + 1`` on the problem's
device, and every simulator entry point takes ``draws=`` to override it
(the parity tests pass the reference's arrays, since ``jax.random`` cannot
be reproduced).

Draw order (fixed; changing it is a semantic break for seeded runs):

  crash / crash_subst : choice(p, f) crash ids -> integers crash times ->
                        uniform (f, p) "who hears the last broadcast"
  omission            : uniform (T, p, p) drop draws -> integers (T, p, p)
                        extra delivery delays in {0, 1}
  async               : integers (T, p, p) per-message delays in [0, tau_max)
  elastic_norm        : uniform (T, p, p) -> argsort = per-worker arrival
                        permutations
  elastic_variance    : uniform (T, p, p) drop draws
  adversarial         : normal (d,) displacement direction (normalized)
  shared memory       : integers (T, d) componentwise staleness in
                        [0, tau_max)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core import compression as C


@dataclass(frozen=True)
class Relaxation:
    """Which consistency relaxation to simulate.

    kind:
      sync              — failure-free synchronous baseline (B = 0)
      crash             — Alg 2: f crash faults, no substitution
      crash_subst       — Alg 1: crash faults, receivers substitute own grad
      omission          — Alg 3: <= f outstanding delayed messages
      async             — B.4: per-message delay < tau_max
      ef_comp           — Alg 6: error-feedback compression (all-delivered)
      elastic_norm      — §5 norm-bounded scheduler (beta)
      elastic_variance  — Alg 4: 1-step delays, substitute-then-correct
      adversarial       — Lemma 6 oracle: view displaced by alpha*B
    """

    kind: str = "sync"
    f: int = 0                   # crash/omission fault bound
    tau_max: int = 1             # async delay bound
    drop_prob: float = 0.3       # per-message delay probability
    compressor: Optional[C.Compressor] = None
    beta: float = 0.8            # norm-bounded scheduler threshold
    B_adv: float = 0.0           # adversarial oracle displacement


@dataclass
class SimResult:
    losses: np.ndarray           # recorded every `record_every`
    grad_norms2: np.ndarray      # ||grad f(x_t)||^2 at the same cadence
    gap2_over_alpha2: np.ndarray # max_i ||x_t - v_t^i||^2 / alpha^2, per step
    x_final: np.ndarray
    record_every: int
    alpha: float

    @property
    def b_hat(self) -> float:
        """Empirical elastic-consistency constant sqrt(max_t E gap^2/a^2)."""
        return float(np.sqrt(np.max(self.gap2_over_alpha2)))

    @property
    def b_hat_mean(self) -> float:
        return float(np.sqrt(np.mean(self.gap2_over_alpha2)))


@dataclass
class Schedule:
    """Pre-drawn scheduling randomness. ``per_step`` arrays have leading dim
    T (one slice per step); ``per_run`` arrays are constant over the run
    (crash times, adversarial direction)."""

    per_step: dict
    per_run: dict


def make_schedule(relax: Relaxation, p: int, d: int, T: int,
                  seed: int) -> Schedule:
    """Draw the full schedule for one run (layout documented above)."""
    rng = np.random.default_rng(seed)
    per_step: dict = {}
    per_run: dict = {}
    kind = relax.kind

    if kind.startswith("crash"):
        if not 0 <= relax.f < p:
            raise ValueError(
                f"crash fault bound f={relax.f} must satisfy 0 <= f < p={p} "
                "(at least one worker must survive)")
        crashed = rng.choice(p, size=relax.f, replace=False)
        times = rng.integers(1, max(T - 1, 2), size=relax.f)
        hear_u = rng.random((relax.f, p))
        crash_step = np.full(p, T, np.int32)          # T == never crashes
        hear = np.ones((p, p), np.float32)            # row j: j's broadcast
        crash_step[crashed] = times
        hear[crashed] = hear_u
        per_run["crash_step"] = crash_step
        per_run["hear_u"] = hear
    elif kind == "omission":
        per_step["drop_u"] = rng.random((T, p, p)).astype(np.float32)
        per_step["extra_delay"] = rng.integers(
            0, 2, size=(T, p, p)).astype(np.int32)
    elif kind == "async":
        delays = rng.integers(0, relax.tau_max,
                              size=(T, p, p)).astype(np.int32)
        delays[:, np.arange(p), np.arange(p)] = 0     # own grad is immediate
        per_step["delays"] = delays
    elif kind == "elastic_norm":
        per_step["perm"] = np.argsort(
            rng.random((T, p, p)), axis=-1).astype(np.int32)
    elif kind == "elastic_variance":
        per_step["drop_u"] = rng.random((T, p, p)).astype(np.float32)
    elif kind == "adversarial":
        adv = rng.normal(size=d).astype(np.float32)
        per_run["adv_dir"] = adv / np.linalg.norm(adv)
    elif kind in ("sync", "ef_comp"):
        pass
    else:
        raise ValueError(kind)
    return Schedule(per_step, per_run)


def make_shared_memory_schedule(p: int, d: int, T: int, tau_max: int,
                                seed: int) -> Schedule:
    rng = np.random.default_rng(seed)
    taus = rng.integers(0, tau_max, size=(T, d)).astype(np.int32)
    return Schedule({"taus": taus}, {})
