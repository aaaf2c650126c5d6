"""Simulator for the paper's distributed models (Algs 1-6) — dispatch
facade, counterpart of ``repro.core.sim``.

p logical workers hold views ``v`` (p, d); the auxiliary/global parameter
``x`` (Def. 1) accumulates *every* generated gradient with weight alpha/p
(parallel-steps rule, Eq. 11) or alpha (single-steps rule, Eq. 10, used by
the shared-memory model).  Each relaxation perturbs *delivery*, exactly as
in the paper's appendix algorithms; the simulator measures the realized
elastic-consistency gap  max_i ||x_t - v_t^i||^2 / alpha^2  every step, so
Table 1's bounds can be checked against ground truth.

Engines
-------
  engine="scan" (default) — `repro_torch.core.sim_engine`: the T-step run
      is one loop on the problem's device (the card unless the problem was
      built with ``device="cpu"``), batched over cases; ``fused`` selects
      the one-kernel-per-step path (``delivery_step`` / ``sync_step``).
      ``simulate_sweep`` and ``simulate_grid`` batch seeds and whole grids.
  engine="ref" — `repro_torch.core.sim_ref`: the numpy loop-per-worker
      oracle.

Randomness: schedules are pre-drawn from ``np.random.default_rng(seed)``
(bitwise the reference's); gradient draws come from the problem's
``presample_grads`` with a ``torch.Generator`` seeded ``seed + 1`` on its
device, or from ``draws=``.  Both engines consume the same schedule and
the same draws.
"""
from __future__ import annotations

from repro_torch.core import sim_engine, sim_ref
from repro_torch.core.sim_engine import (GridResult, simulate_grid,  # noqa: F401
                                         simulate_sweep)
from repro_torch.core.sim_types import (Relaxation, Schedule,  # noqa: F401
                                        SimResult, make_schedule,
                                        make_shared_memory_schedule)


def simulate(problem, relax: Relaxation, p: int, alpha: float, T: int,
             seed: int = 0, x0=None, record_every: int = 10,
             engine: str = "scan", fused="auto", draws=None) -> SimResult:
    """Run T parallel iterations of Eq. (11) under ``relax``.

    ``fused`` (scan engine only): ``"auto"`` takes the fused kernel step
    when the (problem, relaxation) pair supports it and d >=
    `sim_engine.AUTO_MIN_DIM`, ``False`` forces the unfused step, ``True``
    raises if unsupported.  ``draws`` overrides the gradient randomness.
    """
    if engine == "scan":
        return sim_engine.simulate_scan(problem, relax, p, alpha, T,
                                        seed=seed, x0=x0,
                                        record_every=record_every,
                                        fused=fused, draws=draws)
    if engine == "ref":
        return sim_ref.simulate_ref(problem, relax, p, alpha, T, seed=seed,
                                    x0=x0, record_every=record_every,
                                    draws=draws)
    raise ValueError(f"unknown engine {engine!r} (want 'scan' or 'ref')")


def simulate_shared_memory(problem, p: int, alpha: float, T: int,
                           tau_max: int, seed: int = 0, x0=None,
                           record_every: int = 10, engine: str = "scan",
                           draws=None) -> SimResult:
    """Asynchronous shared-memory model (§4.2, Alg 5): single-step updates
    (Eq. 10); each iteration's gradient is computed on a componentwise-stale
    snapshot v[c] = x_{t - tau_c}[c], tau_c < tau_max (interval contention).
    """
    if engine == "scan":
        return sim_engine.simulate_shared_memory_scan(
            problem, p, alpha, T, tau_max, seed=seed, x0=x0,
            record_every=record_every, draws=draws)
    if engine == "ref":
        return sim_ref.simulate_shared_memory_ref(
            problem, p, alpha, T, tau_max, seed=seed, x0=x0,
            record_every=record_every, draws=draws)
    raise ValueError(f"unknown engine {engine!r} (want 'scan' or 'ref')")
