"""Theoretical elastic-consistency bounds (Table 1) and convergence-rate
right-hand sides (Theorems 2-5), used to validate measurements against the
paper's own claims (counterpart of ``repro.core.theory``; pure Python).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


# ---------------------------------------------------------------------------
# Table 1: elastic consistency constants B
# ---------------------------------------------------------------------------

def b_shared_memory(d: int, tau_max: int, m2: float) -> float:
    """Shared-memory tau-bounded asynchrony: B = sqrt(d) * tau_max * M
    (Lemma 17)."""
    return math.sqrt(d) * tau_max * math.sqrt(m2)


def b_async_mp(p: int, tau_max: int, m2: float) -> float:
    """Message-passing tau-bounded asynchrony: B = (p-1) tau_max M / p
    (Lemma 15)."""
    return (p - 1) * tau_max * math.sqrt(m2) / p


def b_async_mp_variance(p: int, tau_max: int, sigma2: float,
                        const: float = 3.0) -> float:
    """Self-substituting asynchronous MP: B = O((p-1) tau_max sigma / p)."""
    return const * (p - 1) * tau_max * math.sqrt(sigma2) / p


def b_crash_m(p: int, f: int, m2: float) -> float:
    """Synchronous MP, f crash/message-drop faults: B = f M / p (Lemma 13/14)."""
    return f * math.sqrt(m2) / p


def b_crash_variance(p: int, f: int, sigma2: float) -> float:
    """Crash faults with self-substitution: B = 3 f sigma / p (Lemma 12)."""
    return 3.0 * f * math.sqrt(sigma2) / p


def b_ef_compression(gamma: float, m2: float) -> float:
    """EF compression: B = sqrt((2-gamma) gamma / (1-gamma)^3) * M
    (Lemma 18)."""
    return math.sqrt((2 - gamma) * gamma / (1 - gamma) ** 3 * m2)


def b_elastic_scheduler_variance(sigma2: float) -> float:
    """Variance-bounded elastic scheduler: B = 3 sigma (Lemma 16)."""
    return 3.0 * math.sqrt(sigma2)


# ---------------------------------------------------------------------------
# Theorem RHS evaluators
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ProblemConstants:
    L: float            # smoothness
    sigma2: float       # gradient variance bound
    f0_minus_fstar: float
    c: float = 0.0      # strong convexity (0 if N/A)
    x0_dist2: float = 0.0  # ||x0 - x*||^2


def thm2_rhs(pc: ProblemConstants, B: float, T: int) -> float:
    """Single-step non-convex rate bound (Theorem 2), alpha = 1/sqrt(T)."""
    return (4 * pc.f0_minus_fstar / math.sqrt(T)
            + 2 * B * B * pc.L ** 2 / T
            + 6 * pc.L * pc.sigma2 / math.sqrt(T)
            + 6 * pc.L ** 3 * B * B / (T * math.sqrt(T)))


def thm3_rhs(pc: ProblemConstants, B: float, T: int, p: int) -> float:
    """Parallel-step non-convex rate bound (Theorem 3), alpha = sqrt(p/T)."""
    return (8 * pc.f0_minus_fstar / math.sqrt(T * p)
            + 4 * B * B * pc.L ** 2 * p / T
            + 8 * pc.L * pc.sigma2 / math.sqrt(T * p)
            + 16 * pc.L ** 3 * B * B * p * math.sqrt(p) / (T * math.sqrt(T)))


def thm4_rhs(pc: ProblemConstants, B: float, T: int) -> float:
    """Single-step strongly-convex bound (Theorem 4)."""
    lt = math.log(T)
    return (pc.x0_dist2 / T
            + 16 * lt ** 2 * pc.L ** 2 * B * B / (pc.c ** 4 * T ** 2)
            + 12 * pc.sigma2 * lt / T
            + 48 * lt ** 3 * B * B * pc.L ** 2 / (pc.c ** 4 * T ** 3))


def thm5_rhs(pc: ProblemConstants, B: float, T: int, p: int) -> float:
    """Parallel-step strongly-convex bound (Theorem 5)."""
    ltp = math.log(T) + math.log(p)
    return (pc.x0_dist2 / (T * p)
            + 16 * ltp ** 2 * pc.L ** 2 * B * B / (pc.c ** 4 * T ** 2)
            + 12 * pc.sigma2 * ltp / (T * p)
            + 48 * ltp ** 3 * B * B * pc.L ** 2 / (pc.c ** 4 * T ** 3))


def lemma6_iters(B: float, eps: float) -> float:
    """Lower bound (Lemma 6): T = Omega(B^2/eps * log(1/eps))."""
    return B * B / eps * math.log(1.0 / eps)
