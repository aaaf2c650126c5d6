"""Exact-semantics numpy oracle for the distributed models (Algs 1-6),
counterpart of ``repro.core.sim_ref``.

The readable, loop-per-worker reference the device engine
(`repro_torch.core.sim_engine`) is held against step for step.  Scheduling
randomness comes from the pre-drawn :class:`~repro_torch.core.sim_types.
Schedule`; gradient randomness from ``draws`` (the problem's
``presample_grads`` from a generator seeded ``seed + 1`` unless given), so
both engines see identical randomness.  Gradients are the problem's
(torch, on its device), brought back to numpy each step.

Semantics are those of the paper's appendix algorithms: p workers hold views
``v`` (p, d); the auxiliary parameter ``x`` (Def. 1) accumulates every
generated gradient with weight alpha/p (parallel-steps rule, Eq. 11) or
alpha (single-steps rule, Eq. 10, shared-memory model).  The realized
elastic-consistency gap  max_i ||x_t - v_t^i||^2 / alpha^2  is measured
every step so Table 1's bounds can be checked against ground truth.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import compression as C
from repro_torch.core.sim_types import (Relaxation, Schedule, SimResult,
                                        make_schedule,
                                        make_shared_memory_schedule)


def default_draws(problem, seed: int, T: int, p: int):
    """The run's gradient randomness: ``presample_grads`` from a generator
    seeded ``seed + 1`` on the problem's device."""
    gen = torch.Generator(device=problem.device).manual_seed(seed + 1)
    return problem.presample_grads(gen, T, p)


def _x0_numpy(x0) -> np.ndarray:
    if isinstance(x0, torch.Tensor):
        return x0.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x0, np.float32)


def _make_grads_at(problem, draws):
    draws = torch.as_tensor(draws, device=problem.device)

    def grads_at(views, t):
        v = torch.as_tensor(np.ascontiguousarray(views), device=problem.device)
        return problem.batch_grads_at(v, draws[t]).cpu().numpy()
    return grads_at


def _record(problem, x, losses, gnorms):
    xt = torch.as_tensor(x, device=problem.device)
    losses.append(float(problem.loss(xt)))
    gnorms.append(float((problem.grad(xt) ** 2).sum()))


def simulate_ref(problem, relax: Relaxation, p: int, alpha: float, T: int,
                 seed: int = 0, x0=None, record_every: int = 10,
                 schedule: Optional[Schedule] = None,
                 draws=None) -> SimResult:
    """Run T parallel iterations of Eq. (11) under ``relax`` (numpy loop)."""
    if schedule is None:
        schedule = make_schedule(relax, p, problem.dim, T, seed)
    if draws is None:
        draws = default_draws(problem, seed, T, p)
    d = problem.dim
    grads_at = _make_grads_at(problem, draws)
    if x0 is None:
        x0 = np.zeros(d, np.float32)
    x0 = _x0_numpy(x0)
    x = np.array(x0, np.float32)                  # auxiliary parameter
    v = np.tile(x0, (p, 1)).astype(np.float32)    # per-worker views
    alive = np.ones(p, bool)

    step_s, run_s = schedule.per_step, schedule.per_run
    pending: list = []     # list of (deliver_t, i_dst, vec) for delayed msgs
    err = np.zeros((p, d), np.float32)    # EF memories (Alg 6)

    losses, gnorms, gaps = [], [], []

    for t in range(T):
        if relax.kind == "adversarial":
            # Lemma 6 oracle: gradient evaluated at a point alpha*B away
            views_adv = x[None] + alpha * relax.B_adv * run_s["adv_dir"][None]
            g = grads_at(np.broadcast_to(views_adv, (p, d)), t)
        else:
            g = grads_at(v, t)                                        # (p, d)

        scale = alpha / p
        if relax.kind in ("sync", "adversarial"):
            upd = g[alive].sum(0) * scale
            x -= upd
            if relax.kind == "sync":
                v[alive] -= upd
            else:
                v[alive] = x[None]  # oracle controls the view directly

        elif relax.kind in ("crash", "crash_subst"):
            # delivery matrix: recv[i, j] — does i receive j's gradient?
            crashing = [j for j in range(p)
                        if alive[j] and run_s["crash_step"][j] == t]
            new_alive = alive.copy()
            new_alive[crashing] = False
            recv = np.ones((p, p), bool)
            recv[:, ~alive] = False
            recv[~alive, :] = False
            for j in crashing:
                # j computes+broadcasts, but only a random subset hears it;
                # same-step co-crashers never hear each other (symmetric rule)
                subset = run_s["hear_u"][j] < 0.5
                subset[j] = False
                recv[:, j] = subset & new_alive
            alive = new_alive
            in_i_t = recv.any(0)                      # sent to >= 1 node
            x -= scale * g[in_i_t].sum(0)
            for i in np.nonzero(alive)[0]:
                got = g[recv[i]].sum(0)
                if relax.kind == "crash_subst":
                    # Alg 1: substitute own grad for peers that crashed this
                    # step and weren't heard (they were alive last step)
                    missed = (~recv[i]) & in_i_t
                    got = got + g[i] * missed.sum()
                v[i] -= scale * got

        elif relax.kind == "omission":
            recv = np.ones((p, p), bool)
            n_out = len(pending)
            drop_u, extra = step_s["drop_u"][t], step_s["extra_delay"][t]
            for i in range(p):
                for j in range(p):
                    if i != j and n_out < relax.f and \
                            drop_u[i, j] < relax.drop_prob:
                        recv[i, j] = False
                        pending.append([t + 1 + int(extra[i, j]),
                                        i, scale * g[j]])
                        n_out += 1
            x -= scale * g.sum(0)
            for i in range(p):
                v[i] -= scale * g[recv[i]].sum(0)
            pending = _deliver(pending, v, t)

        elif relax.kind == "async":
            x -= scale * g.sum(0)
            delays = step_s["delays"][t]
            for i in range(p):
                for j in range(p):
                    if delays[i, j] == 0:
                        v[i] -= scale * g[j]
                    else:
                        pending.append([t + int(delays[i, j]), i,
                                        scale * g[j]])
            pending = _deliver(pending, v, t)

        elif relax.kind == "ef_comp":
            comp = relax.compressor
            payloads = np.zeros_like(g)
            for i in range(p):
                pay, e = C.ef_compress(comp, torch.from_numpy(alpha * g[i]),
                                       torch.from_numpy(err[i]))
                payloads[i] = pay.numpy()
                err[i] = e.numpy()
            x -= scale * g.sum(0)
            v -= payloads.sum(0)[None] / p

        elif relax.kind == "elastic_norm":
            # §5: proceed once received norm >= beta * ||own grad||;
            # leftovers apply next step (speculation depth 1).
            x -= scale * g.sum(0)
            norms = np.linalg.norm(g, axis=1)
            for i in range(p):
                order = step_s["perm"][t, i]
                got, acc = [i], norms[i] * 0.0
                target = relax.beta * norms[i]
                for j in order:
                    if j == i:
                        continue
                    if acc >= target:
                        pending.append([t + 1, i, scale * g[j]])
                    else:
                        got.append(j)
                        acc += norms[j]
                v[i] -= scale * g[got].sum(0)
            pending = _deliver(pending, v, t)

        elif relax.kind == "elastic_variance":
            # Alg 4: delayed peers' gradients replaced by own, corrected at
            # the next iteration once the real gradient arrives.
            x -= scale * g.sum(0)
            drop_u = step_s["drop_u"][t]
            for i in range(p):
                upd = g[i].copy()  # own gradient always available
                for j in range(p):
                    if j == i:
                        continue
                    if drop_u[i, j] < relax.drop_prob:
                        upd += g[i]                       # substitute
                        pending.append([t + 1, i, scale * (g[j] - g[i])])
                    else:
                        upd += g[j]
                v[i] -= scale * upd
            pending = _deliver(pending, v, t)

        else:
            raise ValueError(relax.kind)

        gap2 = float(np.max(np.sum((x[None] - v[alive]) ** 2, axis=1)))
        gaps.append(gap2 / alpha ** 2)
        if t % record_every == 0:
            _record(problem, x, losses, gnorms)

    return SimResult(np.asarray(losses), np.asarray(gnorms),
                     np.asarray(gaps), x, record_every, alpha)


def _deliver(pending, v, t):
    """Apply every delayed message due at step t; return the survivors."""
    still = []
    for dt, i, vec in pending:
        if dt <= t:
            v[i] -= vec
        else:
            still.append([dt, i, vec])
    return still


def simulate_shared_memory_ref(problem, p: int, alpha: float, T: int,
                               tau_max: int, seed: int = 0, x0=None,
                               record_every: int = 10,
                               schedule: Optional[Schedule] = None,
                               draws=None) -> SimResult:
    """Asynchronous shared-memory model (§4.2, Alg 5): single-step updates
    (Eq. 10); each iteration's gradient is computed on a componentwise-stale
    snapshot v[c] = x_{t - tau_c}[c], tau_c < tau_max (interval contention).
    """
    if schedule is None:
        schedule = make_shared_memory_schedule(p, problem.dim, T, tau_max,
                                               seed)
    if draws is None:
        draws = default_draws(problem, seed, T, 1)
    d = problem.dim
    grads_at = _make_grads_at(problem, draws)
    if x0 is None:
        x0 = np.zeros(d, np.float32)
    x0 = _x0_numpy(x0)
    x = np.array(x0, np.float32)
    hist = np.tile(x0, (tau_max + 1, 1)).astype(np.float32)  # ring buffer

    losses, gnorms, gaps = [], [], []
    for t in range(T):
        taus = schedule.per_step["taus"][t]
        idx = (t - taus) % (tau_max + 1)
        view = hist[idx, np.arange(d)]
        g = grads_at(view[None], t)[0]
        gaps.append(float(np.sum((x - view) ** 2)) / alpha ** 2)
        x = x - alpha * g
        hist[(t + 1) % (tau_max + 1)] = x
        if t % record_every == 0:
            _record(problem, x, losses, gnorms)

    return SimResult(np.asarray(losses), np.asarray(gnorms),
                     np.asarray(gaps), x, record_every, alpha)
