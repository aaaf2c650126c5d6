"""Device-resident engine for the elastic-consistency simulator, the
counterpart of ``repro.core.sim_engine``.

Where the reference traces one ``lax.scan`` program, this engine is one
eager loop over T steps whose state stays on the problem's device, with a
leading **case axis B** throughout: :func:`simulate_scan` is B = 1,
:func:`simulate_sweep` stacks seeds and :func:`simulate_grid` stacks
(problem, relaxation knob, alpha, seed) cases, all through the same loop.

  * the per-worker Python loops of the oracle become batched (B, p, p)
    delivery matrices contracted against the (B, p, d) gradient stack,
  * the dynamic ``pending`` list becomes fixed-capacity delay rings
    (`repro_torch.core.delivery`), capacity bounded by the relaxation,
  * EF compression routes through the kernels via
    ``compression.ef_compress_rows`` (rows = B * p workers),
  * the schedule arrays and the gradient draws move to the device once,
    the (T, B, d) trajectory and (T, B) gaps are preallocated there, and no
    step syncs with the host: the host reads the results once per batch,
    after losses and gradient norms are evaluated on the recorded points.

Fused fast path (``fused=True|"auto"``)
---------------------------------------
For the `Quadratic` testbed and the kinds in
:data:`repro_torch.kernels.sim_step.FUSED_KINDS`, each step is one kernel
launch: the delivery tensors of the whole run are precomputed on the device
(they are schedule-determined), then every step is one ``delivery_step``
(K6; it also returns each view's squared distance to x, so the gap is one
masked max) or, for ``sync``, one ``sync_step`` (K7), since every view
equals x exactly.  A CPU tensor takes the kernels' plain versions.  The
unfused step is kept as the parity oracle; ``fused="auto"`` takes the fast
path where it is supported and d >= :data:`AUTO_MIN_DIM`.

Randomness: the schedules are the pre-drawn oblivious-adversary
:class:`~repro_torch.core.sim_types.Schedule`; gradient draws come from
``problem.presample_grads`` with a generator seeded ``seed + 1`` on the
problem's device, or from ``draws=`` (the parity tests pass the
reference's).  Eager PyTorch compiles nothing, so there is no program cache.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core import compression as C
from repro_torch.core import delivery as DLV
from repro_torch.core.sim_ref import default_draws
from repro_torch.core.sim_types import (Relaxation, Schedule, SimResult,
                                        make_schedule,
                                        make_shared_memory_schedule)
from repro_torch.kernels import sim_step as SSK

# "auto" engages the fused path only at d >= 128, as in the reference: below
# it the gradient product is too cheap for the fusion to pay for itself.
AUTO_MIN_DIM = 128

_KNOBS = ("drop_prob", "beta", "B_adv")


def _static_key(relax: Relaxation) -> tuple:
    """The relaxation fields that shape a run; cases that differ only in
    the float knobs (drop_prob/beta/B_adv) share one batch."""
    return (relax.kind, relax.f, relax.tau_max, relax.compressor)


def _resolve_fused(problem, relax: Relaxation, fused) -> bool:
    if fused == "auto":
        return problem.dim >= AUTO_MIN_DIM and \
            SSK.supports_fused(problem, relax)
    if fused is True:
        if not SSK.supports_fused(problem, relax):
            raise ValueError(
                f"fused=True unsupported for kind={relax.kind!r} on "
                f"{type(problem).__name__} (needs quadratic sim_data and a "
                f"kind in {SSK.FUSED_KINDS})")
        return True
    if fused is False:
        return False
    raise ValueError(f"fused must be True, False or 'auto', got {fused!r}")


# ---------------------------------------------------------------------------
# the batch of cases
# ---------------------------------------------------------------------------

@dataclass
class _Cases:
    """B cases of one relaxation kind on one device: per-case alphas and
    float knobs (B,), per-step schedule arrays (T, B, ...), per-run arrays
    (B, ...) and the gradient draws (T, B, p, ...)."""

    relaxes: list
    scheds: list
    alphas: torch.Tensor
    knobs: dict
    per_step: dict
    per_run: dict
    draws: torch.Tensor


def _stack_cases(relaxes, scheds, alphas, draws, device) -> _Cases:
    def stack(arrays, axis):
        return torch.as_tensor(np.stack(arrays, axis=axis), device=device)

    per_step = {k: stack([s.per_step[k] for s in scheds], 1)
                for k in scheds[0].per_step}
    per_run = {k: stack([s.per_run[k] for s in scheds], 0)
               for k in scheds[0].per_run}
    knobs = {k: torch.tensor([float(getattr(r, k)) for r in relaxes],
                             dtype=torch.float32, device=device)
             for k in _KNOBS}
    return _Cases(
        relaxes=list(relaxes), scheds=list(scheds),
        alphas=torch.tensor([float(a) for a in alphas], dtype=torch.float32,
                            device=device),
        knobs=knobs, per_step=per_step, per_run=per_run,
        draws=torch.stack([torch.as_tensor(dr, device=device)
                           for dr in draws], dim=1).contiguous())


def _x0_tensor(problem, x0) -> torch.Tensor:
    if x0 is None:
        return torch.zeros(problem.dim, dtype=torch.float32,
                           device=problem.device)
    if not isinstance(x0, torch.Tensor):
        x0 = torch.from_numpy(np.array(x0, np.float32))
    return x0.to(dtype=torch.float32, device=problem.device)


# ---------------------------------------------------------------------------
# the unfused step (parity oracle), batched over cases
# ---------------------------------------------------------------------------

def _run_unfused(problem, relax: Relaxation, p: int, T: int,
                 x0: torch.Tensor, cs: _Cases):
    """-> (xs (T, B, d), gap2 (T, B)) with x recorded after every step."""
    kind = relax.kind
    dev = problem.device
    d = problem.dim
    nb = cs.alphas.shape[0]
    eye = torch.eye(p, dtype=torch.bool, device=dev)
    alpha = cs.alphas
    scale = (alpha / p)[:, None]                  # (B, 1)
    scale3 = scale[:, :, None]                    # (B, 1, 1)
    knobs, step_s, run_s = cs.knobs, cs.per_step, cs.per_run
    x = x0.expand(nb, d).clone()
    v = x0.expand(nb, p, d).clone()
    alive = torch.ones((nb, p), dtype=torch.bool, device=dev)
    xs = torch.empty((T, nb, d), dtype=torch.float32, device=dev)
    gaps = torch.empty((T, nb), dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)

    om_ring = 3                              # omission: delivery in {t+1, t+2}
    as_ring = max(relax.tau_max, 1)          # async: delay < tau_max
    if kind == "omission":
        ring = DLV.ring_init(om_ring, (nb, p, d), device=dev)
        cnt = DLV.ring_init(om_ring, (nb,), torch.int64, device=dev)
    if kind == "async" and as_ring > 1:
        ring = DLV.ring_init(as_ring, (nb, p, d), device=dev)
    if kind == "ef_comp":
        err = torch.zeros((nb * p, d), dtype=torch.float32, device=dev)
    if kind in ("elastic_norm", "elastic_variance"):
        defer = torch.zeros((nb, p, d), dtype=torch.float32, device=dev)
    if kind == "elastic_norm":
        perm_all = step_s["perm"].long()
        own = torch.arange(p, device=dev)[None, :, None]

    for t in range(T):
        draw = cs.draws[t]
        grads = lambda views: problem.batch_grads_at(views, draw)

        if kind == "adversarial":
            views = x[:, None] + (alpha * knobs["B_adv"])[:, None, None] * \
                run_s["adv_dir"][:, None, :]
            g = grads(views.expand(nb, p, d))
            x = x - scale * g.sum(1)
            v = x[:, None].expand(nb, p, d).clone()

        elif kind == "sync":
            g = grads(v)
            upd = scale * g.sum(1)
            x = x - upd
            v = v - upd[:, None]

        elif kind in ("crash", "crash_subst"):
            g = grads(v)
            crashing = alive & (run_s["crash_step"] == t)
            new_alive = alive & ~crashing
            # recv[b, i, j]: does i receive j's broadcast this step?
            base = alive[:, :, None] & alive[:, None, :]
            heard = (run_s["hear_u"].transpose(1, 2) < 0.5) \
                & new_alive[:, :, None] & ~eye
            recv = torch.where(crashing[:, None, :], heard, base)
            in_recv = recv.any(dim=1)               # heard by >= 1 node
            x = x - scale * (in_recv.float()[:, None] @ g)[:, 0]
            got = recv.float() @ g
            if kind == "crash_subst":
                missed = ((~recv) & in_recv[:, None, :]).sum(2)
                got = got + missed.float()[:, :, None] * g
            v = torch.where(new_alive[:, :, None], v - scale3 * got, v)
            alive = new_alive

        elif kind == "omission":
            g = grads(v)
            cand = (step_s["drop_u"][t] < knobs["drop_prob"][:, None, None]) \
                & ~eye
            # first-come quota: at most f messages outstanding, row-major
            # (i, j) order — identical to the oracle's loop order
            cf = cand.reshape(nb, -1).long()
            before = cf.cumsum(1) - cf
            quota = relax.f - cnt.sum(0)
            take = (cand.reshape(nb, -1) & (before < quota[:, None])) \
                .reshape(nb, p, p)
            gsum = g.sum(1)
            x = x - scale * gsum
            v = v - scale3 * (gsum[:, None] - take.float() @ g)
            for e in (0, 1):                        # extra delay in {0, 1}
                m = take & (step_s["extra_delay"][t] == e)
                slot = (t + 1 + e) % om_ring
                DLV.ring_deposit(ring, slot, scale3 * (m.float() @ g))
                DLV.ring_deposit(cnt, slot, m.sum((1, 2)))
            delivered, _ = DLV.ring_take(ring, t % om_ring)
            v = v - delivered
            DLV.ring_take(cnt, t % om_ring)

        elif kind == "async":
            g = grads(v)
            # one-hot per-delay delivery masks; level 0 is immediate
            masks = DLV.delay_masks(step_s["delays"][t],
                                    max(relax.tau_max, 1))
            x = x - scale * g.sum(1)
            v = v - scale3 * (masks[0] @ g)
            if as_ring > 1:
                for dl in range(1, relax.tau_max):
                    DLV.ring_deposit(ring, (t + dl) % as_ring,
                                     scale3 * (masks[dl] @ g))
                delivered, _ = DLV.ring_take(ring, t % as_ring)
                v = v - delivered

        elif kind == "ef_comp":
            g = grads(v)
            payloads, err = C.ef_compress_rows(
                relax.compressor, (alpha[:, None, None] * g).reshape(nb * p, d),
                err)
            x = x - scale * g.sum(1)
            v = v - payloads.reshape(nb, p, d).sum(1)[:, None] / p

        elif kind == "elastic_norm":
            g = grads(v)
            perm = perm_all[t]                      # (B, p, p) arrival order
            norms = (g * g).sum(2).sqrt()
            self_m = perm == own
            contrib = torch.where(self_m, 0.0, torch.gather(
                norms[:, None, :].expand(nb, p, p), 2, perm))
            acc_before = contrib.cumsum(2) - contrib
            inc = (acc_before < knobs["beta"][:, None, None]
                   * norms[:, :, None]) | self_m
            recv = torch.zeros((nb, p, p), dtype=torch.bool,
                               device=dev).scatter(2, perm, inc)
            gsum = g.sum(1)
            recvg = recv.float() @ g
            x = x - scale * gsum
            v = v - scale3 * recvg - defer
            defer = scale3 * (gsum[:, None] - recvg)

        elif kind == "elastic_variance":
            g = grads(v)
            drop = (step_s["drop_u"][t] < knobs["drop_prob"][:, None, None]) \
                & ~eye
            nd = drop.sum(2).float()[:, :, None]
            gsum = g.sum(1)
            dropg = drop.float() @ g
            # keep@g = gsum - g - drop@g, so upd = gsum + nd*g - drop@g
            x = x - scale * gsum
            v = v - scale3 * (gsum[:, None] + nd * g - dropg) - defer
            defer = scale3 * (dropg - nd * g)

        else:
            raise ValueError(kind)

        xs[t] = x
        sq = (x[:, None] - v).square().sum(2)
        gaps[t] = torch.where(alive, sq, neg_inf).amax(1)
    return xs, gaps


# ---------------------------------------------------------------------------
# the fused step: one kernel launch per step
# ---------------------------------------------------------------------------

def _problem_tensors(problems):
    """A and x* shared (one problem) or stacked (G, d, d) / (G, d)."""
    datas = [pr.sim_data() for pr in problems]
    if len(datas) == 1:
        return datas[0]["A"], datas[0]["x_star"]
    return (torch.stack([dt["A"] for dt in datas]),
            torch.stack([dt["x_star"] for dt in datas]))


def _run_fused(problems, relax: Relaxation, p: int, T: int,
               x0: torch.Tensor, cs: _Cases):
    """Cases are ordered problem-major: case b runs on problem
    ``b // (B // len(problems))``."""
    kind = relax.kind
    dev = problems[0].device
    d = problems[0].dim
    nb = cs.alphas.shape[0]
    a, x_star = _problem_tensors(problems)
    scale = cs.alphas / p
    x = x0.expand(nb, d).contiguous()
    xs = torch.empty((T, nb, d), dtype=torch.float32, device=dev)

    if kind == "sync":
        # every view equals x exactly: the p-view gradient stack collapses
        # to one product + the worker-summed noise row (summed in worker
        # order, so each case's sum does not depend on the batch)
        nsum = cs.draws[:, :, 0].clone()
        for i in range(1, p):
            nsum += cs.draws[:, :, i]
        nsc = scale[None, :, None] * nsum               # (T, B, d)
        for t in range(T):
            x = SSK.fused_sync_step(x, a, x_star, nsc[t], cs.alphas)
            xs[t] = x
        return xs, torch.zeros((T, nb), dtype=torch.float32, device=dev)

    us, alive = [], []
    for relax_i, sched in zip(cs.relaxes, cs.scheds):
        u, na = DLV.delivery_tensors(
            kind, p, T, sched.per_step, sched.per_run,
            {"drop_prob": relax_i.drop_prob}, device=dev)
        us.append(u)
        alive.append(na if na is not None else
                     torch.ones((T, p), dtype=torch.bool, device=dev))
    u = (torch.stack(us, dim=1) * scale[None, :, None, None]).contiguous()
    alive = torch.stack(alive, dim=1)                   # (T, B, p)
    v = x0.expand(nb, p, d).contiguous()
    defer = torch.zeros_like(v) if kind == "elastic_variance" else None
    gaps = torch.empty((T, nb), dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    for t in range(T):
        x, v, defer, sq = SSK.fused_delivery_step(v, x, a, x_star,
                                                  cs.draws[t], u[t], defer)
        xs[t] = x
        gaps[t] = torch.where(alive[t], sq, neg_inf).amax(1)
    return xs, gaps


# ---------------------------------------------------------------------------
# result assembly
# ---------------------------------------------------------------------------

def _finalize_batch(problem, xs, gaps2, alphas, record_every) -> list:
    """Losses and gradient norms on the recorded points of every case, then
    ONE transfer to the host: xs (T, B, d), gaps2 (T, B) on the device;
    ``alphas`` one per case."""
    t_len, nb, d = xs.shape
    rec = xs[::record_every].transpose(0, 1)            # (B, n_rec, d)
    n_rec = rec.shape[1]
    flat = rec.reshape(nb * n_rec, d)
    losses = problem.loss(flat)
    gns = (problem.grad(flat) ** 2).sum(-1)
    a32 = torch.tensor([float(a) for a in alphas], dtype=torch.float32,
                       device=xs.device)
    gap = gaps2.T / (a32 * a32)[:, None]
    host = torch.cat([losses.reshape(-1), gns.reshape(-1), gap.reshape(-1),
                      xs[-1].reshape(-1)]).cpu().numpy()
    n_l = nb * n_rec
    losses = host[:n_l].reshape(nb, n_rec)
    gns = host[n_l:2 * n_l].reshape(nb, n_rec)
    gap = host[2 * n_l:2 * n_l + nb * t_len].reshape(nb, t_len)
    x_fin = host[2 * n_l + nb * t_len:].reshape(nb, d)
    return [SimResult(losses[i], gns[i], gap[i].astype(np.float64),
                      x_fin[i], record_every, float(alphas[i]))
            for i in range(nb)]


def _run_cases(problems, relax, p, T, x0, cs, use_fused):
    if use_fused:
        return _run_fused(problems, relax, p, T, x0, cs)
    assert len(problems) == 1
    return _run_unfused(problems[0], relax, p, T, x0, cs)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def simulate_scan(problem, relax: Relaxation, p: int, alpha: float, T: int,
                  seed: int = 0, x0=None, record_every: int = 10,
                  schedule: Optional[Schedule] = None,
                  fused="auto", draws=None) -> SimResult:
    """Device-loop equivalent of :func:`repro_torch.core.sim_ref.
    simulate_ref` (one case); ``draws`` overrides the gradient randomness
    (``presample_grads``' shape, e.g. (T, p, d) noise)."""
    if schedule is None:
        schedule = make_schedule(relax, p, problem.dim, T, seed)
    if draws is None:
        draws = default_draws(problem, seed, T, p)
    use_fused = _resolve_fused(problem, relax, fused)
    cs = _stack_cases([relax], [schedule], [alpha], [draws], problem.device)
    xs, gaps2 = _run_cases([problem], relax, p, T,
                           _x0_tensor(problem, x0), cs, use_fused)
    return _finalize_batch(problem, xs, gaps2, [alpha], record_every)[0]


def simulate_sweep(problem, relax: Relaxation, p: int, alpha: float, T: int,
                   seeds, x0=None, record_every: int = 10,
                   fused="auto", draws=None) -> list:
    """One batched run over seeds: the schedules and gradient draws get a
    case axis; x0/alpha are shared.  ``draws``: one array per seed, or
    None.  Returns [SimResult] per seed."""
    seeds = list(seeds)
    scheds = [make_schedule(relax, p, problem.dim, T, s) for s in seeds]
    if draws is None:
        draws = [default_draws(problem, s, T, p) for s in seeds]
    use_fused = _resolve_fused(problem, relax, fused)
    cs = _stack_cases([relax] * len(seeds), scheds, [alpha] * len(seeds),
                      draws, problem.device)
    xs, gaps2 = _run_cases([problem], relax, p, T,
                           _x0_tensor(problem, x0), cs, use_fused)
    return _finalize_batch(problem, xs, gaps2, [alpha] * len(seeds),
                           record_every)


@dataclass
class GridResult:
    """Results of :func:`simulate_grid`, keyed by
    ``(i_problem, i_relax, p, i_alpha, seed)``."""

    results: dict = field(default_factory=dict)

    def __getitem__(self, key) -> SimResult:
        return self.results[key]

    def __len__(self) -> int:
        return len(self.results)

    def select(self, i_problem=None, i_relax=None, p=None, i_alpha=None,
               seed=None) -> list:
        """All results matching the given coordinates, key-sorted."""
        want = (i_problem, i_relax, p, i_alpha, seed)
        return [r for k, r in sorted(self.results.items())
                if all(w is None or kk == w for kk, w in zip(k, want))]


def simulate_grid(problems, relaxations, p_list, alphas, T: int,
                  seeds=(0,), x0=None, record_every: int = 10,
                  fused="auto", schedule_fn=None, draws=None) -> GridResult:
    """Batched multi-case sweeps: one batched run per (relaxation statics,
    p) group instead of a Python loop of ``simulate_sweep`` calls.

    ``schedule_fn(i_relax, p, seed) -> Schedule | None`` overrides the
    pre-drawn scheduling randomness per case (None falls back to
    :func:`make_schedule`); an override must keep the default draw's array
    shapes.  ``draws(i_problem, p, seed) -> array | None`` overrides the
    gradient randomness the same way.

    The cartesian product problems x relaxations x alphas x seeds is run
    for every p in ``p_list``.  Relaxations in one group may differ only in
    float knobs (drop_prob/beta/B_adv).  A fused group runs every problem
    (they must share d) in ONE batch, cases ordered problem-major, with A
    stacked (n_problems, d, d): one ``delivery_step`` launch per step for
    the whole group.  An unfused group runs one batch per problem.
    """
    problems = problems if isinstance(problems, (list, tuple)) \
        else [problems]
    relaxations = relaxations if isinstance(relaxations, (list, tuple)) \
        else [relaxations]
    p_list = [p_list] if isinstance(p_list, int) else list(p_list)
    alphas = [alphas] if isinstance(alphas, (int, float)) else list(alphas)
    seeds = [seeds] if isinstance(seeds, int) else list(seeds)
    d = problems[0].dim
    if any(pr.dim != d for pr in problems):
        raise ValueError("simulate_grid problems must share dim")

    grid = GridResult()
    groups: dict = {}
    for ir, r in enumerate(relaxations):
        groups.setdefault(_static_key(r), []).append(ir)

    for p in p_list:
        for irs in groups.values():
            relax0 = relaxations[irs[0]]
            use_fused = _resolve_fused(problems[0], relax0, fused) and all(
                SSK.supports_fused(pr, relax0) for pr in problems)
            if fused is True and not use_fused:
                raise ValueError(
                    "fused=True but not every problem in the grid supports "
                    f"the fused path for kind={relax0.kind!r}")
            cases = [(ir, ia, s) for ir in irs
                     for ia in range(len(alphas)) for s in seeds]
            scheds = [schedule_fn(ir, p, s) if schedule_fn else None
                      for ir, _, s in cases]
            scheds = [sc if sc is not None
                      else make_schedule(relaxations[ir], p, d, T, s)
                      for sc, (ir, _, s) in zip(scheds, cases)]
            case_alphas = [alphas[ia] for _, ia, _ in cases]
            case_relaxes = [relaxations[ir] for ir, _, _ in cases]

            def case_draws(ip):
                out = []
                for _, _, s in cases:
                    dr = draws(ip, p, s) if draws is not None else None
                    out.append(dr if dr is not None else
                               default_draws(problems[ip], s, T, p))
                return out

            batches = [list(range(len(problems)))] if use_fused else \
                [[ip] for ip in range(len(problems))]
            for ips in batches:
                probs = [problems[ip] for ip in ips]
                cs = _stack_cases(case_relaxes * len(ips), scheds * len(ips),
                                  case_alphas * len(ips),
                                  [dr for ip in ips for dr in case_draws(ip)],
                                  probs[0].device)
                xs, gaps2 = _run_cases(probs, relax0, p, T,
                                       _x0_tensor(probs[0], x0), cs,
                                       use_fused)
                n = len(cases)
                for k, ip in enumerate(ips):
                    res = _finalize_batch(problems[ip],
                                          xs[:, k * n:(k + 1) * n],
                                          gaps2[:, k * n:(k + 1) * n],
                                          case_alphas, record_every)
                    for (ir, ia, s), r in zip(cases, res):
                        grid.results[(ip, ir, p, ia, s)] = r
    return grid


def simulate_shared_memory_scan(problem, p: int, alpha: float, T: int,
                                tau_max: int, seed: int = 0, x0=None,
                                record_every: int = 10,
                                schedule: Optional[Schedule] = None,
                                draws=None) -> SimResult:
    """Shared-memory model (Alg 5) on the device: each step's gradient is
    taken at a per-coordinate stale snapshot gathered from a ring of the
    last ``tau_max + 1`` iterates."""
    if schedule is None:
        schedule = make_shared_memory_schedule(p, problem.dim, T, tau_max,
                                               seed)
    if draws is None:
        draws = default_draws(problem, seed, T, 1)
    dev = problem.device
    d = problem.dim
    taus = torch.as_tensor(schedule.per_step["taus"], device=dev).long()
    draws = torch.as_tensor(draws, device=dev)
    a32 = torch.tensor(alpha, dtype=torch.float32, device=dev)
    x = _x0_tensor(problem, x0).clone()
    hist = x.expand(tau_max + 1, d).clone()
    xs = torch.empty((T, 1, d), dtype=torch.float32, device=dev)
    gaps = torch.empty((T, 1), dtype=torch.float32, device=dev)
    for t in range(T):
        idx = (t - taus[t]) % (tau_max + 1)
        view = torch.gather(hist, 0, idx[None])[0]
        g = problem.batch_grads_at(view[None], draws[t])[0]
        gaps[t, 0] = (x - view).square().sum()
        x = x - a32 * g
        hist[(t + 1) % (tau_max + 1)] = x
        xs[t, 0] = x
    return _finalize_batch(problem, xs, gaps, [alpha], record_every)[0]
