"""Exhaustive model checker for the delivery-ring disciplines (counterpart
of ``repro.analysis.rings``).

For every staleness schedule with ``tau <= tau_max`` (plus
:data:`~repro_torch.core.delivery.DROPPED` crash entries) up to a bounded
horizon, it checks the index arithmetic the engines use (deposit at
``(t + tau) % capacity``, take at ``t % capacity``, capacity ``tau_max +
1``) and turns the ring invariants into checked theorems for the bounded
model:

  * **exactly-once delivery**: every non-dropped deposit is taken exactly
    once, at exactly ``t + tau``;
  * **deposit-before-take ordering**: a ``tau = 0`` message is visible to
    the same step's take (the engines deposit before taking);
  * **no slot aliasing**: two messages never share a live slot unless they
    are due the same step, which is what capacity ``tau_max + 1`` buys.  A
    *negative control* re-runs the prover at capacity ``tau_max`` and must
    find aliasing;
  * **crash / rejoin mass conservation**: `delivery_tensors`' per-kind
    conservation laws over every (crash_step, rejoin_step) assignment for
    ``p <= 4`` workers;
  * **version-ring staleness** (`repro_torch.serve.replica`): for every
    publish/refresh interleaving and lag schedule, the served snapshot is
    the version claimed and lags ``latest`` by at most ``tau_serve``.

Three layers keep each other honest: a *python reference model* (explicit
slot multisets: the spec), a *vectorized numpy prover* (the full
enumeration), and the *port's own implementations* on the same schedule
spaces, on a torch device (the card unless the caller asks for the CPU):
`repro_torch.core.delivery`'s int-slot ring ops, the ones the engines
run (each schedule one row of a slot-leading ring, each row's slot from
`delivery_plan`), `delivery_tensors` under `torch.func.vmap`,
and the real `ParamReplica`.  Worker rings never interact (each worker
deposits only into its own ring), so per-ring exhaustiveness composes to
``p`` workers; the checker enumerates the joint space outright wherever it
stays under the budget.  Findings and statistics are the reference's, key
for key.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.func import vmap

from repro_torch.analysis.findings import Finding, Report
from repro_torch.core import delivery as DLV
from repro_torch.core.delivery import DROPPED

#: Joint-enumeration budget: above this many schedules the checker switches
#: from the joint product space to per-ring exhaustion (sound by worker-ring
#: independence, which `check_worker_ring_independence` witnesses).
JOINT_LIMIT = 600_000


def _f(rule: str, where: str, detail: str) -> Finding:
    return Finding(pass_name="rings", rule=rule, where=where, detail=detail)


# ---------------------------------------------------------------------------
# layer 1: python reference model (the spec, executable)
# ---------------------------------------------------------------------------

def simulate_ring_model(taus, cap: int) -> dict:
    """Explicit slot-multiset simulation of one delivery ring.

    Returns {"delivered": {produce_step: deliver_step}, "violations": [...]}
    — the reference the vectorized prover is checked against.
    """
    horizon = len(taus)
    slots = [[] for _ in range(cap)]      # slot -> [(produced, due)]
    delivered: dict = {}
    violations = []
    for t in range(horizon):
        tau = taus[t]
        if tau != DROPPED:                # deposit before take (engine order)
            due = t + tau
            slot = due % cap
            for (_, other_due) in slots[slot]:
                if other_due != due:
                    violations.append(
                        f"alias@t={t}: slot {slot} holds due={other_due}, "
                        f"depositing due={due}")
            slots[slot].append((t, due))
        taken, slots[t % cap] = slots[t % cap], []
        for (s, due) in taken:
            if due != t:
                violations.append(f"mistimed: produced@{s} due@{due} "
                                  f"taken@{t}")
            if s in delivered:
                violations.append(f"double-delivery of message {s}")
            delivered[s] = t
    for s, tau in enumerate(taus):
        if tau != DROPPED and s + tau < horizon and s not in delivered:
            violations.append(f"lost: message {s} (tau={tau}) never taken")
    return {"delivered": delivered, "violations": violations}


# ---------------------------------------------------------------------------
# layer 2: vectorized prover (full enumeration)
# ---------------------------------------------------------------------------

def enumerate_schedules(tau_max: int, horizon: int, rings: int = 1,
                        crashes: bool = True) -> np.ndarray:
    """Every tau assignment: (N, horizon, rings) int8 over
    {DROPPED, 0..tau_max} (or {0..tau_max} with ``crashes=False``)."""
    vals = ([DROPPED] if crashes else []) + list(range(tau_max + 1))
    cols = horizon * rings
    grids = np.meshgrid(*([np.asarray(vals, np.int8)] * cols),
                        indexing="ij")
    flat = np.stack([g.reshape(-1) for g in grids], axis=1)
    return flat.reshape(-1, horizon, rings)


@dataclass
class RingCheckResult:
    n_schedules: int = 0
    n_messages: int = 0
    findings: list = field(default_factory=list)


def prove_ring_schedules(taus: np.ndarray, cap: int,
                         where: str) -> RingCheckResult:
    """Vectorized proof over a (N, H, R) schedule tensor for rings of
    capacity ``cap``: exactly-once at ``t + tau``, no cross-due slot
    aliasing, conservation ``delivered + in_flight + dropped == H*R``."""
    n, horizon, rings = taus.shape
    res = RingCheckResult(n_schedules=n)
    t = np.arange(horizon).reshape(1, horizon, 1)
    valid = taus != DROPPED
    due = np.where(valid, t + taus, -1)
    res.n_messages = int(valid.sum())

    # delivery step realized by take-at-(t % cap): the first t' >= t with
    # t' ≡ due (mod cap) — equals due iff the message fits the capacity
    deliv = t + (due - t) % cap
    bad = valid & (deliv != due)
    if bad.any():
        res.findings.append(_f(
            "mistimed-delivery", where,
            f"{int(bad.any(axis=(1, 2)).sum())}/{n} schedules deliver a "
            f"message at a step other than t+tau (capacity {cap})"))

    # slot aliasing: messages produced at t1 < t2 in the same ring whose
    # dues differ but share a slot while both are live (t2 <= due1 — msg1
    # is only removed by the take at its due step)
    d1 = due[:, :, None, :]               # (N, t1, 1, R)
    d2 = due[:, None, :, :]               # (N, 1, t2, R)
    v1 = valid[:, :, None, :]
    v2 = valid[:, None, :, :]
    t1 = t.reshape(1, horizon, 1, 1)
    t2 = t.reshape(1, 1, horizon, 1)
    alias = (v1 & v2 & (t1 < t2) & (t2 <= d1)
             & (d1 % cap == d2 % cap) & (d1 != d2))
    if alias.any():
        res.findings.append(_f(
            "slot-alias", where,
            f"{int(alias.any(axis=(1, 2, 3)).sum())}/{n} schedules alias a "
            f"live slot across different delivery steps (capacity {cap})"))

    # conservation: every message is delivered in-horizon, still in flight
    # (due beyond the horizon), or explicitly dropped — mass never vanishes
    delivered = valid & (due < horizon) & (deliv == due)
    in_flight = valid & (due >= horizon)
    dropped = ~valid
    total = delivered.sum() + in_flight.sum() + dropped.sum()
    if int(total) != n * horizon * rings:
        res.findings.append(_f(
            "mass-leak", where,
            f"delivered+in_flight+dropped = {int(total)} != "
            f"{n * horizon * rings} messages"))
    return res


# ---------------------------------------------------------------------------
# layer 3: the port's ring ops as ground truth
# ---------------------------------------------------------------------------

def ring_deliveries(taus: np.ndarray, cap: int, device="cuda") -> np.ndarray:
    """Drive `repro_torch.core.delivery`'s int-slot ring ops, the ones the
    engines run, over a (B, H) schedule batch on ``device``: schedule ``b``
    is row ``b`` of a slot-leading (cap, B, H) ring, `delivery_plan`
    routes every row's message of step ``t`` (weight 0 if DROPPED), each
    slot ``s`` takes one deposit of the payloads routed to it (``+0.0``
    elsewhere) and the step then takes slot ``t % cap``.  Returns the
    (B, H, H) delivery matrix ``out[b, t, s] = 1`` iff schedule b delivers
    message s at step t."""
    n, horizon = taus.shape
    dev = torch.device(device)
    table = np.ascontiguousarray(np.asarray(taus, np.int32).T)   # (H, B)
    rings = DLV.ring_init(cap, (n, horizon), device=dev)
    out = torch.empty((n, horizon, horizon), dtype=torch.float32, device=dev)
    payload = torch.zeros((n, horizon), dtype=torch.float32, device=dev)
    for t in range(horizon):
        w_live, slots = DLV.delivery_plan(table, t, cap)
        payload.zero_()
        payload[:, t] = torch.from_numpy(w_live).to(dev)
        slots = torch.from_numpy(slots).to(dev)
        for s in range(cap):
            DLV.ring_deposit(rings, s, payload * (slots == s)[:, None])
        out[:, t], _ = DLV.ring_take(rings, t % cap)
    return out.cpu().numpy()


def check_ground_truth(taus: np.ndarray, cap: int, where: str,
                       device="cuda") -> list:
    """The port's ring ops vs the closed-form delivery law, whole batch at
    once."""
    n, horizon = taus.shape
    got = ring_deliveries(taus, cap, device)
    t = np.arange(horizon)
    due = t[None, :] + np.maximum(taus, 0)
    expect = np.zeros((n, horizon, horizon), np.float32)
    s_idx, b_idx = np.meshgrid(t, np.arange(n), indexing="xy")
    ok = (taus != DROPPED) & (due < horizon)
    expect[b_idx[ok], due[ok], s_idx[ok]] = 1.0
    if not np.array_equal(got, expect):
        n_bad = int((got != expect).any(axis=(1, 2)).sum())
        return [_f("torch-divergence", where,
                   f"repro_torch.core.delivery ring ops diverge from the "
                   f"proven delivery law on {n_bad}/{n} schedules")]
    return []


def single_ring_deliveries(taus_row, cap: int, device="cuda") -> np.ndarray:
    """One worker's ring alone, through the int-slot ring ops as the
    densified engine drives each worker's ``buf`` (`ring_init`, deposit
    at ``(t + tau) % cap``, take at ``t % cap``): its (H, H) deliveries."""
    horizon = len(taus_row)
    ring = DLV.ring_init(cap, (horizon,), device=torch.device(device))
    out = []
    for t in range(horizon):
        tau = int(taus_row[t])
        onehot = torch.zeros((horizon,), device=ring.device)
        onehot[t] = float(tau != DROPPED)
        DLV.ring_deposit(ring, (t + max(tau, 0)) % cap, onehot)
        out.append(DLV.ring_take(ring, t % cap)[0])
    return torch.stack(out).cpu().numpy()


def check_worker_ring_independence(p: int, tau_max: int, horizon: int,
                                  seed: int = 0, device="cuda") -> list:
    """Witness that per-worker rings do not interact: drive the ring ops
    with all p workers in one slot-leading ``(cap, p, H)`` ring on a
    random joint schedule and check every worker's deliveries match its
    OWN single-ring run through the int-slot ops."""
    rng = np.random.default_rng(seed)
    joint = rng.integers(DROPPED, tau_max + 1, size=(p, horizon))
    cap = tau_max + 1
    per_worker = np.stack([single_ring_deliveries(row, cap, device)
                           for row in joint])                 # (p, H, H)
    got = ring_deliveries(joint, cap, device)
    if not np.array_equal(got, per_worker):
        return [_f("worker-coupling", f"async-buf/p{p}",
                   "worker-dim ring deliveries differ from independent "
                   "single-ring runs — rings interact")]
    return []


# ---------------------------------------------------------------------------
# gradient delivery rings: full check
# ---------------------------------------------------------------------------

def check_gradient_rings(tau_max: int, p: int, horizon: int, *,
                         ground_truth: bool = True, device="cuda") -> tuple:
    """All three layers for the bounded-staleness gradient rings at one
    (tau_max, p, horizon) point.  Returns (findings, stats)."""
    cap = tau_max + 1
    where = f"delivery-ring/tau{tau_max}/p{p}/H{horizon}"
    findings: list = []

    joint_size = (tau_max + 2) ** (horizon * p)
    if joint_size <= JOINT_LIMIT:
        taus = enumerate_schedules(tau_max, horizon, rings=p)
        mode = "joint"
    else:
        # per-ring exhaustion; composes by ring independence (witnessed)
        taus = enumerate_schedules(tau_max, horizon, rings=1)
        mode = "per-ring"
        findings += check_worker_ring_independence(p, tau_max, horizon,
                                                   device=device)
    res = prove_ring_schedules(taus, cap, where)
    findings += res.findings

    # the python reference model must agree with the prover (spec vs proof)
    flat = taus.reshape(taus.shape[0], -1)
    stride = max(1, flat.shape[0] // 512)
    for row in flat[::stride]:
        for r in range(taus.shape[2]):
            model = simulate_ring_model(list(row[r::taus.shape[2]]), cap)
            if model["violations"]:
                findings.append(_f(
                    "model-divergence", where,
                    f"reference model violations on a prover-clean "
                    f"schedule: {model['violations'][0]}"))
                break

    if ground_truth:
        single = (taus[:, :, 0] if mode == "joint"
                  else taus.reshape(-1, horizon))
        stride = max(1, single.shape[0] // 4096)
        findings += check_ground_truth(single[::stride], cap, where, device)

    stats = {"mode": mode, "schedules": res.n_schedules,
             "messages": res.n_messages, "capacity": cap}
    return findings, stats


def check_negative_control(tau_max: int, horizon: int) -> list:
    """The prover must FIND aliasing at capacity ``tau_max`` (one slot
    short) — otherwise the checker itself is broken."""
    if tau_max < 1:
        return []
    taus = enumerate_schedules(tau_max, horizon, rings=1, crashes=False)
    res = prove_ring_schedules(taus, tau_max,
                               f"negative-control/tau{tau_max}")
    if not any(f.rule in ("slot-alias", "mistimed-delivery")
               for f in res.findings):
        return [_f("toothless-checker", f"negative-control/tau{tau_max}",
                   f"capacity {tau_max} (one short) produced no aliasing "
                   f"finding — the prover has lost its teeth")]
    return []


# ---------------------------------------------------------------------------
# crash / rejoin mass conservation (delivery_tensors)
# ---------------------------------------------------------------------------

def _conservation_violations(kind: str, u: np.ndarray, alive: np.ndarray,
                             where: str) -> list:
    """The per-kind conservation laws of `delivery_tensors`, batched over a
    leading config axis: u (B, T, 1+p, p), alive (B, T, p)."""
    findings = []
    in_recv = u[:, :, 0, :]
    if not np.all((in_recv == 0) | (in_recv == 1)):
        findings.append(_f("x-row-weight", where,
                           "x applies some gradient with weight not in "
                           "{0, 1}"))
    rows = u[:, :, 1:, :]
    if np.any(rows[~alive] != 0):
        findings.append(_f("dead-row-mass", where,
                           "a dead worker's view row carries mass"))
    row_sums = rows.sum(axis=3)
    expect = in_recv.sum(axis=2)[:, :, None]
    if kind == "crash_subst":
        bad = alive & ~np.isclose(row_sums,
                                  np.broadcast_to(expect, row_sums.shape))
        if bad.any():
            findings.append(_f(
                "mass-not-conserved", where,
                f"substitution fails to conserve mass in "
                f"{int(bad.any(axis=(1, 2)).sum())}/{u.shape[0]} configs"))
    else:
        if np.any(row_sums > expect + 1e-6):
            findings.append(_f("mass-created", where,
                               "crash without substitution creates mass"))
    return findings


def check_crash_rejoin_conservation(p: int, t_steps: int,
                                    chunk: int = 8192,
                                    device="cuda") -> tuple:
    """Enumerate EVERY (crash_step, rejoin_step) assignment for ``p``
    workers over ``t_steps`` steps — crash at any step or never; rejoin at
    any later step or never — against both hear-patterns (all crashing
    broadcasts heard / none), for both crash kinds.  One vmapped
    `delivery_tensors` call per chunk on ``device``; numpy checks the
    laws."""
    dev = torch.device(device)
    findings: list = []
    never_c, never_r = t_steps, 2 * t_steps
    pairs = [(c, r) for c in range(t_steps + 1)
             for r in (range(c + 1, t_steps + 1) if c < t_steps else [])] \
        + [(never_c, never_r)]
    pairs += [(c, never_r) for c in range(t_steps)]       # crash, never rejoin
    combos = np.asarray(list(itertools.product(pairs, repeat=p)),
                        np.int32)                          # (B, p, 2)
    crash = torch.from_numpy(np.ascontiguousarray(combos[:, :, 0])).to(dev)
    rejoin = torch.from_numpy(np.ascontiguousarray(combos[:, :, 1])).to(dev)
    n_cfg = 0
    for kind in ("crash", "crash_subst"):
        where = f"delivery-tensors/{kind}/p{p}/T{t_steps}"
        fn = vmap(lambda cs, rs, hu, kind=kind: DLV.delivery_tensors(
            kind, p, t_steps, {},
            {"crash_step": cs, "rejoin_step": rs, "hear_u": hu}, {},
            device=dev))
        for hear in (0.0, 1.0):
            # hear_u[j, i] < 0.5 == receiver i hears j's crashing broadcast
            hu = torch.full((p, p), hear, device=dev)
            for lo in range(0, len(combos), chunk):
                cs, rs = crash[lo:lo + chunk], rejoin[lo:lo + chunk]
                u, alive = fn(cs, rs, hu.expand(cs.shape[0], p, p))
                findings += _conservation_violations(
                    kind, u.cpu().numpy(), alive.cpu().numpy(), where)
                n_cfg += cs.shape[0]
                if findings:
                    break
    return findings, {"configs": n_cfg, "pairs_per_worker": len(pairs)}


# ---------------------------------------------------------------------------
# version ring (serving replica)
# ---------------------------------------------------------------------------

def simulate_replica_model(ops, tau_serve: int) -> list:
    """Reference model of `repro_torch.serve.replica.ParamReplica`'s
    arithmetic.

    ``ops`` is a sequence of ("publish",) / ("refresh", lag) rounds.  The
    model tracks which version each slot holds and checks: the served slot
    holds exactly ``serving_version``; ``0 <= latest - serving <=
    tau_serve`` at every read; serving never moves backwards.
    """
    cap = tau_serve + 1
    slot_holds = {0: 0}                    # slot -> version last written
    latest = serving = 0
    prev_serving = 0
    violations = []
    for op in ops:
        if op[0] == "publish":
            latest += 1
            slot_holds[latest % cap] = latest
            serving = max(serving, latest - tau_serve)
        else:
            lag = min(op[1], tau_serve)
            serving = max(serving, latest - lag, 0)
        if not 0 <= latest - serving <= tau_serve:
            violations.append(f"staleness {latest - serving} outside "
                              f"[0, {tau_serve}] after {op}")
        if serving < prev_serving:
            violations.append(f"serving moved backwards after {op}")
        prev_serving = serving
        if slot_holds.get(serving % cap) != serving:
            violations.append(
                f"slot {serving % cap} holds version "
                f"{slot_holds.get(serving % cap)} but serving={serving}")
    return violations


def check_replica_ring(tau_serve: int, horizon: int, *,
                       real_runs: int = 512, device="cuda") -> tuple:
    """Enumerate every publish/refresh interleaving x lag schedule up to
    ``horizon`` rounds through the model, then drive the real
    `ParamReplica` on ``device`` (params = the version number itself, so
    the served value IS the served version) on up to ``real_runs`` of
    them."""
    from repro_torch.serve.replica import ParamReplica

    dev = torch.device(device)
    where = f"version-ring/tau{tau_serve}/H{horizon}"
    findings: list = []
    round_opts = [("publish",)] + [("refresh", lag)
                                   for lag in range(tau_serve + 1)] \
        + [("refresh", DROPPED)]
    all_runs = list(itertools.product(round_opts, repeat=horizon))
    for ops in all_runs:
        ops = [("refresh", tau_serve) if o == ("refresh", DROPPED) else o
               for o in ops]
        v = simulate_replica_model(ops, tau_serve)
        if v:
            findings.append(_f("version-ring-model", where, v[0]))
            break

    stride = max(1, len(all_runs) // real_runs)
    checked = 0
    for ops in all_runs[::stride]:
        lags = [o[1] for o in ops if o[0] == "refresh"] or [0]
        rep = ParamReplica({"v": torch.zeros((), device=dev)}, tau_serve,
                           lags=lags)
        model_serving = 0
        latest = 0
        for op in ops:
            if op[0] == "publish":
                latest += 1
                rep.publish({"v": torch.full((), float(latest),
                                             device=dev)})
            else:
                rep.refresh()
            got = float(rep.serving_params()["v"])
            if not (latest - tau_serve <= got <= latest and
                    got == rep.serving_version and
                    got >= model_serving):
                findings.append(_f(
                    "version-ring-real", where,
                    f"ParamReplica served version {got} (serving="
                    f"{rep.serving_version}, latest={latest}) after {op}"))
                break
            model_serving = got
        checked += 1
        if any(f.rule == "version-ring-real" for f in findings):
            break
    return findings, {"interleavings": len(all_runs), "real_runs": checked}


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def run(max_p: int = 4, max_tau: int = 3, *, fast: bool = False,
        device="cuda") -> Report:
    """The full ring-checking pass, its layer 3 on ``device``.  ``fast``
    trims the deepest spaces and skips the ring-op ground truth, as the
    reference's does."""
    rep = Report()
    stats: dict = {}

    grid = [(tau, p) for tau in range(0, max_tau + 1)
            for p in (1, 2, max_p) if p <= max_p]
    for tau_max, p in sorted(set(grid)):
        if fast and (tau_max > 2 or p > 2):
            continue
        horizon = max(4, 2 * (tau_max + 1))
        f, s = check_gradient_rings(tau_max, p, horizon,
                                    ground_truth=not fast, device=device)
        rep.findings += f
        stats[f"delivery/tau{tau_max}/p{p}"] = s
    for tau_max in (1, 2) if fast else (1, 2, 3):
        rep.findings += check_negative_control(tau_max,
                                               2 * (tau_max + 1))
    for p in (2,) if fast else (2, 3, 4):
        if p > max_p:
            continue
        f, s = check_crash_rejoin_conservation(p, 4, device=device)
        rep.findings += f
        stats[f"conservation/p{p}"] = s
    for tau_serve in (0, 1, 2) if fast else (0, 1, 2, 3):
        horizon = 4 if tau_serve >= 2 else 5
        f, s = check_replica_ring(tau_serve, horizon,
                                  real_runs=64 if fast else 512,
                                  device=device)
        rep.findings += f
        stats[f"version-ring/tau{tau_serve}"] = s
    rep.info["rings"] = stats
    return rep
