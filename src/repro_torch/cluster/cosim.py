"""Co-simulation: convergence x wall clock, ranked by time-to-loss
(counterpart of ``repro.cluster.cosim``).

The convergence simulator (`core.sim_engine`) answers "what does staleness
do to the loss" in *steps*; the cluster model (`cluster.perf`) answers
"what does a step cost on *this* cluster" in *seconds*.  For each candidate
(strategy, tau_max, compressor) this module

  1. rolls the cluster event loop under the candidate's staleness bound
     and bytes on the wire (from the golden collective inventory: the wire
     each strategy was audited to use),
  2. feeds the measured ``tau(t, worker)`` table into `simulate_grid`
     through its ``schedule_fn`` hook, so the convergence run sees the
     cluster's staleness and not a uniform draw, and
  3. reads time-to-loss off the learner's wall clock at the step where the
     loss first reaches the target.

Steps-to-loss and time-to-loss rank candidates differently as soon as the
cluster is not uniform: congestion makes the dense synchronous wire
expensive enough that a relaxed strategy wins the wall clock while losing
the steps race.  A permanently slow worker bounds every strategy (the
delivery gate still waits for its step ``t - tau_max`` message); bounded
staleness absorbs transient bursts shorter than the tau window and the
compressed wire absorbs link degradation, and the presets of
`cluster.spec` exercise exactly those two effects.

Everything runs on one torch device, the card unless the caller asks for
the CPU: the event loops, the quadratic and the simulator (at the CLI's
d = 32 every group runs unfused, so the ``topk_ef`` candidate's EF rows go
through K1 and ``onebit_ef``'s through K8).  The gradient noise comes from
the problem's generator, or from ``draws=`` (passed to `simulate_grid`).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import compression as C
from repro_torch.core.delivery import DROPPED, taus_to_message_delays
from repro_torch.core.problems import Quadratic
from repro_torch.core.sim_engine import simulate_grid
from repro_torch.core.sim_types import Relaxation, Schedule

from .perf import ClusterRun, simulate_cluster
from .spec import ClusterSpec

#: where the per-strategy audited bytes-on-wire live (read as data)
_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))
INVENTORY_PATH = os.path.join(_ROOT, "tests", "golden",
                              "collective_inventory.json")


@dataclass(frozen=True)
class Candidate:
    """One point in the (strategy, tau_max, compressor) design space.

    ``strategy`` keys the golden collective inventory (bytes on the wire);
    ``sim_kind``/``tau_max``/``compressor`` configure the convergence run.
    Compressed + stale candidates converge as the async kind (staleness
    dominates at these scales; the wire saving is what the cluster model
    prices).
    """
    name: str
    strategy: str
    sim_kind: str = "sync"        # sync | async | ef_comp
    tau_max: int = 0              # cluster staleness bound (0 = BSP)
    compressor: str = ""          # "" | topk | onebit

    def relaxation(self) -> Relaxation:
        if self.sim_kind == "sync":
            return Relaxation(kind="sync")
        if self.sim_kind == "ef_comp":
            # the ratio of the audited elastic/topk_ef entry, so the wire
            # priced by the cluster model and the compression error of the
            # convergence run describe one strategy
            comp = (C.onebit_compressor() if self.compressor == "onebit"
                    else C.topk_compressor(1 / 8))
            return Relaxation(kind="ef_comp", compressor=comp)
        if self.sim_kind == "async":
            # the engine requires per-message delay < relax.tau_max, and
            # the measured table satisfies tau <= cluster tau_max
            return Relaxation(kind="async", tau_max=self.tau_max + 1)
        raise ValueError(f"unknown sim kind {self.sim_kind!r}")


DEFAULT_CANDIDATES = (
    Candidate("sync", "sync", "sync", 0),
    Candidate("topk_ef", "topk_ef", "ef_comp", 0, "topk"),
    Candidate("onebit_ef", "onebit_ef", "ef_comp", 0, "onebit"),
    Candidate("async_tau4", "async_tau4", "async", 4),
    Candidate("async_tau4_topk_ef", "async_tau4_topk_ef", "async", 4,
              "topk"),
)


def load_wire_bytes(path: str = INVENTORY_PATH) -> dict:
    """strategy -> audited bytes on the wire per step, from the golden
    inventory."""
    with open(path) as f:
        inv = json.load(f)
    return {k: float(v["wire_bytes"]) for k, v in inv["strategies"].items()}


@dataclass(frozen=True)
class CosimResult:
    """One (cluster, candidate) cell of the co-simulation."""
    cluster: str
    candidate: str
    steps_to_loss: float          # inf if the target was never reached
    time_to_loss: float           # seconds on this cluster's clock
    step_s: float                 # mean learner step duration
    wire_bytes: float
    tau_histogram: dict
    dropped: int                  # preempted (DROPPED) messages
    # the recorded losses, one row per seed (the port's addition: the
    # reference keeps them inside rank_candidates)
    losses: np.ndarray | None = field(default=None, compare=False,
                                      repr=False)


def _first_crossing(losses: np.ndarray, record_every: int,
                    target: float) -> float:
    hits = np.flatnonzero(np.asarray(losses) <= target)
    return float(hits[0] * record_every) if hits.size else float("inf")


def rank_candidates(spec: ClusterSpec, candidates=DEFAULT_CANDIDATES, *,
                    t_len: int = 600, flops_per_step: float = 4e8,
                    problem=None, alpha: float = 0.05,
                    target_frac: float = 0.01, seeds=(0,),
                    record_every: int = 2, wire_table: dict | None = None,
                    device="cuda", draws=None):
    """Run the full co-simulation on one cluster shape, on ``device`` (the
    problem's, where one is given).

    Returns ``(results, cluster_runs)``: a list of :class:`CosimResult`
    (one per candidate, with its recorded losses) and the per-candidate
    :class:`ClusterRun` (the measured tau tables).  The loss target is
    ``target_frac`` of the initial loss, shared by all candidates.  ``draws(i_problem, p, seed)``
    overrides the gradient noise (`simulate_grid`'s hook).
    """
    wire = wire_table or load_wire_bytes()
    problem = problem or Quadratic(dim=32, cond=8.0, sigma=0.4, seed=0,
                                   device=device)
    candidates = tuple(candidates)
    x0 = np.zeros(problem.dim, np.float32)
    target = target_frac * float(problem.loss(
        torch.from_numpy(x0).to(problem.device)))

    runs: dict[str, ClusterRun] = {}
    for cand in candidates:
        runs[cand.name] = simulate_cluster(
            spec, t_len, cand.tau_max, flops_per_step,
            wire[cand.strategy], device=problem.device)

    relaxations = [cand.relaxation() for cand in candidates]

    def measured_schedule(ir: int, p: int, seed: int):
        cand = candidates[ir]
        if cand.sim_kind != "async":
            return None               # no scheduling randomness to replace
        delays = taus_to_message_delays(runs[cand.name].taus)
        return Schedule(per_step={"delays": delays}, per_run={})

    grid = simulate_grid([problem], relaxations, [spec.p], [alpha], t_len,
                         seeds=tuple(seeds), x0=x0,
                         record_every=record_every,
                         schedule_fn=measured_schedule, draws=draws)

    results = []
    for ir, cand in enumerate(candidates):
        losses = np.stack([np.asarray(grid.results[(0, ir, spec.p, 0, s)]
                                      .losses) for s in seeds])
        steps = np.mean([_first_crossing(row, record_every, target)
                         for row in losses])
        run = runs[cand.name]
        time_s = run.time_at(int(steps)) if np.isfinite(steps) \
            else float("inf")
        results.append(CosimResult(
            cluster=spec.name, candidate=cand.name,
            steps_to_loss=float(steps), time_to_loss=time_s,
            step_s=float(np.diff(run.closes).mean()) if t_len > 1
            else run.total_s,
            wire_bytes=wire[cand.strategy],
            tau_histogram=run.tau_histogram(),
            dropped=int(np.count_nonzero(run.taus == DROPPED)),
            losses=losses))
    return results, runs


def winners(results) -> dict:
    """The argmin candidate under each metric (ties -> first listed)."""
    finite = [r for r in results if np.isfinite(r.steps_to_loss)]
    if not finite:
        return {"steps": None, "time": None}
    return {
        "steps": min(finite, key=lambda r: r.steps_to_loss).candidate,
        "time": min(finite, key=lambda r: r.time_to_loss).candidate,
    }
