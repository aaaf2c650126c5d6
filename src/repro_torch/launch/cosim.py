"""Cluster co-simulation CLI (counterpart of ``repro.launch.cosim``): rank
(strategy, tau_max, compressor) candidates by *time*-to-loss on a concrete
cluster shape.

Joins the discrete-event cluster model (`repro_torch.cluster`) with the
convergence simulator (`core.sim_engine.simulate_grid`): the cluster model
prices each candidate's step from its bytes on the wire (golden collective
inventory) and emits the measured ``tau(t, worker)`` table; the
convergence run replays exactly that staleness trace, so steps-to-loss and
time-to-loss come from the same execution history.

Usage:
  python -m repro_torch.launch.cosim --cluster straggler_heavy --p 4 \\
      --out experiments/cosim_straggler.json
  python -m repro_torch.launch.cosim --device cpu --cluster path/to/spec.json

``--cluster`` accepts a preset name (see ``repro_torch.cluster.PRESETS``) or
a path to a ClusterSpec JSON file (`ClusterSpec.save` round-trips).
``--device`` defaults to ``cuda`` (the card; it raises without one) and
``cpu`` runs everything on the host.  ``main(argv, draws=..., report=...)``
takes the gradient noise (`rank_candidates`' hook) and fills ``report``
with the spec, the results and the cluster runs.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.cluster import (DEFAULT_CANDIDATES, PRESETS, ClusterSpec,
                                 preset, rank_candidates, winners)
from repro_torch.launch.train import resolve_device


def load_cluster(name_or_path: str, p: int, steps: int) -> ClusterSpec:
    if os.path.exists(name_or_path):
        return ClusterSpec.load(name_or_path)
    if name_or_path in PRESETS:
        return preset(name_or_path, p=p, steps=steps)
    raise SystemExit(
        f"unknown cluster {name_or_path!r}: not a file, not one of "
        f"{', '.join(PRESETS)}")


def main(argv=None, *, draws=None, report: dict | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.cosim",
        description="rank sync strategies by time-to-loss on a cluster "
                    "shape (discrete-event model x convergence sim)")
    ap.add_argument("--cluster", default="straggler_heavy",
                    help=f"preset ({', '.join(PRESETS)}) or ClusterSpec "
                         f"JSON path")
    ap.add_argument("--p", type=int, default=4,
                    help="workers (presets only; a spec file fixes p)")
    ap.add_argument("--steps", type=int, default=600,
                    help="event-loop horizon (learner steps)")
    ap.add_argument("--flops-per-step", type=float, default=4e8)
    ap.add_argument("--alpha", type=float, default=0.05)
    ap.add_argument("--target-frac", type=float, default=0.01,
                    help="loss target as a fraction of the initial loss")
    ap.add_argument("--seeds", default="0",
                    help="comma-separated convergence seeds (averaged)")
    ap.add_argument("--out", default="",
                    help="write the ranking JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the event loops and the "
                         "simulator (cuda raises without a card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    spec = load_cluster(args.cluster, args.p, args.steps)
    seeds = tuple(int(s) for s in args.seeds.split(",") if s)
    results, runs = rank_candidates(
        spec, t_len=args.steps, flops_per_step=args.flops_per_step,
        alpha=args.alpha, target_frac=args.target_frac, seeds=seeds or (0,),
        device=device, draws=draws)
    win = winners(results)
    if report is not None:
        report.update(spec=spec, results=results, runs=runs, winners=win)

    cand_by_name = {c.name: c for c in DEFAULT_CANDIDATES}
    print(f"cluster {spec.name} (p={spec.p}, {len(spec.events)} events), "
          f"{args.steps} steps, target {args.target_frac:.3g}x initial loss")
    print(f"{'candidate':<26} {'steps':>6} {'time_s':>10} {'step_ms':>9} "
          f"{'wire_B':>10} {'drop':>5}")
    for r in sorted(results, key=lambda r: r.time_to_loss):
        steps = ("-" if not (r.steps_to_loss < float("inf"))
                 else str(int(r.steps_to_loss)))
        marks = "".join(m for m, k in (("S", "steps"), ("T", "time"))
                        if win[k] == r.candidate)
        print(f"{r.candidate:<26} {steps:>6} {r.time_to_loss:>10.2f} "
              f"{r.step_s * 1e3:>9.2f} {r.wire_bytes:>10.0f} "
              f"{r.dropped:>5d} {marks}")
    print(f"winner by steps-to-loss: {win['steps']}")
    print(f"winner by  time-to-loss: {win['time']}")
    if win["steps"] != win["time"]:
        print("-> the rankings DISAGREE: step counts alone would pick the "
              "wrong strategy for this cluster shape")

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        payload = {
            "cluster": json.loads(spec.to_json()),
            "steps": args.steps,
            "flops_per_step": args.flops_per_step,
            "alpha": args.alpha,
            "target_frac": args.target_frac,
            "winners": win,
            "candidates": [{
                "name": r.candidate,
                "strategy": cand_by_name[r.candidate].strategy,
                "sim_kind": cand_by_name[r.candidate].sim_kind,
                "tau_max": cand_by_name[r.candidate].tau_max,
                "steps_to_loss": (r.steps_to_loss
                                  if r.steps_to_loss < float("inf")
                                  else None),
                "time_to_loss_s": (r.time_to_loss
                                   if r.time_to_loss < float("inf")
                                   else None),
                "step_s": r.step_s,
                "wire_bytes": r.wire_bytes,
                "tau_histogram": {str(k): v
                                  for k, v in r.tau_histogram.items()},
                "dropped": r.dropped,
            } for r in results],
        }
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1)
            fh.write("\n")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
