"""CLI: ``python -m repro_torch.analysis --all`` (counterpart of
``python -m repro.analysis``).

Runs the selected passes (``--lint`` / ``--audit`` / ``--rings``, or
``--all``), diffs the findings against the port's checked-in baseline
(``src/repro_torch/analysis/baseline.json`` by default), prints a human
summary, optionally writes the full findings JSON (``--json``), and exits
nonzero iff there are NEW findings — fingerprints not in the baseline.
``--update-baseline`` rewrites the baseline to accept exactly the current
findings; newly accepted findings must come with ``--justify '...'`` —
the write is refused otherwise, and a baseline carrying an empty/TODO
justification fails the run.

``--device`` (default ``cuda``, as every launcher of the port; it raises
without a card) is where the audit steps and the ring checker's layer 3
run; the tests pass ``--device cpu``.  ``--devices N`` runs the audited
sync and async steps over N in-process workers (the counterpart of the
reference's forced host devices).  ``--no-compile`` skips the in-place
runs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


def _parse(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis: step audit, ring model checker, "
                    "AST lint")
    ap.add_argument("--all", action="store_true", help="run every pass")
    ap.add_argument("--lint", action="store_true")
    ap.add_argument("--audit", action="store_true")
    ap.add_argument("--rings", action="store_true")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="accepted-findings file (missing == empty)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to accept current findings")
    ap.add_argument("--justify", default="",
                    help="justification text for findings newly accepted "
                         "by --update-baseline (refused without one)")
    ap.add_argument("--json", default="",
                    help="write the full findings/inventory JSON here")
    ap.add_argument("--devices", type=int, default=0,
                    help="in-process workers of the audited steps")
    ap.add_argument("--device", default="cuda",
                    help="where the audited steps run (cuda | cpu)")
    ap.add_argument("--no-compile", action="store_true",
                    help="skip the in-place runs")
    ap.add_argument("--fast", action="store_true",
                    help="trimmed ring spaces (bench smoke mode)")
    ap.add_argument("--max-p", type=int, default=4,
                    help="ring checker worker bound (exhaustive <= 4)")
    ap.add_argument("--max-tau", type=int, default=3,
                    help="ring checker staleness bound (exhaustive <= 3)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    import torch

    from repro_torch.analysis.findings import (Report, load_baseline,
                                               unjustified_entries,
                                               write_baseline)

    args = _parse(argv)
    if not (args.all or args.lint or args.audit or args.rings):
        args.all = True
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (pass --device "
                           "cpu to run on the CPU)")

    report = Report()
    timings = {}
    if args.all or args.lint:
        from repro_torch.analysis import lint
        t0 = time.time()
        report.extend(lint.run())
        timings["lint"] = round(time.time() - t0, 1)
    if args.all or args.rings:
        from repro_torch.analysis import rings
        t0 = time.time()
        report.extend(rings.run(max_p=args.max_p, max_tau=args.max_tau,
                                fast=args.fast, device=args.device))
        timings["rings"] = round(time.time() - t0, 1)
    if args.all or args.audit:
        from repro_torch.analysis import audit
        t0 = time.time()
        report.extend(audit.run(
            compile_donation=not args.no_compile,
            data_parallel=max(args.devices, 1), device=args.device))
        timings["audit"] = round(time.time() - t0, 1)
    report.info["timings_s"] = timings

    if args.update_baseline:
        try:
            write_baseline(args.baseline, report.findings,
                           {"*": args.justify} if args.justify else None)
        except ValueError as e:
            print(f"fail: {e}")
            return 1
        print(f"baseline updated: {args.baseline} "
              f"({len(report.findings)} accepted findings)")
        return 0

    baseline = load_baseline(args.baseline)
    new = report.new_findings(baseline)
    todo = unjustified_entries(args.baseline)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(report.to_json(baseline), fh, indent=1, default=str)

    n_base = len(report.findings) - len(new)
    for pass_name, t in timings.items():
        print(f"  {pass_name}: {t}s")
    if "audit" in report.info:
        strat = report.info["audit"]["bytes_on_wire_by_strategy"]
        print("bytes on wire by strategy (the worker group's byte model):")
        for k in sorted(strat, key=strat.get):
            print(f"  {k:24s} {strat[k]:>14.0f}")
    print(f"findings: {len(report.findings)} total, {n_base} baselined, "
          f"{len(new)} NEW")
    for f in new:
        print(f"  NEW {f}")
    for e in todo:
        print(f"  UNJUSTIFIED {e['rule']} {e['where']} "
              f"(fp {e['fingerprint']})")
    if new:
        print(f"fail: {len(new)} finding(s) not in {args.baseline} — fix "
              f"them or justify via --update-baseline --justify '...'")
        return 1
    if todo:
        print(f"fail: {len(todo)} baselined finding(s) without a real "
              f"justification in {args.baseline} — an accepted hazard "
              f"needs a written reason")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
