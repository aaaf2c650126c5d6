"""Run one cell of the benchmark of ``repro_torch`` once, on the card.

    python3 perfbench/run.py --workload qwen3-async-topk --seed 7 \\
        --seconds 51 --trace 0

loads and warms up the cell (``perfbench/workloads/<cell>.json``), measures
for ``--seconds``, checks the first steps against the plain reference, and
prints one JSON object as the last line of standard output: ``correct``,
``attempted`` and ``failed`` (the window's steps, and those whose loss was
not finite), ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics, as ``BENCHMARK.json`` lists them), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number
compared with its limit.  The last lines of standard error repeat the
checks.  Without a CUDA card, without ``BENCHMARK.json`` or the program,
or with JAX or the JAX package loaded once the window has closed, it
prints no result and exits non-zero.

Caches stay inside the checkout: the program builds its CUDA libraries in
``src/repro_torch/kernels/_build/`` and Triton caches in
``perfbench/.cache/triton/``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def fail(msg: str, code: int = 2) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def spread(values: list) -> dict:
    """The quartiles and the ends of ``values``, and the values."""
    import statistics
    q = (statistics.quantiles(values, n=4) if len(values) > 1
         else values * 3)
    return {"n": len(values), "min": min(values), "q1": q[0],
            "median": q[1], "q3": q[2], "max": max(values), "all": values}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        fail(f"--seed {args.seed}: a seed is a whole number from 0")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "perfbench" / ".cache"
                                         / "triton")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    spec_path = ROOT / "BENCHMARK.json"
    if not spec_path.exists():
        fail("BENCHMARK.json is missing")
    spec = json.loads(spec_path.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        fail(f"no cell {args.workload!r} in BENCHMARK.json")
    chips = cells[args.workload]["chips"]

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs on the card only", 3)
    if torch.cuda.device_count() < chips:
        fail(f"{args.workload} needs {chips} cards, "
             f"{torch.cuda.device_count()} found", 3)
    torch.set_num_threads(1)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program (repro_torch under src/) cannot be imported: {e}")
    from perfbench import harness

    cell = harness.load_cell(args.workload)
    e2e, layer = harness.cell_metrics(spec, args.workload)
    result = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), T_START,
        metric_names=layer if args.trace else e2e)
    extra = result.pop("_extra")
    bad = sorted(set(extra["bad_modules"] + harness.forbidden_modules()))
    if bad:
        fail("modules of JAX or of the JAX package are loaded: "
             + ", ".join(bad), 4)
    checks = result["checks"]
    print(json.dumps({"phases_s": extra["phases_s"],
                      "step_ms": spread(extra["step_ms"]),
                      "host_ms": {k: spread(v)
                                  for k, v in extra["host_ms"].items()},
                      "allocator_in_window": extra["allocator_in_window"]}),
          file=sys.stderr, flush=True)
    print(json.dumps({"not_compared": extra["not_compared"],
                      "left_out": extra["left_out"],
                      "worst_leaves": extra["worst"],
                      "program": extra["program"],
                      "reference": extra["reference"]}),
          file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
