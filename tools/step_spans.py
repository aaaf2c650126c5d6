#!/usr/bin/env python3
"""Where a benchmark cell's training step spends its host and device time,
span by span, from the program's own ``step.*`` and ``wait.*`` spans
(`repro_torch.trace`), and what the spans cost under a profiler.

    python3 tools/step_spans.py [--cells qwen3-async-topk,mixtral-topk-ef]
        [--seed 7] [--steps 3] [--cost-steps 3] [--out FILE]

On the card only.  For each cell it builds the benchmark's program
(`perfbench.harness.Program`), runs the benchmark's set-up steps, then
traces ``--steps`` steps with the host's operations and the device's
activity (after one warm-up step of the profiler, as the benchmark's
traced span does).  Per span name, a step: host ms, calls, kernel
launches (runtime launch calls whose start lies in the span's host
interval, on any thread: autograd launches the backward from its own),
device ms (the device activity those runtime calls enqueued, matched by
correlation id) and device idle ms (the device's idle gaps, by their
overlap with the span's host interval, to be read only where the trace's
device clock drifts little from its host clock, which it prints); and the benchmark's readers of
the spans (and ``k1_roofline_pct``) on the same trace, with each device
ms reader's difference from the span's sum by correlation id
(``readers_off_ms``: 0 where `perfbench.spans` paired every operation with
its own call).  Two checks: the launches inside ``bench.step``
outside every ``step.*`` span, and the synchronizing runtime calls inside
``bench.step`` against the ``wait.*`` spans.  Last, the host-traced step's host ms with the spans on and off
(``trace.span`` replaced by the null context), in turns (none at
``--cost-steps 0``).  Before the
cells, the host cost of one span with no profiler and under one.  Prints
one JSON object for that and one a cell, and writes them all to
``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench.spans import inside  # noqa: E402

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
READERS = ("compress_ms_per_step", "deliver_ms_per_step", "gap_ms_per_step",
           "update_ms_per_step", "compress_roofline_pct", "k1_roofline_pct",
           "model_launches_per_step", "host_waits_per_step",
           "host_wait_ms_per_step")


def _profile(prog, stream, first: int, steps: int):
    """The profile of ``steps`` steps traced with the host's operations
    and the device's activity, after one warm-up step of the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.profiler import schedule as sched

    from perfbench import harness
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched(wait=0, warmup=1, active=steps,
                                repeat=1)) as prof:
        for j in range(steps + 1):
            with record_function("bench.batch"):
                batch = harness.to_device(stream.batch(first + j),
                                          prog.device)
            with record_function("bench.step"):
                prog(batch)
            if j in (0, steps):
                torch.cuda.synchronize()
            prof.step()
    return prof


def _union(intervals) -> list:
    """Sorted disjoint (start, end) covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def _overlap(a, b) -> float:
    """Length of the intersection of two unions."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def table(events, steps: int) -> dict:
    """The per-span table and the two checks of one traced span."""
    import torch
    cpu_t = torch.autograd.DeviceType.CPU
    host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.correlation_id()) for e in events
            if e.device_type() == cpu_t]
    spans = {}
    for name, s, e, _ in host:
        if name.startswith(("step.", "wait.", "bench.step")):
            spans.setdefault(name, []).append((s, e))
    calls_of = {name: len(iv) for name, iv in spans.items()}
    spans = {name: _union(iv) for name, iv in spans.items()}
    dev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
            e.correlation_id()) for e in events
           if e.device_type() != cpu_t and not e.is_user_annotation()
           and e.name() not in spans
           and not e.name().startswith(("ProfilerStep", "bench."))]
    calls = {c: s for name, s, _, c in host if name.startswith("cu")}
    launches = sorted(s for name, s, _, _ in host
                      if name.startswith(LAUNCHES))
    syncs = [s for name, s, _, _ in host if name in SYNCS
             or name.endswith("Synchronize")]
    steps_iv = spans.get("bench.step", [])
    lo, hi = min(s for s, _ in steps_iv), max(e for _, e in steps_iv)
    busy = []
    for _, s, e, _ in sorted(dev, key=lambda d: d[1]):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    gaps = [(max(a[1], lo), min(b[0], hi)) for a, b in zip(busy, busy[1:])
            if a[1] < hi and b[0] > lo]     # sorted and disjoint
    ms = 1e-6 / steps

    def row(name, intervals):
        return {"calls": calls_of[name] / steps,
                "host_ms": sum(e - s for s, e in intervals) * ms,
                "launches": sum(inside(t, intervals) for t in launches)
                / steps,
                "device_ms": sum(e - s for _, s, e, c in dev
                                 if c in calls
                                 and inside(calls[c], intervals)) * ms,
                "idle_ms": _overlap(gaps, intervals) * ms}

    rows = {name: row(name, iv) for name, iv in sorted(spans.items())}
    phases = _union(iv for name, ivs in spans.items()
                    if name.startswith("step.") for iv in ivs)
    waits = _union(iv for name, ivs in spans.items()
                   if name.startswith("wait.") for iv in ivs)
    in_step = [t for t in launches if inside(t, steps_iv)]
    outside = [t for t in in_step if not inside(t, phases)]
    step_syncs = [t for t in syncs if inside(t, steps_iv)]
    return {
        "rows": rows,
        "launches_in_step": len(in_step) / steps,
        "launches_outside_phases": len(outside) / steps,
        "outside_share_pct": 100.0 * len(outside) / max(1, len(in_step)),
        "sync_calls_in_step": len(step_syncs) / steps,
        "sync_calls_outside_waits": sum(not inside(t, waits)
                                        for t in step_syncs) / steps,
        "wait_spans": sum(calls_of[n] for n in calls_of
                          if n.startswith("wait.")) / steps,
        "device_ms_in_step": sum(e - s for _, s, e, c in dev if c in calls
                                 and inside(calls[c], steps_iv)) * ms,
        "device_ms_unmatched": sum(e - s for _, s, e, c in dev
                                   if c not in calls) * ms,
        "idle_ms_in_step": _overlap(gaps, steps_iv) * ms,
        "idle_ms_in_step_outside_phases":
            (_overlap(gaps, steps_iv) - _overlap(gaps, phases)) * ms,
        "clock_drift_us_per_s": clock_drift(dev, calls),
    }


def clock_drift(dev, calls, parts: int = 10) -> float:
    """How fast the trace's device clock drifts from its host clock, in us
    a second: the slope between the least lags of an operation behind its
    call (ns) in the first and the second half of the trace, each taken
    where the device had gone idle.  Far from 0, the idle gaps' overlap
    with host intervals is not to be read."""
    lags = sorted((calls[c], s - calls[c]) for _, s, _, c in dev
                  if c in calls)
    n = len(lags) // parts
    if n == 0:
        return 0.0
    least = [min(lags[i * n:(i + 1) * n], key=lambda x: x[1])
             for i in range(parts)]
    (t0, a), (t1, b) = (min(least[:parts // 2], key=lambda x: x[1]),
                        min(least[parts // 2:], key=lambda x: x[1]))
    return 1e6 * (b - a) / (t1 - t0)


def span_cost(prog, stream, first: int, steps: int) -> dict:
    """The host-traced span's host ms a step with the spans on and off, in
    turns on, off, off, on, on, off, off, on."""
    from perfbench import harness
    from repro_torch import trace
    real = trace.span
    out = {"on": [], "off": []}
    try:
        for k, mode in enumerate(("on", "off", "off", "on") * 2):
            trace.span = real if mode == "on" else (lambda name: trace._OFF)
            _, secs = harness.trace_span(prog, stream, first
                                         + k * (steps + 1), steps, host=True)
            out[mode].append(secs * 1e3 / steps)
    finally:
        trace.span = real
    return out


def span_unit_cost(n_off: int = 200000, n_on: int = 20000) -> dict:
    """Host cost of entering and leaving one span: with no profiler (ns),
    and under a profiler recording the host's operations and the device's
    activity (us)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace
    t0 = time.perf_counter()
    for _ in range(n_off):
        with trace.span("step.cost"):
            pass
    off = (time.perf_counter() - t0) / n_off
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        for _ in range(n_on):
            with trace.span("step.cost"):
                pass
        on = (time.perf_counter() - t0) / n_on
    return {"off_ns": off * 1e9, "on_us": on * 1e6}


def run(name: str, seed: int, steps: int, cost_steps: int) -> dict:
    import torch
    from perfbench import arch, harness
    from perfbench.traffic.markov import MarkovStream

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.load_cell(name)
    dm, tr = arch.dims(cell["config_file"]), cell["traffic_file"]
    stream = MarkovStream(dm["vocab_size"], tr["seq"], tr["batch"], seed,
                          tr["order_states"])
    prog = harness.Program(cell, seed, device)
    t = harness.checked_steps(tr)
    harness.setup_steps(prog, stream, t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof = _profile(prog, stream, t, steps)
    out = {"cell": name, "seed": seed, "steps": steps,
           **table(prof.profiler.kineto_results.events(), steps)}
    # the benchmark's readers on the same span, as device and host events
    events = prof.events()
    ctx = harness.TraceContext(events, 0.0, events, steps, cell,
                               {"step_ms": [], "steps": 0},
                               prog.leaf_sizes)
    out["readers"] = {m: harness.load_metric(m).read(ctx) for m in READERS}
    # the readers' pairing by order against the correlation ids' (ms)
    out["readers_off_ms"] = {
        m: None if out["readers"][m] is None else
        out["readers"][m] - out["rows"]["step." + m.split("_")[0]]["device_ms"]
        for m in READERS[:4]}
    del prof, events, ctx
    t += steps + 1
    if cost_steps:
        out["span_cost_host_ms"] = span_cost(prog, stream, t, cost_steps)
    out["seconds"] = time.perf_counter() - t0
    prog.free()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="qwen3-async-topk,mixtral-topk-ef")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--cost-steps", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "experiments"
                                         / "step_spans.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("step_spans: no CUDA device")
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "perfbench"
                                                  / ".cache" / "triton"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    results = [{"span_unit_cost": span_unit_cost(), "card": card}]
    print(json.dumps(results[0]), flush=True)
    for name in args.cells.split(","):
        r = run(name, args.seed, args.steps, args.cost_steps)
        r["card"] = card
        print(json.dumps(r), flush=True)
        results.append(r)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
