"""The readings a cell's limits are set from, on the card at the cell's
own size (not run by the benchmark's runs).

    python3 perfbench/readings.py --workload qwen3-async-topk \\
        --seeds 101,102,103 --control-seeds 101,102,103

For every seed of ``--seeds``: the program's set-up steps against the
plain reference (the lower readings).  For every seed of
``--control-seeds``, the reference put in the program's place: in the
control's lower precision (float8 e4m3 operands where the configuration
states bfloat16), and with faults planted: half of each step's rows
left out, every worker's message but worker 0's lost, and in an async
cell the delay ring's slot not cleared after its take (the upper
readings).  A step that returns its state unchanged reads 1 by the
comparison's measure and needs no run.  Each line printed is one JSON
record; ``--out`` also writes them to a file.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from perfbench import harness
    from perfbench.reference import model
    from perfbench.traffic.markov import MarkovStream

    if not torch.cuda.is_available():
        sys.exit("readings: no CUDA device")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cell = harness.load_cell(args.workload)
    dm, tr = harness.arch.dims(cell["config_file"]), cell["traffic_file"]
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def stream_of(seed):
        return MarkovStream(dm["vocab_size"], tr["seq"], tr["batch"], seed,
                            tr["order_states"])

    def parse(s):
        return [int(x) for x in s.split(",") if x]

    for seed in parse(args.seeds):
        t0 = time.perf_counter()
        stream = stream_of(seed)
        prog = harness.Program(cell, seed, device)
        got = harness.host_readings(
            harness.setup_steps(prog, stream,
                                harness.checked_steps(tr)),
            prog.paths)
        peak = torch.cuda.max_memory_allocated(device)
        prog.free()
        want = harness.reference_readings(cell, seed, stream, device)
        gaps = harness.compare(got, want)
        emit({"cell": args.workload, "kind": "program", "seed": seed,
              **gaps, "peak": peak, "seconds": time.perf_counter() - t0,
              "losses": got["losses"], "ref_losses": want["losses"]})
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    for seed in parse(args.control_seeds):
        stream = stream_of(seed)
        want = harness.reference_readings(cell, seed, stream, device)
        kinds = [("control_fp8", {"quant": model.fp8}),
                 ("fault_half_batch", {"half_batch": True}),
                 ("fault_drop_exchange", {"drop_exchange": True})]
        if tr["sync"] == "async":
            kinds.append(("fault_slot_kept", {"keep_slot": True}))
        for kind, fault in kinds:
            t0 = time.perf_counter()
            got = harness.reference_readings(cell, seed, stream, device,
                                             **fault)
            emit({"cell": args.workload, "kind": kind, "seed": seed,
                  **harness.compare(got, want),
                  "seconds": time.perf_counter() - t0})
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
