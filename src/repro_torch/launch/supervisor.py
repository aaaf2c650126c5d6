"""Supervised training: watchdog + restart-from-checkpoint wrapper
(counterpart of ``repro.launch.supervisor``).

Wraps a `repro_torch.launch.train` run in a child process and keeps it
alive through real faults:

  * **heartbeat watchdog** — the trainer's step logs are the heartbeat; if
    no output arrives for ``--heartbeat`` seconds the child is presumed
    wedged and SIGKILLed (then treated like any other crash).
  * **restart with backoff** — a nonzero/killed exit restarts the run with
    seeded-jittered exponential backoff, up to ``--max-restarts`` times.
    The child resumes itself from the latest *valid* checkpoint
    (`repro_torch.checkpoint.latest_step` skips torn ones), so recovery
    needs no supervisor-side state beyond the attempt counter.
  * **fault-plan threading** — ``--fault-plan`` is forwarded to the child
    along with ``--fault-attempt N``, so a plan's ``kill`` events fire only
    on their designated attempt (otherwise a scheduled SIGKILL would
    re-fire forever: every resume replays the steps since the last
    checkpoint, including the kill step).

A child run with ``--ranks N`` is one world: a ``kill`` event fires on
rank 0, the launcher then kills the other ranks and exits non-zero (a
rank also ends itself when its launcher is gone, so the watchdog's kill
takes the world down too), and the restart starts the whole world again,
which resumes from the checkpoint rank 0 wrote with every rank's rows
gathered.

Usage (everything after ``--`` goes to `repro_torch.launch.train`; the
supervisor adds nothing of its own, so on a machine without a card the
child's arguments say ``--device cpu``):

  python -m repro_torch.launch.supervisor --max-restarts 3 \\
      --fault-plan plan.json \\
      -- --device cpu --arch qwen3-1.7b-smoke --steps 24 --sync async \\
         --tau-max 2 --ckpt-dir ckpt --ckpt-every 4

Exit code: the child's final exit code (0 on success), or 1 when the
restart budget is exhausted.
"""
from __future__ import annotations

import argparse
import queue
import subprocess
import sys
import threading
import time

import numpy as np


def _parse(argv=None):
    ap = argparse.ArgumentParser(
        description="watchdog/restart supervisor for "
                    "repro_torch.launch.train")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="restarts after the first attempt (bounded retries)")
    ap.add_argument("--backoff", type=float, default=0.5,
                    help="base backoff seconds (doubles per restart)")
    ap.add_argument("--heartbeat", type=float, default=300.0,
                    help="seconds without child output before SIGKILL")
    ap.add_argument("--fault-plan", default="",
                    help="forwarded to the child with --fault-attempt")
    ap.add_argument("--seed", type=int, default=0,
                    help="backoff jitter RNG (deterministic restarts)")
    ap.add_argument("train_args", nargs=argparse.REMAINDER,
                    help="-- then repro_torch.launch.train arguments")
    return ap.parse_args(argv)


def _pump(proc, out_q):
    """Reader thread: child stdout lines -> queue (the heartbeat source)."""
    for line in proc.stdout:
        out_q.put(line)
    out_q.put(None)                   # EOF marker


def supervise(train_args, *, max_restarts: int = 3, backoff: float = 0.5,
              heartbeat: float = 300.0, fault_plan: str = "",
              seed: int = 0, echo=print) -> int:
    """Run `repro_torch.launch.train` under supervision; returns the exit
    code."""
    rng = np.random.default_rng(seed)
    attempt = 0
    while True:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", *train_args]
        if fault_plan:
            cmd += ["--fault-plan", fault_plan,
                    "--fault-attempt", str(attempt)]
        echo(f"[supervisor] attempt {attempt}: {' '.join(cmd)}", flush=True)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        out_q: queue.Queue = queue.Queue()
        threading.Thread(target=_pump, args=(proc, out_q),
                         daemon=True).start()
        watchdog_fired = False
        while True:
            try:
                line = out_q.get(timeout=heartbeat)
            except queue.Empty:
                echo(f"[supervisor] no heartbeat for {heartbeat:.0f}s — "
                     f"killing wedged child", flush=True)
                proc.kill()
                watchdog_fired = True
                break
            if line is None:
                break
            echo(line.rstrip("\n"), flush=True)
        rc = proc.wait()
        if rc == 0 and not watchdog_fired:
            echo(f"[supervisor] child completed on attempt {attempt}",
                 flush=True)
            return 0
        echo(f"[supervisor] child exited rc={rc}"
             f"{' (watchdog)' if watchdog_fired else ''}", flush=True)
        if attempt >= max_restarts:
            echo(f"[supervisor] restart budget exhausted "
                 f"({max_restarts} restarts)", flush=True)
            return 1
        # jittered exponential backoff: deterministic given --seed
        delay = backoff * (2 ** attempt) * (1.0 + 0.25 * rng.random())
        echo(f"[supervisor] restarting in {delay:.2f}s", flush=True)
        time.sleep(delay)
        attempt += 1


def main(argv=None) -> int:
    args = _parse(argv)
    train_args = args.train_args
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    if not train_args:
        raise SystemExit("no train args: supervisor -- <launch.train args>")
    return supervise(train_args, max_restarts=args.max_restarts,
                     backoff=args.backoff, heartbeat=args.heartbeat,
                     fault_plan=args.fault_plan, seed=args.seed)


if __name__ == "__main__":
    raise SystemExit(main())
