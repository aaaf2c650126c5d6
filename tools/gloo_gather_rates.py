#!/usr/bin/env python3
"""Host rates of two ways to gather rows between two ``gloo`` ranks on one
host: ``torch.distributed.all_gather`` (gloo's ring) and the paired
``isend`` / ``irecv`` messages that ``repro_torch.dist.workers.WorkerGroup``
sends, each rank sending its rows to the other in 64 MiB messages.

    python3 tools/gloo_gather_rates.py [MiB]     # default 512 MiB a rank

Both run on host buffers of ``MiB`` bytes a rank, written once before the
first reading, over a ``FileStore`` in a fresh temporary directory; after
one warm-up each, each is read three times in turns (ring, paired,
paired, ring, ring, paired), and the rate is a rank's bytes sent over the
host clock around the call.  The gathered rows are checked against what
each rank sent.  ``nvidia-smi``'s name and power limit are printed when a
card is present, though no card is used.
"""
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

CHUNK = 1 << 26
# one warm-up each, then three readings each in turns
ORDER = ("ring", "paired", "ring", "paired", "paired", "ring", "ring",
         "paired")


def _paired(rows, rank):
    peer, works = 1 - rank, []
    n = rows.shape[1]
    for tag, a in enumerate(range(0, n, CHUNK)):
        b = min(n, a + CHUNK)
        works.append(dist.isend(rows[rank, a:b], peer, tag=tag))
        works.append(dist.irecv(rows[peer, a:b], peer, tag=tag))
    for work in works:
        work.wait()


def _ring(rows, rank):
    dist.all_gather(list(rows), rows[rank].clone())


def _rank(rank, store, n, out):
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            world_size=2, rank=rank)
    rows = torch.zeros((2, n), dtype=torch.uint8)
    readings = {"ring": [], "paired": []}
    for name in ORDER:
        fn = _ring if name == "ring" else _paired
        rows.zero_()
        rows[rank].fill_(rank + 1)
        dist.barrier()
        t0 = time.perf_counter()
        fn(rows, rank)
        readings[name].append(n / (time.perf_counter() - t0) / 1e9)
        if not (bool((rows[0] == 1).all()) and bool((rows[1] == 2).all())):
            raise RuntimeError(f"{name}: the gathered rows are wrong")
    dist.destroy_process_group()
    if rank == 0:
        out.put(readings)


def main():
    mib = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    if torch.cuda.is_available():
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(f"card: {smi.stdout.strip()} (not used)", flush=True)
    tmp = tempfile.mkdtemp()
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, os.path.join(tmp, "store"),
                                             mib << 20, out))
             for r in range(2)]
    try:
        for p in procs:
            p.start()
        readings = out.get(timeout=600)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    if any(p.exitcode != 0 for p in procs):
        raise SystemExit("a rank failed")
    for name, rates in readings.items():
        # the first of each is the warm-up
        print(f"gloo {name}: {mib} MiB a rank, GB/s a rank "
              f"{[round(x, 3) for x in rates[1:]]} (warm-up "
              f"{rates[0]:.3f})", flush=True)


if __name__ == "__main__":
    main()
