#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit, CUDA version) and the
   kernel build, one ``nvcc`` per CUDA source, all started together;
2. every kernel of the training main path against its plain PyTorch
   version at the main path's shapes, timed with CUDA events beside its
   byte bound and the nearest single PyTorch call; ``topk_ef`` (K1) also
   at the small leaves (R = 2,048, 3,584, 57,344; the first and last
   timed beside ``torch.topk`` and the launch floor, the device time of a
   one-element in-place ``add_``), rows off 16 bytes (R = 257, M = 8), and
   two rows whose threshold
   bin overflows the candidate list (an all-zero row with -0.0, and ties),
   its picks bitwise in the documented order and bitwise run to run;
3. a small-input check of the path on the card against the same code on
   the CPU (plain versions), and the smoke model's loss on both;
4. the main path: full-width qwen3-1.7b, ``--sync async --compressor topk
   --topk-ratio 1/16``, EF and overlap on, 2 in-process workers, tau_max 2,
   ``uniform``, seq 256, batch 4, 4 steps, through
   ``repro_torch.launch.train.main``; launch counters are zeroed just
   before and read just after;
5. 2 steps of the same with ``--compressor onebit`` (the one-bit deposit);
6. one more top-k step of the phase-4 configuration under
   ``torch.profiler``: device time by kernel and the device-busy share, and
   at most 5 device kernels a ``topk_ef`` call;
7. the simulator's kernels against their plain versions: ``delivery_step``
   (both bodies) and ``sync_step`` at (p, d) = (8, 32), (16, 512),
   (32, 4096), d = 100 and B = 16 cases at (16, 256) with A shared and
   stacked; ``onebit_ef`` (K8) at the matching (rows, d), (256, 256), its
   routes' edges (R = 2,048 and 2,049 on 8 rows, a cluster's 131,072
   entries and one more) and a row of 2^20 entries, with -0.0 entries
   and an all-zero row, its route logged, and in place on each route;
   ``topk_ef`` at the simulator's (8, 32), k = 8, with ties, its picks in
   the documented order; each run twice (bitwise) and timed beside its
   bound and the launch floor, ``sync_step`` at B = 1 in turns with
   ``torch.addmm``;
8. Table 1 (``bench_table1_bounds.py``'s nine relaxations and shared
   memory, P = 8, d = 32, T = 600) on the card and on the CPU with the same
   draws: card == CPU at the parity tolerances, no VIOLATION;
9. the fused step at ``bench_sim_step_kernel.py``'s sizes (p = 16, d in
   {256, 512}, T = 400, sync and crash_subst; the median of three fused
   runs) against the unfused one, one
   fused run at (32, 4096), the 16-case crash_subst grid through
   ``simulate_grid`` (one ``delivery_step`` launch per step) and a 3-seed
   sync sweep through ``simulate_sweep`` (one ``sync_step`` launch per
   step), a case of each bitwise equal to its single run;
10. Figure 3 (``bench_fig3_variance_bounded.py``: MLP, sync and
    variance-bounded, P = 8, T = 800, seeds 4-7): the accuracy recovers;
    the launch counters are zeroed before phase 8 and read after phase 10;
11. one fused and one unfused crash_subst simulator run and one fused sync
    run under ``torch.profiler``;
12. ``swa_decode_attention`` (K9) against its plain version: the serving
    path's shape (4 slots, 8 kv heads of 128, 4 query heads each, T =
    4112 keys = 257 pages of 16, window 4096) and T = 128, 512, 1000 and
    8192, with rows whose window slid, rows with most keys beyond the
    query and a row with no live key; the profiled decode step's rows (4
    rows of about 503 live keys of 4112); G = 1, 8, 16; D = 64, 256; a
    window of 12 keys; bf16 and f32; each case twice (bitwise), each
    element within one bf16 rounding step of the plain version, and timed
    beside the bound of the bytes its live keys need and, in turns,
    ``scaled_dot_product_attention`` with the same mask;
13. the paged serving steps on small inputs, card against CPU
    (``mixtral-8x7b-smoke`` and a qwen3 smoke with a window of 96, page
    32), teacher-forced, on the logits;
14. the serving path: full-width mixtral-8x7b cut to 24 of its 32 layers,
    six requests (prompts of 4600 to 100 tokens) over 4 slots, page 16,
    32 tokens each, greedy, through ``repro_torch.launch.serve.main``;
    launch counters zeroed just before and read just after (K9 once per
    layer per decode step);
15. one steady decode step of that engine under ``torch.profiler``;
16. ``ssd_chunked`` (K10) against its plain version: the hybrid serving
    path's shape (batch 4, T 4096, 64 heads of 112, N 64) in bf16 and f32,
    the same at batch 1 (phase 19's prefill), T = 128, hd 64 with N 32,
    hd = N = 128, hd 40 with N 24 (off the 16-wide tiles), T = 8 with
    hd = N = 16, no decay and decays near -20; each case twice (bitwise),
    within the stated limits; the path's shape in bf16 and f32, and batch
    1 in bf16, timed beside their bound;
17. zamba2-7b-smoke's prefill and decode steps on the card against the
    CPU: 2 layers in bf16, and 7 layers with the shared block every 3 in
    f32 (bf16 logged);
18. the hybrid serving path: full-width, full-depth zamba2-7b (81 Mamba2
    layers, the shared attention block 14 times), batch 4, prompt 4096, 32
    tokens, greedy, through ``repro_torch.launch.serve.main`` (``--engine
    loop``); launch counters zeroed just before and read just after (K10
    once per Mamba2 layer of the prefill);
19. one batch-1 prefill of that model and one decode step after it, each
    under ``torch.profiler``;
20. the synchronous sync's reduces against their plain versions:
    ``topk_cr_reduce`` (K4) at the path's panels (S = 2 ``topk_ef``
    payloads, M = 1, R of ``w_gate`` and of ``wk``, k = R/16, values in
    bf16 and in f32), S = 4 messages sharing every index, and M = 24, R =
    257, k = 1 with a zero weight and an ``inf`` under a zero weight; on
    its segment route (payloads in K1's order) and, with message 1's
    picks shuffled, its atomic route, the route read back and logged;
    ``onebit_cr_reduce`` (K5) at the same panels with one-bit payloads;
    each case twice (bitwise, and bitwise against the plain version), and
    timed beside its bound (K4 also beside ``index_put_``, and on its
    atomic route);
21. qwen3-1.7b-smoke with 2 workers, 2 steps of each of ``--sync
    topk_ef``, ``onebit_ef`` and ``elastic`` on the card against the same
    code on the CPU: the sync/update half fed the same gradients, and the
    whole step's losses;
22. the synchronous path: full-width qwen3-1.7b, ``--sync topk_ef
    --topk-ratio 1/16``, 2 workers, seq 256, batch 4, 4 steps through
    ``repro_torch.launch.train.main`` (exactly 104 ``topk_ef`` and 52
    ``topk_cr_reduce`` launches), then 2 steps of ``--sync onebit_ef``
    (26 ``onebit_cr_reduce``) and 2 of ``--sync elastic``; launch counters
    zeroed just before each run and read just after;
23. one ``topk_ef`` sync step under ``torch.profiler`` (at most 5 device
    kernels a ``topk_ef`` call; K4's kernels a call logged, as K2's in
    phase 6);
24. small inputs, card against CPU: ``rwkv6-1.6b-smoke`` and gemma3's
    grouped stack (``gemma3-27b-smoke`` with 7 layers, every third global,
    window 32): forward, prefill of 128 and 4 decode steps, in f32 compute
    and bf16; ``rwkv6-1.6b-smoke`` with 2 workers through phase 3's and
    phase 21's checks: one async top-k delivery and one ``--sync
    topk_ef`` step fed the same gradients, the model's loss and a whole
    ``topk_ef`` step's loss;
25. RWKV6 training at full width: ``rwkv6-1.6b`` (24 layers, d 2048, d_ff
    7168, vocab 65,536; 19 leaves), seq 256, batch 4, 2 workers, through
    ``repro_torch.launch.train.main``: 2 steps of ``--sync async
    --compressor topk`` (exactly 76 ``topk_ef`` and 38
    ``topk_cr_deposit`` launches), then 2 of ``--sync topk_ef`` (76
    ``topk_ef`` and 38 ``topk_cr_reduce``); counters zeroed just before
    each run and read just after, the peak memory under 0.90 of the card;
26. one RWKV6 async step under ``torch.profiler``, the kernels launched
    inside the ``wkv6_chunked`` range grouped apart;
27. RWKV6 serving at full width through ``--engine loop``: batch 4, prompt
    4096, 32 tokens, greedy;
28. gemma3-27b serving at full width and depth (62 layers, 5 local with
    window 1024 to 1 global) through ``--engine loop``: batch 1, prompt
    2048, 16 tokens, greedy; phases 27 and 28 launch no kernel of the
    port, check every step's logits finite and log prefill seconds,
    decode steps/s and the peak memory, then profile the model's prefill
    and one decode step (device time by group, busy share);
29. small inputs, card against CPU: ``moonshot-v1-16b-a3b-smoke``,
    ``grok-1-314b-smoke``, ``internvl2-2b-smoke`` and
    ``musicgen-large-smoke`` (on a ``synthetic_batch`` of 2 x 64 with the
    stubs' embeddings: forward logits and aux, prefill and 4 decode
    steps), in f32 compute and bf16;
    ``zamba2-7b-smoke`` with 2 workers through phase 3's and phase 21's
    checks (one fed async top-k delivery, one ``topk_ef`` step, its whole
    step through K10 under autograd); K10 under autograd at zamba2
    training's shape (2, 256, 64 heads of 112, N 64) in bf16: the forward
    bitwise the no-grad launch, the gradients against ``ssd_plain``'s;
30. moonshot-v1-16b-a3b training at full width, cut to 2 of its 48 layers
    (13 leaves, 1,812.2 M entries; ``w_gate``, ``w_up``, ``w_down``
    369,098,752 each) through ``repro_torch.launch.train.main(argv,
    cfg=...)``: 2 async top-k steps at tau_max 1 (exactly 52 ``topk_ef``
    and 26 ``topk_cr_deposit``), 2 ``--sync topk_ef`` steps (52 and 26
    ``topk_cr_reduce``), a profiled ``topk_ef`` step with the
    ``moe_dispatch`` range grouped apart;
31. zamba2-7b training at full width, cut to 12 of its 81 layers (the
    shared block twice; 27 leaves): 2 async top-k steps at tau_max 2
    (exactly 108 ``topk_ef``, 54 ``topk_cr_deposit``, 48
    ``ssd_chunked``: K10 once a Mamba2 layer a worker a step, in the
    forward only), 2 ``topk_ef`` steps (108, 54 ``topk_cr_reduce``, 48),
    a profiled async step;
32. serving at full width through ``repro_torch.launch.serve.main``:
    moonshot-v1-16b-a3b at full depth and grok-1-314b cut to 6 of 64
    layers through ``--engine continuous`` with phase 14's six prompts
    (full attention: no kernel of the port), a profiled moonshot decode
    step with the ``attend_full`` range grouped apart; internvl2-2b (batch
    4, prompt 4096 with 256 patch embeddings a row) and musicgen-large
    (batch 4, prompt 2048 of frame embeddings) at full depth through
    ``--engine loop``, 16 tokens each, no kernel of the port; every
    logit finite, every request served and page freed, every peak within
    90% of the card;
33. small inputs, card against CPU: ``sgd``, ``momentum`` (and
    ``nesterov``), ``adam`` (with ``weight_decay``, and through
    ``warmup_cosine``) and ``clip_by_global_norm``, 5 steps on the same
    leaves; a checkpoint round trip of qwen3-1.7b-smoke's async fused
    state on the card (f32 params, momentum, rings and EF residuals, a
    bf16 copy of the params, Python ints, the numpy tau table): bitwise,
    and in place (every tensor keeps its ``data_ptr``);
34. kill and resume of the main path: qwen3-1.7b at full width, cut to
    ``KILL_RESUME_LAYERS`` of 28 layers, async top-k at tau_max 1, 2
    workers, seq 256, batch 4, 4 steps, a checkpoint every 2, under a
    fault plan (SIGKILL after step 2 on attempt 0, ``grad_poison`` at
    step 1, worker 1 crashed at step 1 for 1 step).  The oracle is the
    same flags with ``--fault-attempt 1`` (saving its final step only)
    through ``repro_torch.launch.train.main``, twice (bitwise run to
    run: the second run's final state is compared leaf by leaf with the
    first's checkpoint instead of being written), launch
    counters zeroed just before the first and read just after (exactly
    104 ``topk_ef`` and 52 ``topk_cr_deposit``); then the run through
    ``python -m repro_torch.launch.supervisor``: it is killed, resumed
    from step 2, and each printed loss equals the oracle's, its final
    checkpoint bitwise the oracle's; checkpoint bytes, save and load
    seconds and the time from the kill to the first resumed step logged;
    the checkpoint directories are deleted at the end;
35. faulted serving: full-width mixtral-8x7b cut to 8 of 32 layers,
    phase 14's requests through ``--engine continuous``, fault-free and
    then with ``--fault-plan`` (``logit_poison`` at tick 4,
    ``page_exhaust`` of 16 pages at tick 6 for 3 ticks): every request
    served, none failed, ``FAULT_SERVE_QUARANTINED`` quarantined (the
    reference's count on this schedule, held on the CPU by
    ``tests/test_torch_faults.py``), every page freed, K9 once a layer a
    decode step, the greedy tokens against the fault-free run's (the first
    difference logged);
36. data-parallel workers over ``torch.distributed``: full-width
    qwen3-1.7b cut to ``DIST_LAYERS`` of 28 layers, 2 workers over 2 ranks
    (one process each, spawned by ``repro_torch.launch.train.main`` with
    ``--ranks 2 --dist-backend gloo``) sharing cuda:0, seq 256, batch 4:
    4 async top-k steps at tau_max 2 (each rank exactly 52 ``topk_ef`` and
    52 ``topk_cr_deposit`` launches, read by the rank and reported), then
    2 ``--sync topk_ef`` steps (26 ``topk_ef`` and 26 ``topk_cr_reduce`` a
    rank); before each, the in-process oracle (``--workers 2``, 104 + 52 and
    52 + 26 launches), whose losses the ranks' equal bitwise, and whose
    final params, optimizer state and sync state stay on the card, shared
    with rank 0 by IPC handle (``repro_torch.launch.train.main(...,
    compare_to=...)``): every final leaf of the three that rank 0 gathers
    equals the oracle's bitwise (largest difference 0); each rank's peak
    memory, step wall and collective bytes
    a step logged, the summed peak under 0.90 of the card; ``--ranks 2``
    with ``nccl`` (named or by default) on the one card raises before any
    step;
37. tensor parallelism (``--model-shards 2``): first K1, K2 and K4
    against their plain versions, bitwise, at the seven (M / 2, R) row
    geometries a rank of full-width qwen3-1.7b at ``TP_LAYERS`` layers
    gives them (``embed`` (75,968, 2048), ``w_*`` (3072, L 2048), ``wq`` /
    ``wo`` (8, L 262,144), ``wk`` / ``wv`` (4, L 262,144), ``ln_*``
    (1024, L), ``final_norm`` (1024, 1) and ``q_norm`` / ``k_norm`` (1, L
    128)), each timed with CUDA events beside its bound and
    ``torch.topk`` or ``index_put_``; then qwen3-1.7b at full width cut to
    ``TP_LAYERS`` of 28 layers, 2 workers over ``--ranks 4 --model-shards
    2 --dist-backend gloo`` (a 2 data x 2 model grid of processes sharing
    cuda:0) through ``repro_torch.launch.train.main``: 4 async top-k
    steps at tau_max 2 (each rank exactly 52 ``topk_ef`` and 52
    ``topk_cr_deposit`` launches) and 2 ``topk_ef`` steps (26 + 26
    ``topk_cr_reduce``); before each, the one-process oracle built from
    the library with the model-2 specs (104 + 52 and 52 + 26 launches),
    whose final params stay on the card, shared with rank 0 by IPC handle
    (``repro_torch.launch.train.main(..., compare_to=...)``): rank 0
    gathers each final leaf whole and compares it; the ranks' losses and
    params agree with the oracle's within ``TP_LOSS_TOL`` and
    ``TP_PARAM_TOL`` (the row- and vocab-parallel sums add in another
    order); each rank's peak memory,
    step wall and bytes by collective (the data group's ``all_gather``
    and ``psum``, the model group's ``model_psum`` and
    ``model_all_gather``) logged, the summed peak under 0.90 of the card;
38. tensor parallelism for the MoE, Mamba2 and RWKV6 stacks: first K1, K2
    and K4 against their plain versions, bitwise, at every (M / 2, R) row
    geometry a rank of this phase's three configs gives them that phase
    37 did not time (24), and K10 at a rank's heads in zamba2-7b training
    (``FAMILY_K10``: 32 of 64 heads) within phase 16's limits, each timed
    with CUDA events over 5 calls beside its bound and ``torch.topk`` or
    ``index_put_``; then one f32 forward and backward of each of the three
    at full width, cut to one layer, over two model ranks (spawned here,
    gloo on cuda:0) against one process: the loss within
    ``FAMILY_GRAD_LOSS_RTOL`` and every gradient leaf, gathered whole by
    rank 0, within ``FAMILY_GRAD_RTOL`` relative (no top-k pick to flip:
    the partial sums only add in another order); then, each at full width through
    ``repro_torch.launch.train.main`` with 2 workers and ``--model-shards
    2 --dist-backend gloo`` on cuda:0 (``FAMILY_TP``): moonshot-v1-16b-a3b
    cut to 1 of 48 layers on ``--ranks 2`` (one data rank of both
    workers), 4 async top-k steps at tau_max 1 and 2 ``topk_ef`` steps;
    zamba2-7b cut to 3 of 81 layers (the shared block once) and rwkv6-1.6b
    cut to 6 of 24 on ``--ranks 4`` (2 data x 2 model), 4 async top-k
    steps at tau_max 2; before each, the one-process oracle with the
    model-2 specs, as phase 37's; exact launch counts per rank and in the
    oracle (K10 once a Mamba2 layer a local worker a step); the ranks'
    losses within ``TP_LOSS_TOL`` of the oracle's, and their final params
    (rank 0 compares each gathered leaf with the oracle's, shared by IPC
    handle) within ``FAMILY_LEAF_REL`` a leaf and ``FAMILY_MODEL_REL`` over
    the model, as a share of the oracle's own move from the params both
    start at; each summed peak under 0.90 of the card;
39. the cluster model and the time-to-loss co-simulation: K1 and K8 at the
    co-simulation's EF rows (4, 32) against their plain versions; the
    three cluster presets through ``repro_torch.launch.cosim.main`` at the
    CLI's defaults (p 4, 600 steps, flops 4e8, alpha 0.05, target 0.01,
    seed 0; the first with ``--out``) on the card and on the CPU, both on
    gradient noise drawn once on the CPU: every candidate's tau table,
    finishes and learner clock bitwise, steps, times, tau histograms,
    drops and winners equal, losses within ``COSIM_LOSS_ATOL +
    COSIM_LOSS_RTOL`` of the CPU's over the first ``PARITY_STEPS`` steps
    (every crossing lies there and clears the bound); exactly 600 K1 and
    600 K8 launches a preset (the ``topk_ef`` and ``onebit_ef``
    candidates, one a step) and no other kernel; each event loop's
    seconds on both and the device-busy share of a profiled card run
    (``straggler_heavy``, 100 steps); then
    the ring checker (``repro_torch.analysis.rings.run``) with its layer
    3 (the port's ring ops, ``delivery_tensors`` under ``vmap`` and
    ``ParamReplica``) on the card: no findings and the CPU run's
    statistics; and a planted fault, rings of capacity ``tau_max`` (one
    slot short), which the prover and the card's ring ops must both flag.

Phase 1 also logs the free disk of the checkpoint directory's filesystem
and the free host memory.  The last three lines of standard output are the
kernels' JSON record (K1, K2 and K4 also carry ``rwkv6_launches``,
``moonshot_launches``, ``zamba2_launches``, ``ranks_launches`` (each
rank's count, by phase 36's run), ``tp_launches`` (each rank's, by phase
37's), ``tp_shapes`` (phase 37's times at each geometry),
``families_tp_launches`` and ``families_tp_shapes`` (phase 38's; K10 too),
K1 and K2 ``kill_resume_launches``, K10 ``zamba2_launches``, K1 and K8
``cosim_launches``, phase 39's over the three presets), the card's
name and power limit, and the result ``{"ok": true, "device": {...}}``.
"""
import contextlib
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# phase 34's checkpoints (git-ignored; deleted at the end of the phase)
CKPT_ROOT = ROOT / ".chip_ckpt"
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory (data sheet)
FP32_FLOPS_PER_S = 67e12            # H100 SXM FP32 outside the tensor cores
TOPK_RATIO = 1 / 16
# K1's, K4's, K6's, K7's, K8's, K9's and K10's times before their redesign,
# recorded by this script on an H100 80GB HBM3 at 700.00 W (PERF.md's
# kernel table; K1 and K4 CUDA-event times over 5 calls, the others one
# device_ms reading each):
# logged as recorded, never measured here nor put in the kernels' JSON line
EARLIER_MS = {"topk_ef": 5.733, "delivery_step": 0.2004,
              "swa_decode_attention": 0.1454, "sync_step": 0.0581,
              "ssd_chunked": 8.970, "topk_cr_reduce": 1.918,
              "onebit_ef": 0.0042}
# the hybrid path before K10's redesign, recorded by this script in the same
# way (its last run before the redesign): phase 18's batch-4 prefill (s) and
# phase 19's batch-1 prefill, its wall with the profiler on and K10's device
# time in it (ms)
EARLIER_HYBRID = {"batch-4 prefill s": 2.8984,
                  "batch-1 prefill wall ms": 946.14,
                  "batch-1 prefill K10 ms": 361.191}
# leaf row lengths of full-width qwen3-1.7b on the main path (M = 1)
R_WK = 28 * 2048 * 8 * 128          # layers/attn/wk: 58,720,256
R_WGATE = 28 * 2048 * 6144          # layers/mlp/w_gate: 352,321,536
# device kernels of a profiled step, by what launched them (first match)
PROFILE_GROUPS = (
    ("K1 topk_ef", ("topk_ef_hist", "topk_ef_cand", "topk_ef_digit",
                    "topk_ef_place")),
    ("K2 topk_cr_deposit", ("deposit_kernel",)),
    ("K3 onebit_cr_deposit", ("onebit_deposit",)),
    ("K4 topk_cr_reduce", ("topk_reduce_",)),
    ("K5 onebit_cr_reduce", ("onebit_reduce",)),
    ("matmul", ("nvjet", "gemm", "gemv", "xmma", "cutlass", "cublas",
                "sm90_", "sm80_")),
    ("copy / cast", ("copy", "Memcpy", "Memset")),
    ("elementwise / reduce", ("elementwise", "reduce", "softmax",
                              "index")),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, warmup: int = 1, iters: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20):
    """-> (device ms per call, host ms per call) of a small launch.  The
    host takes longer to issue such a call than the card to run it, so the
    stream is first held by a spin kernel long enough for all ``iters``
    calls to be queued; the events then time the calls back to back on the
    device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / 3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * host * iters * 2 + 2e6))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host * 1e3


def paired_ms(torch, kernel, library, rounds: int = 5):
    """-> (kernel ms, library ms, note): ``device_ms`` of each in turns
    (kernel, library, kernel, library, ...), so that both see the card in
    the same states; the least of each, and a note of every reading and of
    the pairs in which the kernel was the faster."""
    ks, ls = [], []
    for _ in range(rounds):
        ks.append(device_ms(torch, kernel)[0])
        ls.append(device_ms(torch, library)[0])
    wins = sum(k < lib for k, lib in zip(ks, ls))
    note = (f"paired readings kernel [{', '.join(f'{x:.4f}' for x in ks)}] "
            f"library [{', '.join(f'{x:.4f}' for x in ls)}] ms, kernel "
            f"faster in {wins} of {rounds} pairs")
    return min(ks), min(ls), note


def launch_floor_ms(torch, dev) -> float:
    """``device_ms`` of a one-element in-place ``add_`` on the card: what a
    launch that does almost nothing takes between its neighbours."""
    x = torch.zeros(1, device=dev)
    return device_ms(torch, lambda: x.add_(1))[0]


def bound_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def model_leaves(arch, cfg=None) -> int:
    """Stacked parameter leaves of ``arch`` (or of ``cfg``, an
    ``ArchConfig``): one K1 call a leaf a worker and one K2 or K4 call a
    leaf a step."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF
    return len(T.leaves(TF.model_defs(cfg or get_config(arch))))


def _topk_check(torch, topk_ef, topk_ef_plain, g, e, k):
    """K1 against its plain version: the picks bitwise in the documented
    order (above the threshold, then the ties, each in index order), the
    residual bitwise, and every output bitwise from run to run.  -> (order
    bitwise, residual bitwise, run to run bitwise, max |kernel - plain|)."""
    from repro_torch.kernels.topk_ef.ref import documented_order
    kv, ki, ke = topk_ef(g, e, k)
    again = topk_ef(g, e, k)
    pv, pi, pe = topk_ef_plain(g, e, k)
    torch.cuda.synchronize()
    dv, di = documented_order(pv, pi)
    order = torch.equal(ki, di) and torch.equal(kv.view(torch.int32),
                                                dv.view(torch.int32))
    same_e = torch.equal(ke.view(torch.int32), pe.view(torch.int32))
    repeat = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                 for a, b in zip((kv, ki, ke), again))
    err = max(float((kv - dv).abs().max()), float((ke - pe).abs().max()))
    return order, same_e, repeat, err


def check_topk_ef(torch, dev, gen, records):
    from repro_torch.kernels.topk_ef.kernel import candidate_cap, topk_ef
    from repro_torch.kernels.topk_ef.ref import topk_ef_plain

    def inputs(m, r, kind):
        if kind == "ties":          # few magnitudes; the last row all zero
            g = torch.randint(-2, 3, (m, r), generator=gen, device=dev).float()
            e = 0.5 * torch.randint(-1, 2, (m, r), generator=gen,
                                    device=dev).float()
            g[-1] = 0.0
            e[-1] = 0.0
        elif kind == "zeros":       # -0.0 beside 0.0, no residual
            g = torch.zeros((m, r), device=dev)
            g[:, ::3] = -0.0
            e = None
        else:
            g = torch.randn((m, r), generator=gen, device=dev)
            e = 0.1 * torch.randn((m, r), generator=gen, device=dev)
        return g, e

    # (M, R, kind): the path's leaves (w_gate, wk, the stacked norms,
    # q_norm / k_norm, the final norm), ties with an all-zero row, rows off
    # 16 bytes (R % 4 != 0), and two rows whose threshold bin overflows
    # the candidate list (the second route)
    worst = 0.0
    for m, r, kind in ((8, 4096, "ties"), (8, 257, "ties"),
                       (1, 2048, "gauss"), (1, 3584, "gauss"),
                       (1, 57344, "gauss"), (1, 1 << 22, "zeros"),
                       (2, 1 << 22, "ties"), (1, R_WK, "gauss"),
                       (1, R_WGATE, "gauss")):
        k = max(1, int(round(r * TOPK_RATIO)))
        g, e = inputs(m, r, kind)
        w = g if e is None else e + g
        keys = w[0].view(torch.int32) & 0x7fffffff
        t = int(torch.topk(keys, k).values[-1])
        in_bin = int(((keys >> 20) == (t >> 20)).sum())
        del w, keys
        order, same_e, repeat, err = _topk_check(torch, topk_ef,
                                                 topk_ef_plain, g, e, k)
        worst = max(worst, err)
        route = "overflow" if in_bin > candidate_cap(r) else "list"
        log(f"check topk_ef ({m}, {r}) k={k} {kind}: threshold bin of row 0 "
            f"{in_bin} keys, cap {candidate_cap(r)} ({route}); vals/idx "
            f"bitwise in the documented order {order}, new_err bitwise "
            f"{same_e}, run-to-run bitwise {repeat}, max_abs_err {err}")
        require(order and same_e and repeat, "topk_ef != plain version")
        if r in (2048, 57344):
            ms, call = device_ms(torch, lambda: topk_ef(g, e, k))
            plain, pcall = device_ms(torch, lambda: topk_ef_plain(g, e, k))
            absw = (e + g).abs()
            lib, _ = device_ms(torch, lambda: torch.topk(absw, k, dim=1))
            log(f"time topk_ef ({m}, {r}) k={k}: kernel {ms:.4f} ms on the "
                f"device ({call:.4f} ms a call from the host), plain "
                f"{plain:.4f} ms ({pcall:.4f}), torch.topk {lib:.4f} ms, "
                f"launch floor {launch_floor_ms(torch, dev):.4f} ms, bound "
                f"{bound_ms(12 * m * r + 8 * m * k):.6f} ms")
            del absw
        if r == R_WGATE:
            absw = (e + g).abs()
            ms = time_ms(torch, lambda: topk_ef(g, e, k), warmup=2, iters=5)
            plain = time_ms(torch, lambda: topk_ef_plain(g, e, k))
            lib = time_ms(torch, lambda: torch.topk(absw, k, dim=1))
            nbytes = 12 * m * r + 8 * m * k
            records[topk_ef.name] = dict(
                name=topk_ef.name, route="cuda", source=topk_ef.source,
                replaces=topk_ef.replaces, max_abs_err=worst, ms=ms,
                plain_ms=plain, bound_ms=bound_ms(nbytes), bound_by="bytes",
                library_ms=lib, shape=[m, r], k=k)
            log(f"time topk_ef ({m}, {r}) k={k}: kernel {ms:.3f} ms, plain "
                f"{plain:.3f} ms, torch.topk {lib:.3f} ms, bound "
                f"{bound_ms(nbytes):.3f} ms ({nbytes} bytes)")
            del absw
        del g, e
        torch.cuda.empty_cache()
    records[topk_ef.name]["max_abs_err"] = worst


def _deposit_case(torch, dev, gen, r, k, slots, weights):
    """A (3, 1, r) ring and S messages as the path makes them: each top-k
    payload is ``topk_ef``'s output on a fresh gradient (picks in index
    order within each group), each sign map a fair coin."""
    from repro_torch.kernels.topk_ef.kernel import topk_ef
    s = len(slots)
    acc = 0.01 * torch.randn((3, 1, r), generator=gen, device=dev)
    vals, idx = [], []
    for _ in range(s):
        g = torch.randn((1, r), generator=gen, device=dev)
        v, i, _ = topk_ef(g, None, k, out_err=g)
        vals.append(v)
        idx.append(i)
        del g
    vals = torch.stack(vals)
    idx = torch.stack(idx)
    pos = torch.rand((s, 1, r), generator=gen, device=dev) < 0.5
    means = torch.randn((s, 1, 2), generator=gen, device=dev)
    slots_t = torch.tensor(slots, dtype=torch.int32, device=dev)
    w_t = torch.tensor(weights, dtype=torch.float32, device=dev)
    return acc, vals, idx, pos, means, slots_t, w_t


def check_deposits(torch, dev, gen, records):
    from repro_torch.kernels.cr_reduce.kernel import (onebit_cr_deposit,
                                                      topk_cr_deposit)
    from repro_torch.kernels.cr_reduce.ref import (onebit_cr_deposit_plain,
                                                   topk_cr_deposit_plain)
    r = R_WGATE
    k = int(round(r * TOPK_RATIO))
    # two messages share slot 1, the third is DROPPED (weight 0)
    acc, vals, idx, pos, means, slots, w = _deposit_case(
        torch, dev, gen, r, k, [1, 1, 2], [1.0, 0.5, 0.0])
    errs = {}
    for kern, plain, args in (
            (topk_cr_deposit, topk_cr_deposit_plain, (vals, idx)),
            (onebit_cr_deposit, onebit_cr_deposit_plain, (pos, means))):
        a_p = plain(acc.clone(), *args, slots, w)
        # K2 keeps one route, the atomic scatter a message (a row-segment
        # redesign was tried and not kept: PERF.md)
        for rep in range(3):        # a race would show only now and then
            a_k = kern(acc.clone(), *args, slots, w)
            torch.cuda.synchronize()
            same = torch.equal(a_k.view(torch.int32), a_p.view(torch.int32))
            errs[kern.name] = max(errs.get(kern.name, 0.0),
                                  float((a_k - a_p).abs().max()))
            log(f"check {kern.name} acc (3, 1, {r}) S=3 slots [1, 1, 2] w "
                f"[1, 0.5, 0] run {rep}: bitwise {same}, max_abs_err "
                f"{errs[kern.name]}")
            require(same, f"{kern.name} != plain version")
            del a_k
        del a_p
    del acc, vals, idx, pos, means
    torch.cuda.empty_cache()

    # timing at the main path's panel: p = 2 messages into a 3-slot ring
    acc, vals, idx, pos, means, slots, w = _deposit_case(
        torch, dev, gen, r, k, [0, 2], [1.0, 1.0])
    ms = time_ms(torch, lambda: topk_cr_deposit(acc, vals, idx, slots, w),
                 warmup=2, iters=5)
    plain = time_ms(torch, lambda: topk_cr_deposit_plain(acc, vals, idx,
                                                         slots, w))
    flat = (slots.long()[:, None, None] * r + idx.long()).reshape(-1)
    prods = (vals * w[:, None, None]).reshape(-1)
    acc_flat = acc.view(-1)
    lib = time_ms(torch, lambda: acc_flat.index_put_((flat,), prods,
                                                     accumulate=True))
    targets = int(torch.unique(flat).numel())
    nbytes = 2 * 1 * k * 8 + targets * 8
    # the card reads and writes 32-byte sectors: each sector of a slot
    # that takes a pick is read and written once, beside the payload
    sectors = int(torch.unique(flat // 8).numel())
    sector_bytes = 2 * 1 * k * 8 + sectors * 32 * 2
    records[topk_cr_deposit.name] = dict(
        name=topk_cr_deposit.name, route="cuda",
        source=topk_cr_deposit.source, replaces=topk_cr_deposit.replaces,
        max_abs_err=errs[topk_cr_deposit.name], ms=ms, plain_ms=plain,
        bound_ms=bound_ms(nbytes), bound_by="bytes", library_ms=lib,
        sector_bound_ms=bound_ms(sector_bytes), shape=[3, 1, r], k=k,
        messages=2)
    log(f"time topk_cr_deposit (3, 1, {r}) S=2 k={k} (topk_ef payloads): "
        f"kernel {ms:.3f} ms, plain {plain:.3f} ms, "
        f"index_put_(accumulate=True) {lib:.3f} ms (products precomputed), "
        f"bound {bound_ms(nbytes):.3f} ms ({nbytes} bytes), sector bound "
        f"{bound_ms(sector_bytes):.3f} ms ({sectors} sectors of 32 bytes "
        f"read and written, {sectors / (2 * r / 8):.4f} of the two slots)")
    del flat, prods
    ms = time_ms(torch, lambda: onebit_cr_deposit(acc, pos, means, slots, w),
                 warmup=2, iters=5)
    plain = time_ms(torch, lambda: onebit_cr_deposit_plain(acc, pos, means,
                                                           slots, w))
    n_slots = len(set(slots.tolist()))
    nbytes = 2 * r + 2 * 2 * 4 + n_slots * r * 4 * 2
    records[onebit_cr_deposit.name] = dict(
        name=onebit_cr_deposit.name, route="triton",
        source=onebit_cr_deposit.source, replaces=onebit_cr_deposit.replaces,
        max_abs_err=errs[onebit_cr_deposit.name], ms=ms, plain_ms=plain,
        bound_ms=bound_ms(nbytes), bound_by="bytes", library_ms=None,
        shape=[3, 1, r], messages=2)
    log(f"time onebit_cr_deposit (3, 1, {r}) S=2: kernel {ms:.3f} ms, plain "
        f"{plain:.3f} ms, bound {bound_ms(nbytes):.3f} ms ({nbytes} bytes)")
    del acc, vals, idx, pos, means
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: the path on a small input, card against CPU
# ---------------------------------------------------------------------------

def check_small_path(torch, dev, arch="qwen3-1.7b-smoke",
                     runs=(("topk", 3), ("onebit", 1))):
    """Phase 3 (and 24): the delivery half of ``arch``'s async step, 2
    workers, fed the same numpy gradients for each (compressor, steps) of
    ``runs`` on the card and on the CPU (params, rings and EF residuals
    within 1e-6, the stale gap within rtol 1e-5), then the model's loss on
    both within 2e-2."""
    import numpy as np

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset, to_device
    from repro_torch.dist.async_engine import (AsyncConfig,
                                               init_async_state,
                                               make_async_train_step)
    from repro_torch.dist.train import loss_fn
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params, param_specs
    from repro_torch.optim import constant, momentum

    cfg = get_config(arch)
    defs = TF.model_defs(cfg)
    specs = param_specs(defs)
    base = init_params(defs, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    leaves = T.leaves(base)
    for compressor, steps in runs:
        acfg = AsyncConfig(tau_max=2, schedule="uniform", seed=1,
                           compressor=compressor, topk_ratio=TOPK_RATIO)
        runs = {}
        grads = [[[rng.standard_normal(p.shape).astype(np.float32)
                   for p in leaves] for _ in range(2)] for _ in range(steps)]
        for d in ("cpu", dev):
            params = T.tree_map(lambda p: p.clone().to(d), base)
            opt = momentum(constant(3e-3), 0.9)
            opt_state = opt.init(T.leaves(params))
            state = init_async_state(acfg, 2, params, specs)
            step = make_async_train_step(cfg, opt, acfg, 2, specs)
            _, td = T.flatten(params)
            for t in range(steps):
                feed = [(torch.zeros((), device=d),
                         T.unflatten(td, [torch.from_numpy(x).to(d)
                                          for x in grads[t][w]]))
                        for w in range(2)]
                params, opt_state, state, m = step.deliver(params, opt_state,
                                                           state, feed)
            runs[str(d)] = (T.leaves(params) + T.leaves(state["acc"])
                            + T.leaves(state["err"]), float(m["stale_gap2"]))
        (cpu, gap_c), (card, gap_g) = runs["cpu"], runs[str(dev)]
        err = max(float((a.cpu() - b).abs().max()) for a, b in zip(card, cpu))
        log(f"check path {arch} {compressor} delivery, card vs cpu, {steps} "
            f"steps: params/acc/err max_abs_err {err}, stale_gap2 "
            f"{gap_g} vs {gap_c}")
        require(err <= 1e-6 and math.isclose(gap_g, gap_c, rel_tol=1e-5),
                f"{compressor} delivery on the card disagrees with the CPU")
    batch = SyntheticLMDataset(cfg.vocab_size, 64, 2, seed=0).batch(0)
    with torch.no_grad():
        l_cpu = float(loss_fn(cfg, base, to_device(batch, "cpu"))[0])
        l_card = float(loss_fn(cfg, T.tree_map(lambda p: p.to(dev), base),
                               to_device(batch, dev))[0])
    log(f"check {arch} loss card {l_card:.6f} vs cpu {l_cpu:.6f}")
    require(abs(l_card - l_cpu) < 2e-2, "smoke loss differs card vs cpu")


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def run_path(torch, kernels, compressor: str, steps: int,
             arch: str = "qwen3-1.7b", tau_max: int = 2, cfg=None):
    """Drive the main path through the trainer's entry point, with the
    launch counters zeroed just before; returns the counts after it.  The
    peak memory must stay within 90% of the card (with ``track_gap`` on).
    ``cfg`` (``arch`` cut in depth) overrides ``--arch``."""
    from repro_torch.launch import train

    argv = ["--arch", arch, "--sync", "async", "--compressor",
            compressor, "--topk-ratio", str(TOPK_RATIO), "--ef", "--overlap",
            "--tau-max", str(tau_max), "--async-schedule", "uniform",
            "--workers", "2", "--batch", "4", "--seq", "256", "--steps",
            str(steps), "--device", "cuda", "--seed", "0", "--log-every",
            "1"]
    log(f"path: python -m repro_torch.launch.train {' '.join(argv)}"
        + (f" (cfg: n_layers {cfg.n_layers})" if cfg is not None else ""))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    history = train.main(argv, cfg=cfg)
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"path {arch} {compressor}: {steps} steps in {wall:.2f} s (model "
        f"init included); step_s {[round(r['step_s'], 4) for r in history]};"
        f" losses {[r['loss'] for r in history]}; peak memory {peak} bytes "
        f"({peak / total:.4f} of {total}); launches {json.dumps(counts)}")
    require(len(history) == steps, "missing steps")
    require(peak <= 0.9 * total, "peak memory above 90% of the card")
    for row in history:
        require(math.isfinite(row["loss"]) and
                math.isfinite(row["stale_gap2"]), f"non-finite step {row}")
    return counts


def profile_step(torch, title: str = "profile step", sync=None,
                 arch: str = "qwen3-1.7b", cfg=None, groups=PROFILE_GROUPS,
                 range_name: str = "wkv6_chunked",
                 range_group: str = "WKV6 forward") -> None:
    """Where a training step's device time goes: full-width ``arch`` (or
    ``cfg``) as phase 4 (``sync=None``: the async top-k step, tau_max 2)
    or phase 22 (``sync``: that synchronous strategy, 2 workers) builds it,
    through the same public functions; one warm-up step, then one step
    under ``torch.profiler``; prints device time by kernel group (kernels
    that a torch op inside a ``range_name`` range launched form
    ``range_group``: by default the RWKV6 WKV loop's forward and its
    recompute) and the device-busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import SyncConfig
    from repro_torch.data.pipeline import SyntheticLMDataset, to_device
    from repro_torch.dist.async_engine import (AsyncConfig,
                                               init_async_state,
                                               make_async_train_step)
    from repro_torch.dist.train import (init_dist_sync_state,
                                        make_elastic_train_step)
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params, param_specs
    from repro_torch.optim import constant, momentum

    dev = torch.device("cuda")
    cfg = cfg or get_config(arch)
    defs = TF.model_defs(cfg)
    specs = param_specs(defs)
    params = init_params(defs, torch.Generator(device=dev).manual_seed(0),
                         dev)
    n_leaves = len(T.leaves(params))
    opt = momentum(constant(3e-3), 0.9)
    opt_state = opt.init(T.leaves(params))
    if sync is None:
        acfg = AsyncConfig(tau_max=2, schedule="uniform", compressor="topk",
                           topk_ratio=TOPK_RATIO)
        state = init_async_state(acfg, 2, params, specs)
        step = make_async_train_step(cfg, opt, acfg, 2, specs)
    else:
        scfg = SyncConfig(strategy=sync, topk_ratio=TOPK_RATIO)
        state = init_dist_sync_state(scfg, 2, params)
        step = make_elastic_train_step(cfg, opt, scfg, 2, specs)
    data = SyntheticLMDataset(cfg.vocab_size, 256, 4, seed=0)
    batches = [to_device(data.batch(t), dev) for t in range(2)]
    params, opt_state, state, _ = step(params, opt_state, state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, state, m = step(params, opt_state, state,
                                           batches[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    found, per_name = device_groups(torch, prof, groups, range_name,
                                    range_group)
    log_groups(f"{title} ({arch}, {cfg.n_layers} layers), loss "
               f"{float(m['loss']):.6f}", wall, found, per_name)
    # K1 compresses each leaf for each of the 2 workers; K2 or K4 takes
    # each leaf's 2 messages in one call
    k1 = found.get("K1 topk_ef", (0.0, 0))[1]
    calls = 2 * n_leaves
    log(f"  K1 device kernels a call: {k1 / calls:.2f} ({k1} in {calls} "
        f"calls)")
    require(0 < k1 <= 5 * calls, f"K1 launched {k1} kernels in {calls} "
            "calls")
    name = "K2 topk_cr_deposit" if sync is None else "K4 topk_cr_reduce"
    us, count = found.get(name, (0.0, 0))
    log(f"  {name}: {us / 1e3:.3f} ms in {count} device kernels, "
        f"{count / n_leaves:.2f} a call ({n_leaves} calls)")
    for key, (kus, kcount) in per_name.items():
        if any(p in key for p in dict(groups)[name]):
            log(f"    {kus / 1e3:9.3f} ms  x{kcount:<4d} {key[:90]}")
    require(count > 0, f"{name} ran no device kernel")
    if cfg.block_type == "rwkv6" or cfg.is_moe or cfg.shared_attn_every:
        require(found.get(range_group, (0.0, 0))[1] > 0,
                f"no device kernel inside the {range_name} range")


# ---------------------------------------------------------------------------
# phase 7: the simulator's kernels against their plain versions
# ---------------------------------------------------------------------------

# (B cases, p workers, d, problems G): None = one A shared by every case
SIM_SHAPES = ((1, 8, 32, None), (1, 16, 512, None), (1, 32, 4096, None),
              (1, 8, 100, None), (16, 16, 256, None), (16, 16, 256, 16))
TIMED_SIM_SHAPE = (1, 32, 4096, None)
STEP_TOL = dict(rtol=1e-5, atol=1e-4)      # tests/test_sim_step_kernel.py
ONEBIT_TOL = dict(rtol=1e-6, atol=1e-6)


def bound_of(n_bytes: float, flops: float):
    """-> (bound ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the FP32 operations over the FP32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sim_inputs(torch, dev, gen, b, p, d, defer, groups):
    """A step's inputs at the simulator's scales: a symmetric A with
    entries of order 1/sqrt(d) (a Quadratic's A has eigenvalues 1..cond),
    views and x* of order 1, noise, a 0/1 delivery tensor scaled by
    alpha/p and (defer) a small deferred correction."""
    n = lambda *s: torch.randn(s, generator=gen, device=dev)
    r = n(groups, d, d) if groups else n(d, d)
    a = ((r + r.transpose(-1, -2)) / (2 * d ** 0.5)).contiguous()
    del r
    xs = n(groups, d) if groups else n(d)
    m = 1 + 2 * p if defer else 1 + p
    u = (torch.rand((b, m, p), generator=gen, device=dev) < 0.8).float()
    u *= 0.02 / p
    dfr = 1e-3 * n(b, p, d) if defer else None
    return n(b, p, d), n(b, d), a, xs, 0.1 * n(b, p, d), u, dfr


def compare(torch, got, want, again, tol):
    """-> (max |got - want|, all close, got bitwise equal to again)."""
    err, close, same = 0.0, True, True
    for g, w, g2 in zip(got, want, again):
        if w is None:
            continue
        err = max(err, float((g.float() - w.float()).abs().max()))
        close = close and (torch.allclose(g, w, **tol) if g.is_floating_point()
                           else torch.equal(g, w))
        same = same and torch.equal(g, g2)
    return err, close, same


def step_bytes_flops(b, p, d, groups, defer):
    """Bytes the delivery step must move (inputs once, outputs once) and
    its FP32 operations (the two products)."""
    g = groups or 1
    m = 1 + 2 * p if defer else 1 + p
    pd = b * p * d
    n_in = g * d * d + g * d + b * d + 2 * pd + b * m * p + (pd if defer
                                                             else 0)
    n_out = b * d + pd + (pd if defer else 0) + b * p
    return 4 * (n_in + n_out), 2.0 * b * p * d * d + 2.0 * b * m * p * d


def check_sim_step(torch, dev, gen, records):
    from repro_torch.kernels.sim_step.kernel import delivery_step, sync_step
    from repro_torch.kernels.sim_step.ref import (delivery_step_plain,
                                                  sync_step_plain)
    worst = {delivery_step.name: 0.0, sync_step.name: 0.0}
    floor = launch_floor_ms(torch, dev)
    log(f"launch floor {floor:.4f} ms (a one-element add_ on the device)")
    for b, p, d, groups in SIM_SHAPES:
        timed = (b, p, d, groups) == TIMED_SIM_SHAPE
        for defer in (False, True):
            args = sim_inputs(torch, dev, gen, b, p, d, defer, groups)
            got = delivery_step(*args)
            want = delivery_step_plain(*args)
            again = delivery_step(*args)
            torch.cuda.synchronize()
            err, close, same = compare(torch, got, want, again, STEP_TOL)
            worst[delivery_step.name] = max(worst[delivery_step.name], err)
            tag = (f"B={b} (p, d)=({p}, {d}) A {'stacked' if groups else 'shared'}"
                   f" {'defer' if defer else 'no defer'}")
            log(f"check delivery_step {tag}: close {close}, run-to-run "
                f"bitwise {same}, max_abs_err {err}")
            require(close and same, f"delivery_step {tag} != plain version")
            nbytes, flops = step_bytes_flops(b, p, d, groups, defer)
            bnd, by = bound_of(nbytes, flops)
            ms, call = device_ms(torch, lambda: delivery_step(*args))
            plain, pcall = device_ms(torch,
                                     lambda: delivery_step_plain(*args))
            log(f"time delivery_step {tag}: kernel {ms:.4f} ms on the "
                f"device ({call:.4f} ms a call from the host), plain "
                f"{plain:.4f} ms ({pcall:.4f}), bound {bnd:.4f} ms ({by}; "
                f"{nbytes} bytes, {flops:.4g} flops), launch floor "
                f"{floor:.4f} ms; library call: none")
            if timed and not defer:
                records[delivery_step.name] = dict(
                    name=delivery_step.name, route="cuda",
                    source=delivery_step.source,
                    replaces=delivery_step.replaces, ms=ms, plain_ms=plain,
                    bound_ms=bnd, bound_by=by, library_ms=None,
                    shape=[b, p, d])
            del args, got, want, again

        _, x, a, xs, noise, _, _ = sim_inputs(torch, dev, gen, b, p, d,
                                              False, groups)
        nsum = noise.sum(1)
        c = 0.02 + 0.001 * torch.arange(b, device=dev, dtype=torch.float32)
        sargs = (x, a, xs, nsum, c)
        got = sync_step(*sargs)
        want = sync_step_plain(*sargs)
        again = sync_step(*sargs)
        torch.cuda.synchronize()
        err, close, same = compare(torch, [got], [want], [again], STEP_TOL)
        worst[sync_step.name] = max(worst[sync_step.name], err)
        tag = f"B={b} d={d} A {'stacked' if groups else 'shared'}"
        log(f"check sync_step {tag}: close {close}, run-to-run bitwise "
            f"{same}, max_abs_err {err}")
        require(close and same, f"sync_step {tag} != plain version")
        g = groups or 1
        nbytes = 4 * (g * d * d + g * d + 3 * b * d + b)
        bnd, by = bound_of(nbytes, 2.0 * b * d * d)
        ms, call = device_ms(torch, lambda: sync_step(*sargs))
        plain, pcall = device_ms(torch, lambda: sync_step_plain(*sargs))
        lib, verdict = None, ""
        if b == 1 and groups is None:
            cf = float(c[0])
            base, diff = x - nsum, x - xs
            single = ms
            ms, lib, note = paired_ms(torch, lambda: sync_step(*sargs),
                                      lambda: torch.addmm(base, diff, a,
                                                          alpha=-cf))
            verdict = (f"; below torch.addmm {ms < lib} (least of each; "
                       f"{note}; one reading alone {single:.4f} ms)")
        log(f"time sync_step {tag}: kernel {ms:.4f} ms on the device "
            f"({call:.4f} ms a call from the host), plain {plain:.4f} ms "
            f"({pcall:.4f}), torch.addmm "
            f"{'none (batched)' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{bnd:.4f} ms ({by}; {nbytes} bytes), launch floor "
            f"{floor:.4f} ms{verdict}")
        if timed:
            records[sync_step.name] = dict(
                name=sync_step.name, route="cuda", source=sync_step.source,
                replaces=sync_step.replaces, ms=ms, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=lib, shape=[b, d])
        del x, a, xs, noise, nsum, sargs
        torch.cuda.empty_cache()
    for name, err in worst.items():
        records[name]["max_abs_err"] = err


# (M = B * p worker rows, R = d) as the simulator's EF rounds give them,
# then K8's route edges: the warp rows' longest row and the first cluster
# row, a cluster's register capacity and one entry more (two passes), and a
# row of 2^20 entries (eight passes)
ONEBIT_SHAPES = ((8, 32), (16, 512), (32, 4096), (8, 100), (256, 256),
                 (8, 2048), (8, 2049), (1, 131072), (1, 131073), (1, 1 << 20))


def check_onebit_ef(torch, dev, gen, records):
    from repro_torch.kernels.onebit_ef.kernel import onebit_ef, plan
    from repro_torch.kernels.onebit_ef.ref import onebit_ef_plain
    worst = 0.0
    floor = launch_floor_ms(torch, dev)
    in_place = set()
    for m, r in ONEBIT_SHAPES:
        g = torch.randn((m, r), generator=gen, device=dev)
        e = 0.1 * torch.randn((m, r), generator=gen, device=dev)
        if m >= 2:
            g[0, ::3] = -0.0            # -0.0 entries: the + class
            e[0, ::3] = -0.0
        g[-1] = 0.0
        e[-1] = 0.0                     # an all-zero row
        got = onebit_ef(g, e)
        want = onebit_ef_plain(g, e)
        again = onebit_ef(g, e)
        torch.cuda.synchronize()
        err, close, same = compare(torch, got, want, again, ONEBIT_TOL)
        packed_same = torch.equal(got[0], want[0])
        worst = max(worst, err)
        route, cluster, threads, units, passes = plan(m, r)
        tag = (f"({m}, {r}) {route} route (cluster {cluster}, {threads} "
               f"threads, {units} units, {passes} passes)")
        log(f"check onebit_ef {tag}: packed bitwise {packed_same}, "
            f"means/new_err close {close}, run-to-run bitwise {same}, "
            f"max_abs_err {err}")
        require(packed_same and close and same, "onebit_ef != plain version")
        kind = (route, cluster > 1, passes > 1)
        if kind not in in_place:        # out_err = err, once a route
            in_place.add(kind)
            e2 = e.clone()
            got2 = onebit_ef(g, e2, out_err=e2)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(x, y) for x, y in zip(got2, got))
            log(f"check onebit_ef {tag} in place: bitwise the out-of-place "
                f"call {bitwise}")
            require(bitwise and got2[2].data_ptr() == e2.data_ptr(),
                    "onebit_ef in place != out of place")
            del e2, got2
        nbytes = 12 * m * r + m * ((r + 7) // 8) + 8 * m
        bnd, by = bound_of(nbytes, 6.0 * m * r)
        ms, call = device_ms(torch, lambda: onebit_ef(g, e))
        plain, pcall = device_ms(torch, lambda: onebit_ef_plain(g, e))
        log(f"time onebit_ef ({m}, {r}): kernel {ms:.4f} ms on the device "
            f"({call:.4f} ms a call from the host), plain {plain:.4f} ms "
            f"({pcall:.4f}), bound {bnd:.6f} ms ({by}; {nbytes} bytes), "
            f"launch floor {floor:.4f} ms; library call: none")
        if (m, r) == (32, 4096):
            records[onebit_ef.name] = dict(
                name=onebit_ef.name, route="cuda", source=onebit_ef.source,
                replaces=onebit_ef.replaces, ms=ms, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=None, shape=[m, r])
        del g, e, got, want, again
    records[onebit_ef.name]["max_abs_err"] = worst


def check_topk_ef_sim_shape(torch, dev, gen):
    """K1 at the simulator's shape: (p, d) = (8, 32), k = 8 (ratio 0.25),
    with many ties at the threshold and an all-zero row."""
    from repro_torch.kernels.topk_ef.kernel import topk_ef
    from repro_torch.kernels.topk_ef.ref import topk_ef_plain
    m, r, k = 8, 32, 8
    g = torch.randint(-2, 3, (m, r), generator=gen, device=dev).float()
    e = 0.5 * torch.randint(-1, 2, (m, r), generator=gen, device=dev).float()
    g[-1] = 0.0
    e[-1] = 0.0
    order, same_e, repeat, _ = _topk_check(torch, topk_ef, topk_ef_plain, g,
                                           e, k)
    log(f"check topk_ef sim shape ({m}, {r}) k={k} ties: vals/idx bitwise in "
        f"the documented order {order}, new_err bitwise {same_e}, "
        f"run-to-run bitwise {repeat}")
    require(order and same_e and repeat,
            "topk_ef != plain version at the simulator's shape")
    nbytes = 12 * m * r + 8 * m * k
    ms, call = device_ms(torch, lambda: topk_ef(g, e, k))
    plain, pcall = device_ms(torch, lambda: topk_ef_plain(g, e, k))
    absw = (e + g).abs()
    lib, _ = device_ms(torch, lambda: torch.topk(absw, k, dim=1))
    log(f"time topk_ef sim shape ({m}, {r}) k={k}: kernel {ms:.4f} ms on "
        f"the device ({call:.4f} ms a call from the host), plain "
        f"{plain:.4f} ms ({pcall:.4f}), torch.topk {lib:.4f} ms, launch "
        f"floor {launch_floor_ms(torch, dev):.4f} ms, bound "
        f"{bound_ms(nbytes):.6f} ms ({nbytes} bytes)")


# ---------------------------------------------------------------------------
# phases 8-10: the simulator on the card
# ---------------------------------------------------------------------------

def parity(a, b) -> bool:
    """The reference's engine-parity tolerances (tests/test_sim_engine.py)."""
    import numpy as np
    return (np.allclose(a.gap2_over_alpha2, b.gap2_over_alpha2, rtol=2e-3,
                        atol=2e-3)
            and np.allclose(a.losses, b.losses, rtol=2e-3, atol=2e-4)
            and np.allclose(a.grad_norms2, b.grad_norms2, rtol=2e-3,
                            atol=2e-4)
            and np.allclose(a.x_final, b.x_final, rtol=2e-3, atol=2e-4))


# Table 1 rows whose runs are chaotic in the last bits: one-bit EF puts each
# coordinate in a sign class, and an entry near zero changes class on a
# rounding difference, so two correct implementations drift apart over a
# long run.  The reference's own two engines do (its scan and its numpy
# oracle, fed the same draws, over Table 1's 600 steps).  Such a row is
# held to the parity tolerances over the reference's parity
# horizon (tests/test_sim_engine.py runs T = 60) and to B_hat within 2e-3
# over the whole run; the full-run comparison is printed.
CHAOTIC_ROWS = ("onebit_ef",)
PARITY_STEPS = 60


def table1(torch):
    """Table 1 (benchmarks/bench_table1_bounds.py's configuration): each
    relaxation once on the card and once on the CPU with the same draws;
    B_hat against its bound, no VIOLATION, finite losses."""
    import numpy as np

    from repro_torch.core import compression as C
    from repro_torch.core import theory
    from repro_torch.core.problems import Quadratic
    from repro_torch.core.sim import (Relaxation, simulate,
                                      simulate_shared_memory)
    from repro_torch.core.sim_ref import default_draws

    p, t_len, alpha, dim = 8, 600, 0.02, 32
    prob = {d: Quadratic(dim=dim, cond=8.0, sigma=1.0, seed=0, device=d)
            for d in ("cpu", "cuda")}
    x0 = np.ones(dim, np.float32) * 2.0
    r2 = float(np.sum((x0 - prob["cpu"].x_star.numpy()) ** 2)) * 1.5
    m2 = prob["cpu"].m2_estimate(r2)
    s2 = prob["cpu"].sigma2
    cases = [
        ("sync", Relaxation("sync"), 0.0),
        ("crash_f3", Relaxation("crash", f=3), theory.b_crash_m(p, 3, m2)),
        ("crash_subst_f3", Relaxation("crash_subst", f=3),
         theory.b_crash_variance(p, 3, s2)),
        ("omission_f6", Relaxation("omission", f=6, drop_prob=0.2),
         theory.b_crash_m(p, 6, m2)),
        ("async_tau2", Relaxation("async", tau_max=2),
         theory.b_async_mp(p, 2, m2)),
        ("topk_ef_25pct", Relaxation("ef_comp",
                                     compressor=C.topk_compressor(0.25)),
         theory.b_ef_compression(C.topk_gamma(dim, dim // 4), m2)),
        ("onebit_ef", Relaxation("ef_comp", compressor=C.onebit_compressor()),
         theory.b_ef_compression(C.onebit_gamma(dim), m2)),
        ("elastic_norm_b08", Relaxation("elastic_norm", beta=0.8), None),
        ("elastic_variance", Relaxation("elastic_variance", drop_prob=0.3),
         theory.b_elastic_scheduler_variance(s2)),
    ]
    draws = default_draws(prob["cpu"], 3, t_len, p)
    runs = [(name, bound, lambda d, n=t_len, r=relax: simulate(
        prob[d], r, p, alpha, n, seed=3, x0=x0, draws=draws[:n]))
        for name, relax, bound in cases]
    shm_draws = default_draws(prob["cpu"], 3, t_len, 1)
    runs.append(("shared_memory_tau3", theory.b_shared_memory(dim, 3, m2),
                 lambda d, n=t_len: simulate_shared_memory(
                     prob[d], p, 0.005, n, tau_max=3, seed=3, x0=x0,
                     draws=shm_draws[:n])))
    for name, bound, run in runs:
        t0 = time.perf_counter()
        card = run("cuda")
        wall = time.perf_counter() - t0
        cpu = run("cpu")
        agree = parity(card, cpu)
        verdict = "na" if bound is None else (
            "ok" if card.b_hat <= bound * 1.05 else "VIOLATION")
        finite = bool(np.isfinite(card.losses).all())
        log(f"table1/{name}: B_hat {card.b_hat:.4f} (cpu {cpu.b_hat:.4f}), "
            f"B_theory {bound if bound is not None else float('nan'):.4f}, "
            f"{verdict}, loss_end {card.losses[-1]:.6f} (cpu "
            f"{cpu.losses[-1]:.6f}), card == cpu at parity tolerance "
            f"{agree}, card run {wall:.3f} s")
        if name in CHAOTIC_ROWS:
            head_card, head_cpu = run("cuda", PARITY_STEPS), run(
                "cpu", PARITY_STEPS)
            head = parity(head_card, head_cpu)
            b_close = math.isclose(card.b_hat, cpu.b_hat, rel_tol=2e-3)
            log(f"table1/{name}: first {PARITY_STEPS} steps card == cpu at "
                f"parity tolerance {head}; B_hat card == cpu within 2e-3 "
                f"{b_close} (the full runs drift apart: see CHAOTIC_ROWS)")
            require(head and b_close, f"table1/{name}: card and CPU runs "
                    "disagree")
        else:
            require(agree, f"table1/{name}: card and CPU runs disagree")
        require(verdict != "VIOLATION" and finite, f"table1/{name}: {verdict}"
                f", finite losses {finite}")


def fused_at_repo_sizes(torch, counts):
    """bench_sim_step_kernel.py's grid: fused against unfused at p = 16,
    d in {256, 512}, T = 400 for sync and crash_subst; one fused run at
    (32, 4096); then the 16-case grid (4 problems x 2 alphas x 2 seeds,
    crash_subst f=3, p = 16, d = 256) in one simulate_grid call, one
    delivery_step launch per step for all 16 cases; then a 3-seed sync
    sweep, one sync_step launch per step, a case bitwise equal to its
    single run."""
    import numpy as np

    from repro_torch.core.problems import Quadratic
    from repro_torch.core.sim import (Relaxation, simulate, simulate_grid,
                                      simulate_sweep)

    t_len = 400
    relaxes = (("sync", Relaxation("sync"), "sync_step"),
               ("crash_subst", Relaxation("crash_subst", f=3),
                "delivery_step"))
    warm = Quadratic(dim=64, cond=8.0, sigma=1.0, seed=0, device="cuda")
    for _, relax, _ in relaxes:      # first calls: cuBLAS and Triton set-up
        simulate(warm, relax, 16, 0.02, 5, seed=3, fused=True)
        simulate(warm, relax, 16, 0.02, 5, seed=3, fused=False)
    for p, d in ((16, 256), (16, 512)):
        prob = Quadratic(dim=d, cond=8.0, sigma=1.0, seed=0, device="cuda")
        x0 = np.ones(d, np.float32)
        for name, relax, kernel in relaxes:
            walls = []
            for _ in range(3):       # the median of three fused runs
                before = counts()
                t0 = time.perf_counter()
                fused = simulate(prob, relax, p, 0.02, t_len, seed=3, x0=x0,
                                 fused=True)
                walls.append(time.perf_counter() - t0)
                used = {k: v - before[k] for k, v in counts().items()}
                require(used[kernel] == t_len, f"{kernel} launched "
                        f"{used[kernel]} times, not {t_len}")
            t_f = sorted(walls)[1]
            t0 = time.perf_counter()
            unfused = simulate(prob, relax, p, 0.02, t_len, seed=3, x0=x0,
                               fused=False)
            t_u = time.perf_counter() - t0
            agree = parity(fused, unfused)
            log(f"sim_step/{name}_p{p}_d{d}: fused {t_len / t_f:.1f} "
                f"steps/s ({t_f:.3f} s, the median of "
                f"[{', '.join(f'{t_len / w:.1f}' for w in walls)}]), unfused "
                f"{t_len / t_u:.1f} steps/s ({t_u:.3f} s), speedup "
                f"{t_u / t_f:.2f}x; fused == unfused at parity tolerance "
                f"{agree}; launches in each fused run {json.dumps(used)}")
            require(agree, f"{name} p{p} d{d}: fused != unfused")
    t0 = time.perf_counter()
    big = Quadratic(dim=4096, cond=8.0, sigma=1.0, seed=0, device="cuda")
    build = time.perf_counter() - t0
    before = counts()
    t0 = time.perf_counter()
    res = simulate(big, Relaxation("crash_subst", f=3), 32, 0.02, t_len,
                   seed=3, x0=np.ones(4096, np.float32), fused=True)
    wall = time.perf_counter() - t0
    used = counts()["delivery_step"] - before["delivery_step"]
    log(f"sim_step/crash_subst_p32_d4096: fused {t_len / wall:.1f} steps/s "
        f"({wall:.3f} s; problem built in {build:.1f} s on the host), "
        f"B_hat {res.b_hat:.4f}, loss_end {res.losses[-1]:.6f}, "
        f"delivery_step launches {used}")
    require(used == t_len and np.isfinite(res.losses).all(),
            "fused run at (32, 4096) failed")
    del big

    probs = [Quadratic(dim=256, cond=8.0, sigma=1.0, seed=s, device="cuda")
             for s in range(4)]
    relax = Relaxation("crash_subst", f=3)
    x0 = np.ones(256, np.float32)
    before = counts()
    t0 = time.perf_counter()
    grid = simulate_grid(probs, relax, 16, [0.01, 0.02], t_len, seeds=[0, 1],
                         x0=x0)
    wall = time.perf_counter() - t0
    used = counts()["delivery_step"] - before["delivery_step"]
    one = simulate(probs[3], relax, 16, 0.02, t_len, seed=1, x0=x0)
    got = grid[(3, 0, 16, 1, 1)]
    same = np.array_equal(one.x_final, got.x_final) and np.array_equal(
        one.gap2_over_alpha2, got.gap2_over_alpha2)
    log(f"sim_step/grid_crash_subst_p16_d256_x{len(grid)}: "
        f"{len(grid) / wall:.2f} runs/s ({wall:.3f} s), delivery_step "
        f"launches {used} for the whole grid; case (3, 0, 16, 1, 1) bitwise "
        f"equal to its single run {same}")
    require(len(grid) == 16 and used == t_len and same,
            "the fused grid is not one launch per step or differs from its "
            "single runs")

    # sync: a batched sweep of three seeds, one sync_step launch a step for
    # all three, each case bitwise equal to its own single run
    sync = Relaxation("sync")
    before = counts()
    sweep = simulate_sweep(probs[0], sync, 16, 0.02, t_len, [0, 1, 2], x0=x0,
                           fused=True)
    used = counts()["sync_step"] - before["sync_step"]
    one = simulate(probs[0], sync, 16, 0.02, t_len, seed=2, x0=x0,
                   fused=True)
    same = np.array_equal(one.x_final.view(np.int32),
                          sweep[2].x_final.view(np.int32)) and \
        np.array_equal(one.losses, sweep[2].losses)
    log(f"sim_step/sweep_sync_p16_d256_x3: sync_step launches {used} for "
        f"the sweep of 3 seeds x {t_len} steps; seed 2 bitwise equal to its "
        f"single run {same}")
    require(used == t_len and same,
            "the fused sync sweep is not one launch per step or differs "
            "from its single runs")


def figure3(torch):
    """Figure 3 (benchmarks/bench_fig3_variance_bounded.py): MLP grid of
    sync and the variance-bounded scheduler, P = 8, alpha 0.08, T = 800,
    seeds 4-7; the variance-bounded accuracy must recover to sync's (within
    0.05)."""
    import numpy as np

    from repro_torch.core.problems import MLPClassification
    from repro_torch.core.sim import Relaxation, simulate_grid

    mlp = MLPClassification(seed=0, device="cuda")
    x0 = mlp.init(seed=1)
    cases = [("sync", Relaxation("sync")),
             ("variance_bounded", Relaxation("elastic_variance",
                                             drop_prob=0.3))]
    t0 = time.perf_counter()
    grid = simulate_grid(mlp, [r for _, r in cases], 8, 0.08, 800,
                         seeds=(4, 5, 6, 7), x0=x0)
    wall = time.perf_counter() - t0

    def accuracy(x):
        w1, b1, w2, b2 = mlp._unflatten(torch.as_tensor(x, device=mlp.device))
        pred = (torch.tanh(mlp.xs @ w1 + b1) @ w2 + b2).argmax(-1)
        return float((pred == mlp.ys).float().mean())

    accs = {}
    for ir, (name, _) in enumerate(cases):
        batch = grid.select(i_relax=ir)
        acc = [accuracy(r.x_final) for r in batch]
        accs[name] = float(np.mean(acc))
        log(f"fig3_right/{name}: loss {np.mean([r.losses[-1] for r in batch]):.4f}"
            f", acc {accs[name]:.4f} +- {np.std(acc):.4f}, B_hat "
            f"{np.mean([r.b_hat for r in batch]):.4f}, seeds 4-7")
        require(all(np.isfinite(r.losses).all() for r in batch),
                f"fig3 {name}: non-finite loss")
    recovered = accs["variance_bounded"] >= accs["sync"] - 0.05
    log(f"fig3_right/accuracy_recovered: {'ok' if recovered else 'VIOLATION'}"
        f" (grid of 8 runs x 800 steps in {wall:.3f} s)")
    require(recovered, "fig3: the variance-bounded accuracy did not recover")


def profile_sim(torch) -> None:
    """Where a simulator run's time goes: crash_subst at p = 16, d = 256,
    T = 100, fused and unfused, and sync fused, under torch.profiler:
    device time by kernel, kernel launches per step and the device-busy
    share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.problems import Quadratic
    from repro_torch.core.sim import Relaxation, simulate

    prob = Quadratic(dim=256, cond=8.0, sigma=1.0, seed=0, device="cuda")
    x0 = np.ones(256, np.float32)
    t_len = 100
    for kind, fused in (("crash_subst", True), ("crash_subst", False),
                        ("sync", True)):
        relax = (Relaxation("crash_subst", f=3) if kind == "crash_subst"
                 else Relaxation("sync"))
        simulate(prob, relax, 16, 0.02, t_len, seed=3, x0=x0, fused=fused)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            simulate(prob, relax, 16, 0.02, t_len, seed=3, x0=x0,
                     fused=fused)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernel_type = torch.autograd.DeviceType.CUDA
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == kernel_type
                and e.self_device_time_total > 0]
        busy_us = sum(r[1] for r in rows)
        n_kernels = sum(r[2] for r in rows)
        log(f"profile sim {kind} p16 d256 T{t_len} fused={fused}: wall "
            f"{wall * 1e3:.2f} ms (profiler on), device kernels "
            f"{busy_us / 1e3:.3f} ms ({busy_us / 1e3 / (wall * 1e3):.4f} of "
            f"wall), {n_kernels} kernels ({n_kernels / t_len:.2f} per step)")
        for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
            log(f"  {us / 1e3:9.4f} ms  x{count:<5d} {key[:90]}")


# ---------------------------------------------------------------------------
# phases 12-15: serving
# ---------------------------------------------------------------------------

# K9 at the serving path's shape: 4 slots, 8 kv heads of 128, 4 query heads
# each, a window gather of 257 pages of 16 keys; window 4096
SWA_PATH = (4, 8, 4, 128, 4112)
SWA_WINDOW = 4096
# K9 against its plain version, element by element: |got - want| <= atol +
# rtol * |want|.  In bf16 both round an f32 result to bf16, so they may
# differ by one rounding step, at most 2^-7 of the value; atol covers f32
# summation-order differences near zero.  f32 keeps tests/test_kernels.py's
# bound.
SWA_TOL = {"bfloat16": (1e-5, 2.0 ** -7), "float32": (3e-6, 0.0)}
SERVE_LAYERS = 24
SERVE_PROMPTS = (4600, 3070, 1010, 500, 200, 100)
SERVE_GEN = 32
# the paged steps on the card against the same code on the CPU, with TF32
# and reduced-precision bf16 reductions off as the serving launcher runs
# them; an H100 80GB HBM3 read 0.022 (mixtral smoke) and 0.020 (qwen3)
LOGIT_TOL = 0.05
SERVE_GROUPS = (
    ("K9 swa_decode_attention", ("swa_decode_kernel",)),
    ("matmul", ("nvjet", "gemm", "gemv", "xmma", "cutlass", "cublas",
                "sm90_", "sm80_")),
    ("gather / copy", ("index", "gather", "copy", "Memcpy", "Memset",
                       "cat")),
)


def swa_rows(torch, dev, gen, b, kv, g, d, t, dtype):
    """K9's inputs: row 0 keys from 0 with the query at the last key; row
    1 a window that slid (base 150, pos - base = T - 1); row 2 most keys
    beyond pos; row 3 no live key."""
    n = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
    base = torch.tensor([0, 150, 3, 500], dtype=torch.int32, device=dev)
    pos = torch.tensor([t - 1, 150 + t - 1, 40, 100], dtype=torch.int32,
                       device=dev)
    return n(b, kv, g, d), n(b, t, kv, d), n(b, t, kv, d), pos, base


def swa_over_limit(got, want, dtype) -> float:
    """The largest |got - want| over its limit (<= 1 passes)."""
    atol, rtol = SWA_TOL[dtype]
    err = (got.float() - want.float()).abs()
    return float((err / (atol + rtol * want.float().abs())).max())


def swa_bytes_flops(torch, q, k, pos, base, window):
    """The bytes and operations K9's function needs on these inputs: q read
    and the output written once; K and V of the live keys of each row; for
    a row with no live key (its output is the mean of its values) V of all
    T keys and no K.  Two multiply-adds a live key per query head and
    dimension; one add a value per query head for a mean."""
    b, kv, g, d = q.shape
    t = k.shape[1]
    key_pos = base[:, None] + torch.arange(t, device=q.device)[None]
    live = ((key_pos <= pos[:, None]) & (pos[:, None] - key_pos < window)
            ).sum(1).tolist()
    es = k.element_size()
    row = kv * d * es
    nbytes = 2 * q.numel() * es + 8 * b + sum(
        2 * n * row if n else t * row for n in live)
    flops = sum(4.0 * kv * g * d * n if n else 1.0 * kv * g * d * t
                for n in live)
    return nbytes, flops, live


# K9's cases beyond the serving path's shape at T in SWA_T: (label, (B, KV,
# G, D, T), window, rows); rows "swa_rows" (a slid window, most keys beyond
# pos, no live key) or "decode" (phase 15's step: 4 rows of about 503 live
# keys from base 0)
SWA_T = (4112, 128, 512, 1000, 8192)
SWA_CASES = (
    ("decode step", (4, 8, 4, 128, 4112), SWA_WINDOW, "decode"),
    ("G 1", (4, 8, 1, 128, 4112), SWA_WINDOW, "swa_rows"),
    ("G 8", (4, 8, 8, 128, 4112), SWA_WINDOW, "swa_rows"),
    ("G 16", (4, 2, 16, 128, 4112), SWA_WINDOW, "swa_rows"),
    ("D 64", (4, 8, 4, 64, 4112), SWA_WINDOW, "swa_rows"),
    ("D 256", (4, 4, 4, 256, 4112), SWA_WINDOW, "swa_rows"),
    ("window 12", (4, 8, 4, 128, 1000), 12, "swa_rows"),
)


def check_swa_decode(torch, dev, gen, records):
    import torch.nn.functional as F

    from repro_torch.kernels.swa_attention.kernel import swa_decode_attention
    from repro_torch.kernels.swa_attention.ref import swa_decode_plain
    b, kv, g, d, t_path = SWA_PATH
    cases = [(f"T {t}", (b, kv, g, d, t), SWA_WINDOW, "swa_rows")
             for t in SWA_T] + list(SWA_CASES)
    worst = 0.0
    for label, shape, window, rows in cases:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            b, kv, g, d, t = shape
            q, k, v, pos, base = swa_rows(torch, dev, gen, b, kv, g, d, t, dt)
            if rows == "decode":
                pos = torch.tensor([502, 503, 501, 500], dtype=torch.int32,
                                   device=dev)
                base = torch.zeros(4, dtype=torch.int32, device=dev)
            args = (q, k, v, pos, base)
            got = swa_decode_attention(*args, window=window)
            again = swa_decode_attention(*args, window=window)
            want = swa_decode_plain(*args, window=window)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            over = swa_over_limit(got, want, dtype)
            err_dead, over_dead = 0.0, 0.0
            if rows == "swa_rows":       # row 3: the mean of its values
                mean = v[3].float().mean(0)[:, None].expand(kv, g, d)
                err_dead = float((got[3].float() - mean).abs().max())
                over_dead = swa_over_limit(got[3], mean, dtype)
            same = torch.equal(got, again)
            finite = bool(torch.isfinite(got).all())
            if dtype == "bfloat16":
                worst = max(worst, err)
            tag = (f"{label}: (B, KV, G, D, T) = ({b}, {kv}, {g}, {d}, {t}) "
                   f"window {window} {dtype}")
            atol, rtol = SWA_TOL[dtype]
            log(f"check swa_decode_attention {tag}: max_abs_err {err}, "
                f"largest error over its limit {over} (limit {atol} + "
                f"{rtol} |plain| an element; max |plain| "
                f"{float(want.float().abs().max())}); no-live-key row vs "
                f"mean of values {err_dead} ({over_dead} of its limit), "
                f"run-to-run bitwise {same}, finite {finite}")
            require(over <= 1 and over_dead <= 1 and same and finite,
                    f"swa_decode_attention {tag} != plain version")
            key_pos = base[:, None] + torch.arange(t, device=dev)[None]
            mask = (key_pos <= pos[:, None]) & (pos[:, None] - key_pos
                                                < window)
            qs = q.reshape(b, kv * g, 1, d)
            ks = k.transpose(1, 2).contiguous()
            vs = v.transpose(1, 2).contiguous()
            sdpa_mask = mask[:, None, None, :]
            run = lambda: swa_decode_attention(*args, window=window)
            single, call = device_ms(torch, run)
            sdpa = lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=sdpa_mask, enable_gqa=True)
            ms, lib, note = paired_ms(torch, run, sdpa)
            plain, _ = device_ms(torch, lambda: swa_decode_plain(
                *args, window=window))
            nbytes, flops, live = swa_bytes_flops(torch, q, k, pos, base,
                                                  window)
            bnd, by = bound_of(nbytes, flops)
            log(f"time swa_decode_attention {tag}: kernel {ms:.4f} ms on the "
                f"device ({call:.4f} ms a call from the host), plain "
                f"{plain:.4f} ms, "
                f"scaled_dot_product_attention (bool mask, enable_gqa) "
                f"{lib:.4f} ms, below it {ms < lib} (least of each; {note}; "
                f"one reading alone {single:.4f} ms); bound {bnd:.4f} ms "
                f"({ms / bnd:.2f}x; {by}; {nbytes} bytes for live keys "
                f"{live} of {t})")
            if label == f"T {t_path}" and dtype == "bfloat16":
                records[swa_decode_attention.name] = dict(
                    name=swa_decode_attention.name, route="cuda",
                    source=swa_decode_attention.source,
                    replaces=swa_decode_attention.replaces, ms=ms,
                    plain_ms=plain, bound_ms=bnd, bound_by=by,
                    library_ms=lib, shape=[b, kv, g, d, t])
            del q, k, v, ks, vs, got, again, want, args
            torch.cuda.empty_cache()
    records[swa_decode_attention.name]["max_abs_err"] = worst


def set_matmul_precision(torch, reduced: bool) -> None:
    """TF32 float32 matmuls and reduced-precision bf16 reductions on or
    off (off is how the serving launcher runs)."""
    torch.backends.cuda.matmul.allow_tf32 = reduced
    torch.backends.cudnn.allow_tf32 = reduced
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        reduced


def check_small_serve(torch, dev):
    """The paged prefill and decode steps on the card against the same
    code on the CPU: two requests, then 4 decode steps fed the same
    (teacher-forced) tokens; logits within LOGIT_TOL at full matmul
    precision.  The card is run a second time with TF32 matmuls and
    reduced-precision bf16 reductions, and that reading is only logged."""
    import dataclasses

    import numpy as np

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_serving_params
    from repro_torch.serve import engine as ENG
    from repro_torch.serve.paged_cache import (PagedCacheConfig,
                                               init_page_pool)

    def steps(cfg, pcfg, params, d, w, lens, table, prompts, feed):
        p = T.tree_map(lambda a: a.to(d), params)
        kp, vp = init_page_pool(cfg.n_layers, cfg.n_kv_heads,
                                cfg.resolved_head_dim, pcfg, device=d)
        out = []
        for i, s in enumerate(lens):
            bp = -(-s // pcfg.page_size)
            toks = np.zeros((1, bp * pcfg.page_size), np.int32)
            toks[0, :s] = prompts[i]
            step = ENG.make_paged_prefill_step(cfg, pcfg, bp)
            lg, kp, vp = step(p, kp, vp, torch.tensor(toks, device=d), s,
                              torch.tensor(table[i, :bp], device=d))
            out.append(lg.cpu())
        decode = ENG.make_paged_decode_step(cfg, pcfg, window=w)
        pos = torch.tensor(lens, dtype=torch.int32, device=d)
        tab = torch.tensor(table, device=d)
        act = torch.ones((len(lens),), dtype=torch.bool, device=d)
        for t in range(len(feed)):
            lg, pos, kp, vp = decode(p, kp, vp,
                                     torch.tensor(feed[t], device=d), pos,
                                     tab, act)
            out.append(lg.cpu())
        return out

    cases = (("mixtral-8x7b-smoke", None, 8, 8, (45, 16)),
             ("qwen3-1.7b-smoke", 96, 32, 6, (150, 64)))
    # the steps end in sample_tokens; returning the logits there instead
    # exposes them through the steps' own code
    sample_tokens = ENG.sample_tokens
    ENG.sample_tokens = lambda logits, sc, gen=None: logits
    try:
        for name, window, ps, n_table, lens in cases:
            cfg = get_config(name)
            if window:
                cfg = dataclasses.replace(cfg, sliding_window=window)
            w = cfg.layer_window_sizes()[0]
            params = init_serving_params(
                TF.model_defs(cfg), torch.Generator().manual_seed(0), "cpu")
            r = len(lens)
            pcfg = PagedCacheConfig(page_size=ps, num_pages=r * n_table,
                                    max_requests=r, max_pages_per_seq=n_table)
            rng = np.random.default_rng(0)
            table = np.arange(r * n_table, dtype=np.int32).reshape(r, n_table)
            prompts = [rng.integers(0, cfg.vocab_size, s) for s in lens]
            feed = rng.integers(0, cfg.vocab_size, (4, r)).astype(np.int32)
            args = (cfg, pcfg, params)
            rest = (w, lens, table, prompts, feed)
            cpu = steps(*args, "cpu", *rest)
            err = {}
            for reduced in (False, True):
                set_matmul_precision(torch, reduced)
                card = steps(*args, dev, *rest)
                err[reduced] = max(float((a - b).abs().max())
                                   for a, b in zip(cpu, card))
            set_matmul_precision(torch, False)
            log(f"check serve steps {name} (window {w}, page {ps}), card vs "
                f"cpu, 2 prefills + 4 teacher-forced decode steps: logits "
                f"max_abs_err {err[False]} (tol {LOGIT_TOL}); with TF32 "
                f"matmuls and reduced-precision bf16 reductions on the card "
                f"{err[True]} (logged only)")
            require(err[False] <= LOGIT_TOL,
                    f"{name}: serving logits differ card vs cpu")
    finally:
        ENG.sample_tokens = sample_tokens
        set_matmul_precision(torch, False)


def serve_argv(arch: str = "mixtral-8x7b"):
    return ["--arch", arch, "--engine", "continuous",
            "--prompt-lens", ",".join(map(str, SERVE_PROMPTS)),
            "--gen", str(SERVE_GEN), "--batch", "4", "--page-size", "16",
            "--device", "cuda", "--seed", "0"]


def run_serve(torch, kernels, arch: str = "mixtral-8x7b",
              layers=SERVE_LAYERS, per_step=("swa_decode_attention",),
              extra=()):
    """Phases 14, 32 and 35: ``arch`` (cut to ``layers``, None: its full
    depth; ``extra``: more launcher arguments) serving ``SERVE_PROMPTS``
    through its launcher's entry point
    with the continuous engine, the launch counters zeroed just before:
    each kernel of ``per_step`` launched once a layer a decode step, no
    other kernel of the port; returns (counts, result)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)
    argv = serve_argv(arch) + list(extra)
    log(f"serve path: python -m repro_torch.launch.serve {' '.join(argv)} "
        f"({arch} with n_layers {cfg.n_layers}, windows "
        f"{sorted(set(cfg.layer_window_sizes()))}; {cfg.param_count()} "
        f"parameters)")
    total = torch.cuda.get_device_properties(0).total_memory
    left = torch.cuda.memory_allocated()
    log(f"serve path: memory allocated before loading {left} bytes")
    require(left < 2 ** 30, "earlier phases left memory allocated")
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    out = serve.main(argv, cfg=cfg)
    counts = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    engine = out["engine"]
    toks = out["tokens"]
    decode_s = out["wall_s"] - sum(out["prefill_s"])
    n_tok = sum(len(t) for t in toks)
    log(f"serve path {arch}: {len(toks)} requests, {engine.steps} decode "
        f"steps "
        f"(scheduler clock {out['scheduler'].clock}), wall {out['wall_s']:.3f}"
        f" s; prefill s per request "
        f"{[round(x, 4) for x in out['prefill_s']]}; decode "
        f"{engine.steps / decode_s:.3f} steps/s ({decode_s:.3f} s); "
        f"{n_tok / out['wall_s']:.3f} tokens/s end to end; peak memory "
        f"{peak} bytes ({peak / total:.3f} of {total}); launches "
        f"{json.dumps(counts)}")
    for name, count in counts.items():
        want = cfg.n_layers * engine.steps if name in per_step else 0
        require(count == want, f"serving {arch}: {name} launched {count} "
                f"times, not {want}")
    require(len(toks) == len(SERVE_PROMPTS) and all(
        len(t) == SERVE_GEN and int(t.min()) >= 0
        and int(t.max()) < cfg.vocab_size for t in toks),
        "a request did not complete with in-vocab tokens")
    engine.alloc.check()
    require(engine.alloc.n_free == engine.pcfg.num_pages, "pages leaked")
    require(peak <= 0.9 * total, "peak memory above 90% of the card")
    return counts, out


def device_groups(torch, prof, patterns, range_name, range_group):
    """Device time (us) and kernel count by group from a profile: kernels
    that a torch op inside the ``range_name`` profiler range launched form
    ``range_group``; the rest go to the first group of ``patterns`` whose
    name pattern they match, else "other".  Also returns every kernel's
    time and count by name (kernels launched through ctypes, not by a
    torch op, appear only in these device rows)."""
    def ranged(event, inside):
        inside = inside or event.name == range_name
        for k in event.kernels if inside else ():
            yield k
        for child in event.cpu_children:
            yield from ranged(child, inside)

    per_name = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and e.self_device_time_total > 0):
            per_name[e.key] = (e.self_device_time_total, e.count)
    in_range = {}
    for root in prof.events():
        if root.device_type == torch.autograd.DeviceType.CPU and \
                root.cpu_parent is None:
            for k in ranged(root, False):
                t, c = in_range.get(k.name, (0.0, 0))
                in_range[k.name] = (t + k.duration, c + 1)
    groups = {}
    for name, (us, count) in per_name.items():
        r_us, r_count = in_range.get(name, (0.0, 0))
        r_us, r_count = min(r_us, us), min(r_count, count)
        group = next((g for g, pats in patterns
                      if any(p in name for p in pats)), "other")
        for g, t, c in ((group, us - r_us, count - r_count),
                        (range_group, r_us, r_count)):
            if c:
                have_t, have_c = groups.get(g, (0.0, 0))
                groups[g] = (have_t + t, have_c + c)
    return groups, per_name


def log_groups(title, wall, groups, per_name) -> None:
    busy_us = sum(t for t, _ in groups.values())
    n_kernels = sum(c for _, c in groups.values())
    log(f"{title}: wall {wall * 1e3:.2f} ms (profiler on), device kernels "
        f"{busy_us / 1e3:.3f} ms ({busy_us / 1e3 / (wall * 1e3):.3f} of "
        f"wall), {n_kernels} kernels")
    for group, (us, count) in sorted(groups.items(), key=lambda g: -g[1][0]):
        log(f"  group {group:<24s} {us / 1e3:9.3f} ms  x{count}")
    for name, (us, count) in sorted(per_name.items(),
                                    key=lambda r: -r[1][0])[:12]:
        log(f"  {us / 1e3:9.3f} ms  x{count:<5d} {name[:100]}")


def profile_serve(torch, engine, range_name: str = "moe_dispatch",
                  range_group: str = "MoE dispatch") -> None:
    """Phase 15 (and 32): one steady decode step of the engine (4 active
    slots of 500 tokens, the same gather) under torch.profiler.  Device
    kernels launched by a torch op inside the ``range_name`` range (by
    default routing and the dispatch product; ``attend_full``: the full
    attention's page gather and scores) form their own group; the rest are
    grouped by name."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(1)
    for rid in range(4):
        engine.start(100 + rid, rng.integers(0, engine.cfg.vocab_size, 500),
                     8)
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for rid in range(4):
        engine.finish(100 + rid)
    log_groups(f"profile serve decode step ({engine.cfg.name}, "
               f"{engine.cfg.n_layers} layers)", wall, *device_groups(
                   torch, prof, SERVE_GROUPS, range_name, range_group))


# ---------------------------------------------------------------------------
# phases 16-19: serving the Mamba2 hybrid (zamba2-7b)
# ---------------------------------------------------------------------------

# K10 at the serving path's shape: batch 4, prompt 4096, 64 heads of 112,
# state 64 (chunk 128); and at phase 19's batch 1
SSD_PATH = (4, 4096, 64, 112, 64)
SSD_BATCH1 = (1, 4096, 64, 112, 64)
# (shape, dtype, log-decays): the path's shape in bf16 and f32, and at batch
# 1; one chunk; hd 64 and N 32; the largest hd and N the kernel takes; hd
# and N off the 16-wide tiles (padded with zeros); T = 8, one short chunk;
# no decay; decays near -20 (exp underflows across a chunk)
SSD_CASES = ((SSD_PATH, "bfloat16", "u"), (SSD_PATH, "float32", "u"),
             (SSD_BATCH1, "bfloat16", "u"),
             ((4, 128, 64, 112, 64), "bfloat16", "u"),
             ((4, 256, 64, 64, 32), "bfloat16", "u"),
             ((2, 256, 8, 128, 128), "float32", "u"),
             ((2, 384, 8, 40, 24), "bfloat16", "u"),
             ((2, 8, 4, 16, 16), "float32", "u"),
             (SSD_PATH, "bfloat16", "zero"), (SSD_PATH, "bfloat16", "-20"))
# K10 against its plain version, element by element.  f32 y and the state:
# within SSD_REL of the plain version's largest magnitude (an H100 80GB
# HBM3 read 8.5e-7 for y and for the state at the path's shape:
# the two sum in other orders and take exp of cumsums summed in other
# orders).  bf16 y: that f32 limit plus one bf16 rounding step, 2^-7
# |plain|: both round an f32 result once, and two f32 results d apart
# round at most d + 2^-7 |y| apart.  One rounding step alone, 1e-5 +
# 2^-7 |plain|, fails where |y| is near 0 (the elements over it are
# counted and logged).
SSD_REL = 4e-6
BF16_FLOPS_PER_S = 989e12           # H100 SXM dense bf16 tensor cores
HYBRID_PROMPT, HYBRID_GEN, HYBRID_BATCH = 4096, 32, 4
# phase 17: zamba2-7b-smoke card against CPU.  Its default 2 layers in
# bf16 within HYBRID_BF16_TOL (the size of a difference in bf16 rounding
# order: the port against the reference on the CPU read 0.019; an H100
# 80GB HBM3 read 4.8e-7); 7 layers with the shared block every 3 in f32
# compute within HYBRID_F32_TOL (the H100 read 2.05e-4); the 7-layer bf16
# reading is logged only: the shared block's random weights make its
# attention nearly one-hot, so one bf16 rounding step can flip which key
# wins (the reference's own jitted and eager forwards differ there by
# 1.38; the H100 read 0.183)
HYBRID_BF16_TOL, HYBRID_F32_TOL = 0.05, 1e-3
HYBRID_GROUPS = (        # K10's passes: ssd_chunk_state, _scan, _out
    ("K10 ssd_chunked", ("ssd_chunk_",)),
    ("matmul", ("nvjet", "gemm", "gemv", "xmma", "cutlass", "cublas",
                "sm90_", "sm80_")),
)


def ssd_inputs(torch, dev, gen, shape, dtype, decay):
    b, t, h, hd, n = shape
    dt = getattr(torch, dtype)
    x = torch.randn((b, t, h, hd), generator=gen, device=dev).to(dt)
    if decay == "u":
        a = -0.1 * torch.rand((b, t, h), generator=gen, device=dev)
    elif decay == "zero":
        a = torch.zeros((b, t, h), device=dev)
    else:
        a = -20.0 - torch.rand((b, t, h), generator=gen, device=dev)
    bm = torch.randn((b, t, n), generator=gen, device=dev).to(dt)
    cm = torch.randn((b, t, n), generator=gen, device=dev).to(dt)
    return x, a, bm, cm


def ssd_bytes_flops(shape, es, chunk=128):
    """Bytes K10's function moves (x, a, B, C read once; y and the state
    written once) and the operations it needs: per (b, chunk) the lower
    triangle of C B^T (shared by the heads); per (b, h, chunk) the lower
    triangle of A X, C S^T (after the first chunk) and X^T (B decay)."""
    b, t, h, hd, n = shape
    c = min(chunk, t)
    nc, tri = t // c, c * (c + 1) // 2
    nbytes = 2 * b * t * h * hd * es + 4 * b * t * h + 2 * b * t * n * es \
        + 4 * b * h * hd * n
    flops = 2.0 * b * nc * tri * n + 2.0 * b * h * (
        nc * tri * hd + (nc - 1) * c * n * hd + nc * hd * n * c)
    return nbytes, flops


def check_ssd(torch, dev, gen, records):
    """Phase 16: K10 against ssd_plain on the card."""
    from repro_torch.kernels.ssd.kernel import ssd_chunked
    from repro_torch.kernels.ssd.ref import ssd_plain
    worst = 0.0
    for shape, dtype, decay in SSD_CASES:
        args = ssd_inputs(torch, dev, gen, shape, dtype, decay)
        y, s = ssd_chunked(*args)
        y2, s2 = ssd_chunked(*args)
        py, ps = ssd_plain(*args)
        torch.cuda.synchronize()
        ymax = float(py.float().abs().max())
        smax = float(ps.abs().max())
        atol = SSD_REL * ymax
        rtol = 2.0 ** -7 if dtype == "bfloat16" else 0.0
        err = (y.float() - py.float()).abs()
        over = float((err / (atol + rtol * py.float().abs())).max())
        s_err = float((s - ps).abs().max())
        s_over = s_err / (SSD_REL * smax) if smax else float(s_err > 0)
        same = torch.equal(y, y2) and torch.equal(s, s2)
        finite = bool(torch.isfinite(y.float()).all()
                      and torch.isfinite(s).all())
        y_err = float(err.max())
        one_step = int((err > 1e-5 + 2.0 ** -7 * py.float().abs()).sum())
        if dtype == "bfloat16":
            worst = max(worst, y_err)
        tag = f"(B, T, H, hd, N) = {shape} {dtype} a={decay}"
        log(f"check ssd_chunked {tag}: y max_abs_err {y_err} (max |plain| "
            f"{ymax}; largest error over its limit {over}, limit "
            f"{SSD_REL} max|plain| + {rtol} |plain|; {one_step} of "
            f"{py.numel()} elements over 1e-5 + 2^-7 |plain| alone), "
            f"state max_abs_err "
            f"{s_err} ({s_over} of {SSD_REL} max|plain| = {smax}), "
            f"run-to-run bitwise {same}, finite {finite}")
        require(over <= 1 and s_over <= 1 and same and finite,
                f"ssd_chunked {tag} != plain version")
        if shape in (SSD_PATH, SSD_BATCH1) and decay == "u" and (
                dtype == "bfloat16" or shape == SSD_PATH):
            ms, call = device_ms(torch, lambda: ssd_chunked(*args))
            plain, _ = device_ms(torch, lambda: ssd_plain(*args), iters=5)
            nbytes, flops = ssd_bytes_flops(shape, y.element_size())
            rate = BF16_FLOPS_PER_S if dtype == "bfloat16" \
                else FP32_FLOPS_PER_S
            t_bytes = bound_ms(nbytes)
            t_ops = flops / rate * 1e3
            bnd, by = (t_bytes, "bytes") if t_bytes >= t_ops \
                else (t_ops, "operations")
            log(f"time ssd_chunked {tag}: kernel {ms:.4f} ms on the device "
                f"({call:.4f} ms a call from the host), plain {plain:.4f} "
                f"ms, bound {bnd:.4f} ms ({by}; {nbytes} bytes, {flops:.4e} "
                f"operations at {rate:.3g}/s = {t_ops:.4f} ms); no single "
                f"PyTorch call computes the chunked scan")
            if dtype == "bfloat16" and shape == SSD_PATH:
                records[ssd_chunked.name] = dict(
                    name=ssd_chunked.name, route="cuda",
                    source=ssd_chunked.source,
                    replaces=ssd_chunked.replaces, ms=ms, plain_ms=plain,
                    bound_ms=bnd, bound_by=by, library_ms=None,
                    shape=list(shape))
        del args, y, y2, s, s2, py, ps, err
        torch.cuda.empty_cache()
    records[ssd_chunked.name]["max_abs_err"] = worst


def check_small_hybrid(torch, dev):
    """Phase 17: zamba2-7b-smoke's prefill and 4 teacher-forced decode
    steps on the card against the same code on the CPU, with TF32 and
    reduced-precision bf16 reductions off."""
    import dataclasses

    import numpy as np

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_serving_params

    def steps(cfg, params, d, toks, feed):
        p = T.tree_map(lambda a: a.to(d), params)
        lg, cache = TF.prefill(cfg, p, {"tokens": torch.tensor(
            toks, device=d)}, toks.shape[1] + len(feed))
        out = [lg.float().cpu()]
        for f in feed:
            lg, cache = TF.decode_step(cfg, p, cache, torch.tensor(
                f, device=d))
            out.append(lg.float().cpu())
        return out

    base = get_config("zamba2-7b-smoke")
    seven = dataclasses.replace(base, n_layers=7, shared_attn_every=3)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, base.vocab_size, (2, 256)).astype(np.int32)
    feed = rng.integers(0, base.vocab_size, (4, 2, 1)).astype(np.int32)
    set_matmul_precision(torch, False)
    compute = TF.COMPUTE_DTYPE
    try:
        for cfg, dtype, tol in ((base, torch.bfloat16, HYBRID_BF16_TOL),
                                (seven, torch.float32, HYBRID_F32_TOL),
                                (seven, torch.bfloat16, None)):
            TF.COMPUTE_DTYPE = dtype
            params = init_serving_params(
                TF.model_defs(cfg), torch.Generator().manual_seed(0), "cpu")
            cpu = steps(cfg, params, "cpu", toks, feed)
            card = steps(cfg, params, dev, toks, feed)
            err = max(float((a - b).abs().max()) for a, b in zip(cpu, card))
            finite = all(bool(torch.isfinite(a).all()) for a in card)
            log(f"check hybrid steps {cfg.name} n_layers {cfg.n_layers} "
                f"shared every {cfg.shared_attn_every}, compute {dtype}, "
                f"card vs cpu, prefill of 256 + 4 teacher-forced decode "
                f"steps: logits max_abs_err {err} (tol "
                f"{tol if tol else 'none: logged only'}; max |logit| "
                f"{max(float(a.abs().max()) for a in cpu)})")
            require(finite, f"{cfg.name}: non-finite logits on the card")
            require(tol is None or err <= tol,
                    f"{cfg.name}: hybrid logits differ card vs cpu")
    finally:
        TF.COMPUTE_DTYPE = compute


def run_hybrid_serve(torch, kernels):
    """Phase 18: zamba2-7b at full width and depth through the serving
    launcher's loop: K10 once per Mamba2 layer of the batched prefill."""
    from repro_torch.configs import get_config

    n = get_config("zamba2-7b").n_layers
    counts, prefill_s = run_loop_serve(
        torch, kernels, "zamba2-7b", HYBRID_BATCH, HYBRID_PROMPT, HYBRID_GEN,
        want={"ssd_chunked": n})
    log(f"hybrid path: prefill {prefill_s:.4f} s against "
        f"{EARLIER_HYBRID['batch-4 prefill s']} s before K10's redesign "
        f"(recorded, not measured in this run)")
    return counts


def run_loop_serve(torch, kernels, arch, batch, prompt, gen, want=None):
    """Phases 18, 27 and 28: ``arch`` at full width and depth through the
    serving launcher's loop, with the launch counters zeroed just before:
    exactly ``want`` (kernel name -> launches) and no other kernel of the
    port; every sampled step's logits are checked finite on the device.
    Returns (counts, prefill seconds)."""
    from repro_torch.configs import get_config
    from repro_torch.dist import train as DT
    from repro_torch.launch import serve

    cfg = get_config(arch)
    argv = ["--arch", arch, "--engine", "loop", "--batch", str(batch),
            "--prompt-len", str(prompt), "--gen", str(gen), "--device",
            "cuda", "--seed", "0"]
    log(f"loop serve: python -m repro_torch.launch.serve {' '.join(argv)} "
        f"({cfg.n_layers} layers, windows "
        f"{sorted(set(cfg.layer_window_sizes()))}; {cfg.param_count()} "
        f"parameters by param_count)")
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    left = torch.cuda.memory_allocated()
    log(f"loop serve {arch}: memory allocated before loading {left} bytes")
    require(left < 2 ** 30, "earlier phases left memory allocated")
    finite = []
    sample_tokens = DT.sample_tokens

    def checked(logits, sc, gen=None):
        finite.append(torch.isfinite(logits).all())
        return sample_tokens(logits, sc, gen)

    torch.cuda.reset_peak_memory_stats()
    DT.sample_tokens = checked
    try:
        for k in kernels:
            k.launches = 0
        out = serve.main(argv)
        counts = {k.name: k.launches for k in kernels}
    finally:
        DT.sample_tokens = sample_tokens
    peak = torch.cuda.max_memory_allocated()
    toks = out["tokens"]
    prefill_s = out["prefill_s"][0]
    decode_s = out["wall_s"] - prefill_s
    n_tok = sum(len(t) for t in toks)
    log(f"loop serve {arch}: {len(toks)} sequences x {gen} tokens, wall "
        f"{out['wall_s']:.4f} s; prefill {prefill_s:.4f} s (CUDA events, "
        f"{batch} x {prompt} tokens); decode {(gen - 1) / decode_s:.4f} "
        f"steps/s ({gen - 1} steps in {decode_s:.4f} s); "
        f"{n_tok / out['wall_s']:.4f} tokens/s end to end; peak memory "
        f"{peak} bytes ({peak / total:.4f} of {total}); launches "
        f"{json.dumps(counts)}")
    want = want or {}
    for name, count in counts.items():
        require(count == want.get(name, 0),
                f"serving {arch}: {name} launched {count} times, not "
                f"{want.get(name, 0)}")
    require(len(toks) == batch and all(
        len(t) == gen and int(t.min()) >= 0
        and int(t.max()) < cfg.vocab_size for t in toks),
        "a sequence did not complete with in-vocab tokens")
    require(len(finite) == gen and all(bool(f) for f in finite),
            f"non-finite logits serving {arch}")
    require(peak <= 0.9 * total, "peak memory above 90% of the card")
    return counts, prefill_s


def profile_loop(torch, arch, batch, prompt, groups=PROFILE_GROUPS,
                 range_name="wkv6_chunked", range_group="WKV6"):
    """Phases 19, 27 and 28: the served model's prefill (``batch`` x
    ``prompt``) and a decode step after it, each after a warm-up call and
    under torch.profiler, through the step builders the loop uses; device
    time by group (kernels that a torch op inside the ``range_name``
    profiler range launched form ``range_group``) and the device-busy
    share of each.  Returns the prefill's (wall s, groups)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.dist.train import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_serving_params

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = get_config(arch)
    params = init_serving_params(
        TF.model_defs(cfg), torch.Generator(device=dev).manual_seed(0), dev)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    tokens = {"tokens": torch.tensor(toks, device=dev)}
    prefill = make_prefill_step(cfg, prompt + 8)
    decode = make_decode_step(cfg)
    tok, cache = prefill(params, tokens)                  # warm-up
    tok, cache = decode(params, cache, tok[:, None])
    torch.cuda.synchronize()
    out = None
    for title, step in (
            (f"profile {arch} prefill ({batch} x {prompt})",
             lambda: prefill(params, tokens)),
            (f"profile {arch} decode step (batch {batch})",
             lambda: decode(params, cache, tok[:, None]))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        found, per_name = device_groups(torch, prof, groups, range_name,
                                        range_group)
        log_groups(title, wall, found, per_name)
        out = out or (wall, found)
    del params, cache
    return out


def profile_hybrid(torch) -> None:
    """Phase 19: one batch-1 prefill of the phase-18 model (4096 tokens)
    and one decode step after it, device time grouped as K10, attention
    (kernels that a torch op inside the ``shared_attention`` range
    launched), matmul and other."""
    wall, groups = profile_loop(torch, "zamba2-7b", 1, HYBRID_PROMPT,
                                HYBRID_GROUPS, "shared_attention",
                                "attention")
    k10_ms = groups.get("K10 ssd_chunked", (0.0, 0))[0] / 1e3
    log(f"  K10 group {k10_ms:.3f} ms and wall {wall * 1e3:.2f} ms against "
        f"{EARLIER_HYBRID['batch-1 prefill K10 ms']} ms and "
        f"{EARLIER_HYBRID['batch-1 prefill wall ms']} ms before K10's "
        f"redesign (recorded, not measured in this run)")


# ---------------------------------------------------------------------------
# phases 20-23: the synchronous gradient sync (--sync topk_ef|onebit_ef|
# elastic)
# ---------------------------------------------------------------------------

SYNC_STEPS = {"topk_ef": 4, "onebit_ef": 2, "elastic": 2}


def same_bits(torch, a, b) -> bool:
    """Bitwise equal, with NaN (of any payload) at the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        torch.where(na, 0.0, a).view(torch.int32),
        torch.where(nb, 0.0, b).view(torch.int32))


def reduce_panel(torch, dev, gen, s, m, r, k, shared=False):
    """S messages as the path makes them: each top-k payload is
    ``topk_ef``'s picks of a fresh gradient (``shared``: the first
    message's indices in every message, with fresh values), each one-bit
    payload ``onebit_compress_rows`` of a fresh gradient."""
    from repro_torch.kernels.cr_reduce.ops import onebit_compress_rows
    from repro_torch.kernels.topk_ef.kernel import topk_ef
    vals, idx, pos, means = [], [], [], []
    for i in range(s):
        g = torch.randn((m, r), generator=gen, device=dev)
        v, j, _ = topk_ef(g, None, k, out_err=g)
        vals.append(v if not shared or i == 0 else
                    torch.randn(v.shape, generator=gen, device=dev))
        idx.append(j if not shared or i == 0 else idx[0])
        del g
        g = torch.randn((m, r), generator=gen, device=dev)
        p, mn, _ = onebit_compress_rows(g, None, out_err=g)
        pos.append(p)
        means.append(mn)
        del g
    return (torch.stack(vals), torch.stack(idx), torch.stack(pos),
            torch.stack(means))


def check_reduces(torch, dev, gen, records):
    """Phase 20: K4 and K5 against their plain versions on the card."""
    from repro_torch.kernels.cr_reduce.kernel import (onebit_cr_reduce,
                                                      topk_cr_reduce)
    from repro_torch.kernels.cr_reduce.ref import (onebit_cr_reduce_plain,
                                                   topk_cr_reduce_plain)
    worst = {topk_cr_reduce.name: 0.0, onebit_cr_reduce.name: 0.0}
    # (S, M, R, k, weights, shared indices, inf under a zero weight,
    # message 1's picks shuffled: a payload off K1's order, which sends the
    # whole call to K4's atomic route)
    cases = [(2, 1, R_WGATE, None, [1.0, 1.0], False, False, False),
             (2, 1, R_WGATE, None, [1.0, 1.0], False, False, True),
             (2, 1, R_WK, None, [1.0, 1.0], False, False, False),
             (4, 1, R_WK, None, [1.0, 0.5, 0.25, 2.0], True, False, False),
             (4, 1, R_WK, None, [1.0, 0.5, 0.25, 2.0], True, False, True),
             (3, 24, 257, 1, [1.0, 0.0, 0.0], False, True, False),
             (3, 24, 257, 16, [1.0, 0.0, 0.5], False, True, True)]
    for s, m, r, k, weights, shared, poison, shuffled in cases:
        k = k or int(round(r * TOPK_RATIO))
        vals, idx, pos, means = reduce_panel(torch, dev, gen, s, m, r, k,
                                             shared)
        if poison:
            vals[2, 5, 0] = float("inf")
            means[2, 5, 0] = float("inf")
        if shuffled:
            order = torch.randperm(k, generator=gen, device=dev)
            idx[1] = idx[1][:, order]
            vals[1] = vals[1][:, order]
        w = torch.tensor(weights, dtype=torch.float32, device=dev)
        for dtype in ("bfloat16", "float32"):
            v = vals.to(getattr(torch, dtype))
            args = (v, idx, w, r)
            first = topk_cr_reduce(*args)
            route = topk_cr_reduce.last_route()
            runs = (first, topk_cr_reduce(*args),
                    topk_cr_reduce_plain(*args))
            tag = (f"(S, M, R) = ({s}, {m}, {r}) k={k} vals {dtype} w "
                   f"{weights}{' shared indices' if shared else ''}"
                   f"{' inf under w=0' if poison else ''}"
                   f"{' message 1 shuffled' if shuffled else ''}, "
                   f"{route} route")
            _check_reduce(torch, topk_cr_reduce.name, tag, runs, worst)
            require(route == ("atomic" if shuffled else "segment"),
                    f"{topk_cr_reduce.name} {tag}: unexpected route")
        del v, runs, first
        args = (pos, means, w)
        runs = (onebit_cr_reduce(*args), onebit_cr_reduce(*args),
                onebit_cr_reduce_plain(*args))
        _check_reduce(torch, onebit_cr_reduce.name,
                      f"(S, M, R) = ({s}, {m}, {r}) w {weights}"
                      f"{' inf mean under w=0' if poison else ''}", runs,
                      worst)
        del vals, idx, pos, means, runs, args
        torch.cuda.empty_cache()

    # timing at the main path's panel: 2 workers' payloads of w_gate,
    # values in bf16 as they cross the wire, unit weights
    r = R_WGATE
    k = int(round(r * TOPK_RATIO))
    vals, idx, pos, means = reduce_panel(torch, dev, gen, 2, 1, r, k)
    vals = vals.to(torch.bfloat16)
    w = torch.ones((2,), dtype=torch.float32, device=dev)
    ms = time_ms(torch, lambda: topk_cr_reduce(vals, idx, w, r), warmup=2,
                 iters=5)
    require(topk_cr_reduce.last_route() == "segment",
            "topk_cr_reduce: the path's payloads took the atomic route")
    # the same picks, message 1's shuffled: the atomic route, timed alike
    order = torch.randperm(k, generator=gen, device=dev)
    shuffled = torch.stack([idx[0], idx[1][:, order]])
    ms_atomic = time_ms(torch, lambda: topk_cr_reduce(vals, shuffled, w, r),
                        warmup=2, iters=5)
    require(topk_cr_reduce.last_route() == "atomic",
            "topk_cr_reduce: a shuffled payload took the segment route")
    del shuffled, order
    plain = time_ms(torch, lambda: topk_cr_reduce_plain(vals, idx, w, r))
    flat = idx.long().reshape(-1)
    prods = (vals.float() * w[:, None, None]).reshape(-1)
    buf = torch.empty((r,), dtype=torch.float32, device=dev)
    lib = time_ms(torch, lambda: buf.zero_().index_put_(
        (flat,), prods, accumulate=True))
    del flat, prods, buf
    nbytes = 2 * k * (2 + 4) + 4 * 2 + 4 * r
    records[topk_cr_reduce.name] = dict(
        name=topk_cr_reduce.name, route="cuda", source=topk_cr_reduce.source,
        replaces=topk_cr_reduce.replaces,
        max_abs_err=worst[topk_cr_reduce.name], ms=ms, plain_ms=plain,
        bound_ms=bound_ms(nbytes), bound_by="bytes", library_ms=lib,
        shape=[2, 1, r], k=k, vals="bfloat16", atomic_route_ms=ms_atomic)
    log(f"time topk_cr_reduce (2, 1, {r}) k={k} bf16 vals (topk_ef "
        f"payloads): kernel {ms:.4f} ms (segment route; the atomic route "
        f"{ms_atomic:.4f} ms with message 1's picks shuffled), plain "
        f"{plain:.4f} ms, zero_ + index_put_(accumulate=True) {lib:.4f} ms "
        f"(flat indices and products precomputed), bound "
        f"{bound_ms(nbytes):.4f} ms ({nbytes} bytes)")
    ms = time_ms(torch, lambda: onebit_cr_reduce(pos, means, w), warmup=2,
                 iters=5)
    plain = time_ms(torch, lambda: onebit_cr_reduce_plain(pos, means, w))
    nbytes = 2 * r + 2 * 8 + 4 * 2 + 4 * r
    records[onebit_cr_reduce.name] = dict(
        name=onebit_cr_reduce.name, route="triton",
        source=onebit_cr_reduce.source, replaces=onebit_cr_reduce.replaces,
        max_abs_err=worst[onebit_cr_reduce.name], ms=ms, plain_ms=plain,
        bound_ms=bound_ms(nbytes), bound_by="bytes", library_ms=None,
        shape=[2, 1, r])
    log(f"time onebit_cr_reduce (2, 1, {r}) (one-bit payloads): kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound_ms(nbytes):.4f} "
        f"ms ({nbytes} bytes); no single PyTorch call reduces sign maps")
    del vals, idx, pos, means
    torch.cuda.empty_cache()


def _check_reduce(torch, name, tag, runs, worst):
    got, again, want = runs
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) \
        else 0.0
    worst[name] = max(worst[name], err)
    same, repeat = same_bits(torch, got, want), same_bits(torch, got, again)
    n_nan = int(torch.isnan(got).sum())
    log(f"check {name} {tag}: bitwise vs plain {same}, run to run "
        f"{repeat}, max_abs_err {err}, NaN entries {n_nan}")
    require(same and repeat, f"{name} {tag} != plain version")


def check_small_sync(torch, dev, arch="qwen3-1.7b-smoke", syncs=SYNC_STEPS,
                     steps=2):
    """Phase 21 (and 24): ``arch``, 2 workers, ``steps`` steps of each
    synchronous strategy of ``syncs`` on the card against the same code on
    the CPU: the sync/update half fed the same numpy gradients (params and
    per-worker state within 1e-6, gap2 within rtol 1e-5, as phase 3), then
    the whole step's losses within 2e-2 (the port's bf16 forward/backward
    on two devices)."""
    import numpy as np

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import SyncConfig
    from repro_torch.data.pipeline import SyntheticLMDataset, to_device
    from repro_torch.dist.train import (init_dist_sync_state,
                                        make_elastic_train_step)
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params, param_specs
    from repro_torch.optim import constant, momentum

    cfg = get_config(arch)
    specs = param_specs(TF.model_defs(cfg))
    base = init_params(TF.model_defs(cfg), torch.Generator().manual_seed(0),
                       "cpu")
    rng = np.random.default_rng(0)
    data = SyntheticLMDataset(cfg.vocab_size, 64, 4, seed=0)
    for sync in syncs:
        # beta 0.5: the elastic norm gate defers some buckets of random
        # gradients (at 0.9 it syncs all of them)
        scfg = SyncConfig(strategy=sync, topk_ratio=TOPK_RATIO, beta=0.5)
        grads = [[[rng.standard_normal(p.shape).astype(np.float32)
                   for p in T.leaves(base)] for _ in range(2)]
                 for _ in range(steps)]
        runs = {}
        for d in ("cpu", dev):
            fed, whole = [], []
            for feed_grads in (True, False):
                params = T.tree_map(lambda p: p.clone().to(d), base)
                opt = momentum(constant(3e-3), 0.9)
                opt_state = opt.init(T.leaves(params))
                state = init_dist_sync_state(scfg, 2, params)
                step = make_elastic_train_step(cfg, opt, scfg, 2, specs)
                _, td = T.flatten(params)
                for t in range(steps):
                    if feed_grads:
                        feed = [(torch.zeros((), device=d), T.unflatten(
                            td, [torch.from_numpy(x).to(d)
                                 for x in grads[t][w]])) for w in range(2)]
                        params, opt_state, state, m = step.sync_update(
                            params, opt_state, state, feed)
                    else:
                        params, opt_state, state, m = step(
                            params, opt_state, state,
                            to_device(data.batch(t), d))
                        whole.append(float(m["loss"]))
                if feed_grads:
                    per_worker = [v for k, v in sorted(state.items())
                                  if k != "step"]
                    fed = (T.leaves(params) + sum(
                        (T.leaves(v) for v in per_worker), []),
                           float(m["gap2_over_alpha2"]))
            runs[str(d)] = (fed, whole)
        ((cpu, gap_c), loss_c), ((card, gap_g), loss_g) = \
            runs["cpu"], runs[str(dev)]
        err = max(float((a.detach().cpu() - b.detach()).abs().max())
                  for a, b in zip(card, cpu))
        dloss = max(abs(a - b) for a, b in zip(loss_g, loss_c))
        log(f"check sync {sync} {arch}, 2 workers, card vs cpu: fed "
            f"gradients params/state max_abs_err {err}, gap2_over_alpha2 "
            f"{gap_g} vs {gap_c}; whole-step losses card {loss_g} cpu "
            f"{loss_c} (max diff {dloss})")
        require(err <= 1e-6 and math.isclose(gap_g, gap_c, rel_tol=1e-5),
                f"{sync} sync half on the card disagrees with the CPU")
        require(dloss < 2e-2, f"{sync} smoke losses differ card vs cpu")


def run_sync_path(torch, kernels, sync: str, arch: str = "qwen3-1.7b",
                  steps: int = 0, cfg=None, also=None):
    """Phase 22 (and 25, 30, 31): full-width ``arch`` (or ``cfg``, cut in
    depth) through the trainer's entry point with ``--sync sync`` for
    ``steps`` (default ``SYNC_STEPS``), the launch counters zeroed just
    before; returns the counts after it.  Every loss and gap finite, peak
    memory within 90% of the card, and each kernel launched exactly as
    often as the leaves say (``also``: kernel name -> launches of the
    forward's own kernels, K10 on the Mamba2 stack)."""
    from repro_torch.launch import train

    steps = steps or SYNC_STEPS[sync]
    n_leaves = model_leaves(arch, cfg)
    argv = ["--arch", arch, "--sync", sync, "--topk-ratio",
            str(TOPK_RATIO), "--workers", "2", "--batch", "4", "--seq",
            "256", "--steps", str(steps), "--device", "cuda", "--seed", "0",
            "--log-every", "1"]
    log(f"sync path: python -m repro_torch.launch.train {' '.join(argv)}"
        + (f" (cfg: n_layers {cfg.n_layers})" if cfg is not None else ""))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    history = train.main(argv, cfg=cfg)
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"sync path {arch} {sync}: {steps} steps in {wall:.2f} s (model "
        f"init included); step_s {[round(r['step_s'], 4) for r in history]};"
        f" losses {[r['loss'] for r in history]}; peak memory {peak} bytes "
        f"({peak / total:.4f} of {total}); launches {json.dumps(counts)}")
    require(len(history) == steps, "missing steps")
    require(peak <= 0.9 * total, "peak memory above 90% of the card")
    for row in history:
        require(math.isfinite(row["loss"]) and
                math.isfinite(row["gap2_over_alpha2"]),
                f"non-finite step {row}")
    want = {"topk_ef": {"topk_ef": n_leaves * 2 * steps,
                        "topk_cr_reduce": n_leaves * steps},
            "onebit_ef": {"onebit_cr_reduce": n_leaves * steps},
            "elastic": {}}[sync]
    want = {**want, **(also or {})}
    for name, count in counts.items():
        require(count == want.get(name, 0),
                f"{sync}: {name} launched {count} times, not "
                f"{want.get(name, 0)}")
    return counts


# ---------------------------------------------------------------------------
# phases 24-28: RWKV6 training and serving, gemma3's local:global stack
# ---------------------------------------------------------------------------

RWKV_ARCH = "rwkv6-1.6b"
TRAIN_STEPS = 2
# phase 24: card against CPU.  f32 compute within SMALL_F32_TOL; bf16 within
# SMALL_BF16_TOL, the bound the CPU parity tests hold these models to
# against the reference (tests/test_torch_rwkv6.py, test_torch_archs.py)
SMALL_F32_TOL, SMALL_BF16_TOL = 1e-3, 0.1
# phases 27 and 28: (arch, batch, prompt, tokens) served through --engine loop
LOOP_SERVES = (("rwkv6-1.6b", 4, 4096, 32), ("gemma3-27b", 1, 2048, 16))


def _model_logits(torch, TF, cfg, params, d, batch, feed):
    """``forward`` of ``cfg`` on device ``d``, then the batch's prompt
    (its tokens and a frontend's stub embeddings) through ``prefill`` and
    the teacher-forced decode steps: the logits of each, f32 on the CPU,
    and the forward's aux loss."""
    from repro_torch import tree as T
    p = T.tree_map(lambda a: a.to(d), params)
    b = {k: v.to(d) for k, v in batch.items()}
    prompt = {k: v for k, v in b.items() if k != "labels"}
    with torch.no_grad():
        logits, aux = TF.forward(cfg, p, b)
        out = [logits.float().cpu()]
        lg, cache = TF.prefill(cfg, p, prompt,
                               b["tokens"].shape[1] + len(feed))
        out.append(lg.float().cpu())
        for f in feed:
            lg, cache = TF.decode_step(cfg, p, cache,
                                       torch.tensor(f, device=d))
            out.append(lg.float().cpu())
    return out, float(aux)


def check_small_models(torch, dev, cfgs, seq, f32_tol, bf16_tol,
                       aux_tol=0.0):
    """Phases 24 and 29, models: each config of ``cfgs`` on the card
    against the same code on the CPU, on a ``synthetic_batch`` of 2 x
    ``seq`` (the stubs' embeddings included): forward, prefill and 4
    teacher-forced decode steps, in f32 compute (logits within
    ``f32_tol``) and in bf16 (``bf16_tol``), the router's aux loss within
    ``aux_tol``, with TF32 and reduced-precision bf16 reductions off."""
    import numpy as np

    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params

    rng = np.random.default_rng(0)
    set_matmul_precision(torch, False)
    compute = TF.COMPUTE_DTYPE
    try:
        for cfg in cfgs:
            batch = synthetic_batch(cfg, 2, seq, seed=0)
            feed = rng.integers(0, cfg.vocab_size,
                                (4, 2, 1)).astype(np.int32)
            params = init_params(TF.model_defs(cfg),
                                 torch.Generator().manual_seed(0), "cpu")
            for dtype, tol in ((torch.float32, f32_tol),
                               (torch.bfloat16, bf16_tol)):
                TF.COMPUTE_DTYPE = dtype
                cpu, aux_c = _model_logits(torch, TF, cfg, params, "cpu",
                                           batch, feed)
                card, aux_g = _model_logits(torch, TF, cfg, params, dev,
                                            batch, feed)
                err = max(float((a - b).abs().max())
                          for a, b in zip(cpu, card))
                finite = all(bool(torch.isfinite(a).all()) for a in card)
                log(f"check model {cfg.name} n_layers {cfg.n_layers} windows "
                    f"{sorted(set(cfg.layer_window_sizes()))}, "
                    f"{cfg.frontend} frontend, {cfg.n_experts} experts, "
                    f"compute {dtype}, card vs cpu, forward + prefill of "
                    f"{seq} + 4 decode steps: logits max_abs_err {err} (tol "
                    f"{tol}; max |logit| "
                    f"{max(float(a.abs().max()) for a in cpu)}), aux "
                    f"{aux_g} vs {aux_c} (tol {aux_tol})")
                require(finite, f"{cfg.name}: non-finite logits on the card")
                require(err <= tol, f"{cfg.name}: logits differ card vs cpu")
                require(abs(aux_g - aux_c) <= aux_tol,
                        f"{cfg.name}: aux loss differs card vs cpu")
    finally:
        TF.COMPUTE_DTYPE = compute


def run_family_training(torch, kernels, records, arch, layers, tau_max,
                        key, forward_kernels=None):
    """Phases 25, 30 and 31: ``arch`` at full width, cut to ``layers``
    (None: its full depth), through the trainer's entry point (``cfg=``),
    ``TRAIN_STEPS`` async top-k steps at ``tau_max``, then
    ``TRAIN_STEPS`` ``--sync topk_ef`` steps, the launch counters zeroed
    just before each run and read just after: exactly 2 K1 calls a leaf a
    step, one K2 (async) or K4 (sync) call a leaf a step, and
    ``forward_kernels`` (name -> launches a run: K10 on the Mamba2 stack);
    the counts go to ``records`` under ``key``.  Returns the config."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch import tree as T
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import count_params

    base = get_config(arch)
    cfg = dataclasses.replace(base, n_layers=layers or base.n_layers)
    defs = TF.model_defs(cfg)
    n = len(T.leaves(defs))
    big = max(zip(T.paths(defs), T.leaves(defs)),
              key=lambda pd: math.prod(pd[1].shape))
    log(f"{arch} training at full width, {cfg.n_layers} of {base.n_layers} "
        f"layers: {n} leaves, {count_params(defs)} entries; largest "
        f"{big[0]} {math.prod(big[1].shape)}")
    also = forward_kernels or {}
    gc.collect()
    torch.cuda.empty_cache()
    counts = run_path(torch, kernels, "topk", TRAIN_STEPS, arch=arch,
                      tau_max=tau_max, cfg=cfg)
    want = {"topk_ef": n * 2 * TRAIN_STEPS,
            "topk_cr_deposit": n * TRAIN_STEPS, **also}
    for name, count in counts.items():
        require(count == want.get(name, 0),
                f"{arch} async: {name} launched {count} times, not "
                f"{want.get(name, 0)}")
    got = {name: counts[name] for name in want}
    gc.collect()
    torch.cuda.empty_cache()
    counts = run_sync_path(torch, kernels, "topk_ef", arch=arch,
                           steps=TRAIN_STEPS, cfg=cfg, also=also)
    got["topk_ef"] += counts["topk_ef"]
    got["topk_cr_reduce"] = counts["topk_cr_reduce"]
    for name in also:
        got[name] += counts[name]
    for name, count in got.items():
        records[name][key] = count
    log(f"{arch} training: launches {json.dumps(got)}")
    return cfg


# ---------------------------------------------------------------------------
# phases 29-32: moonshot-v1-16b-a3b, grok-1-314b, the frontends, zamba2
# training
# ---------------------------------------------------------------------------

FAMILY_SMOKES = ("moonshot-v1-16b-a3b-smoke", "grok-1-314b-smoke",
                 "internvl2-2b-smoke", "musicgen-large-smoke")
# phase 29: card against CPU, the bounds tests/test_torch_families.py holds
# these smoke models to against the reference (f32 compute logits, bf16
# logits, the router's aux loss)
FAMILY_F32_TOL, FAMILY_BF16_TOL, FAMILY_AUX_TOL = 1e-3, 0.3, 2e-3
# K10 under autograd at zamba2 training's shape (one worker's batch 2 x 256
# of 64 heads of 112, N 64), bf16: the gradients against ssd_plain's
# autograd, within SSD_GRAD_REL of each gradient's largest magnitude (the
# backward is ssd_plain's, recomputed on the same inputs, so the two are
# expected bitwise equal)
SSD_TRAIN = (2, 256, 64, 112, 64)
SSD_GRAD_REL = 1e-6
MOONSHOT, MOONSHOT_LAYERS, MOONSHOT_TAU = "moonshot-v1-16b-a3b", 2, 1
ZAMBA2, ZAMBA2_LAYERS = "zamba2-7b", 12
GROK, GROK_LAYERS = "grok-1-314b", 6
# phase 32's loop serves: (arch, batch, prompt, tokens), full depth
FRONTEND_SERVES = (("internvl2-2b", 4, 4096, 16),
                   ("musicgen-large", 4, 2048, 16))


def check_ssd_autograd(torch, dev, gen):
    """Phase 29, K10 under autograd at zamba2 training's shape in bf16,
    with decays in (-1, 0) and in (-2, -1) (a chunk's summed decay then
    passes -128: exp(cum_i - cum_j) above the diagonal overflows, which
    the plain version masks before the exponential): the forward bitwise
    the no-grad launch and one launch counted; the backward launches
    nothing and gives ssd_plain's autograd gradients within SSD_GRAD_REL,
    finite, in the inputs' dtypes."""
    from repro_torch.kernels.ssd.kernel import ssd_chunked
    from repro_torch.kernels.ssd.ref import ssd_plain
    b, t, h, hd, n = SSD_TRAIN
    for lo in (0.0, 1.0):
        x = torch.randn((b, t, h, hd), generator=gen,
                        device=dev).to(torch.bfloat16)
        a = -lo - torch.rand((b, t, h), generator=gen, device=dev)
        bm = torch.randn((b, t, n), generator=gen,
                         device=dev).to(torch.bfloat16)
        cm = torch.randn((b, t, n), generator=gen,
                         device=dev).to(torch.bfloat16)
        wy = torch.randn((b, t, h, hd), generator=gen, device=dev)
        ws = torch.randn((b, h, hd, n), generator=gen, device=dev)
        y0, s0 = ssd_chunked(x, a, bm, cm)
        grads, ms = [], []
        for fn in (ssd_chunked, ssd_plain):
            ins = [v.clone().requires_grad_() for v in (x, a, bm, cm)]
            torch.cuda.synchronize()
            before = ssd_chunked.launches
            t0 = time.perf_counter()
            y, s = fn(*ins)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ((y.float() * wy).sum() + (s * ws).sum()).backward()
            torch.cuda.synchronize()
            ms.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
            if fn is ssd_chunked:
                same = torch.equal(y, y0) and torch.equal(s, s0)
                require(same and ssd_chunked.launches == before + 1,
                        "K10 under autograd: forward not the no-grad launch")
            grads.append([v.grad for v in ins])
        worst, bitwise = 0.0, True
        for got, want, v in zip(*grads, (x, a, bm, cm)):
            require(got.dtype == v.dtype and got.is_contiguous()
                    and bool(torch.isfinite(got.float()).all()),
                    "K10 gradient dtype, layout or finiteness")
            scale = float(want.float().abs().max())
            worst = max(worst, float((got.float() - want.float()).abs().max())
                        / scale)
            bitwise = bitwise and torch.equal(got, want)
        log(f"check ssd_chunked under autograd {SSD_TRAIN} bf16, a in "
            f"({-lo - 1}, {-lo}): forward bitwise the no-grad launch, 1 "
            f"launch, none in backward; gradients vs ssd_plain's autograd: "
            f"largest error {worst} of each gradient's max (tol "
            f"{SSD_GRAD_REL}), bitwise {bitwise}; host clock, one call "
            f"each: kernel forward {ms[0][0]:.3f} ms + backward "
            f"{ms[0][1]:.3f} ms, plain forward {ms[1][0]:.3f} ms + backward "
            f"{ms[1][1]:.3f} ms")
        require(worst <= SSD_GRAD_REL, "K10 gradients differ from ssd_plain's")
        del x, a, bm, cm, wy, ws, y0, s0, grads
    torch.cuda.empty_cache()


def run_moonshot_training(torch, kernels, records):
    """Phase 30: moonshot-v1-16b-a3b at full width, 2 of its 48 layers (13
    leaves; ``w_gate``, ``w_up`` and ``w_down`` 369,098,752 entries each),
    async at tau_max 1, then ``topk_ef``; a profiled ``topk_ef`` step with
    the ``moe_dispatch`` range (routing and the dispatch product) grouped
    apart."""
    cfg = run_family_training(torch, kernels, records, MOONSHOT,
                              MOONSHOT_LAYERS, MOONSHOT_TAU,
                              "moonshot_launches")
    gc.collect()
    torch.cuda.empty_cache()
    profile_step(torch, "profile moonshot topk_ef step", sync="topk_ef",
                 arch=MOONSHOT, cfg=cfg, range_name="moe_dispatch",
                 range_group="MoE dispatch")


def run_zamba2_training(torch, kernels, records):
    """Phase 31: zamba2-7b at full width, 12 of its 81 Mamba2 layers (the
    shared block twice; 27 leaves), async at tau_max 2, then ``topk_ef``.
    K10 runs each Mamba2 layer's forward under autograd, once a layer a
    worker a step, and never in backward (its backward is ``ssd_plain``
    recomputed; no layer is checkpointed): 2 workers x 12 layers x 2
    steps = 48 launches a run.  Then a profiled async step with K10's
    passes and the shared block's attention grouped apart."""
    k10 = {"ssd_chunked": 2 * ZAMBA2_LAYERS * TRAIN_STEPS}
    cfg = run_family_training(torch, kernels, records, ZAMBA2,
                              ZAMBA2_LAYERS, 2, "zamba2_launches", k10)
    gc.collect()
    torch.cuda.empty_cache()
    profile_step(torch, "profile zamba2 async step", arch=ZAMBA2, cfg=cfg,
                 groups=HYBRID_GROUPS[:1] + PROFILE_GROUPS,
                 range_name="shared_attention",
                 range_group="shared attention")


def run_family_serves(torch, kernels):
    """Phase 32: moonshot-v1-16b-a3b at full depth and grok-1-314b cut to
    6 of 64 layers through ``--engine continuous`` (full attention, no
    kernel of the port), a profiled moonshot decode step with the full
    attention's gather and scores (``attend_full``) grouped apart; then
    internvl2-2b and musicgen-large at full depth through ``--engine
    loop`` with their stubs' embeddings (no kernel of the port)."""
    counts, out = run_serve(torch, kernels, MOONSHOT, None, per_step=())
    profile_serve(torch, out["engine"], "attend_full", "full attention")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    counts, out = run_serve(torch, kernels, GROK, GROK_LAYERS, per_step=())
    del out
    for arch, batch, prompt, n_tok in FRONTEND_SERVES:
        gc.collect()
        torch.cuda.empty_cache()
        run_loop_serve(torch, kernels, arch, batch, prompt, n_tok)


# ---------------------------------------------------------------------------
# phases 33-35: optimizers, checkpoints, kill and resume, faulted serving
# ---------------------------------------------------------------------------

def host_resources() -> str:
    """Free disk of ``CKPT_ROOT``'s filesystem and free host memory."""
    free_disk = shutil.disk_usage(ROOT).free
    avail = "unknown"
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = str(int(line.split()[1]) * 1024)
    return (f"free disk {free_disk} bytes ({ROOT}), free host memory "
            f"{avail} bytes")


OPTIM_STEPS = 5
# card against CPU: the same elementwise arithmetic in the same order, but
# the global norm's sums run in another order on the card, and adam's
# moments have differed in the last bits (relative 8e-8 after 5 steps)
OPTIM_TOL = 1e-6


def check_optim(torch, dev) -> None:
    """Phase 33a: every optimizer and schedule of ``repro_torch.optim``,
    ``OPTIM_STEPS`` steps on the same leaves and gradients on the card and
    on the CPU; params and state within ``OPTIM_TOL`` (relative, plus
    ``OPTIM_TOL`` absolute), counts equal."""
    import numpy as np

    from repro_torch import optim as O

    sched = O.warmup_cosine(3e-2, 2, 6)
    cases = {
        "sgd": (lambda: O.sgd(O.constant(0.05)), None),
        "momentum": (lambda: O.momentum(O.constant(0.05), 0.9), None),
        "nesterov": (lambda: O.momentum(O.constant(0.05), 0.9,
                                        nesterov=True), None),
        "adam": (lambda: O.adam(O.constant(1e-2)), None),
        "adam_wd": (lambda: O.adam(O.constant(1e-2), weight_decay=0.01),
                    None),
        "adam_warmup_cosine": (lambda: O.adam(sched), None),
        "momentum_clipped": (lambda: O.momentum(O.constant(0.05), 0.9), 2.5),
    }
    rng = np.random.default_rng(0)
    shapes = ((1024, 64), (4099,), (3, 5, 7))
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * np.float32(3 ** t)
              for s in shapes] for t in range(OPTIM_STEPS)]
    for name, (make, clip) in cases.items():
        out = {}
        for d in ("cpu", dev):
            opt = make()
            # copies: the updates land in place
            params = [torch.tensor(x, device=d) for x in p0]
            state = opt.init(params)
            norms = []
            for g_np in grads:
                g = [torch.tensor(x, device=d) for x in g_np]
                if clip is not None:
                    g, norm = O.clip_by_global_norm(g, clip)
                    norms.append(float(norm))
                upd, state = opt.update(g, state, params)
                O.apply_updates(params, upd)
            moments = [x for k in ("mu", "m", "v") for x in state.get(k, [])]
            out[str(d)] = (state["count"], params + moments, norms)
        (c_cpu, t_cpu, n_cpu), (c_card, t_card, n_card) = (
            out["cpu"], out[str(dev)])
        err = max(float(((a.cpu() - b).abs() / (b.abs() + 1)).max())
                  for a, b in zip(t_card, t_cpu))
        bitwise = all(torch.equal(a.cpu(), b) for a, b in zip(t_card, t_cpu))
        log(f"check optim {name}: card vs cpu {OPTIM_STEPS} steps, count "
            f"{c_card} vs {c_cpu}, params/state max rel err {err}"
            f"{' (bitwise)' if bitwise else ''}"
            + (f", norms {n_card} vs {n_cpu}" if clip else ""))
        require(c_card == c_cpu == OPTIM_STEPS, f"{name}: count")
        require(err <= OPTIM_TOL, f"{name}: card disagrees with the CPU")
        for a, b in zip(n_card, n_cpu):
            require(math.isclose(a, b, rel_tol=OPTIM_TOL), f"{name}: norm")
    log("check schedules: " + ", ".join(
        f"{name} {[float(fn(t)) for t in range(8)]}" for name, fn in (
            ("warmup_cosine(3e-2, 2, 6)", sched),
            ("cosine_decay(0.1, 7, 0.05)", O.cosine_decay(0.1, 7, 0.05)))))


def same_leaf(torch, a, b) -> bool:
    """A checkpoint leaf restored: tensors bitwise (any dtype), numbers
    and integer arrays equal, of the same type."""
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))
    return bool(type(a) is type(b) and (a == b if not hasattr(a, "shape")
                                        else (a == b).all()))


def check_ckpt_round_trip(torch, dev) -> None:
    """Phase 33b: qwen3-1.7b-smoke's async fused state on the card (2
    workers, tau_max 2, top-k with EF; rings, residuals and momentum
    filled), a bf16 copy of its params, Python ints and the numpy tau
    table: saved, then restored in place into zeroed tensors of the same
    layout: bitwise, every ``data_ptr`` kept."""
    import tempfile

    import numpy as np

    from repro_torch import tree as T
    from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                        save_checkpoint)
    from repro_torch.configs import get_config
    from repro_torch.dist.async_engine import AsyncConfig, init_async_state
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params, param_specs
    from repro_torch.optim import constant, momentum

    cfg = get_config("qwen3-1.7b-smoke")
    defs = TF.model_defs(cfg)
    specs = param_specs(defs)
    gen = torch.Generator(device=dev).manual_seed(3)

    def state_tree(fill: bool):
        params = init_params(defs, gen, dev)
        opt_state = momentum(constant(1e-2), 0.9).init(T.leaves(params))
        acfg = AsyncConfig(tau_max=2, compressor="topk",
                           topk_ratio=TOPK_RATIO)
        state = init_async_state(acfg, 2, params, specs)
        serving = T.tree_map(lambda p: p.to(torch.bfloat16), params)
        tree = (params, opt_state, state, serving)
        if fill:
            opt_state["count"], state["step"] = 7, 5
            for x in opt_state["mu"] + T.leaves(state["acc"]) + \
                    T.leaves(state["err"]):
                x.normal_(generator=gen)
        else:
            for x in T.leaves(params) + T.leaves(serving):
                x.zero_()
            state["taus"] = np.zeros_like(state["taus"])
        return tree

    def flat(tree):
        params, opt_state, state, serving = tree
        return (T.leaves(params) + [opt_state["count"]] + opt_state["mu"]
                + T.leaves(state["acc"]) + T.leaves(state["err"])
                + [state["step"], state["taus"]] + T.leaves(serving))

    saved = state_tree(True)
    like = state_tree(False)
    ptrs = [x.data_ptr() for x in flat(like) if isinstance(x, torch.Tensor)]
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(tmp, 5, saved)
        save_s = time.perf_counter() - t0
        require(latest_step(tmp) == 5, "latest_step after the save")
        t0 = time.perf_counter()
        out = load_checkpoint(tmp, 5, like=like)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        n_bytes = os.path.getsize(path)
    got, want = flat(out), flat(saved)
    same = all(same_leaf(torch, a, b) for a, b in zip(got, want))
    kept = [x.data_ptr() for x in got if isinstance(x, torch.Tensor)] == ptrs
    log(f"check ckpt round trip on the card: {len(want)} leaves, {n_bytes} "
        f"bytes, save {save_s:.3f} s, load in place {load_s:.3f} s; bitwise "
        f"{same}, data_ptr kept {kept}; count {out[1]['count']}, step "
        f"{out[2]['step']}")
    require(same and kept, "checkpoint round trip on the card")
    require(out[1]["count"] == 7 and out[2]["step"] == 5, "ints restored")


KILL_RESUME_ARCH = "qwen3-1.7b"
# a checkpoint is 24 bytes an entry (params, momentum, two ring slots, two
# EF residuals): 41.3 GB at 28 layers, 13.5 GB at 5 (computed).  The phase
# writes three (the first oracle's final one, the supervised run's steps 2
# and 4; the second oracle's final state is compared with the first's file,
# not written); a run of this script may write at most DISK_WRITE_LIMIT to
# the host's disk, deleted files included (PERF.md section 4).  5 is the
# deepest cut whose three writes fit in 0.85 of it (6 layers: 41.1 GiB)
KILL_RESUME_LAYERS = 5
KILL_RESUME_WRITES = 3
DISK_WRITE_LIMIT = 45 * 2 ** 30
KILL_RESUME_STEPS = 4
KILL_RESUME_PLAN = {"seed": 0, "events": [
    {"step": 2, "kind": "kill", "on_attempt": 0},
    {"step": 1, "kind": "grad_poison"},
    {"step": 1, "kind": "crash", "worker": 1, "duration": 1}]}
LOSS_LINE = re.compile(r"^step\s+(\d+)\s+loss\s+(\S+)")
CKPT_LINE = re.compile(r"^ckpt: (saved|loaded) step (\d+) in ([\d.]+) s"
                       r"(?: \((\d+) bytes\))?")


def kill_resume_argv():
    return ["--arch", KILL_RESUME_ARCH, "--n-layers",
            str(KILL_RESUME_LAYERS), "--sync", "async", "--compressor",
            "topk", "--topk-ratio", str(TOPK_RATIO), "--ef", "--overlap",
            "--tau-max", "1", "--async-schedule", "uniform", "--workers",
            "2", "--batch", "4", "--seq", "256", "--steps",
            str(KILL_RESUME_STEPS), "--ckpt-every", "2", "--device", "cuda",
            "--seed", "0", "--log-every", "1"]


def compare_checkpoints(a_dir: Path, b_dir: Path, step: int):
    """Leaf by leaf (one leaf in host memory at a time): -> (leaves,
    bytes, [keys that differ])."""
    import numpy as np

    name = f"step_{step:08d}.npz"
    differ, n_bytes = [], 0
    with np.load(a_dir / name) as a, np.load(b_dir / name) as b:
        require(sorted(a.files) == sorted(b.files), "checkpoint leaf keys")
        for key in a.files:
            x, y = a[key], b[key]
            n_bytes += x.nbytes
            if x.dtype != y.dtype or x.shape != y.shape or \
                    x.tobytes() != y.tobytes():
                differ.append(key)
            del x, y
        return len(a.files), n_bytes, differ


def compare_with_checkpoint(ckpt_dir: Path, step: int, tree):
    """``tree`` against checkpoint ``step`` of ``ckpt_dir``, leaf by leaf in
    the checkpoint module's own order and encoding, one leaf in host memory
    at a time, writing nothing: -> (leaves, bytes, [keys that differ])."""
    import numpy as np

    from repro_torch.checkpoint import ckpt

    leaves: list = []
    ckpt._describe(tree, leaves)
    differ, n_bytes = [], 0
    with np.load(ckpt_dir / f"step_{step:08d}.npz") as a:
        require(len(a.files) == len(leaves), "checkpoint leaf count")
        for i, leaf in enumerate(leaves):
            x, y = a[str(i)], ckpt._host_array(leaf)
            n_bytes += x.nbytes
            if x.dtype != y.dtype or x.shape != y.shape or \
                    x.tobytes() != y.tobytes():
                differ.append(str(i))
            del x, y
    return len(leaves), n_bytes, differ


def run_oracle(torch, argv, kernels=None):
    """One in-process run of the trainer, its standard output captured and
    logged; -> (history, text, launch counts, peak bytes)."""
    from repro_torch.launch import train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels or ():
        k.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        history = train.main(argv)
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels or ()}
    peak = torch.cuda.max_memory_allocated()
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  oracle | {line}")
    log(f"oracle: {len(history)} steps in {wall:.2f} s (model init and "
        f"checkpoints included); peak memory {peak} bytes; launches "
        f"{json.dumps(counts)}")
    return history, text, counts, peak


def run_kill_resume(torch, kernels, records) -> None:
    """Phase 34 (see the module docstring)."""
    import dataclasses

    from repro_torch import checkpoint as CK
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import count_params

    base = get_config(KILL_RESUME_ARCH)
    cfg = dataclasses.replace(base, n_layers=KILL_RESUME_LAYERS)
    defs = TF.model_defs(cfg)
    n_leaves, entries = len(T.leaves(defs)), count_params(defs)
    full = count_params(TF.model_defs(base))
    # params, momentum, two ring slots (tau_max 1) and two EF residuals
    predicted = 24 * entries
    free = shutil.disk_usage(ROOT).free
    log(f"kill-resume: {KILL_RESUME_ARCH} at full width, "
        f"{cfg.n_layers} of {base.n_layers} layers: {n_leaves} leaves, "
        f"{entries} entries ({full} at full depth); checkpoint about "
        f"{predicted} bytes (computed; {24 * full} at full depth); "
        f"{host_resources()}")
    require(3 * predicted <= 0.8 * free,
            "three checkpoints do not fit in 80% of the free disk")
    require(KILL_RESUME_WRITES * predicted <= 0.85 * DISK_WRITE_LIMIT,
            "the phase's checkpoints would write too much to the disk")
    total = torch.cuda.get_device_properties(0).total_memory
    plan = json.dumps(KILL_RESUME_PLAN)
    argv = kill_resume_argv()
    dirs = {k: CKPT_ROOT / k for k in ("oracle_a", "oracle_b", "supervised")}
    save = CK.save_checkpoint
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    CKPT_ROOT.mkdir(parents=True)
    proc = None
    try:
        # the oracle saves its final step only: a save reads the state and
        # changes nothing in the run
        oracle_argv = argv + ["--fault-plan", plan, "--fault-attempt", "1",
                              "--ckpt-every", str(KILL_RESUME_STEPS)]
        log(f"kill-resume oracle: python -m repro_torch.launch.train "
            f"{' '.join(oracle_argv)} --ckpt-dir {dirs['oracle_a']}")
        hist_a, text_a, counts, peak = run_oracle(
            torch, oracle_argv + ["--ckpt-dir", str(dirs["oracle_a"])],
            kernels)
        want = {"topk_ef": n_leaves * 2 * KILL_RESUME_STEPS,
                "topk_cr_deposit": n_leaves * KILL_RESUME_STEPS}
        for name, count in counts.items():
            require(count == want.get(name, 0), f"kill-resume oracle: "
                    f"{name} launched {count} times, not {want.get(name, 0)}")
        for name in want:
            records[name]["kill_resume_launches"] = counts[name]
        log(f"kill-resume oracle: peak memory {peak / total:.4f} of {total}")
        require(peak <= 0.9 * total, "peak memory above 90% of the card")
        require("faults: poisoned=1 skipped=1 ckpt_errors=0" in text_a,
                "the oracle's fault line")
        losses_a = [r["loss"] for r in hist_a]
        require(math.isnan(losses_a[1]) and all(
            math.isfinite(x) for i, x in enumerate(losses_a) if i != 1),
            f"oracle losses {losses_a}")

        # determinism: a second uninterrupted run, bitwise the first; its
        # final save is compared with the first run's file, not written
        compared = []

        def compare_instead(ckpt_dir, step, tree, *, write=True):
            require(write, "the in-process oracle's save does not write")
            compared.append(compare_with_checkpoint(dirs["oracle_a"], step,
                                                    tree))
            return str(dirs["oracle_a"] / f"step_{step:08d}.npz")

        CK.save_checkpoint = compare_instead
        try:
            hist_b, _, _, _ = run_oracle(
                torch, oracle_argv + ["--ckpt-dir", str(dirs["oracle_b"])])
        finally:
            CK.save_checkpoint = save
        require(len(compared) == 1, "the second oracle's final state was "
                "not compared")
        n, n_bytes, differ = compared[0]
        same_losses = [f"{x:.6f}" for x in losses_a] == \
            [f"{r['loss']:.6f}" for r in hist_b]
        log(f"kill-resume determinism: oracle run twice, the second's final "
            f"state (compared, not written) against the first's checkpoint: "
            f"{n} leaves, {n_bytes} bytes, leaves that differ {differ}; "
            f"losses {losses_a} vs {[r['loss'] for r in hist_b]}")
        require(not differ and same_losses,
                "two uninterrupted runs differ on the card")
        require(not dirs["oracle_b"].exists(), "the second oracle wrote")
        del hist_b
        gc.collect()
        torch.cuda.empty_cache()
        log(f"kill-resume: memory allocated before the supervisor "
            f"{torch.cuda.memory_allocated()} bytes, reserved "
            f"{torch.cuda.memory_reserved()}")

        plan_path = CKPT_ROOT / "plan.json"
        plan_path.write_text(plan)
        cmd = [sys.executable, "-m", "repro_torch.launch.supervisor",
               "--backoff", "0.5", "--heartbeat", "600", "--fault-plan",
               str(plan_path), "--", *argv, "--ckpt-dir",
               str(dirs["supervised"])]
        log(f"kill-resume: {' '.join(cmd[1:])}")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + (
            os.pathsep + os.environ["PYTHONPATH"]
            if os.environ.get("PYTHONPATH") else ""))
        t_start = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                env=env, cwd=ROOT, start_new_session=True)
        lines = []
        for line in proc.stdout:
            lines.append((time.perf_counter() - t_start, line.rstrip("\n")))
            log(f"  supervised {lines[-1][0]:8.2f} s | {lines[-1][1]}")
        rc = proc.wait(timeout=60)
        wall = time.perf_counter() - t_start
        text = [t for _, t in lines]
        require(rc == 0, f"supervisor exit {rc}")
        require(any(t.startswith("fault: SIGKILL at step 2") for t in text),
                "no SIGKILL at step 2")
        require("resumed from step 2" in text, "no resume from step 2")
        require("[supervisor] child completed on attempt 1" in text,
                "the child did not complete on attempt 1")
        got = [(int(m.group(1)), m.group(2)) for m in map(LOSS_LINE.match,
                                                          text) if m]
        want_steps = [0, 1, 2, 2, 3]
        require([s for s, _ in got] == want_steps,
                f"printed steps {[s for s, _ in got]}, not {want_steps}")
        mism = [(s, loss, f"{losses_a[s]:.6f}") for s, loss in got
                if loss != f"{losses_a[s]:.6f}"]
        log(f"kill-resume: printed losses {got}; oracle "
            f"{[f'{x:.6f}' for x in losses_a]}; mismatches {mism}")
        require(not mism, "a resumed step's loss differs from the oracle's")
        n, n_bytes, differ = compare_checkpoints(
            dirs["oracle_a"], dirs["supervised"], KILL_RESUME_STEPS)
        log(f"kill-resume: final checkpoints {n} leaves, {n_bytes} bytes of "
            f"arrays, leaves that differ from the oracle's {differ}")
        require(not differ, "the resumed run's checkpoint differs")
        t_kill = next(t for t, s in lines if s.startswith("fault: SIGKILL"))
        i_resume = next(i for i, (_, s) in enumerate(lines)
                        if s == "resumed from step 2")
        t_first = next(t for t, s in lines[i_resume:]
                       if LOSS_LINE.match(s))
        io_lines = [m.groups() for m in map(CKPT_LINE.match, text) if m]
        oracle_io = [m.groups() for m in map(CKPT_LINE.match,
                                             text_a.splitlines()) if m]
        size = os.path.getsize(dirs["supervised"] /
                               f"step_{KILL_RESUME_STEPS:08d}.npz")
        log(f"kill-resume: checkpoint {size} bytes on disk (predicted "
            f"{predicted}); supervised saves/loads {io_lines}; oracle saves "
            f"{oracle_io}; kill to first resumed step {t_first - t_kill:.2f} "
            f"s; supervised wall {wall:.2f} s")
    finally:
        CK.save_checkpoint = save
        if proc is not None and proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)


FAULT_SERVE_LAYERS = 8
FAULT_SERVE_PLAN = {"seed": 0, "events": [
    {"step": 4, "kind": "logit_poison"},
    {"step": 6, "kind": "page_exhaust", "param": 16.0, "duration": 3}]}
# the reference's launcher quarantines 4 requests on this schedule and plan:
# the poisoned request's NaN reaches every token of its group through the
# MoE's dense dispatch product, and requests admitted later read the pages
# it left (test_serve_fault_plan_card_schedule_matches_reference)
FAULT_SERVE_QUARANTINED = 4


def run_faulted_serve(torch, kernels) -> None:
    """Phase 35 (see the module docstring)."""
    _, clean = run_serve(torch, kernels, layers=FAULT_SERVE_LAYERS)
    clean_toks = [list(map(int, t)) for t in clean["tokens"]]
    del clean
    gc.collect()
    torch.cuda.empty_cache()
    counts, out = run_serve(torch, kernels, layers=FAULT_SERVE_LAYERS,
                            extra=("--fault-plan",
                                   json.dumps(FAULT_SERVE_PLAN)))
    sched, engine = out["scheduler"], out["engine"]
    toks = [list(map(int, t)) for t in out["tokens"]]
    first = next(((i, j, a[j], b[j]) for i, (a, b) in
                  enumerate(zip(toks, clean_toks)) for j in range(len(a))
                  if a[j] != b[j]), None)
    log(f"faulted serve: quarantined {sched.quarantined}, failed "
        f"{sched.failed}, rejected {sched.rejected}, clock {sched.clock}, "
        f"{engine.steps} decode steps, check_finite {engine.check_finite}; "
        f"greedy tokens equal to the fault-free run's: {first is None}"
        + ("" if first is None else
           f" (first difference: request {first[0]} token {first[1]}: "
           f"{first[2]} against {first[3]})"))
    require(engine.check_finite, "logit_poison did not arm check_finite")
    require(sched.failed == 0
            and sched.quarantined == FAULT_SERVE_QUARANTINED,
            f"faulted serve: {sched.failed} failed, {sched.quarantined} "
            f"quarantined (the reference: 0 and {FAULT_SERVE_QUARANTINED})")
    require(counts["swa_decode_attention"] > 0, "K9 never launched")
    del out
    gc.collect()
    torch.cuda.empty_cache()


# phase 36: data-parallel workers over two torch.distributed ranks
DIST_ARCH = "qwen3-1.7b"
DIST_LAYERS = 7
DIST_RUNS = (("async", ["--sync", "async", "--compressor", "topk",
                        "--ef", "--overlap", "--tau-max", "2",
                        "--async-schedule", "uniform"], 4),
             ("topk_ef", ["--sync", "topk_ef"], 2))
# bytes a rank holds an entry at tau_max 2 with one worker (params,
# momentum, one EF residual, three ring slots, a gradient, the applied
# update, the transients of the step): 36.4 at this phase's peak on an
# H100 80GB HBM3.  Beside the ranks the oracle keeps its whole final state
# for rank 0 to compare with: 28 B an entry for the async run (params,
# momentum, two workers' EF residuals, three ring slots), 16 for topk_ef.
# At 12 layers (915,198,976 entries) that is 66.6 GB for the ranks and
# 25.6 GB for the oracle, more than the card; at 7 (663,518,976) it is
# 48.3 + 18.6 GB, with about 9 GB left for the three CUDA contexts, the
# ranks' reserved but unallocated cache and this process's reserve after
# phases 1-35 (with the params alone kept, 13 layers left about 2 GB)
DIST_BYTES_PER_ENTRY = 36.4


def dist_argv(flags, steps):
    return ["--arch", DIST_ARCH, "--n-layers", str(DIST_LAYERS), *flags,
            "--topk-ratio", str(TOPK_RATIO), "--workers", "2", "--batch",
            "4", "--seq", "256", "--steps", str(steps), "--device", "cuda",
            "--seed", "0", "--log-every", "1"]


def run_grid_oracle(torch, kernels, cfg, argv, model: int = 1,
                    whole: bool = False) -> dict:
    """The one-process oracle of a ``--ranks`` run: ``argv``'s workers and
    steps in this process, built from the library (as
    ``repro_torch.launch.train`` builds them) with the model-``model``
    specs, every kernel's counter zeroed just before.  -> losses, step
    seconds, wall, launches, peak, the bytes a step by collective and the
    final leaves in a checkpoint's order, which stay on the card: the
    params', or with ``whole`` the params', the optimizer state's and the
    sync state's; the rest is freed."""
    from repro_torch import tree as T
    from repro_torch.checkpoint import checkpoint_leaves
    from repro_torch.data.pipeline import SyntheticLMDataset, to_device
    from repro_torch.dist.workers import WorkerGroup
    from repro_torch.launch import train
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params, param_specs

    dev = torch.device("cuda")
    # the trainer's precision: bitwise the ranks' (train._train sets it)
    set_matmul_precision(torch, False)
    args = train._parse(argv)
    defs = TF.model_defs(cfg)
    specs = param_specs(defs, {"model": model})
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(defs, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    group = WorkerGroup(args.workers)
    opt_state, state, run = train._build(args, cfg, group, params, specs)
    data = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch,
                              seed=args.seed)
    losses, step_s, wire = [], [], []
    for t in range(args.steps):
        batch = to_device(data.batch(t), dev)
        group.reset_wire()
        t1 = time.perf_counter()
        params, opt_state, state, metrics = run(params, opt_state, state,
                                                batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        losses.append(float(metrics["loss"]))
        wire.append({k: v["bytes"] for k, v in group.wire.items()})
    out = dict(losses=losses, step_s=step_s,
               wall=time.perf_counter() - t0,
               launches={k.name: k.launches for k in kernels},
               peak=torch.cuda.max_memory_allocated(), wire=wire,
               leaves=[x.detach() if isinstance(x, torch.Tensor) else x
                       for x in (checkpoint_leaves((params, opt_state, state))
                                 if whole else T.leaves(params))])
    del params, opt_state, state, run, metrics, batch
    gc.collect()
    return out


def release_oracle(torch) -> None:
    """Give back what this process keeps on the card beside the oracle's
    leaves before ranks start: the kernels' kept scratch (grown to the
    oracle's whole rows) and the allocator's cache."""
    from repro_torch.kernels.cr_reduce.kernel import topk_cr_reduce
    from repro_torch.kernels.topk_ef.kernel import topk_ef

    topk_ef.release_scratch()
    topk_cr_reduce.release_scratch()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  this process holds {torch.cuda.memory_allocated()} bytes "
        f"allocated, {torch.cuda.memory_reserved()} reserved; free on the "
        f"card {torch.cuda.mem_get_info()[0]}")


def drop_oracle(torch, oracle) -> None:
    """Free the oracle's leaves once the ranks that shared them by IPC
    handle are gone."""
    oracle["leaves"].clear()
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()


def run_dist(torch, kernels, records) -> None:
    """Phase 36 (see the module docstring)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import count_params

    base = get_config(DIST_ARCH)
    cfg = dataclasses.replace(base, n_layers=DIST_LAYERS)
    n_leaves = model_leaves(DIST_ARCH, cfg)
    entries = count_params(TF.model_defs(cfg))
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"dist: {DIST_ARCH} at full width, {DIST_LAYERS} of "
        f"{base.n_layers} layers: {n_leaves} leaves, {entries} entries; two "
        f"ranks of one worker each on cuda:0 over gloo; "
        f"{DIST_BYTES_PER_ENTRY} B an entry a rank, "
        f"{2 * DIST_BYTES_PER_ENTRY * entries / total:.3f} of the card for "
        f"both, and the oracle's whole final state, 28 B an entry (async), "
        f"{28 * entries / total:.3f} (computed); {host_resources()}")

    # nccl runs one rank a card: two ranks on this one card must raise
    # before any step, named or by default
    for extra in (["--dist-backend", "nccl"], []):
        try:
            train.main(dist_argv(DIST_RUNS[1][1], 1) + ["--ranks", "2",
                                                        *extra])
        except ValueError as e:
            log(f"dist: --ranks 2 {' '.join(extra) or '(default backend)'} "
                f"on one card refused: {e}")
            require("nccl runs one rank a card" in str(e),
                    f"the nccl refusal's reason: {e}")
        else:
            require(False, "two nccl ranks on one card did not raise")

    for name, flags, steps in DIST_RUNS:
        argv = dist_argv(flags, steps)
        want_one = {"topk_ef": n_leaves * steps}
        want_one["topk_cr_deposit" if name == "async" else
                 "topk_cr_reduce"] = n_leaves * steps
        want_oracle = {k: 2 * v if k == "topk_ef" else v
                       for k, v in want_one.items()}

        # the oracle: both workers in this process; its final params,
        # optimizer state and sync state stay on the card for rank 0 to
        # compare with
        oracle = run_grid_oracle(torch, kernels, cfg, argv, whole=True)
        counts = oracle["launches"]
        kept = sum(x.numel() * x.element_size() for x in oracle["leaves"]
                   if isinstance(x, torch.Tensor))
        log(f"dist {name} oracle (--workers 2, one process): "
            f"{oracle['wall']:.2f} s with init; {len(oracle['leaves'])} "
            f"final leaves kept, {kept} bytes ({kept / entries:.2f} B an "
            f"entry, {kept / total:.4f} of the card); peak "
            f"{oracle['peak'] / total:.4f} of the card; step_s "
            f"{[round(x, 4) for x in oracle['step_s']]}; wire bytes a step "
            f"{oracle['wire']}; launches {json.dumps(counts)}")
        for k, count in counts.items():
            require(count == want_oracle.get(k, 0), f"dist {name} oracle: "
                    f"{k} launched {count} times, not {want_oracle.get(k, 0)}")
        release_oracle(torch)

        # the ranks: two processes sharing cuda:0; rank 0 compares each
        # final leaf of the params, the optimizer state and the sync state
        # with the oracle's, opened by IPC handle
        for k in kernels:
            k.launches = 0
        rep_r = {}
        t0 = time.perf_counter()
        hist_r = train.main(argv + ["--ranks", "2", "--dist-backend", "gloo"],
                            report=rep_r, compare_to=oracle["leaves"])
        wall_r = time.perf_counter() - t0
        require(all(k.launches == 0 for k in kernels),
                "the parent launched a kernel")
        peaks = [r["max_memory_allocated"] for r in rep_r["ranks"]]
        for r in rep_r["ranks"]:
            log(f"dist {name} rank {r['rank']} on {r['device']}: step_s "
                f"{[round(x, 4) for x in r['step_s']]}; wire bytes a step "
                f"{r['wire']}; peak {r['max_memory_allocated']} bytes "
                f"({r['max_memory_allocated'] / total:.4f} of the card); "
                f"comparing the final leaves {r['compare_s']:.2f} s; "
                f"launches {json.dumps(r['launches'])}")
            for k, count in r["launches"].items():
                require(count == want_one.get(k, 0), f"dist {name} rank "
                        f"{r['rank']}: {k} launched {count} times, not "
                        f"{want_one.get(k, 0)}")
        log(f"dist {name}: 2 ranks {wall_r:.2f} s (spawn, init and the "
            f"comparison included); summed peak {sum(peaks)} bytes, "
            f"{sum(peaks) / total:.4f} of the card")
        require(sum(peaks) <= 0.9 * total,
                "the ranks' summed peak is above 90% of the card")
        losses_r = [r["loss"] for r in hist_r]
        diffs = rep_r["leaf_max_abs"]
        differ = [path for path, x in diffs.items() if x != 0]
        log(f"dist {name}: losses {losses_r} (ranks) vs the oracle's "
            f"{oracle['losses']}; {len(diffs)} final leaves of the params "
            f"({n_leaves}), the optimizer state and the sync state compared "
            f"by rank 0 (as a checkpoint numbers them), leaves that differ "
            f"{differ}")
        require([x.hex() for x in losses_r]
                == [x.hex() for x in oracle["losses"]],
                "the ranks' losses differ from the in-process oracle's")
        require(len(diffs) == len(oracle["leaves"]) > n_leaves
                and not differ, "the ranks' final params, optimizer state "
                "or sync state differ from the oracle's")
        for k in want_one:
            records[k].setdefault("ranks_launches", {})[name] = [
                r["launches"][k] for r in rep_r["ranks"]]
        del hist_r
        drop_oracle(torch, oracle)


# phase 37: tensor parallelism over a 2 data x 2 model grid of four ranks
TP_ARCH = "qwen3-1.7b"
TP_LAYERS = 8
TP_RUNS = (("async", ["--sync", "async", "--compressor", "topk", "--ef",
                      "--overlap", "--tau-max", "2", "--async-schedule",
                      "uniform"], 4),
           ("topk_ef", ["--sync", "topk_ef"], 2))
# the ranks against the one-process oracle, set before the first card run:
# each loss within TP_LOSS_TOL (the CPU tests' bound on a bf16 forward that
# sums its row- and vocab-parallel partials in another order), each final
# param within TP_PARAM_TOL a step (lr 3e-3 times 0.05: bf16 rounding
# flips a few top-k picks near the threshold, each moving one entry by
# about lr times a gradient entry of the threshold's size)
TP_LOSS_TOL = 2e-2
TP_PARAM_TOL = 3e-3 * 0.05


def tp_argv(flags, steps):
    return ["--arch", TP_ARCH, "--n-layers", str(TP_LAYERS), *flags,
            "--topk-ratio", str(TOPK_RATIO), "--workers", "2", "--batch",
            "4", "--seq", "256", "--steps", str(steps), "--device", "cuda",
            "--seed", "0", "--log-every", "1"]


def tp_geometries(cfg):
    """-> {leaf names: (M / 2, R)}: the distinct row geometries of a rank
    of ``cfg`` at ``--model-shards 2``, with the leaves that have each."""
    import torch

    from repro_torch import tree as T
    from repro_torch.core.scheduler import leaf_rows_geometry
    from repro_torch.dist.sharding import shard_leaf
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import param_specs

    defs = TF.model_defs(cfg)
    specs = param_specs(defs, {"model": 2})
    out = {}
    for path, d, spec in zip(T.paths(defs), T.leaves(defs), T.leaves(specs)):
        whole = torch.empty(d.shape, device="meta")
        local = shard_leaf(whole, spec, 0, 2).shape
        geom = leaf_rows_geometry(tuple(local), spec)[:2]
        out.setdefault(geom, []).append(path.split("/")[-1])
    return {", ".join(names): geom for geom, names in out.items()}


def check_tp_kernels(torch, dev, gen, records, geoms=None,
                     key: str = "tp_shapes"):
    """Phase 37's first half: K1, K2 and K4 at the rank's geometries
    (``geoms``, ``{leaf names: (M, R)}``: phase 38's; by default phase
    37's seven), their times recorded under ``key`` and logged under its
    stem (``tp``, ``families_tp``)."""
    tag = key.removesuffix("_shapes")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.cr_reduce.kernel import (topk_cr_deposit,
                                                      topk_cr_reduce)
    from repro_torch.kernels.cr_reduce.ref import (topk_cr_deposit_plain,
                                                   topk_cr_reduce_plain)
    from repro_torch.kernels.topk_ef.kernel import topk_ef
    from repro_torch.kernels.topk_ef.ref import topk_ef_plain

    if geoms is None:
        cfg = dataclasses.replace(get_config(TP_ARCH), n_layers=TP_LAYERS)
        geoms = tp_geometries(cfg)
        require(len(geoms) == 7, f"{len(geoms)} tensor-parallel "
                "geometries, not 7")
    shapes = {n: {} for n in ("topk_ef", "topk_cr_deposit",
                              "topk_cr_reduce")}
    for names, (m, r) in geoms.items():
        k = max(1, int(round(r * TOPK_RATIO)))
        g = torch.randn((m, r), generator=gen, device=dev)
        e = 0.1 * torch.randn((m, r), generator=gen, device=dev)
        order, same_e, repeat, err = _topk_check(torch, topk_ef,
                                                 topk_ef_plain, g, e, k)
        require(order and same_e and repeat,
                f"topk_ef != plain version at ({m}, {r}) ({names})")
        records["topk_ef"]["max_abs_err"] = max(
            records["topk_ef"]["max_abs_err"], err)
        absw = (e + g).abs()
        ms = time_ms(torch, lambda: topk_ef(g, e, k), warmup=2, iters=5)
        plain = time_ms(torch, lambda: topk_ef_plain(g, e, k))
        lib = time_ms(torch, lambda: torch.topk(absw, k, dim=1))
        nbytes = 12 * m * r + 8 * m * k
        shapes["topk_ef"][names] = dict(shape=[m, r], k=k, ms=ms,
                                        plain_ms=plain, library_ms=lib,
                                        bound_ms=bound_ms(nbytes))
        log(f"{tag} check topk_ef ({m}, {r}) k={k} [{names}]: bitwise in the "
            f"documented order {order}, new_err {same_e}, run to run "
            f"{repeat}; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"torch.topk {lib:.4f} ms, bound {bound_ms(nbytes):.4f} ms "
            f"({nbytes} bytes)")
        del absw, g, e

        # two workers' payloads from K1 on fresh gradients, gathered
        vals, idx = [], []
        for _ in range(2):
            g = torch.randn((m, r), generator=gen, device=dev)
            v, i, _ = topk_ef(g, None, k, out_err=g)
            vals.append(v)
            idx.append(i)
            del g
        vals, idx = torch.stack(vals), torch.stack(idx)
        acc = 0.01 * torch.randn((3, m, r), generator=gen, device=dev)
        slots = torch.tensor([0, 2], dtype=torch.int32, device=dev)
        w = torch.ones((2,), dtype=torch.float32, device=dev)
        want = topk_cr_deposit_plain(acc.clone(), vals, idx, slots, w)
        got = topk_cr_deposit(acc.clone(), vals, idx, slots, w)
        again = topk_cr_deposit(acc.clone(), vals, idx, slots, w)
        torch.cuda.synchronize()
        dep_same = same_bits(torch, got, want) and same_bits(torch, got,
                                                             again)
        dep_err = float((got - want).abs().max())
        require(dep_same, f"topk_cr_deposit != plain version at (3, {m}, "
                f"{r}) ({names})")
        del got, want, again
        ms = time_ms(torch, lambda: topk_cr_deposit(acc, vals, idx, slots,
                                                    w), warmup=2, iters=5)
        plain = time_ms(torch, lambda: topk_cr_deposit_plain(
            acc, vals, idx, slots, w))
        rows = torch.arange(m, device=dev)[None, :, None]
        flat = ((slots.long()[:, None, None] * m + rows) * r
                + idx.long()).reshape(-1)
        prods = vals.reshape(-1)
        acc_flat = acc.view(-1)
        lib = time_ms(torch, lambda: acc_flat.index_put_(
            (flat,), prods, accumulate=True))
        nbytes = 2 * m * k * 8 + int(torch.unique(flat).numel()) * 8
        shapes["topk_cr_deposit"][names] = dict(
            shape=[3, m, r], k=k, ms=ms, plain_ms=plain, library_ms=lib,
            bound_ms=bound_ms(nbytes))
        records["topk_cr_deposit"]["max_abs_err"] = max(
            records["topk_cr_deposit"]["max_abs_err"], dep_err)
        log(f"{tag} check topk_cr_deposit (3, {m}, {r}) S=2 k={k} [{names}]: "
            f"bitwise vs plain and run to run {dep_same}; kernel {ms:.4f} "
            f"ms, plain {plain:.4f} ms, index_put_(accumulate=True) "
            f"{lib:.4f} ms, bound {bound_ms(nbytes):.4f} ms")
        del acc, acc_flat, flat, prods, rows

        v16 = vals.to(torch.bfloat16)
        want = topk_cr_reduce_plain(v16, idx, w, r)
        got = topk_cr_reduce(v16, idx, w, r)
        route = topk_cr_reduce.last_route()
        again = topk_cr_reduce(v16, idx, w, r)
        torch.cuda.synchronize()
        red_same = same_bits(torch, got, want) and same_bits(torch, got,
                                                             again)
        red_err = float((got - want).abs().max())
        require(red_same, f"topk_cr_reduce != plain version at (2, {m}, "
                f"{k}) -> ({m}, {r}) ({names})")
        del got, want, again
        ms = time_ms(torch, lambda: topk_cr_reduce(v16, idx, w, r),
                     warmup=2, iters=5)
        plain = time_ms(torch, lambda: topk_cr_reduce_plain(v16, idx, w, r))
        rows = torch.arange(m, device=dev)[None, :, None]
        flat = (rows * r + idx.long()).reshape(-1)
        prods = v16.float().reshape(-1)
        buf = torch.empty((m * r,), dtype=torch.float32, device=dev)
        lib = time_ms(torch, lambda: buf.zero_().index_put_(
            (flat,), prods, accumulate=True))
        nbytes = 2 * m * k * (2 + 4) + 4 * 2 + 4 * m * r
        shapes["topk_cr_reduce"][names] = dict(
            shape=[2, m, k], r=r, ms=ms, plain_ms=plain, library_ms=lib,
            bound_ms=bound_ms(nbytes), route=route)
        records["topk_cr_reduce"]["max_abs_err"] = max(
            records["topk_cr_reduce"]["max_abs_err"], red_err)
        log(f"{tag} check topk_cr_reduce (2, {m}, {k}) -> ({m}, {r}) bf16 "
            f"vals [{names}]: bitwise vs plain and run to run {red_same}, "
            f"{route} route; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"zero_ + index_put_ {lib:.4f} ms, bound {bound_ms(nbytes):.4f} "
            "ms")
        del vals, idx, v16, flat, prods, buf, rows, slots, w
        torch.cuda.empty_cache()
    for name, per in shapes.items():
        records[name][key] = per


def run_tp(torch, kernels, records) -> None:
    """Phase 37's second half (see the module docstring)."""
    import dataclasses

    import numpy as np

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import count_params

    base = get_config(TP_ARCH)
    cfg = dataclasses.replace(base, n_layers=TP_LAYERS)
    n_leaves = model_leaves(TP_ARCH, cfg)
    defs = TF.model_defs(cfg)
    entries = count_params(defs)
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"tp: {TP_ARCH} at full width, {TP_LAYERS} of {base.n_layers} "
        f"layers: {n_leaves} leaves, {entries} entries; 2 workers over a "
        f"2 data x 2 model grid of four ranks on cuda:0 over gloo; each "
        f"rank holds about half the entries, {DIST_BYTES_PER_ENTRY} B an "
        f"entry (phase 36's rate): "
        f"{2 * DIST_BYTES_PER_ENTRY * entries / total:.3f} of the card for "
        f"the four (computed); {host_resources()}")

    for name, flags, steps in TP_RUNS:
        argv = tp_argv(flags, steps)
        want_one = {"topk_ef": n_leaves * steps}
        want_one["topk_cr_deposit" if name == "async" else
                 "topk_cr_reduce"] = n_leaves * steps
        want_oracle = {k: 2 * v if k == "topk_ef" else v
                       for k, v in want_one.items()}

        # the oracle: both workers in this process, the model-2 specs; its
        # final params stay on the card, and rank 0 opens them by IPC
        # handle and compares its gathered leaves with them
        oracle = run_grid_oracle(torch, kernels, cfg, argv, model=2)
        losses_o, counts = oracle["losses"], oracle["launches"]
        log(f"tp {name} oracle (one process, 2 workers, model-2 specs): "
            f"{oracle['wall']:.2f} s; losses {losses_o}; step_s "
            f"{[round(x, 4) for x in oracle['step_s']]}; peak "
            f"{oracle['peak'] / total:.4f} of the card; launches "
            f"{json.dumps(counts)}")
        for k, count in counts.items():
            require(count == want_oracle.get(k, 0), f"tp {name} oracle: {k} "
                    f"launched {count} times, not {want_oracle.get(k, 0)}")
        # the kernels' kept scratch grows to the oracle's whole rows
        # (151,936 for embed): give it back before the ranks start
        release_oracle(torch)

        # the ranks: four processes sharing cuda:0; rank 0 gathers each
        # final leaf whole and compares it with the oracle's
        for k in kernels:
            k.launches = 0
        rep = {}
        t0 = time.perf_counter()
        hist = train.main(argv + ["--ranks", "4", "--model-shards", "2",
                                  "--dist-backend", "gloo"], report=rep,
                          compare_to=oracle["leaves"])
        wall_r = time.perf_counter() - t0
        require(all(k.launches == 0 for k in kernels),
                "the parent launched a kernel")
        peaks = [r["max_memory_allocated"] for r in rep["ranks"]]
        one_rank = DIST_BYTES_PER_ENTRY * entries
        for r in rep["ranks"]:
            log(f"tp {name} rank {r['rank']} on {r['device']}: step_s "
                f"{[round(x, 4) for x in r['step_s']]}; bytes a step by "
                f"collective {r['wire']}; peak {r['max_memory_allocated']} "
                f"bytes ({r['max_memory_allocated'] / total:.4f} of the "
                f"card, {r['max_memory_allocated'] / one_rank:.4f} of a "
                f"phase-36 rank's {one_rank:.0f} at this cut, computed); "
                f"spawn to start {r['spawn_s']:.2f} s, rendezvous "
                f"{r['mesh_s']:.2f} s, set-up before the first step "
                f"{r['setup_s']:.2f} s, gathering and comparing the final "
                f"leaves {r['compare_s']:.2f} s; launches "
                f"{json.dumps(r['launches'])}")
            for k, count in r["launches"].items():
                require(count == want_one.get(k, 0), f"tp {name} rank "
                        f"{r['rank']}: {k} launched {count} times, not "
                        f"{want_one.get(k, 0)}")
            require(any(k.startswith("model_") for k in r["wire"][0]),
                    f"tp {name} rank {r['rank']}: no model-group bytes")
        log(f"tp {name}: 4 ranks {wall_r:.2f} s (spawn, init and the "
            f"comparison included); summed peak {sum(peaks)} bytes, "
            f"{sum(peaks) / total:.4f} of the card")
        require(sum(peaks) <= 0.9 * total,
                "the ranks' summed peak is above 90% of the card")
        losses_r = [r["loss"] for r in hist]
        loss_err = max(abs(a - b) for a, b in zip(losses_r, losses_o))
        diffs = rep["leaf_max_abs"]
        worst = max(diffs.values())
        log(f"tp {name}: losses {losses_r} (ranks) vs the oracle's "
            f"{losses_o}, largest difference {loss_err} (limit "
            f"{TP_LOSS_TOL}); final params: largest difference {worst} "
            f"(limit {TP_PARAM_TOL * steps}); by leaf "
            f"{json.dumps(dict(zip(T.paths(defs), diffs.values())))}")
        require(len(losses_r) == steps and np.all(np.isfinite(losses_r)),
                f"tp {name}: the ranks' losses are not finite")
        require(loss_err <= TP_LOSS_TOL,
                f"tp {name}: the ranks' losses are off the oracle's")
        require(len(diffs) == n_leaves and worst <= TP_PARAM_TOL * steps,
                f"tp {name}: the ranks' final params are off the oracle's")
        for k in want_one:
            records[k].setdefault("tp_launches", {})[name] = [
                r["launches"][k] for r in rep["ranks"]]
        del hist
        # the oracle's leaves were shared by IPC handle: free them here too
        drop_oracle(torch, oracle)


# phase 38: tensor parallelism for the MoE, Mamba2 and RWKV6 stacks at full
# width, cut in depth: (arch, layers, --ranks, tau_max, runs of (name,
# flags, steps)); 2 workers and --model-shards 2 each.  Computed at phase
# 36's 36.4 B an entry a replica: moonshot at 1 of 48 layers
# (1,241,651,200 entries) holds one replica on a data 1 x model 2 grid,
# 45.2 GB (a 2 x 2 grid's two, 90.4 GB, do not fit), with 2 workers at
# tau_max 1 (one ring slot less, one EF residual more than phase 36's rate)
# and the oracle's final params, 5.0 GB, beside it: 0.59 of the card,
# under 0.85 with four contexts and this process's reserve; zamba2 at 3 of
# 81 (668,325,312 entries; the shared block runs before layer 0) and rwkv6
# at 6 of 24 (620,906,496) hold two replicas on a 2 x 2 grid, 48.7 and
# 45.2 GB
FAMILY_TP = (
    ("moonshot-v1-16b-a3b", 1, 2, 1, (("async", 4), ("topk_ef", 2))),
    ("zamba2-7b", 3, 4, 2, (("async", 4),)),
    ("rwkv6-1.6b", 6, 4, 2, (("async", 4),)),
)
# K10 at a rank's heads in zamba2-7b training: batch 4 over 2 workers, 32
# of the 64 heads of 112, N 64
FAMILY_K10 = (2, 256, 32, 112, 64)
# the ranks' final params against the oracle's: the Frobenius norm of each
# leaf's difference over the norm of the oracle's own move of that leaf
# (from the params both started at) within FAMILY_LEAF_REL, and the same
# over the whole model within FAMILY_MODEL_REL.  bf16 partial sums added in
# another order flip top-k picks near the threshold (and, in the MoE, a
# token's expert near a tie), over every leaf: the first card run (H100
# 80GB HBM3, 700 W) read 0.046-0.218 over the model and at most 0.296 in
# a leaf (moonshot's ln_mlp, topk_ef; this phase logs every leaf's), where
# the limits set before it, 0.1 and 0.75, had expected a few flips only.
# Each limit is about twice the worst reading and under 1, what no update
# at all reads.  They catch a gross fault only: with the model-group sum
# of the sharded norms dropped from the backward (planted), zamba2 read
# 0.248 over the model and 0.614 in conv_bc_w, rwkv6 0.107 and 0.279 (not
# caught).  The f32 gradient check (FAMILY_GRAD, below) is the fine one
FAMILY_LEAF_REL, FAMILY_MODEL_REL = 0.6, 0.45


# phase 38's gradient check: one f32 forward and backward of each stack at
# full width, cut to one layer (zamba2's shared block runs before it),
# batch 2 x 256, over two model ranks against one process.  No top-k pick
# can flip here; the ranks' row-parallel, vocab-parallel and norm sums only
# add in another order than the one process's.  Set before the first card
# run: the loss within FAMILY_GRAD_LOSS_RTOL and each gradient leaf within
# FAMILY_GRAD_RTOL relative (Frobenius), twice the CPU tests' f32 bound
# (tests/test_torch_tp.py's 5e-5) for the longer sums at full width.  The
# first two card runs read the same bits: at most 6.93e-5 (the attention
# q/k path of zamba2's shared block and moonshot: the softmax's gradient
# cancels at the near-uniform attention of random weights), 3.5e-5 off
# it, 2.9e-6 in rwkv6; the planted fault above 0.387 (zamba2's b_proj)
# and 0.0255 (rwkv6's w_r)
FAMILY_GRAD = (("moonshot-v1-16b-a3b", 1), ("zamba2-7b", 1),
               ("rwkv6-1.6b", 1))
FAMILY_GRAD_BATCH = (2, 256)
FAMILY_GRAD_RTOL, FAMILY_GRAD_LOSS_RTOL = 1e-4, 1e-5


def _f32_grads(torch, arch, n_layers, rank=0, size=1):
    """The loss and the gradient leaves of one f32 forward and backward of
    ``arch`` cut to ``n_layers`` on cuda:0 (model rank ``rank`` of ``size``
    under the installed model group: its slices)."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset, to_device
    from repro_torch.dist.train import mean_grads
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params, param_specs

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    defs = TF.model_defs(cfg)
    specs = param_specs(defs, {"model": size})
    params = init_params(defs, torch.Generator(device=dev).manual_seed(0),
                         dev, specs=specs, rank=rank, size=size)
    batch = to_device(SyntheticLMDataset(
        cfg.vocab_size, FAMILY_GRAD_BATCH[1], FAMILY_GRAD_BATCH[0],
        seed=0).batch(0), dev)
    loss, _, grads = mean_grads(cfg, params, batch)
    return float(loss), T.paths(grads), T.leaves(grads), T.leaves(specs)


def _family_grad_rank(rank, store, want, results):
    """One of the two model ranks of phase 38's gradient check (a spawned
    process): each of ``FAMILY_GRAD`` in f32; rank 0 gathers each gradient
    leaf whole and compares it with the one process's (``want``, by IPC
    handle; ``None`` on rank 1)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.dist.sharding import WorkerRows
    from repro_torch.launch.mesh import close, make_host_mesh
    from repro_torch.models import actx, layers
    from repro_torch.models import transformer as TF

    torch.cuda.set_device(0)
    set_matmul_precision(torch, False)
    layers.COMPUTE_DTYPE = TF.COMPUTE_DTYPE = torch.float32
    layout = make_host_mesh(backend="gloo", world=2, rank=rank,
                            store_path=store, model=2)
    actx.install(actx.ModelGroup(layout))
    try:
        out = []
        for i, (arch, n_layers) in enumerate(FAMILY_GRAD):
            loss, paths, grads, specs = _f32_grads(torch, arch, n_layers,
                                                   rank, 2)
            rels = {}
            for j, (path, g, sp) in enumerate(zip(paths, grads, specs)):
                dim = actx.model_dim(sp)
                whole = g if dim is None \
                    else WorkerRows(g, None, dim).gather()
                if want is not None:
                    w = want[i][1][j]
                    norm = float(torch.linalg.vector_norm(w))
                    diff = float(torch.linalg.vector_norm(
                        whole.to(w.device) - w))
                    rels[path] = diff / norm if norm else diff
                del whole
            out.append({"loss": loss, "rels": rels})
            del grads
            torch.cuda.empty_cache()
        if want is not None:
            results.put(out)
    finally:
        actx.install(None)
        close(layout)


def check_family_grads(torch) -> None:
    """Phase 38's gradient check (see ``FAMILY_GRAD``): the one process
    here, then the two model ranks, spawned."""
    import multiprocessing
    import queue
    import tempfile

    from repro_torch.models import layers
    from repro_torch.models import transformer as TF

    set_matmul_precision(torch, False)
    t0 = time.perf_counter()
    kept = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = TF.COMPUTE_DTYPE = torch.float32
    want = []
    try:
        for arch, n_layers in FAMILY_GRAD:
            loss, _, grads, _ = _f32_grads(torch, arch, n_layers)
            want.append((loss, [g.detach() for g in grads]))
            del grads
    finally:
        layers.COMPUTE_DTYPE = TF.COMPUTE_DTYPE = kept
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_grads_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_family_grad_rank, daemon=True,
                         args=(r, os.path.join(tmp, "store"),
                               want if r == 0 else None, results))
             for r in range(2)]
    try:
        for proc in procs:
            proc.start()
        got = None
        while got is None:
            try:
                got = results.get(timeout=1.0)
            except queue.Empty:
                codes = [p.exitcode for p in procs]
                require(all(c in (None, 0) for c in codes),
                        f"gradient check: a rank failed ({codes})")
                if None not in codes:
                    # both ended: rank 0's result is in the queue or lost
                    got = results.get(timeout=10.0)
        for proc in procs:
            proc.join(timeout=60)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            if proc.pid is not None:
                proc.join()
        shutil.rmtree(tmp, ignore_errors=True)
    for (arch, n_layers), (loss_o, grads_o), rec in zip(FAMILY_GRAD, want,
                                                        got):
        loss_rel = abs(rec["loss"] - loss_o) / abs(loss_o)
        rels = rec["rels"]
        worst = max(rels, key=rels.get)
        log(f"tp38 grads {arch}, {n_layers} layer(s), f32, batch "
            f"{FAMILY_GRAD_BATCH[0]} x {FAMILY_GRAD_BATCH[1]}, 2 model ranks "
            f"vs one process: loss {rec['loss']} vs {loss_o}, relative "
            f"{loss_rel:.3g} (limit {FAMILY_GRAD_LOSS_RTOL}); worst leaf "
            f"{worst} {rels[worst]:.3g} (limit {FAMILY_GRAD_RTOL}); by leaf "
            f"{json.dumps({p: float(f'{x:.3g}') for p, x in rels.items()})}")
        require(len(rels) == len(grads_o), f"tp38 grads {arch}: leaves "
                "missing")
        require(loss_rel <= FAMILY_GRAD_LOSS_RTOL
                and rels[worst] <= FAMILY_GRAD_RTOL,
                f"tp38 grads {arch}: the ranks' f32 gradient is off the one "
                "process's")
    log(f"tp38 grads: {time.perf_counter() - t0:.2f} s (spawn included)")
    del want
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()


def family_argv(arch, layers, tau, name, steps):
    flags = ["--sync", "topk_ef"] if name == "topk_ef" else [
        "--sync", "async", "--compressor", "topk", "--ef", "--overlap",
        "--tau-max", str(tau), "--async-schedule", "uniform"]
    return ["--arch", arch, "--n-layers", str(layers), *flags,
            "--topk-ratio", str(TOPK_RATIO), "--workers", "2", "--batch",
            "4", "--seq", "256", "--steps", str(steps), "--device", "cuda",
            "--seed", "0", "--log-every", "1"]


def check_family_tp_kernels(torch, dev, gen, records):
    """Phase 38's first half: K1, K2 and K4 at every row geometry a rank of
    phase 38's three configs gives them that phase 37 did not time, then
    K10 at a rank's heads, each against its plain version."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd.kernel import ssd_chunked
    from repro_torch.kernels.ssd.ref import ssd_plain

    seen = set(tp_geometries(dataclasses.replace(
        get_config(TP_ARCH), n_layers=TP_LAYERS)).values())
    geoms = {}
    for arch, layers, *_ in FAMILY_TP:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        for names, geom in tp_geometries(cfg).items():
            if geom not in seen:
                seen.add(geom)
                geoms[f"{arch}: {names}"] = geom
    log(f"tp38: {len(geoms)} new rank geometries")
    check_tp_kernels(torch, dev, gen, records, geoms, "families_tp_shapes")

    args = ssd_inputs(torch, dev, gen, FAMILY_K10, "bfloat16", "u")
    y, st = ssd_chunked(*args)
    y2, st2 = ssd_chunked(*args)
    py, ps = ssd_plain(*args)
    torch.cuda.synchronize()
    ymax, smax = float(py.float().abs().max()), float(ps.abs().max())
    err = (y.float() - py.float()).abs()
    over = float((err / (SSD_REL * ymax + 2.0 ** -7 * py.float().abs()))
                 .max())
    s_over = float((st - ps).abs().max()) / (SSD_REL * smax)
    same = torch.equal(y, y2) and torch.equal(st, st2)
    require(over <= 1 and s_over <= 1 and same and bool(
        torch.isfinite(y.float()).all()),
        f"ssd_chunked at a rank's heads {FAMILY_K10} != plain version")
    ms = time_ms(torch, lambda: ssd_chunked(*args), warmup=2, iters=5)
    plain = time_ms(torch, lambda: ssd_plain(*args))
    nbytes, flops = ssd_bytes_flops(FAMILY_K10, 2)
    t_bytes, t_ops = bound_ms(nbytes), flops / BF16_FLOPS_PER_S * 1e3
    bnd, by = (t_bytes, "bytes") if t_bytes >= t_ops \
        else (t_ops, "operations")
    log(f"tp38 check ssd_chunked (B, T, H, hd, N) = {FAMILY_K10} bf16: y "
        f"max_abs_err {float(err.max())} (largest error over its limit "
        f"{over}), state {s_over} of its limit, run to run bitwise {same}; "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms "
        f"({by}); no single PyTorch call computes the chunked scan")
    records["ssd_chunked"]["max_abs_err"] = max(
        records["ssd_chunked"]["max_abs_err"], float(err.max()))
    records["ssd_chunked"]["families_tp_shapes"] = {
        "zamba2-7b: a rank's heads": dict(
            shape=list(FAMILY_K10), ms=ms, plain_ms=plain, bound_ms=bnd,
            bound_by=by, library_ms=None)}
    del args, y, y2, st, st2, py, ps, err
    torch.cuda.empty_cache()


def run_family_tp(torch, kernels, records) -> None:
    """Phase 38's second half (see the module docstring)."""
    import dataclasses

    import numpy as np

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import count_params, init_params

    dev = torch.device("cuda")
    total = torch.cuda.get_device_properties(0).total_memory
    for arch, layers, ranks, tau, runs in FAMILY_TP:
        base = get_config(arch)
        cfg = dataclasses.replace(base, n_layers=layers)
        defs = TF.model_defs(cfg)
        entries, n_leaves = count_params(defs), len(T.leaves(defs))
        data = ranks // 2
        local = 2 // data
        held = DIST_BYTES_PER_ENTRY * entries * data + 4 * entries
        log(f"tp38: {arch} at full width, {layers} of {base.n_layers} "
            f"layers: {n_leaves} leaves, {entries} entries; 2 workers over "
            f"a {data} data x 2 model grid of {ranks} ranks on cuda:0 over "
            f"gloo, tau_max {tau}; {data} replica(s) at "
            f"{DIST_BYTES_PER_ENTRY} B an entry and the oracle's final "
            f"params: {held / 1e9:.2f} GB, {held / total:.3f} of the card "
            f"(computed); {host_resources()}")
        for name, steps in runs:
            argv = family_argv(arch, layers, tau, name, steps)
            k1 = n_leaves * steps
            sync = "topk_cr_reduce" if name == "topk_ef" \
                else "topk_cr_deposit"
            want_one = {"topk_ef": k1 * local, sync: k1}
            want_oracle = {"topk_ef": 2 * k1, sync: k1}
            if cfg.block_type == "mamba2":
                # K10 once a Mamba2 layer a worker a step, forward only
                want_one["ssd_chunked"] = layers * steps * local
                want_oracle["ssd_chunked"] = 2 * layers * steps
            tag = f"tp38 {arch} {name}"

            oracle = run_grid_oracle(torch, kernels, cfg, argv, model=2)
            counts = oracle["launches"]
            log(f"{tag} oracle (one process, 2 workers, model-2 specs): "
                f"{oracle['wall']:.2f} s; losses {oracle['losses']}; "
                f"step_s {[round(x, 4) for x in oracle['step_s']]}; peak "
                f"{oracle['peak'] / total:.4f} of the card; launches "
                f"{json.dumps(counts)}")
            for k, count in counts.items():
                require(count == want_oracle.get(k, 0), f"{tag} oracle: "
                        f"{k} launched {count} times, not "
                        f"{want_oracle.get(k, 0)}")
            require(oracle["peak"] <= 0.9 * total,
                    f"{tag} oracle: peak above 90% of the card")
            # the oracle's own move of each leaf, from the params both
            # runs start at
            init = init_params(defs, torch.Generator(device=dev).manual_seed(
                0), dev)
            paths = T.paths(init)
            moved = {p: float(torch.linalg.vector_norm(f - i))
                     for p, f, i in zip(paths, oracle["leaves"],
                                        T.leaves(init))}
            del init
            release_oracle(torch)

            for k in kernels:
                k.launches = 0
            rep = {}
            t0 = time.perf_counter()
            hist = train.main(argv + ["--ranks", str(ranks),
                                      "--model-shards", "2",
                                      "--dist-backend", "gloo"],
                              report=rep, compare_to=oracle["leaves"])
            wall = time.perf_counter() - t0
            require(all(k.launches == 0 for k in kernels),
                    "the parent launched a kernel")
            peaks = [r["max_memory_allocated"] for r in rep["ranks"]]
            for r in rep["ranks"]:
                log(f"{tag} rank {r['rank']}: step_s "
                    f"{[round(x, 4) for x in r['step_s']]}; bytes a step by "
                    f"collective {r['wire']}; peak "
                    f"{r['max_memory_allocated']} bytes "
                    f"({r['max_memory_allocated'] / total:.4f} of the card); "
                    f"spawn to start {r['spawn_s']:.2f} s, set-up "
                    f"{r['setup_s']:.2f} s, comparing the final leaves "
                    f"{r['compare_s']:.2f} s; launches "
                    f"{json.dumps(r['launches'])}")
                for k, count in r["launches"].items():
                    require(count == want_one.get(k, 0), f"{tag} rank "
                            f"{r['rank']}: {k} launched {count} times, not "
                            f"{want_one.get(k, 0)}")
                require(any(k.startswith("model_") for k in r["wire"][0]),
                        f"{tag} rank {r['rank']}: no model-group bytes")
            log(f"{tag}: {ranks} ranks {wall:.2f} s (spawn, init and the "
                f"comparison included); summed peak {sum(peaks)} bytes, "
                f"{sum(peaks) / total:.4f} of the card")
            require(sum(peaks) <= 0.9 * total,
                    f"{tag}: the ranks' summed peak is above 90% of the card")
            losses = [r["loss"] for r in hist]
            loss_err = max(abs(a - b) for a, b in zip(losses,
                                                      oracle["losses"]))
            rel = {p: rep["leaf_l2"][str(i)] / moved[p]
                   for i, p in enumerate(paths)}
            whole = math.sqrt(sum(x * x for x in rep["leaf_l2"].values())
                              / sum(x * x for x in moved.values()))
            worst = max(rel, key=rel.get)
            log(f"{tag}: losses {losses} (ranks) vs the oracle's "
                f"{oracle['losses']}, largest difference {loss_err} (limit "
                f"{TP_LOSS_TOL}); final params against the oracle's, over "
                f"its own move: whole model {whole:.4g} (limit "
                f"{FAMILY_MODEL_REL}), worst leaf {worst} {rel[worst]:.4g} "
                f"(limit {FAMILY_LEAF_REL}); by leaf "
                f"{json.dumps({p: round(x, 5) for p, x in rel.items()})}; "
                f"largest entry difference by leaf "
                f"{json.dumps(dict(zip(paths, rep['leaf_max_abs'].values())))}")
            require(len(losses) == steps and np.all(np.isfinite(losses)),
                    f"{tag}: the ranks' losses are not finite")
            require(loss_err <= TP_LOSS_TOL,
                    f"{tag}: the ranks' losses are off the oracle's")
            require(len(rel) == n_leaves and min(moved.values()) > 0
                    and rel[worst] <= FAMILY_LEAF_REL
                    and whole <= FAMILY_MODEL_REL,
                    f"{tag}: the ranks' final params are off the oracle's")
            for k in want_one:
                records[k].setdefault("families_tp_launches", {})[
                    f"{arch} {name}"] = [r["launches"][k]
                                         for r in rep["ranks"]]
            del hist
            drop_oracle(torch, oracle)


# ---------------------------------------------------------------------------
# phase 39: the cluster model, the time-to-loss co-simulation and the
# delivery-ring model checker
# ---------------------------------------------------------------------------

COSIM_PRESETS = ("uniform", "straggler_heavy", "preemptible")
COSIM_P, COSIM_STEPS, COSIM_DIM = 4, 600, 32      # the CLI's defaults
COSIM_RATIO = 1 / 8                 # cluster.cosim's top-k EF ratio
# card against CPU on the same draws: every recorded loss within
# COSIM_LOSS_ATOL + COSIM_LOSS_RTOL |CPU| over the first PARITY_STEPS
# steps, where every crossing lies (tests/test_torch_cluster.py's bound
# against the reference: the two sum the quadratic's products in other
# orders); later the EF runs drift chaotically (one-bit from step 110
# against the reference on the CPU, top-k from step 468), so the rest of
# the run is logged only
COSIM_LOSS_RTOL, COSIM_LOSS_ATOL = 1e-4, 1e-6
# the kernels of the EF candidates (cluster.cosim.DEFAULT_CANDIDATES'
# topk_ef and onebit_ef): one launch a step each, per preset
COSIM_EF_KERNELS = ("topk_ef", "onebit_ef")


def check_cosim_kernels(torch, dev, gen) -> None:
    """K1 and K8 at the co-simulation's EF rows, (B p, d) = (4, 32), k = 4,
    against their plain versions on the same card tensors: K1 bitwise in
    the documented order, K8 packed bitwise and within ONEBIT_TOL."""
    from repro_torch.kernels.onebit_ef.kernel import onebit_ef
    from repro_torch.kernels.onebit_ef.ref import onebit_ef_plain
    from repro_torch.kernels.topk_ef.kernel import topk_ef
    from repro_torch.kernels.topk_ef.ops import topk_k
    from repro_torch.kernels.topk_ef.ref import topk_ef_plain
    m, r = COSIM_P, COSIM_DIM
    k = topk_k(r, COSIM_RATIO)
    g = 0.05 * torch.randn((m, r), generator=gen, device=dev)
    e = 0.01 * torch.randn((m, r), generator=gen, device=dev)
    order, same_e, repeat, err = _topk_check(torch, topk_ef, topk_ef_plain,
                                             g, e, k)
    got, want, again = onebit_ef(g, e), onebit_ef_plain(g, e), onebit_ef(g, e)
    torch.cuda.synchronize()
    oerr, close, same = compare(torch, got, want, again, ONEBIT_TOL)
    packed = torch.equal(got[0], want[0])
    log(f"check cosim rows ({m}, {r}): topk_ef k={k} picks bitwise in the "
        f"documented order {order}, new_err bitwise {same_e}, run to run "
        f"{repeat}, max_abs_err {err}; onebit_ef packed bitwise {packed}, "
        f"means/new_err close {close}, run to run {same}, max_abs_err "
        f"{oerr}")
    require(order and same_e and repeat, "topk_ef != plain at the cosim rows")
    require(packed and close and same, "onebit_ef != plain at the cosim rows")
    floor = launch_floor_ms(torch, dev)
    for name, fn, plain, nbytes in (
            ("topk_ef", lambda: topk_ef(g, e, k),
             lambda: topk_ef_plain(g, e, k), 12 * m * r + 8 * m * k),
            ("onebit_ef", lambda: onebit_ef(g, e),
             lambda: onebit_ef_plain(g, e),
             12 * m * r + m * ((r + 7) // 8) + 8 * m)):
        ms, call = device_ms(torch, fn)
        pms, _ = device_ms(torch, plain)
        log(f"time {name} cosim rows ({m}, {r}): kernel {ms:.4f} ms on the "
            f"device ({call:.4f} ms a call from the host), plain {pms:.4f} "
            f"ms, bound {bound_ms(nbytes):.3e} ms ({nbytes} bytes), launch "
            f"floor {floor:.4f} ms")


def profile_cosim(torch, argv, draws) -> None:
    """One card co-simulation under torch.profiler (the CLI's argv, its
    draws): the device-busy share of its wall and the device time by
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import cosim as cli
    with contextlib.redirect_stdout(io.StringIO()):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cli.main(argv, draws=draws)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kernel_type = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == kernel_type and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    n_kernels = sum(r[2] for r in rows)
    log(f"profile cosim {' '.join(argv)}: wall {wall * 1e3:.2f} ms "
        f"(profiler on), device kernels {busy_us / 1e3:.3f} ms (busy "
        f"{busy_us / 1e3 / (wall * 1e3):.4f} of wall), {n_kernels} kernels")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:6]:
        log(f"  {us / 1e3:9.4f} ms  x{count:<6d} {key[:90]}")


def _cosim_losses(results) -> dict:
    """candidate -> its recorded losses (seed 0) as f64."""
    import numpy as np
    return {r.candidate: np.asarray(r.losses[0], np.float64)
            for r in results}


def run_cosim(torch, kernels, records) -> None:
    """The three presets through ``launch/cosim.main`` at the CLI's
    defaults on the card and on the CPU, on the same CPU-drawn gradient
    noise: tau tables, finishes and closes bitwise, steps, times and
    winners equal, losses within the stated bound over PARITY_STEPS; exact
    K1 and K8 launch counts (counters zeroed just before each card run);
    then the ring checker with its layer 3 on the card (no findings, the
    CPU run's statistics) and a planted capacity fault it must find."""
    import tempfile

    import numpy as np

    from repro_torch.analysis import rings
    from repro_torch.core.problems import Quadratic
    from repro_torch.core.sim_ref import default_draws
    from repro_torch.launch import cosim as cli

    t_phase = time.perf_counter()
    quad = Quadratic(dim=COSIM_DIM, cond=8.0, sigma=0.4, seed=0,
                     device="cpu")                # cluster.cosim's problem
    draws_cpu = default_draws(quad, 0, COSIM_STEPS, COSIM_P)
    target = 0.01 * float(quad.loss(torch.zeros(COSIM_DIM)))
    draws = lambda ip, p, s: draws_cpu            # noqa: E731 (seed 0 only)
    horizon = PARITY_STEPS // 2                   # record_every 2
    launches = {k.name: 0 for k in kernels}
    tmp = tempfile.mkdtemp(prefix="cosim_")
    try:
        for i, name in enumerate(COSIM_PRESETS):
            argv = ["--cluster", name]
            out = [] if i else ["--out", os.path.join(tmp, f"{name}.json")]
            runs = {}
            for device in ("cpu", "cuda"):
                rep = {}
                for k in kernels:
                    k.launches = 0
                text = io.StringIO()
                with contextlib.redirect_stdout(text):
                    t0 = time.perf_counter()
                    cli.main(argv + ["--device", device]
                             + (out if device == "cuda" else []),
                             draws=draws, report=rep)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                counts = {k.name: k.launches for k in kernels}
                if device == "cuda":
                    for line in text.getvalue().splitlines():
                        log(f"  cosim {name}: {line}")
                    for key, v in counts.items():
                        launches[key] += v
                else:
                    require(not any(counts.values()),
                            f"cosim {name}: a kernel launched on the CPU")
                runs[device] = (rep, _cosim_losses(rep["results"]), wall)
            (cpu, cpu_loss, cpu_wall), (gpu, gpu_loss, gpu_wall) = \
                runs["cpu"], runs["cuda"]
            log(f"cosim {name}: card {gpu_wall:.2f} s, CPU {cpu_wall:.2f} s "
                f"(each with its five event loops and the grid); event "
                f"loops card / CPU s: " + ", ".join(
                    f"{c} {gpu['runs'][c].loop_s:.4f} / "
                    f"{cpu['runs'][c].loop_s:.4f}" for c in gpu["runs"]))
            for c, run in gpu["runs"].items():
                want = cpu["runs"][c]
                require(run.device.startswith("cuda") and want.device == "cpu",
                        f"cosim {name} {c}: the loop ran on the wrong device")
                for f in ("taus", "closes", "finishes"):
                    require(np.array_equal(getattr(run, f), getattr(want, f)),
                            f"cosim {name} {c}: card {f} != CPU {f}")
            fields = lambda r: (r.candidate, r.steps_to_loss,  # noqa: E731
                                r.time_to_loss, r.step_s, r.tau_histogram,
                                r.dropped)
            require([fields(r) for r in gpu["results"]]
                    == [fields(r) for r in cpu["results"]],
                    f"cosim {name}: card results != CPU results")
            require(gpu["winners"] == cpu["winners"],
                    f"cosim {name}: card winners != CPU winners")
            for c, want in cpu_loss.items():
                got = gpu_loss[c]
                diff = np.abs(got - want)
                lim = COSIM_LOSS_ATOL + COSIM_LOSS_RTOL * np.abs(want)
                res = next(r for r in cpu["results"] if r.candidate == c)
                if np.isfinite(res.steps_to_loss):
                    # the crossing lies in the horizon and clears the bound
                    cross = int(res.steps_to_loss) // 2
                    near = want[max(cross - 1, 0):cross + 1]
                    require(cross < horizon and bool(np.all(
                        np.abs(near - target) > COSIM_LOSS_ATOL
                        + COSIM_LOSS_RTOL * target)),
                        f"cosim {name} {c}: the loss crossing does not "
                        f"clear the card-CPU bound")
                log(f"  cosim {name} {c}: steps {res.steps_to_loss} time "
                    f"{res.time_to_loss:.4f} s, loss |card - CPU| "
                    f"{diff[:horizon].max():.3e} over {PARITY_STEPS} steps "
                    f"(limit {lim[:horizon].min():.1e}-"
                    f"{lim[:horizon].max():.1e}), {diff.max():.3e} over "
                    f"the run")
                require(bool(np.all(diff[:horizon] <= lim[:horizon])),
                        f"cosim {name} {c}: card losses off the CPU's")
            log(f"cosim {name}: winners {json.dumps(gpu['winners'])}")
            if not i:
                with open(out[1]) as fh:
                    payload = json.load(fh)
                require(payload["winners"] == gpu["winners"]
                        and len(payload["candidates"]) == 5,
                        "cosim --out JSON")
        want = {k: COSIM_STEPS * len(COSIM_PRESETS) if k in
                COSIM_EF_KERNELS else 0 for k in launches}
        log(f"cosim launches {json.dumps(launches)}")
        require(launches == want, f"cosim launches {launches} != {want}")
        for k, n in launches.items():
            if n:
                records[k]["cosim_launches"] = n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # profiled at 100 steps: the profiler's tables of a 600-step run take
    # about 30 s to build
    profile_cosim(torch, ["--cluster", "straggler_heavy", "--device",
                          "cuda", "--steps", "100"],
                  lambda ip, p, s: draws_cpu[:100])

    # the ring checker: layer 3 on the card, then against its CPU run
    t0 = time.perf_counter()
    rep = rings.run(device="cuda")
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_rep = rings.run(device="cpu")
    t_cpu = time.perf_counter() - t0
    log(f"rings: card {t_card:.2f} s, CPU {t_cpu:.2f} s; findings "
        f"{[str(f) for f in rep.findings]}; stats "
        f"{json.dumps(rep.info['rings'])}")
    require(rep.findings == [] and cpu_rep.findings == [],
            "rings: the checker found a fault in the ring code")
    require(rep.info == cpu_rep.info, "rings: card stats != CPU stats")
    # the planted fault: rings of capacity tau_max, one slot short
    for tau_max in (1, 2, 3):
        h = 2 * (tau_max + 1)
        taus = rings.enumerate_schedules(tau_max, h, crashes=False)
        proved = rings.prove_ring_schedules(taus, tau_max, "planted")
        truth = rings.check_ground_truth(taus[:, :, 0], tau_max, "planted",
                                         device="cuda")
        log(f"rings planted capacity {tau_max} (tau_max {tau_max}): "
            f"{[str(f) for f in proved.findings + truth]}")
        require(any(f.rule == "slot-alias" for f in proved.findings),
                f"rings: no aliasing found at capacity {tau_max}")
        require([f.rule for f in truth] == ["torch-divergence"],
                f"rings: the card's ring ops at capacity {tau_max} did not "
                f"diverge from the delivery law")
    log(f"phase 39: wall {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on an "
              "NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import (_build, all_kernels, main_path_kernels,
                                     sim_kernels)

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    log(f"host: {host_resources()}")
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"build: {len(reports)} CUDA libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    kernels = main_path_kernels()
    records = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    check_topk_ef(torch, dev, gen, records)
    check_deposits(torch, dev, gen, records)
    check_small_path(torch, dev)

    counts = run_path(torch, kernels, "topk", 4)
    require(counts["topk_ef"] == 13 * 2 * 4,
            f"topk_ef launches {counts['topk_ef']} != 104")
    require(counts["topk_cr_deposit"] == 13 * 4,
            f"topk_cr_deposit launches {counts['topk_cr_deposit']} != 52")
    records["topk_ef"]["launches"] = counts["topk_ef"]
    records["topk_cr_deposit"]["launches"] = counts["topk_cr_deposit"]

    counts = run_path(torch, kernels, "onebit", 2)
    require(counts["onebit_cr_deposit"] == 13 * 2,
            f"onebit_cr_deposit launches {counts['onebit_cr_deposit']} != 26")
    records["onebit_cr_deposit"]["launches"] = counts["onebit_cr_deposit"]
    profile_step(torch)
    torch.cuda.empty_cache()

    # the simulator: its kernels, then Table 1, the fused path at the
    # repo's sizes and Figure 3 with the launch counters zeroed just before
    check_sim_step(torch, dev, gen, records)
    check_onebit_ef(torch, dev, gen, records)
    check_topk_ef_sim_shape(torch, dev, gen)
    torch.cuda.empty_cache()
    sim = sim_kernels()
    for k in sim:
        k.launches = 0
    read = lambda: {k.name: k.launches for k in sim}
    t0 = time.perf_counter()
    table1(torch)
    after_table1 = read()
    log(f"sim path: table 1 launches {json.dumps(after_table1)}")
    # one launch a step: 600 steps each, and the one-bit row's 60-step
    # prefix run (CHAOTIC_ROWS)
    require(after_table1["topk_ef"] == 600 and
            after_table1["onebit_ef"] == 600 + PARITY_STEPS,
            "table 1's EF runs did not launch topk_ef / onebit_ef each step")
    fused_at_repo_sizes(torch, read)
    figure3(torch)
    sim_counts = read()
    log(f"sim path: {time.perf_counter() - t0:.1f} s, launches "
        f"{json.dumps(sim_counts)}")
    for name in ("delivery_step", "sync_step", "onebit_ef"):
        require(sim_counts[name] > 0, f"{name} never launched on the sim path")
        records[name]["launches"] = sim_counts[name]
    profile_sim(torch)

    # serving: K9, the small card-vs-CPU check, then the full-width path
    # with every kernel's counter zeroed just before it
    gc.collect()
    torch.cuda.empty_cache()
    check_swa_decode(torch, dev, gen, records)
    check_small_serve(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    counts, served = run_serve(torch, all_kernels())
    records["swa_decode_attention"]["launches"] = counts[
        "swa_decode_attention"]
    profile_serve(torch, served["engine"])
    del served

    # the Mamba2 hybrid: K10, the small card-vs-CPU check, then full-width,
    # full-depth zamba2-7b with every kernel's counter zeroed just before
    gc.collect()
    torch.cuda.empty_cache()
    check_ssd(torch, dev, gen, records)
    check_small_hybrid(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    counts = run_hybrid_serve(torch, all_kernels())
    records["ssd_chunked"]["launches"] = counts["ssd_chunked"]
    gc.collect()
    torch.cuda.empty_cache()
    profile_hybrid(torch)

    # the synchronous gradient sync: K4 and K5, the small card-vs-CPU
    # check, then full-width qwen3-1.7b with every kernel's counter zeroed
    # just before each strategy's run
    gc.collect()
    torch.cuda.empty_cache()
    check_reduces(torch, dev, gen, records)
    check_small_sync(torch, dev)
    for sync in SYNC_STEPS:
        counts = run_sync_path(torch, all_kernels(), sync)
        for name in ("topk_cr_reduce", "onebit_cr_reduce"):
            if counts[name]:
                records[name]["launches"] = counts[name]
    gc.collect()
    torch.cuda.empty_cache()
    profile_step(torch, "profile sync step (topk_ef)", sync="topk_ef")

    # RWKV6 and gemma3: the small card-vs-CPU checks, full-width RWKV6
    # training (K1 with K2 or K4 on its 19 leaves) and a profiled step, then
    # serving RWKV6 and full-depth gemma3-27b through the loop
    gc.collect()
    torch.cuda.empty_cache()
    # gemma3's grouped stack: 7 layers, every third global
    gemma = dataclasses.replace(get_config("gemma3-27b-smoke"), n_layers=7,
                                global_every=3)
    require(gemma.layer_window_sizes() == [32, 32, 0, 32, 32, 0, 32],
            "gemma3's grouped windows")
    check_small_models(torch, dev, (get_config("rwkv6-1.6b-smoke"), gemma),
                       128, SMALL_F32_TOL, SMALL_BF16_TOL)
    check_small_path(torch, dev, "rwkv6-1.6b-smoke", (("topk", 1),))
    check_small_sync(torch, dev, "rwkv6-1.6b-smoke", ("topk_ef",), steps=1)
    run_family_training(torch, all_kernels(), records, RWKV_ARCH, None, 2,
                        "rwkv6_launches")
    gc.collect()
    torch.cuda.empty_cache()
    profile_step(torch, "profile rwkv6 async step", arch=RWKV_ARCH)
    for arch, batch, prompt, n_tok in LOOP_SERVES:
        run_loop_serve(torch, all_kernels(), arch, batch, prompt, n_tok)
        profile_loop(torch, arch, batch, prompt)

    # the last four families and zamba2 training: the small card-vs-CPU
    # checks (the new smoke models, zamba2's fed async and topk_ef halves
    # and K10 under autograd), moonshot and zamba2 training at full width
    # (K1 with K2 or K4, K10 in zamba2's forward), then serving moonshot,
    # grok-1 and the two frontends
    gc.collect()
    torch.cuda.empty_cache()
    check_small_models(torch, dev, [get_config(n) for n in FAMILY_SMOKES],
                       64, FAMILY_F32_TOL, FAMILY_BF16_TOL, FAMILY_AUX_TOL)
    check_small_path(torch, dev, "zamba2-7b-smoke", (("topk", 1),))
    check_small_sync(torch, dev, "zamba2-7b-smoke", ("topk_ef",), steps=1)
    check_ssd_autograd(torch, dev, gen)
    run_moonshot_training(torch, all_kernels(), records)
    run_zamba2_training(torch, all_kernels(), records)
    gc.collect()
    torch.cuda.empty_cache()
    run_family_serves(torch, all_kernels())

    # the robustness slice: the optimizers and a checkpoint round trip
    # (small), the supervised kill and resume of the main path, then
    # faulted serving, each with every kernel's counter zeroed just before
    gc.collect()
    torch.cuda.empty_cache()
    check_optim(torch, dev)
    check_ckpt_round_trip(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    run_kill_resume(torch, all_kernels(), records)
    gc.collect()
    torch.cuda.empty_cache()
    run_faulted_serve(torch, all_kernels())

    # data-parallel workers over two ranks sharing the card, against the
    # in-process oracle, every kernel's counter zeroed just before each run
    gc.collect()
    torch.cuda.empty_cache()
    run_dist(torch, all_kernels(), records)

    # tensor parallelism: K1, K2 and K4 at a rank's row geometries, then
    # the grid of four ranks against the one-process oracle, every kernel's
    # counter zeroed just before each run
    gc.collect()
    torch.cuda.empty_cache()
    check_tp_kernels(torch, dev, gen, records)
    run_tp(torch, all_kernels(), records)

    # tensor parallelism for the MoE, Mamba2 and RWKV6 stacks: K1, K2, K4
    # and K10 at the new rank geometries, then each stack over its grid
    # against the one-process oracle, every kernel's counter zeroed just
    # before each run
    gc.collect()
    torch.cuda.empty_cache()
    check_family_tp_kernels(torch, dev, gen, records)
    check_family_grads(torch)
    run_family_tp(torch, all_kernels(), records)

    # the cluster model and the time-to-loss co-simulation (K1 and K8 on
    # the EF candidates' rows), every kernel's counter zeroed just before
    # each card run, then the ring checker with its layer 3 on the card
    gc.collect()
    torch.cuda.empty_cache()
    check_cosim_kernels(torch, dev, gen)
    run_cosim(torch, all_kernels(), records)
    log(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log("recorded, not measured in this run: the times before the "
        "redesign (one device_ms reading each, H100 80GB HBM3 at 700.00 W, "
        "PERF.md) " + ", ".join(f"{name} {ms} ms"
                                for name, ms in EARLIER_MS.items()))
    extra = ("sector_bound_ms", "rwkv6_launches", "moonshot_launches",
             "zamba2_launches", "kill_resume_launches", "ranks_launches",
             "tp_launches", "tp_shapes", "families_tp_launches",
             "families_tp_shapes", "cosim_launches")
    line = [{k: records[kern.name][k] for k in keys
             + tuple(k for k in extra if k in records[kern.name])}
            for kern in all_kernels()]
    print(json.dumps({"kernels": line}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
