"""End-to-end trainer of the port (counterpart of ``repro.launch.train``,
with its checkpointing, fault injection and tensor parallelism).

    python -m repro_torch.launch.train --arch qwen3-1.7b --sync async \\
        --compressor topk --topk-ratio 0.0625 --tau-max 2 --workers 2 \\
        --batch 4 --seq 256 --steps 4
    python -m repro_torch.launch.train --arch qwen3-1.7b --sync topk_ef \\
        --topk-ratio 0.0625 --workers 2 --batch 4 --seq 256 --steps 4
    python -m repro_torch.launch.train --arch rwkv6-1.6b --sync async \\
        --compressor topk --topk-ratio 0.0625 --tau-max 2 --workers 2 \\
        --batch 4 --seq 256 --steps 2
    python -m repro_torch.launch.train --arch zamba2-7b-smoke \\
        --sync topk_ef --workers 2 --steps 3

``--arch`` takes every id of ``repro_torch.configs`` and its ``-smoke``
variant.

``--sync exact`` is the exact step on the whole batch; ``topk_ef``,
``onebit_ef`` and ``elastic`` (norm gate, ``--beta``, ``--budget-b``) are
the synchronous strategies of `repro_torch.core.scheduler`; ``async`` is
the bounded-staleness engine, where ``--crash-subst`` renormalizes the
mass of crashed or delayed workers.  A step's line is printed every
``--log-every`` steps; ``main`` returns every step's metrics.

``--workers N`` runs N data-parallel workers (each takes a contiguous
batch shard).  ``--ranks R`` lays them over R processes, one
``torch.distributed`` rank each with N / R contiguous workers
(`repro_torch.launch.mesh`; R must divide N): the counterpart of the
reference's ``--devices N`` is ``--workers N --ranks N``.  The ranks are
started with the ``spawn`` method after the CUDA kernels are built once;
they meet through a ``FileStore`` in a fresh temporary directory (no TCP
port) and gather the compressed payloads and every dense mean in worker
order, so a run's losses and state do not depend on R.  Rank 0 prints the
step lines, writes the checkpoints and hands its metrics back; if a rank
dies, the others are killed and the run raises.  ``--dist-backend``
defaults to ``nccl`` on ``--device cuda`` (one card a rank: with fewer
cards than ranks it raises; name ``gloo`` to share a card) and ``gloo`` on
the CPU.  ``--sync exact`` is the whole-batch step of one process and
refuses ``--ranks`` > 1 (its data-parallel form is ``--sync async
--tau-max 0``).

    python -m repro_torch.launch.train --device cpu --arch qwen3-1.7b-smoke \\
        --sync async --compressor topk --workers 2 --ranks 2 --steps 3

``--model-shards m`` (default 1) lays the ranks out as a grid of ``R / m``
data ranks by ``m`` model ranks (`repro_torch.launch.mesh`; m must divide
R and R / m the workers): each rank holds its model shard of every leaf by
the reference's spec (``param_specs(defs, {"model": m})``) and runs the
forward and backward with Megatron's collectives over its model group
(`repro_torch.models.actx`); compression and delivery run on its own rows
and the payloads cross its data group only.  The counterpart of the
reference's ``--devices D --model-shards m`` is ``--workers D/m --ranks D
--model-shards m``.  Every stack runs it: the attention stacks, the MoE
over the rank's experts, Mamba2 and RWKV6 over the rank's heads; an ``m``
that would cut a split leaf another way than the reference's spec (the
experts, the heads or ``d_ff`` not divisible) is refused before any rank
starts.  The fused delivery stays fused.  ``--sync exact`` takes ``--ranks m
--model-shards m`` (one data rank).  A checkpoint holds whole leaves, as
the reference's ``--model-shards m`` run writes them, and resumes under
any layout with the same ``m``; a fused async checkpoint of another ``m``
(its ``acc`` rings are (cap, M, R) with M the model-sharded dim) is
refused before any rank starts.

    python -m repro_torch.launch.train --device cpu --arch qwen3-1.7b-smoke \\
        --sync async --compressor topk --workers 2 --ranks 4 \\
        --model-shards 2 --steps 3

``--device`` defaults to ``cuda``; without a card the trainer raises
unless ``--device cpu`` is given — it never carries on on the CPU by
itself.  ``--n-layers N`` cuts the arch to its first N layers at full
width (0: its own depth; more than its depth is refused).

Checkpoints and faults, as the reference's:

    python -m repro_torch.launch.train --device cpu --arch qwen3-1.7b-smoke \\
        --sync async --compressor topk --tau-max 2 --steps 8 \\
        --ckpt-dir ckpt --ckpt-every 2 --fault-plan plan.json

``--ckpt-dir`` resumes from its newest loadable checkpoint
(`repro_torch.checkpoint.latest_step`), in place into the state this run
has just allocated, and prints ``resumed from step N``; a checkpoint of
another configuration (strategy, ``--tau-max``, ``--compressor``, ``--ef``,
``--overlap``, a resized tau table) raises ``ValueError``.  Every
``--ckpt-every`` steps it saves ``(params, opt_state, sync_state)``: the
delay rings, EF residuals, tau table and step counters travel with the
params, so a resumed run continues bitwise where the killed one was.  A
save is best effort: an ``OSError`` is printed and training goes on.
``--fault-plan`` (a path or inline JSON, `repro_torch.faults.FaultPlan`)
with ``--fault-attempt`` (the supervisor's restart count): ``grad_poison``
steps scale the loss by NaN/Inf and arm the skip-step guard (``--sync
exact`` or ``async`` only), tau events rewrite the tau table, ``ckpt_io``
fails a save and ``kill`` SIGKILLs the process after its step (under
``--ranks``, rank 0, and the world goes down with it; the supervisor
restarts the whole world, which resumes from the gathered checkpoint).
"""
from __future__ import annotations

import argparse
import os
import queue
import shutil
import sys
import tempfile
import threading
import time


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b-smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--sync", default="exact",
                    choices=["exact", "topk_ef", "onebit_ef", "elastic",
                             "async"])
    ap.add_argument("--beta", type=float, default=0.9)
    ap.add_argument("--budget-b", type=float, default=0.0)
    ap.add_argument("--topk-ratio", type=float, default=1 / 16)
    ap.add_argument("--tau-max", type=int, default=4)
    ap.add_argument("--async-schedule", default="uniform",
                    choices=["constant", "uniform", "roundrobin",
                             "straggler", "crash", "rejoin"])
    ap.add_argument("--compressor", default="none",
                    choices=["none", "topk", "onebit"])
    ap.add_argument("--ef", action=argparse.BooleanOptionalAction,
                    default=True, help="error feedback for --compressor")
    ap.add_argument("--crash-subst", action="store_true",
                    help="async: renormalize dead-worker mass so survivors "
                         "keep the full step size (paper crash_subst)")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="fused compact-wire delivery (deposit kernels); "
                         "--no-overlap keeps the densified delivery")
    ap.add_argument("--workers", type=int, default=1,
                    help="data-parallel workers")
    ap.add_argument("--ranks", type=int, default=1,
                    help="processes the workers are laid over, one "
                         "torch.distributed rank each (divides --workers)")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="ranks a model group shards the model over "
                         "(tensor parallelism; divides --ranks)")
    ap.add_argument("--dist-backend", default=None, choices=["gloo", "nccl"],
                    help="the ranks' backend (default: nccl on --device "
                         "cuda, gloo on the CPU)")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the arch to its first N layers (0: all)")
    # fault injection (repro_torch.faults): a plan path or inline JSON; the
    # supervisor forwards --fault-attempt so kill events fire exactly once
    ap.add_argument("--fault-plan", default="")
    ap.add_argument("--fault-attempt", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def resolve_device(name: str):
    """The torch device to run on; a CUDA device without a card raises."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available; pass --device cpu to "
            "run on the CPU")
    return device


_STATE_MISMATCH = (
    "checkpointed sync/async state does not match the current --sync "
    "configuration (different strategy, --tau-max, --compressor, --ef, "
    "--overlap, or a --steps change that resized the tau table?) — delay "
    "rings and tau schedules cannot be reinterpreted; resume with the "
    "original flags or use a fresh --ckpt-dir")


def main(argv=None, *, cfg=None, report=None,
         compare_to=None) -> list[dict]:
    """Run the configured training; returns one metrics dict per step run
    (``step``, ``loss``, ``gap2_over_alpha2``, ``stale_gap2``,
    ``mean_tau``, ``nonfinite``, ``step_s``, ``wire_bytes``; a metric the
    strategy does not have is 0; under ``--ranks``, rank 0's).  ``cfg``
    (an ``ArchConfig``) overrides ``--arch``, e.g. a config cut in depth.
    Every arch trains on the synthetic token stream; a frontend arch
    (vision, audio) then embeds its tokens, as the reference's launcher
    does.  A ``report`` dict receives ``"ranks"``, one dict a rank (its
    kernel launches, peak device memory, step seconds and per-step wire
    bytes by collective, and the seconds its set-up before the first
    step and its share of the comparison took; under ``--ranks``, also
    from the parent's spawn to the rank's start and its rendezvous).
    ``compare_to`` (the leaves of another run's final ``(params,
    opt_state, state)`` in the one-process layout, in the order a
    checkpoint writes them, or the first of them, e.g. the params alone)
    makes the report's ``"leaf_max_abs"`` the largest absolute difference
    of each of as many final leaves, gathered whole, from its
    counterpart, keyed as the checkpoint's arrays (``"0"``, ``"1"``,
    ...), and ``"leaf_l2"`` the Frobenius norm of each difference (rank
    0 compares; the leaves reach it through ``torch.multiprocessing``,
    CUDA ones by IPC handle); without it both are ``None``."""
    args = _parse(argv)
    if args.ranks > 1 or args.model_shards > 1:
        return _run_ranks(args, cfg, report, compare_to)
    from repro_torch.launch.mesh import RankLayout
    rep = None if report is None else {}
    history = _train(args, cfg, RankLayout(), rep, compare_to)
    if report is not None:
        report["leaf_max_abs"] = rep.pop("leaf_max_abs")
        report["leaf_l2"] = rep.pop("leaf_l2")
        report["ranks"] = [rep]
    return history


def _arch(args, cfg):
    """The config to train: ``cfg`` or ``--arch``, cut to ``--n-layers``."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = cfg if cfg is not None else get_config(args.arch)
    if args.n_layers:
        if not 0 < args.n_layers <= cfg.n_layers:
            raise SystemExit(f"--n-layers {args.n_layers}: {cfg.name} has "
                             f"{cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    return cfg


def _check_resume(args, cfg) -> None:
    """Raise ``ValueError`` when ``--ckpt-dir``'s newest checkpoint cannot
    be restored into this configuration's whole layout, which is built on
    the ``meta`` device (no storage) to compare the structures."""
    import torch

    from repro_torch import tree as T
    from repro_torch.checkpoint import check_checkpoint, latest_step
    from repro_torch.dist.workers import WorkerGroup
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import param_specs

    last = latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if last is None:
        return
    defs = TF.model_defs(cfg)
    specs = param_specs(defs, {"model": args.model_shards})
    params = T.tree_map(lambda d: torch.empty(d.shape, device="meta"), defs)
    opt_state, state, _ = _build(args, cfg, WorkerGroup(args.workers),
                                 params, specs)
    try:
        check_checkpoint(args.ckpt_dir, last, (params, opt_state, state))
    except ValueError as e:
        raise ValueError(f"{_STATE_MISMATCH} ({e})") from e


def _run_ranks(args, cfg, report, compare_to):
    """The parent of a ``--ranks`` run: check the layout, the family and
    the checkpoint to resume, build the CUDA kernels once, spawn one
    process a rank, collect rank 0's history and every rank's report, and
    take the world down if a rank dies."""
    import multiprocessing

    import torch

    from repro_torch.launch.mesh import check_layout, default_backend
    from repro_torch.models.transformer import check_tensor_parallel

    device_type = torch.device(args.device).type
    backend = args.dist_backend or default_backend(device_type)
    resolve_device(args.device)
    check_layout(args.workers, args.ranks, backend, device_type,
                 args.model_shards)
    if args.sync == "exact" and args.ranks != args.model_shards:
        raise SystemExit("--sync exact is the whole-batch step of one "
                         "data rank (--ranks m --model-shards m); over data "
                         "ranks use --sync async --tau-max 0")
    arch = _arch(args, cfg)
    check_tensor_parallel(arch, args.model_shards)
    _check_resume(args, arch)
    if device_type == "cuda":
        # before any rank starts, so that two ranks never race nvcc
        from repro_torch.kernels import _build
        _build.build_all()
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank {r}", daemon=True,
                         args=(r, args, backend, os.path.join(tmp, "store"),
                               cfg, report is not None,
                               _compare_part(compare_to, r), results,
                               os.getpid(), time.time()))
             for r in range(args.ranks)]
    got = {}
    try:
        for proc in procs:
            proc.start()
        while len(got) < len(procs):
            try:
                rank, out = results.get(timeout=1.0)
                got[rank] = out
                continue
            except queue.Empty:
                pass
            dead = [f"{p.name} exited with code {p.exitcode}" for p in procs
                    if p.exitcode not in (None, 0)]
            if not dead and all(p.exitcode == 0 for p in procs):
                try:
                    rank, out = results.get(timeout=10.0)
                    got[rank] = out
                    continue
                except queue.Empty:
                    dead = ["every rank exited without a result"]
            if dead:
                raise RuntimeError(f"{'; '.join(dead)}: the other ranks "
                                   "were killed")
        for proc in procs:
            proc.join()
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            if proc.pid is not None:
                proc.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if report is not None:
        ranks = [got[r]["report"] for r in range(args.ranks)]
        report["leaf_max_abs"] = ranks[0].pop("leaf_max_abs")
        report["leaf_l2"] = ranks[0].pop("leaf_l2")
        report["ranks"] = ranks
    return got[0]["history"]


def _compare_part(compare_to, rank: int):
    """Rank ``rank``'s part of ``compare_to``: rank 0 compares with the
    leaves, the others only join the gathers (a ``None`` a leaf)."""
    if compare_to is None or rank == 0:
        return compare_to
    return [None] * len(compare_to)


def _exit_with_parent(parent_pid: int) -> None:
    """End this rank if the process that spawned it is gone."""
    def watch():
        while os.getppid() == parent_pid:
            time.sleep(1.0)
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def _rank_main(rank, args, backend, store_path, cfg, want_report,
               compare_to, results, parent_pid, t_spawn):
    """One rank of a ``--ranks`` run (a spawned process; ``t_spawn``: the
    host clock when the parent started the ranks)."""
    from repro_torch.launch.mesh import close, make_host_mesh
    from repro_torch.models import actx

    spawn_s = time.time() - t_spawn     # the interpreter and its imports
    _exit_with_parent(parent_pid)
    if rank:
        sys.stdout = open(os.devnull, "w")
    t0 = time.perf_counter()
    layout = make_host_mesh(backend=backend, world=args.ranks, rank=rank,
                            store_path=store_path, model=args.model_shards)
    mesh_s = time.perf_counter() - t0
    try:
        rep = {} if want_report else None
        history = _train(args, cfg, layout, rep, compare_to)
        if compare_to is not None:
            # drop the parent's leaves (CUDA ones shared by IPC handle) now:
            # the parent frees them once every rank holding one lets go
            compare_to.clear()
        if rep is not None:
            rep.update(spawn_s=spawn_s, mesh_s=mesh_s)
        results.put((rank, {"history": history if rank == 0 else None,
                            "report": rep}))
    finally:
        actx.install(None)
        close(layout)


def _build(args, cfg, group, params, specs, injector=None):
    """The optimizer state, the sync or async state and the step function
    ``run(params, opt_state, state, batch)`` of ``--sync`` over ``group``
    (``params`` and ``specs``: this rank's)."""
    from repro_torch import tree as T
    from repro_torch.core.scheduler import SyncConfig
    from repro_torch.dist.async_engine import (AsyncConfig,
                                               init_async_state,
                                               make_async_train_step)
    from repro_torch.dist.train import (init_dist_sync_state,
                                        make_elastic_train_step,
                                        make_train_step)
    from repro_torch.optim import constant, momentum

    guard = injector is not None and injector.has_poison
    opt = momentum(constant(args.lr), 0.9)
    opt_state = opt.init(T.leaves(params))
    if args.sync == "exact":
        exact = make_train_step(cfg, opt, skip_nonfinite=guard, specs=specs)

        def run(params, opt_state, state, batch):
            params, opt_state, m = exact(params, opt_state, batch)
            return params, opt_state, state, m
        # the reference's exact state: a step counter the step never moves
        return opt_state, {"step": 0}, run
    if args.sync != "async":
        scfg = SyncConfig(strategy=args.sync, topk_ratio=args.topk_ratio,
                          beta=args.beta, budget_b=args.budget_b,
                          gate="norm")
        state = init_dist_sync_state(scfg, group, params)
        return opt_state, state, make_elastic_train_step(cfg, opt, scfg,
                                                         group, specs)
    # the horizon is decoupled from --steps (up to 1024), so a resume with
    # a larger --steps reuses the checkpointed tau table; the crash/rejoin
    # schedules place their outages at horizon fractions, so theirs follows
    # the run (the resume check holds it)
    horizon = max(args.steps, 1) \
        if args.async_schedule in ("crash", "rejoin") \
        else max(args.steps, 1024)
    acfg = AsyncConfig(
        tau_max=args.tau_max, schedule=args.async_schedule,
        compressor=args.compressor, error_feedback=args.ef,
        topk_ratio=args.topk_ratio, horizon=horizon, seed=args.seed,
        crash_subst=args.crash_subst, skip_nonfinite=guard,
        overlap=args.overlap)
    state = init_async_state(acfg, group, params, specs)
    if injector is not None and injector.plan.has_tau_events:
        # crash/rejoin/delay/drop faults rewrite the host tau table; a
        # resume restores the same rewritten table from the checkpoint
        state["taus"] = injector.plan.apply_to_taus(state["taus"],
                                                    args.tau_max)
    return opt_state, state, make_async_train_step(cfg, opt, acfg, group,
                                                   specs)


def _train(args, cfg, layout, report, compare_to=None) -> list[dict]:
    """The training loop of one process: all the workers (one rank), or
    rank ``layout.rank``'s."""
    t_start = time.perf_counter()
    import numpy as np
    import torch

    from repro_torch import tree as T
    from repro_torch.checkpoint import (checkpoint_leaves, latest_step,
                                        load_checkpoint, save_checkpoint)
    from repro_torch.data.pipeline import SyntheticLMDataset, to_device
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.workers import WorkerGroup
    from repro_torch.launch.mesh import rank_device
    from repro_torch.models import actx
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params, param_specs

    if layout.world == 1:
        device = resolve_device(args.device)
    else:
        device = rank_device(layout, torch.device(args.device).type)
        if device.type == "cuda":
            torch.cuda.set_device(device)
    group = WorkerGroup(args.workers, layout)
    writer = layout.rank == 0
    if device.type == "cuda":
        # full-precision f32 products, f32 accumulation of bf16 products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    cfg = _arch(args, cfg)
    injector = None
    if args.fault_plan:
        from repro_torch.faults import FaultPlan, TrainFaultInjector
        injector = TrainFaultInjector(FaultPlan.load(args.fault_plan),
                                      attempt=args.fault_attempt)
    guard = injector is not None and injector.has_poison
    # the poison guard only arms the paths that implement it; a poison plan
    # with another --sync would corrupt params silently, so refuse it
    if guard and args.sync not in ("exact", "async"):
        raise SystemExit("--fault-plan with grad_poison events needs "
                         "--sync exact or async (the skip-step guard)")
    m = layout.model
    TF.check_tensor_parallel(cfg, m)
    if m > 1:
        actx.install(actx.ModelGroup(layout, group._count))
    defs = TF.model_defs(cfg)
    specs = param_specs(defs, {"model": m})
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(defs, gen, device, specs=specs,
                         rank=layout.model_rank, size=m)
    opt_state, state, run = _build(args, cfg, group, params, specs,
                                   injector)
    opt_specs = SH.opt_state_specs(opt_state, specs)
    data = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch,
                              seed=args.seed)

    def whole(params, opt_state, state):
        # the trees in the one-process layout: per-worker and model-sharded
        # leaves gathered (or scattered) one leaf at a time
        return (SH.shard_view(params, specs),
                SH.shard_view(opt_state, opt_specs),
                SH.gather_state(state, group, specs))

    step_idx = 0
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            t0 = time.perf_counter()
            try:
                # every rank reads the file and takes its part of each leaf
                params, opt_state, restored = load_checkpoint(
                    args.ckpt_dir, last,
                    like=whole(params, opt_state, state))
            except ValueError as e:
                raise ValueError(f"{_STATE_MISMATCH} ({e})") from e
            params, opt_state = SH.local_tree((params, opt_state))
            state = SH.scatter_state(restored, state)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            load_s = time.perf_counter() - t0
            step_idx = last
            print(f"resumed from step {last}", flush=True)
            print(f"ckpt: loaded step {last} in {load_s:.3f} s", flush=True)

    if report is not None:
        from repro_torch.kernels import all_kernels
        kernels = all_kernels()
        launched = {k.name: k.launches for k in kernels}
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
    history, wire = [], []
    setup_s = time.perf_counter() - t_start
    for t in range(step_idx, args.steps):
        batch = to_device(data.batch(t), device)
        if guard:
            # the loss_scale channel: ones normally, NaN/Inf on grad_poison
            # steps; present on every step once armed (a scale of 1.0 is
            # bitwise neutral)
            batch["loss_scale"] = torch.full(
                (args.batch,), injector.loss_scale(t), dtype=torch.float32,
                device=device)
        group.reset_wire()
        t0 = time.perf_counter()
        params, opt_state, state, metrics = run(params, opt_state, state,
                                                batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        row = {"step": t, "step_s": time.perf_counter() - t0,
               "loss": float(metrics["loss"]),
               "gap2_over_alpha2": float(metrics.get("gap2_over_alpha2",
                                                     0.0)),
               "stale_gap2": float(metrics.get("stale_gap2", 0.0)),
               "mean_tau": float(metrics.get("mean_tau", 0.0)),
               "nonfinite": float(metrics.get("nonfinite", 0.0)),
               "wire_bytes": group.wire_bytes()}
        history.append(row)
        wire.append({k: v["bytes"] for k, v in group.wire.items()})
        if t % args.log_every == 0:
            # gap2/a2 as the reference prints it: the elastic gap, or the
            # bounded-staleness engine's stale gap
            gap = row["stale_gap2"] if args.sync == "async" \
                else row["gap2_over_alpha2"]
            tau = f"  tau {row['mean_tau']:.2f}" if args.sync == "async" \
                else ""
            print(f"step {t:5d}  loss {row['loss']:.6f}  gap2/a2 {gap:.4g}"
                  f"{tau}  step_s {row['step_s']:.4f}", flush=True)
        if args.ckpt_dir and args.ckpt_every and \
                (t + 1) % args.ckpt_every == 0:
            t0 = time.perf_counter()
            try:
                if injector is not None:
                    injector.check_ckpt_io(t + 1)
                path = save_checkpoint(
                    args.ckpt_dir, t + 1, whole(params, opt_state, state),
                    write=writer)
                if path is not None:
                    print(f"ckpt: saved step {t + 1} in "
                          f"{time.perf_counter() - t0:.3f} s "
                          f"({os.path.getsize(path)} bytes)", flush=True)
            except OSError as e:
                # best effort: keep training; the next save (or the torn
                # checkpoint skip in latest_step) covers recovery
                print(f"ckpt save failed at step {t + 1}: {e}", flush=True)
        if injector is not None and writer:
            injector.maybe_kill(t)
    losses = [r["loss"] for r in history]
    if injector is not None:
        skipped = sum(r["nonfinite"] > 0 for r in history)
        print(f"faults: poisoned={injector.poisoned_steps} "
              f"skipped={skipped} ckpt_errors={injector.ckpt_errors}",
              flush=True)
        finite = [x for x in losses[-10:] if np.isfinite(x)]
        losses = finite if finite else losses
    if history:
        print(f"final loss {np.mean(losses[-10:]):.4f}", flush=True)
    t0 = time.perf_counter()
    leaf_max_abs = leaf_l2 = None
    if compare_to is not None:
        # every rank joins each leaf's gather; rank 0 compares it whole
        mine = checkpoint_leaves(whole(params, opt_state, state))
        if len(compare_to) > len(mine):
            raise ValueError(f"compare_to holds {len(compare_to)} leaves, "
                             f"the run's state {len(mine)}")
        leaf_max_abs, leaf_l2 = {}, {}
        for i, (leaf, want) in enumerate(zip(mine, compare_to)):
            got = leaf.gather() if isinstance(leaf, SH.WorkerRows) \
                else leaf
            if want is not None:
                got = torch.as_tensor(got).detach()
                want = torch.as_tensor(want).detach()
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise ValueError(
                        f"leaf {i}: {got.dtype} {tuple(got.shape)} against "
                        f"{want.dtype} {tuple(want.shape)} to compare to")
                # f32 for bf16 and f32 leaves, f64 for the integer ones
                dt = torch.promote_types(want.dtype, torch.float32) \
                    if want.is_floating_point() else torch.float64
                diff = got.to(want.device, dt) - want.to(dt)
                leaf_max_abs[str(i)] = float(diff.abs().max()) \
                    if diff.numel() else 0.0
                leaf_l2[str(i)] = float(torch.linalg.vector_norm(diff))
                del diff
            del got
    compare_s = time.perf_counter() - t0
    if report is not None:
        report.update(
            rank=layout.rank, device=str(device),
            launches={k.name: k.launches - launched[k.name]
                      for k in kernels},
            max_memory_allocated=(torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None),
            step_s=[r["step_s"] for r in history], wire=wire,
            leaf_max_abs=leaf_max_abs, leaf_l2=leaf_l2, setup_s=setup_s,
            compare_s=compare_s)
    return history


if __name__ == "__main__":
    main()
