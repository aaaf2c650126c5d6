"""End-to-end trainer of the port (counterpart of ``repro.launch.train``,
without its checkpointing, fault injection and tensor parallelism).

    python -m repro_torch.launch.train --arch qwen3-1.7b --sync async \\
        --compressor topk --topk-ratio 0.0625 --tau-max 2 --workers 2 \\
        --batch 4 --seq 256 --steps 4
    python -m repro_torch.launch.train --arch qwen3-1.7b --sync topk_ef \\
        --topk-ratio 0.0625 --workers 2 --batch 4 --seq 256 --steps 4

``--sync exact`` is the exact step on the whole batch; ``topk_ef``,
``onebit_ef`` and ``elastic`` (norm gate, ``--beta``, ``--budget-b``) are
the synchronous strategies of `repro_torch.core.scheduler`; ``async`` is
the bounded-staleness engine.

``--workers N`` runs N data-parallel workers in this process (each takes a
contiguous batch shard).  ``--device`` defaults to ``cuda``; without a card
the trainer raises unless ``--device cpu`` is given — it never carries on on
the CPU by itself.
"""
from __future__ import annotations

import argparse
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
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="fused compact-wire delivery (deposit kernels); "
                         "--no-overlap keeps the densified delivery")
    ap.add_argument("--workers", type=int, default=1,
                    help="in-process data-parallel workers")
    ap.add_argument("--device", default="cuda")
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


def main(argv=None) -> list[dict]:
    """Run the configured training; returns one metrics dict per step
    (``loss``, ``gap2_over_alpha2``, ``stale_gap2``, ``mean_tau``,
    ``step_s``; a metric the strategy does not have is 0)."""
    args = _parse(argv)
    import numpy as np
    import torch

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import SyncConfig
    from repro_torch.data.pipeline import SyntheticLMDataset, to_device
    from repro_torch.dist.async_engine import (AsyncConfig,
                                               init_async_state,
                                               make_async_train_step)
    from repro_torch.dist.train import (init_dist_sync_state,
                                        make_elastic_train_step,
                                        make_train_step)
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params, param_specs
    from repro_torch.optim import constant, momentum

    device = resolve_device(args.device)
    if device.type == "cuda":
        # full-precision f32 products, f32 accumulation of bf16 products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    cfg = get_config(args.arch)
    defs = TF.model_defs(cfg)
    specs = param_specs(defs)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(defs, gen, device)
    opt = momentum(constant(args.lr), 0.9)
    opt_state = opt.init(T.leaves(params))
    data = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch,
                              seed=args.seed)

    if args.sync == "exact":
        exact = make_train_step(cfg, opt)

        def run(params, opt_state, state, batch):
            params, opt_state, m = exact(params, opt_state, batch)
            return params, opt_state, state, m
        state = None
    elif args.sync != "async":
        scfg = SyncConfig(strategy=args.sync, topk_ratio=args.topk_ratio,
                          beta=args.beta, budget_b=args.budget_b,
                          gate="norm")
        state = init_dist_sync_state(scfg, args.workers, params)
        run = make_elastic_train_step(cfg, opt, scfg, args.workers, specs)
    else:
        horizon = max(args.steps, 1) \
            if args.async_schedule in ("crash", "rejoin") \
            else max(args.steps, 1024)
        acfg = AsyncConfig(
            tau_max=args.tau_max, schedule=args.async_schedule,
            compressor=args.compressor, error_feedback=args.ef,
            topk_ratio=args.topk_ratio, horizon=horizon, seed=args.seed,
            overlap=args.overlap)
        state = init_async_state(acfg, args.workers, params, specs)
        run = make_async_train_step(cfg, opt, acfg, args.workers, specs)

    history = []
    for t in range(args.steps):
        batch = to_device(data.batch(t), device)
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
               "mean_tau": float(metrics.get("mean_tau", 0.0))}
        history.append(row)
        # gap2/a2 as the reference prints it: the elastic gap, or the
        # bounded-staleness engine's stale gap
        gap = row["stale_gap2"] if args.sync == "async" \
            else row["gap2_over_alpha2"]
        tau = f"  tau {row['mean_tau']:.2f}" if args.sync == "async" else ""
        print(f"step {t:5d}  loss {row['loss']:.6f}  gap2/a2 {gap:.4g}"
              f"{tau}  step_s {row['step_s']:.4f}", flush=True)
    if history:
        print(f"final loss {np.mean([r['loss'] for r in history[-10:]]):.4f}",
              flush=True)
    return history


if __name__ == "__main__":
    main()
