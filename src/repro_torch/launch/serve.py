"""Serving launcher of the port (counterpart of ``repro.launch.serve``):
the dense legacy loop or the continuous-batching engine.

    # continuous batching on the paged KV cache, mixed-length requests
    python -m repro_torch.launch.serve --arch mixtral-8x7b-smoke \\
        --engine continuous --prompt-lens 8,16,24,8 --gen 16

    # the legacy loop (the parity oracle): one static batch
    python -m repro_torch.launch.serve --arch qwen3-1.7b-smoke \\
        --engine loop --prompt-len 32 --gen 16 --batch 4

    # the Mamba2 hybrid, RWKV6, gemma3's local:global stack and the vision
    # and audio frontends serve through the loop only (the paged engine
    # raises NotImplementedError); a frontend arch's prompt carries its
    # stub embeddings from data.pipeline.synthetic_batch
    python -m repro_torch.launch.serve --arch internvl2-2b-smoke \\
        --engine loop --prompt-len 32 --gen 16 --batch 4
    python -m repro_torch.launch.serve --arch zamba2-7b-smoke \\
        --engine loop --prompt-len 32 --gen 16 --batch 4
    python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --engine loop --prompt-len 4096 --gen 32 --batch 4
    python -m repro_torch.launch.serve --arch gemma3-27b \\
        --engine loop --prompt-len 2048 --gen 16 --batch 1

``--device`` defaults to ``cuda``; without a card the launcher raises unless
``--device cpu`` is given.  Weights are random, drawn from a
``torch.Generator`` seeded with ``--seed`` and held in bf16 (vectors
f32); prompts come from ``np.random.default_rng(--seed)``.  Both engines
keep every step's tokens on the device and fetch them once at the end.
``--temperature/--top-k`` switch both from greedy to sampled decoding.
``--devices > 1`` is not ported and raises: the reference only replicates
its page pool over forced XLA host devices.

``--fault-plan`` (continuous engine; a path or inline JSON,
`repro_torch.faults.FaultPlan`) drives the engine's fault paths through
`repro_torch.faults.ServeFaultInjector`: ``logit_poison`` NaN-poisons a
live request's KV (the engine then checks every decode step's logits and
the scheduler quarantines the request: evicted and requeued once, failed
on a second offense) and ``page_exhaust`` holds pages of the pool for a
few ticks (retry-after backpressure):

    python -m repro_torch.launch.serve --device cpu \\
        --arch mixtral-8x7b-smoke --engine continuous \\
        --prompt-lens 45,16,30,8 --gen 8 --batch 2 --page-size 8 \\
        --fault-plan '{"events": [{"step": 4, "kind": "logit_poison"}]}'
"""
from __future__ import annotations

import argparse
import time


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b-smoke")
    ap.add_argument("--engine", default="loop",
                    choices=["loop", "continuous"])
    ap.add_argument("--batch", type=int, default=4,
                    help="loop: batch size; continuous: request slots")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--prompt-lens", default="",
                    help="continuous: comma list of per-request prompt "
                         "lengths (default: --batch x --prompt-len)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--devices", type=int, default=0,
                    help="the reference's forced host devices (not "
                         "ported: must be <= 1)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-plan", default="",
                    help="continuous engine: repro_torch.faults plan (path "
                         "or inline JSON) — logit_poison/page_exhaust "
                         "events drive the quarantine/backpressure paths")
    return ap.parse_args(argv)


def _run_loop(args, cfg, params, sample, device):
    import numpy as np
    import torch

    from repro_torch.configs.base import FRONTEND_NONE
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.dist.train import make_decode_step, make_prefill_step

    max_len = args.prompt_len + args.gen
    rng = np.random.default_rng(args.seed)
    tokens = rng.integers(0, cfg.vocab_size,
                          size=(args.batch, args.prompt_len), dtype=np.int32)
    prefill = make_prefill_step(cfg, max_len, sample)
    decode = make_decode_step(cfg, sample)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    batch = {"tokens": torch.tensor(tokens, device=device)}
    if cfg.frontend != FRONTEND_NONE:
        # the stub's frame or patch embeddings, as the reference builds its
        # prompt with synthetic_batch; the tokens stay the ones drawn above
        stubs = synthetic_batch(cfg, args.batch, args.prompt_len, args.seed,
                                device=device)
        batch.update({k: v for k, v in stubs.items()
                      if k not in ("tokens", "labels")})
    cuda = device.type == "cuda"
    if cuda:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        marks[0].record()
    t0 = time.perf_counter()
    tok, cache = prefill(params, batch, gen)
    if cuda:
        marks[1].record()
    prefill_s = time.perf_counter() - t0
    out = [tok]                     # device tensors; fetched once at the end
    for _ in range(args.gen - 1):
        tok, cache = decode(params, cache, tok[:, None], gen)
        out.append(tok)
    toks = list(torch.stack(out, dim=1).cpu().numpy())
    if cuda:
        prefill_s = marks[0].elapsed_time(marks[1]) / 1e3
    return toks, None, None, [prefill_s]


def _run_continuous(args, cfg, params, sample, device):
    import numpy as np

    from repro_torch.serve import (ContinuousScheduler, PagedCacheConfig,
                                   Request, StepEngine)

    if args.prompt_lens:
        lens = [int(s) for s in args.prompt_lens.split(",")]
    else:
        lens = [args.prompt_len] * args.batch
    ps = args.page_size
    per_req = -(-(max(lens) + args.gen) // ps)
    pcfg = PagedCacheConfig(
        page_size=ps, max_requests=min(args.batch, len(lens)),
        max_pages_per_seq=per_req,
        num_pages=sum(-(-(s + args.gen) // ps) for s in lens))
    plan = injector = None
    if args.fault_plan:
        from repro_torch.faults import FaultPlan, ServeFaultInjector
        plan = FaultPlan.load(args.fault_plan)
    engine = StepEngine(cfg, params, pcfg, sample=sample, seed=args.seed,
                        check_finite=plan is not None
                        and "logit_poison" in plan.kinds())
    if plan is not None:
        injector = ServeFaultInjector(plan, engine)
    sched = ContinuousScheduler(
        engine, queue_limit=4 * len(lens), quarantine=plan is not None,
        on_tick=injector.on_tick if injector else None)
    rng = np.random.default_rng(args.seed)
    trace = [Request(rid=i, max_new=args.gen, arrival=0,
                     prompt=rng.integers(0, cfg.vocab_size, size=s,
                                         dtype=np.int32))
             for i, s in enumerate(lens)]
    toks = sched.run(trace)
    if injector is not None:
        injector.release_all()
    engine.alloc.check()
    st = sched.stats()
    print(f"continuous: {len(lens)} requests in {sched.clock} steps, "
          f"{engine.steps} decode steps, p50={st['p50']:.0f} "
          f"p99={st['p99']:.0f} latency steps, rejected={sched.rejected} "
          f"rejected_frac={st['rejected_frac']:.3f} "
          f"quarantined={st['quarantined']} failed={st['failed']}",
          flush=True)
    gen = [toks.get(i, np.zeros((0,), np.int32)) for i in range(len(lens))]
    secs = engine.prefill_seconds()
    return gen, engine, sched, [secs[i] for i in range(len(lens))]


def main(argv=None, *, cfg=None) -> dict:
    """Serve as configured; returns ``{"tokens": [per-request int32
    arrays], "engine", "scheduler" (continuous only, else None), "wall_s",
    "prefill_s"}``: seconds per request (continuous), or one entry for the
    loop's batched prefill; on a card from CUDA events on the stream.
    ``cfg`` (an ``ArchConfig``) overrides ``--arch``."""
    args = _parse(argv)
    if args.devices > 1:
        raise NotImplementedError(
            "--devices > 1 is not ported: the reference forces N XLA host "
            "devices and only replicates the page pool over them (its "
            "model axis is 1, so paged_cache_specs shards nothing); one "
            "torch process has no counterpart of that emulation")
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import resolve_device
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_serving_params
    from repro_torch.serve.sampling import SampleConfig

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    cfg = cfg if cfg is not None else get_config(args.arch)
    params = init_serving_params(
        TF.model_defs(cfg), torch.Generator(device=device).manual_seed(
            args.seed), device)
    sample = (SampleConfig(temperature=args.temperature, top_k=args.top_k)
              if args.temperature > 0 else SampleConfig())
    t0 = time.perf_counter()
    run = _run_loop if args.engine == "loop" else _run_continuous
    gen, engine, sched, prefill_s = run(args, cfg, params, sample, device)
    wall = time.perf_counter() - t0
    for i, seq_tokens in enumerate(gen):
        print(f"seq {i}: {list(map(int, seq_tokens))}", flush=True)
    return {"tokens": gen, "engine": engine, "scheduler": sched,
            "wall_s": wall, "prefill_s": prefill_s}


if __name__ == "__main__":
    main()
