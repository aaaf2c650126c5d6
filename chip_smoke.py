#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit, CUDA version) and the
   kernel build, one ``nvcc`` per CUDA source, all started together;
2. every kernel of the training main path against its plain PyTorch
   version at the main path's shapes, timed with CUDA events beside its
   byte bound and the nearest single PyTorch call;
3. a small-input check of the path on the card against the same code on
   the CPU (plain versions), and the smoke model's loss on both;
4. the main path: full-width qwen3-1.7b, ``--sync async --compressor topk
   --topk-ratio 1/16``, EF and overlap on, 2 in-process workers, tau_max 2,
   ``uniform``, seq 256, batch 4, 4 steps, through
   ``repro_torch.launch.train.main``; launch counters are zeroed just
   before and read just after;
5. 2 steps of the same with ``--compressor onebit`` (the one-bit deposit);
6. one more top-k step of the phase-4 configuration under
   ``torch.profiler``: device time by kernel and the device-busy share;
7. the simulator's kernels against their plain versions: ``delivery_step``
   (both bodies) and ``sync_step`` at (p, d) = (8, 32), (16, 512),
   (32, 4096), d = 100 and B = 16 cases at (16, 256) with A shared and
   stacked; ``onebit_ef`` at the matching (rows, d); ``topk_ef`` at the
   simulator's (8, 32), k = 8, with ties; each run twice (bitwise) and
   timed beside its bound;
8. Table 1 (``bench_table1_bounds.py``'s nine relaxations and shared
   memory, P = 8, d = 32, T = 600) on the card and on the CPU with the same
   draws: card == CPU at the parity tolerances, no VIOLATION;
9. the fused step at ``bench_sim_step_kernel.py``'s sizes (p = 16, d in
   {256, 512}, T = 400, sync and crash_subst) against the unfused one, one
   fused run at (32, 4096), and the 16-case crash_subst grid through
   ``simulate_grid`` (one ``delivery_step`` launch per step);
10. Figure 3 (``bench_fig3_variance_bounded.py``: MLP, sync and
    variance-bounded, P = 8, T = 800, seeds 4-7): the accuracy recovers;
    the launch counters are zeroed before phase 8 and read after phase 10;
11. one fused and one unfused simulator run under ``torch.profiler``.

The last three lines of standard output are the kernels' JSON record, the
card's name and power limit, and the result ``{"ok": true, "device":
{...}}``.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory (data sheet)
FP32_FLOPS_PER_S = 67e12            # H100 SXM FP32 outside the tensor cores
TOPK_RATIO = 1 / 16
# leaf row lengths of full-width qwen3-1.7b on the main path (M = 1)
R_WK = 28 * 2048 * 8 * 128          # layers/attn/wk: 58,720,256
R_WGATE = 28 * 2048 * 6144          # layers/mlp/w_gate: 352,321,536
# device kernels of a profiled step, by what launched them (first match)
PROFILE_GROUPS = (
    ("K1 topk_ef", ("init_kernel", "hist0_kernel", "histn_kernel",
                    "select_kernel", "count_kernel", "scan_kernel",
                    "write_kernel")),
    ("K2 topk_cr_deposit", ("deposit_kernel",)),
    ("K3 onebit_cr_deposit", ("onebit_deposit",)),
    ("matmul", ("gemm", "xmma", "cutlass", "cublas", "sm90_", "sm80_")),
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


def bound_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_topk_ef(torch, dev, gen, records):
    from repro_torch.kernels.topk_ef.kernel import topk_ef
    from repro_torch.kernels.topk_ef.ref import q_dense, topk_ef_plain

    def inputs(m, r, ties=False):
        if ties:
            g = torch.randint(-2, 3, (m, r), generator=gen, device=dev).float()
            e = 0.5 * torch.randint(-1, 2, (m, r), generator=gen,
                                    device=dev).float()
            g[-1] = 0.0
            e[-1] = 0.0            # an all-zero row
        else:
            g = torch.randn((m, r), generator=gen, device=dev)
            e = 0.1 * torch.randn((m, r), generator=gen, device=dev)
        return g, e

    worst = 0.0
    for m, r, ties in ((8, 4096, True), (1, R_WK, False),
                       (1, R_WGATE, False)):
        k = max(1, int(round(r * TOPK_RATIO)))
        g, e = inputs(m, r, ties)
        kv, ki, ke = topk_ef(g, e, k)
        pv, pi, pe = topk_ef_plain(g, e, k)
        torch.cuda.synchronize()
        same_idx = torch.equal(torch.sort(ki, 1).values,
                               torch.sort(pi, 1).values)
        qk, qp = q_dense(kv, ki, r), q_dense(pv, pi, r)
        same_q = torch.equal(qk.view(torch.int32), qp.view(torch.int32))
        same_e = torch.equal(ke.view(torch.int32), pe.view(torch.int32))
        err = max(float((qk - qp).abs().max()), float((ke - pe).abs().max()))
        worst = max(worst, err)
        log(f"check topk_ef ({m}, {r}) k={k} ties={ties}: idx sets equal "
            f"{same_idx}, Q bitwise {same_q}, new_err bitwise {same_e}, "
            f"max_abs_err {err}")
        require(same_idx and same_q and same_e, "topk_ef != plain version")
        del kv, ki, ke, pv, pi, pe, qk, qp
        if r == R_WGATE:
            w = e + g
            absw = w.abs()
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
            del w, absw
        del g, e
        torch.cuda.empty_cache()


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
    records[topk_cr_deposit.name] = dict(
        name=topk_cr_deposit.name, route="cuda",
        source=topk_cr_deposit.source, replaces=topk_cr_deposit.replaces,
        max_abs_err=errs[topk_cr_deposit.name], ms=ms, plain_ms=plain,
        bound_ms=bound_ms(nbytes), bound_by="bytes", library_ms=lib,
        shape=[3, 1, r], k=k, messages=2)
    log(f"time topk_cr_deposit (3, 1, {r}) S=2 k={k} (topk_ef payloads): "
        f"kernel {ms:.3f} ms, plain {plain:.3f} ms, "
        f"index_put_(accumulate=True) {lib:.3f} ms (products precomputed), "
        f"bound {bound_ms(nbytes):.3f} ms ({nbytes} bytes)")
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

def check_small_path(torch, dev):
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

    cfg = get_config("qwen3-1.7b-smoke")
    defs = TF.model_defs(cfg)
    specs = param_specs(defs)
    base = init_params(defs, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    leaves = T.leaves(base)
    for compressor, steps in (("topk", 3), ("onebit", 1)):
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
        log(f"check path {compressor} smoke delivery, card vs cpu, {steps} "
            f"steps: params/acc/err max_abs_err {err}, stale_gap2 "
            f"{gap_g} vs {gap_c}")
        require(err <= 1e-6 and math.isclose(gap_g, gap_c, rel_tol=1e-5),
                f"{compressor} delivery on the card disagrees with the CPU")
    batch = SyntheticLMDataset(cfg.vocab_size, 64, 2, seed=0).batch(0)
    with torch.no_grad():
        l_cpu = float(loss_fn(cfg, base, to_device(batch, "cpu"))[0])
        l_card = float(loss_fn(cfg, T.tree_map(lambda p: p.to(dev), base),
                               to_device(batch, dev))[0])
    log(f"check smoke model loss card {l_card:.6f} vs cpu {l_cpu:.6f}")
    require(abs(l_card - l_cpu) < 2e-2, "smoke loss differs card vs cpu")


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def run_path(torch, kernels, compressor: str, steps: int):
    """Drive the main path through the trainer's entry point, with the
    launch counters zeroed just before; returns the counts after it.  The
    peak memory must stay within 90% of the card (with ``track_gap`` on)."""
    from repro_torch.launch import train

    argv = ["--arch", "qwen3-1.7b", "--sync", "async", "--compressor",
            compressor, "--topk-ratio", str(TOPK_RATIO), "--ef", "--overlap",
            "--tau-max", "2", "--async-schedule", "uniform", "--workers", "2",
            "--batch", "4", "--seq", "256", "--steps", str(steps),
            "--device", "cuda", "--seed", "0"]
    log(f"path: python -m repro_torch.launch.train {' '.join(argv)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    history = train.main(argv)
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"path {compressor}: {steps} steps in {wall:.2f} s (model init "
        f"included); peak memory {peak} bytes ({peak / total:.3f} of "
        f"{total}); launches {json.dumps(counts)}")
    require(len(history) == steps, "missing steps")
    require(peak <= 0.9 * total, "peak memory above 90% of the card")
    for row in history:
        require(math.isfinite(row["loss"]) and
                math.isfinite(row["stale_gap2"]), f"non-finite step {row}")
    return counts


def profile_step(torch) -> None:
    """Where a main-path step's device time goes: the full-width
    configuration of phase 4 built through the same public functions, one
    warm-up step, then one step under ``torch.profiler``; prints device
    time by kernel and the device-busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset, to_device
    from repro_torch.dist.async_engine import (AsyncConfig,
                                               init_async_state,
                                               make_async_train_step)
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params, param_specs
    from repro_torch.optim import constant, momentum

    dev = torch.device("cuda")
    cfg = get_config("qwen3-1.7b")
    defs = TF.model_defs(cfg)
    specs = param_specs(defs)
    params = init_params(defs, torch.Generator(device=dev).manual_seed(0),
                         dev)
    opt = momentum(constant(3e-3), 0.9)
    opt_state = opt.init(T.leaves(params))
    acfg = AsyncConfig(tau_max=2, schedule="uniform", compressor="topk",
                       topk_ratio=TOPK_RATIO)
    state = init_async_state(acfg, 2, params, specs)
    step = make_async_train_step(cfg, opt, acfg, 2, specs)
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
    kernel_type = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == kernel_type and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    log(f"profile step: wall {wall * 1e3:.1f} ms (profiler on), device "
        f"kernels {busy_us / 1e3:.1f} ms ({busy_us / 1e3 / (wall * 1e3):.3f}"
        f" of wall), loss {float(m['loss']):.6f}")
    groups = {}
    for key, us, count in rows:
        group = next((g for g, pats in PROFILE_GROUPS if any(
            p in key for p in pats)), "other")
        t, c = groups.get(group, (0.0, 0))
        groups[group] = (t + us, c + count)
    for group, (us, count) in sorted(groups.items(), key=lambda g: -g[1][0]):
        log(f"  group {group:<24s} {us / 1e3:9.3f} ms  x{count}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:100]}")


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
                f"{nbytes} bytes, {flops:.4g} flops); library call: none")
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
        lib = None
        if b == 1 and groups is None:
            cf = float(c[0])
            base, diff = x - nsum, x - xs
            lib, _ = device_ms(torch, lambda: torch.addmm(base, diff, a,
                                                          alpha=-cf))
        log(f"time sync_step {tag}: kernel {ms:.4f} ms on the device "
            f"({call:.4f} ms a call from the host), plain {plain:.4f} ms "
            f"({pcall:.4f}), torch.addmm "
            f"{'none (batched)' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{bnd:.4f} ms ({by}; {nbytes} bytes)")
        if timed:
            records[sync_step.name] = dict(
                name=sync_step.name, route="cuda", source=sync_step.source,
                replaces=sync_step.replaces, ms=ms, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=lib, shape=[b, d])
        del x, a, xs, noise, nsum, sargs
        torch.cuda.empty_cache()
    for name, err in worst.items():
        records[name]["max_abs_err"] = err


def check_onebit_ef(torch, dev, gen, records):
    from repro_torch.kernels.onebit_ef.kernel import onebit_ef
    from repro_torch.kernels.onebit_ef.ref import onebit_ef_plain
    worst = 0.0
    # (M = B * p worker rows, R = d), as the simulator's EF rounds give them
    for m, r in ((8, 32), (16, 512), (32, 4096), (8, 100), (256, 256)):
        g = torch.randn((m, r), generator=gen, device=dev)
        e = 0.1 * torch.randn((m, r), generator=gen, device=dev)
        g[-1] = 0.0
        e[-1] = 0.0                     # an all-zero row
        got = onebit_ef(g, e)
        want = onebit_ef_plain(g, e)
        again = onebit_ef(g, e)
        torch.cuda.synchronize()
        err, close, same = compare(torch, got, want, again, ONEBIT_TOL)
        packed_same = torch.equal(got[0], want[0])
        worst = max(worst, err)
        log(f"check onebit_ef ({m}, {r}): packed bitwise {packed_same}, "
            f"means/new_err close {close}, run-to-run bitwise {same}, "
            f"max_abs_err {err}")
        require(packed_same and close and same, "onebit_ef != plain version")
        nbytes = 12 * m * r + m * ((r + 7) // 8) + 8 * m
        bnd, by = bound_of(nbytes, 6.0 * m * r)
        ms, call = device_ms(torch, lambda: onebit_ef(g, e))
        plain, pcall = device_ms(torch, lambda: onebit_ef_plain(g, e))
        log(f"time onebit_ef ({m}, {r}): kernel {ms:.4f} ms on the device "
            f"({call:.4f} ms a call from the host), plain {plain:.4f} ms "
            f"({pcall:.4f}), bound {bnd:.6f} ms ({by}; {nbytes} bytes); "
            f"library call: none")
        if (m, r) == (32, 4096):
            records[onebit_ef.name] = dict(
                name=onebit_ef.name, route="triton", source=onebit_ef.source,
                replaces=onebit_ef.replaces, ms=ms, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=None, shape=[m, r])
    records[onebit_ef.name]["max_abs_err"] = worst


def check_topk_ef_sim_shape(torch, dev, gen):
    """K1 at the simulator's shape: (p, d) = (8, 32), k = 8 (ratio 0.25),
    with many ties at the threshold."""
    from repro_torch.kernels.topk_ef.kernel import topk_ef
    from repro_torch.kernels.topk_ef.ref import q_dense, topk_ef_plain
    m, r, k = 8, 32, 8
    g = torch.randint(-2, 3, (m, r), generator=gen, device=dev).float()
    e = 0.5 * torch.randint(-1, 2, (m, r), generator=gen, device=dev).float()
    g[-1] = 0.0
    e[-1] = 0.0
    kv, ki, ke = topk_ef(g, e, k)
    pv, pi, pe = topk_ef_plain(g, e, k)
    kv2, ki2, ke2 = topk_ef(g, e, k)
    torch.cuda.synchronize()
    same_idx = torch.equal(torch.sort(ki, 1).values, torch.sort(pi, 1).values)
    same_q = torch.equal(q_dense(kv, ki, r), q_dense(pv, pi, r))
    same_e = torch.equal(ke, pe)
    repeat = torch.equal(ki, ki2) and torch.equal(kv, kv2) and \
        torch.equal(ke, ke2)
    log(f"check topk_ef sim shape ({m}, {r}) k={k} ties: idx sets equal "
        f"{same_idx}, Q bitwise {same_q}, new_err bitwise {same_e}, "
        f"run-to-run bitwise {repeat}")
    require(same_idx and same_q and same_e and repeat,
            "topk_ef != plain version at the simulator's shape")
    nbytes = 12 * m * r + 8 * m * k
    ms, call = device_ms(torch, lambda: topk_ef(g, e, k))
    plain, pcall = device_ms(torch, lambda: topk_ef_plain(g, e, k))
    absw = (e + g).abs()
    lib, _ = device_ms(torch, lambda: torch.topk(absw, k, dim=1))
    log(f"time topk_ef sim shape ({m}, {r}) k={k}: kernel {ms:.4f} ms on "
        f"the device ({call:.4f} ms a call from the host), plain "
        f"{plain:.4f} ms ({pcall:.4f}), torch.topk {lib:.4f} ms, bound "
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
    delivery_step launch per step for all 16 cases."""
    import numpy as np

    from repro_torch.core.problems import Quadratic
    from repro_torch.core.sim import (Relaxation, simulate, simulate_grid)

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
            before = counts()
            t0 = time.perf_counter()
            fused = simulate(prob, relax, p, 0.02, t_len, seed=3, x0=x0,
                             fused=True)
            t_f = time.perf_counter() - t0
            used = {k: v - before[k] for k, v in counts().items()}
            t0 = time.perf_counter()
            unfused = simulate(prob, relax, p, 0.02, t_len, seed=3, x0=x0,
                               fused=False)
            t_u = time.perf_counter() - t0
            agree = parity(fused, unfused)
            log(f"sim_step/{name}_p{p}_d{d}: fused {t_len / t_f:.1f} "
                f"steps/s ({t_f:.3f} s), unfused {t_len / t_u:.1f} steps/s "
                f"({t_u:.3f} s), speedup {t_u / t_f:.2f}x; fused == unfused "
                f"at parity tolerance {agree}; launches in the fused run "
                f"{json.dumps(used)}")
            require(agree, f"{name} p{p} d{d}: fused != unfused")
            require(used[kernel] == t_len, f"{kernel} launched "
                    f"{used[kernel]} times, not {t_len}")
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
    T = 100, fused and unfused, under torch.profiler: device time by
    kernel, kernel launches per step and the device-busy share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.problems import Quadratic
    from repro_torch.core.sim import Relaxation, simulate

    prob = Quadratic(dim=256, cond=8.0, sigma=1.0, seed=0, device="cuda")
    relax = Relaxation("crash_subst", f=3)
    x0 = np.ones(256, np.float32)
    t_len = 100
    for fused in (True, False):
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
        log(f"profile sim crash_subst p16 d256 T{t_len} fused={fused}: wall "
            f"{wall * 1e3:.2f} ms (profiler on), device kernels "
            f"{busy_us / 1e3:.3f} ms ({busy_us / 1e3 / (wall * 1e3):.4f} of "
            f"wall), {n_kernels} kernels ({n_kernels / t_len:.2f} per step)")
        for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
            log(f"  {us / 1e3:9.4f} ms  x{count:<5d} {key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on an "
              "NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import (_build, all_kernels, main_path_kernels,
                                     sim_kernels)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
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

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: records[kern.name][k] for k in keys}
                                  for kern in all_kernels()]}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
