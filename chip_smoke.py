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
   ``torch.profiler``: device time by kernel and the device-busy share.

The last two lines of standard output are the kernels' JSON record and the
result ``{"ok": true, "device": {...}}``.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory (data sheet)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on an "
              "NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, main_path_kernels

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

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: records[kern.name][k] for k in keys}
                                  for kern in kernels]}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
