"""One run of one cell: set-up, the measured window, the traced span, and
the comparison with the plain reference that decides ``correct``.

A cell is ``workloads/<cell>.json``: its configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``, read
by the one generator :mod:`perfbench.traffic.markov` and the one step
builder :class:`Program`), its set-up and traced steps and the limit of
each number compared.  The per-layer metrics a cell reports are those
``BENCHMARK.json`` lists for it; each is read by
``metrics/<metric>.py``.

The program (``repro_torch``) gives the system under test: its model
definitions, optimizer, sync or async state and training step, built as
its launcher builds them.  The benchmark makes the weights and the
batches from the seed and hands them to the program and to the reference
alike.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

from perfbench import arch, peaks, weights
from perfbench.counts import flops as FL
from perfbench.counts import kernel_bytes as KB
from perfbench.traffic.markov import MarkovStream

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the numbers the comparison reads; a cell's ``limits`` name those it
# compares
CHECKS = ("loss_gap", "grad1_gap", "change_gap")
# leaves whose first raw gradient is under this share of the median leaf's
# are left out of the comparison of norms
ZERO_GRAD_SHARE = 1e-3
# the fewest set-up steps the comparison follows
MIN_CHECKED_STEPS = 3


def load_json(path) -> dict:
    return json.loads(Path(path).read_text())


def load_cell(name: str) -> dict:
    """A cell with its configuration and traffic files read in."""
    cell = load_json(HERE / "workloads" / f"{name}.json")
    cell["name"] = name
    cell["config_file"] = arch.load_config(cell["config"])
    cell["traffic_file"] = load_json(HERE / "traffic"
                                     / f"{cell['traffic']}.json")
    return cell


def checked_steps(traffic: dict) -> int:
    """The set-up steps the comparison follows: three, and with a delay
    ring of ``tau_max + 1`` slots two turns of it, so that a slot that was
    taken, filled again and taken again is compared."""
    return max(MIN_CHECKED_STEPS, 2 * (traffic.get("tau_max", 0) + 1))


def cell_metrics(spec: dict, cell: str):
    """``(end_to_end names, per_layer names)`` ``spec`` (BENCHMARK.json)
    has a cell report: a metric with a ``workloads`` key in the cells it
    lists, a per-layer one without it wherever its ``moves`` is
    reported."""
    e2e = [m["name"] for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    layer = [m["name"] for m in spec["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in e2e
                              else [])]
    return e2e, layer


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------

def port_arch(conf: dict):
    """The program's config of ``conf``: its ``port_config`` with the
    depth, norm epsilon, RoPE base, window, tying and router constants of
    the file; the widths must already be the file's."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MOE

    dm = arch.dims(conf)
    cfg = dataclasses.replace(
        get_config(conf["port_config"]), n_layers=dm["n_layers"],
        norm_eps=dm["norm_eps"], rope_theta=dm["rope_theta"],
        sliding_window=dm["sliding_window"], global_every=0,
        tie_embeddings=dm["tie_embeddings"],
        router_aux_weight=dm["router_aux_weight"],
        capacity_factor=dm["capacity_factor"])
    have = {"d_model": cfg.d_model, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim,
            "vocab_size": cfg.vocab_size, "n_experts": cfg.n_experts,
            "experts_per_token": cfg.experts_per_token,
            "qk_norm": cfg.qk_norm,
            "expert_d_ff": cfg.expert_d_ff if cfg.is_moe else 0}
    if not cfg.is_moe:
        have["d_ff"] = cfg.d_ff
    if cfg.is_moe:
        have["routing_group"] = MOE.GROUP_SIZE
    wrong = {k: (v, dm[k]) for k, v in have.items() if v != dm[k]}
    if wrong or cfg.block_type != "attn" or cfg.frontend != "none":
        raise ValueError(f"{conf['port_config']} is not the configuration "
                         f"of the file: {wrong}")
    return cfg


class Program:
    """The training step of a cell, built as the port's launcher builds it,
    on the benchmark's weights for ``seed``."""

    def __init__(self, cell: dict, seed: int, device):
        import torch
        from repro_torch import tree as T
        from repro_torch.models import transformer as TF
        from repro_torch.models.params import param_specs
        from repro_torch.optim import constant, momentum

        self.device, self.seed = device, seed
        self.dm = arch.dims(cell["config_file"])
        tr = self.traffic = cell["traffic_file"]
        cfg = port_arch(cell["config_file"])
        defs = TF.model_defs(cfg)
        specs = param_specs(defs, {"model": 1})
        flat_defs, treedef = T.flatten(defs)
        self.paths = T.paths(defs)
        self.shapes = [tuple(d.shape) for d in flat_defs]
        self.params = T.unflatten(treedef, weights.make(
            self.paths, self.shapes, seed, device, self.dm["d_model"]))
        opt = momentum(constant(tr["lr"]), tr["momentum"])
        self.opt_state = opt.init(T.leaves(self.params))
        if tr["sync"] == "async":
            from repro_torch.dist.async_engine import (AsyncConfig,
                                                       init_async_state,
                                                       make_async_train_step)
            acfg = AsyncConfig(
                tau_max=tr["tau_max"], schedule=tr["schedule"],
                compressor=tr["compressor"],
                error_feedback=tr["error_feedback"],
                topk_ratio=tr["topk_ratio"], horizon=tr["horizon"],
                seed=seed)
            self.state = init_async_state(acfg, tr["workers"], self.params,
                                          specs)
            self.step = make_async_train_step(cfg, opt, acfg, tr["workers"],
                                              specs)
        else:
            from repro_torch.core.scheduler import SyncConfig
            from repro_torch.dist.train import (init_dist_sync_state,
                                                make_elastic_train_step)
            scfg = SyncConfig(strategy=tr["sync"],
                              topk_ratio=tr["topk_ratio"], gate="norm")
            self.state = init_dist_sync_state(scfg, tr["workers"],
                                              self.params)
            self.step = make_elastic_train_step(cfg, opt, scfg,
                                                tr["workers"], specs)
        self.leaf_sizes = [math.prod(s) for s in self.shapes]
        self._torch = torch

    def __call__(self, batch: dict):
        """One step; returns the step's loss, a 0-d tensor on the device."""
        self.params, self.opt_state, self.state, metrics = self.step(
            self.params, self.opt_state, self.state, batch)
        return metrics["loss"]

    def mu_norms(self):
        """Each leaf's norm of the momentum (a device tensor): after the
        first step that applies a message, the first gradient as the
        optimizer got it."""
        torch = self._torch
        return torch.stack([torch.linalg.vector_norm(m)
                            for m in self.opt_state["mu"]])

    def change_norms(self):
        """Each leaf's norm of its change from the seed's weights, each
        leaf drawn again alone (a device tensor)."""
        from repro_torch import tree as T
        torch = self._torch
        out = []
        for i, p in enumerate(T.leaves(self.params)):
            p0 = weights.leaf(self.paths[i], self.shapes[i], i, self.seed,
                              self.device, self.dm["d_model"])
            out.append(torch.linalg.vector_norm(p.detach() - p0))
            del p0
        return torch.stack(out)

    def free(self):
        self.params = self.opt_state = self.state = self.step = None
        gc.collect()
        if self.device.type == "cuda":
            self._torch.cuda.empty_cache()


def to_device(batch: dict, device) -> dict:
    """A numpy batch as int64 tensors on ``device``, copied without a
    host wait (from page-locked memory) on a card."""
    import torch
    out = {}
    for k, v in batch.items():
        x = torch.from_numpy(v.astype("int64"))
        if device.type == "cuda":
            x = x.pin_memory().to(device, non_blocking=True)
        out[k] = x
    return out


class StepClock:
    """Marks at step ends: CUDA events on the stream on a card (read after
    the window), the host clock on the CPU."""

    def __init__(self, device):
        import torch
        self.torch, self.cuda = torch, device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def intervals_ms(self, marks) -> list:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]


def allocator_counts(device) -> dict:
    """The caching allocator's counts of device mallocs and frees and of
    retries after freeing its cache (each retry waits for the device)."""
    if device.type != "cuda":
        return {}
    import torch
    stats = torch.cuda.memory_stats(device)
    return {k: stats.get(k, 0) for k in ("num_alloc_retries",
                                         "num_device_alloc",
                                         "num_device_free")}


def sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

def _leaf_gaps(got, want, counted) -> dict:
    """Each counted leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median one."""
    med = statistics.median(want[i] for i in counted)
    out = {}
    for i in counted:
        den = max(want[i], med)
        if not (math.isfinite(got[i]) and math.isfinite(want[i])):
            out[i] = math.inf
        elif den == 0.0:
            out[i] = 0.0 if got[i] == 0.0 else math.inf
        else:
            out[i] = abs(got[i] - want[i]) / den
    return out


def compare(got: dict, want: dict) -> dict:
    """The numbers of the comparison: ``loss_gap`` (the worst step's
    relative gap of the loss), ``grad1_gap`` (of each leaf's norm of the
    first gradient the optimizer got: the momentum after the reference's
    first step that applied a message) and ``change_gap`` (of each leaf's
    norm of the parameters' change over the set-up steps); and the leaves
    left out."""
    med0 = statistics.median(want["grad0"])
    counted = [i for i, g in enumerate(want["grad0"])
               if g >= ZERO_GRAD_SHARE * med0]
    loss_gap = 0.0
    for a, b in zip(got["losses"], want["losses"]):
        if not (math.isfinite(a) and math.isfinite(b)):
            loss_gap = math.inf
            break
        loss_gap = max(loss_gap, abs(a - b) / abs(b))
    out = {"loss_gap": loss_gap,
           "left_out": [want["paths"][i] for i in range(len(want["paths"]))
                        if i not in counted]}
    first = want["first"]
    pairs = {"grad1": (got["mu_steps"][first], want["mu_steps"][first]),
             "change": (got["change"], want["change"])}
    for key, (a, b) in pairs.items():
        gaps = _leaf_gaps(a, b, counted)
        worst = max(gaps, key=gaps.get)
        out[f"{key}_gap"] = gaps[worst]
        out[f"{key}_worst"] = want["paths"][worst]
        out[f"{key}_leaf_gaps"] = [gaps.get(i) for i in
                                   range(len(want["paths"]))]
    return out


def reference_batches(stream: MarkovStream, steps: int, device) -> list:
    import torch
    return [{k: torch.from_numpy(v.astype("int64")).to(device)
             for k, v in stream.batch(t).items()} for t in range(steps)]


def reference_readings(cell: dict, seed: int, stream, device, **fault):
    from perfbench.reference import train as RT
    tr = cell["traffic_file"]
    return RT.readings(arch.dims(cell["config_file"]), tr, seed,
                       reference_batches(stream, checked_steps(tr), device),
                       device, **fault)


# ---------------------------------------------------------------------------
# set-up: the checked first steps
# ---------------------------------------------------------------------------

def setup_steps(prog: Program, stream: MarkovStream, steps: int) -> dict:
    """Drive the program through its first ``steps`` steps (the warm-up
    of every shape the window uses) and keep what the comparison reads:
    each step's loss, the momentum's norms after each step and the
    parameters' change after the last.  Tensors stay on the device."""
    losses, mu = [], []
    for t in range(steps):
        losses.append(prog(to_device(stream.batch(t), prog.device)))
        mu.append(prog.mu_norms())
    return {"losses": losses, "mu_steps": mu,
            "change": prog.change_norms()}


def host_readings(dev: dict, paths) -> dict:
    import torch
    return {"losses": [float(x) for x in torch.stack(dev["losses"]).cpu()],
            "mu_steps": [[float(x) for x in m.cpu()]
                         for m in dev["mu_steps"]],
            "change": [float(x) for x in dev["change"].cpu()],
            "paths": list(paths)}


# ---------------------------------------------------------------------------
# the traced span
# ---------------------------------------------------------------------------

def trace_span(prog: Program, stream: MarkovStream, first: int, steps: int,
               host: bool):
    """Profile ``steps`` steps after one warm-up step of the profiler: the
    device's activity alone, or with ``host`` the host's operations and
    the program's ranges too, whose recording stretches the host's part
    of a step.  Returns the span's events and its host seconds."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.profiler import schedule as sched

    acts = [ProfilerActivity.CUDA] if prog.device.type == "cuda" else []
    if host or not acts:
        acts.append(ProfilerActivity.CPU)
    t0 = span = None
    with profile(activities=acts,
                 schedule=sched(wait=0, warmup=1, active=steps,
                                repeat=1)) as prof:
        for j in range(steps + 1):
            if j == 1:
                t0 = time.perf_counter()
            with record_function("bench.batch"):
                batch = to_device(stream.batch(first + j), prog.device)
            with record_function("bench.step"):
                prog(batch)
            if j in (0, steps):
                sync(prog.device)
            if j == steps:
                span = time.perf_counter() - t0
            prof.step()
    return prof.events(), span


def _dev_time_us(e) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


class TraceContext:
    """What a per-layer metric reads: the device's activity in a span
    traced without the host's operations (``device_ops``, ``kernels``,
    ``busy_s``, ``span_s``), the device time under each of the program's
    ranges (``record_function``) in a second span traced with them, the
    window's step records and the cell's counts."""

    def __init__(self, device_events, span_s: float, host_events,
                 steps: int, cell: dict, window: dict, leaf_sizes: list):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        self.cell, self.window, self.steps = cell, window, steps
        self.span_s, self.leaf_sizes = span_s, leaf_sizes
        self.traffic = cell["traffic_file"]
        self.dims = arch.dims(cell["config_file"])
        self.peaks, self.flops, self.kernel_bytes = peaks, FL, KB
        cpu, ranges = [], {}
        for e in host_events:
            if e.device_type != cuda:
                cpu.append((e.name, float(e.time_range.start),
                            float(e.time_range.end)))
                if getattr(e, "is_user_annotation", False):
                    ranges[e.name] = ranges.get(e.name, 0.0) \
                        + _dev_time_us(e) * 1e-6

        def ops(events):
            # a range shows on the device too, as an annotation, not an op
            return [(e.name, float(e.time_range.start),
                     float(e.time_range.end - e.time_range.start))
                    for e in events if e.device_type == cuda
                    and not getattr(e, "is_user_annotation", False)
                    and e.name not in ranges
                    and not e.name.startswith(("ProfilerStep", "bench."))]
        self.device_ops = ops(device_events)    # (name, start us, dur us)
        self.kernels = [d for d in self.device_ops
                        if not d[0].startswith(("Memcpy", "Memset"))]
        self.ranges = ranges                    # name -> device seconds
        self._host_span = (ops(host_events), cpu)

    @staticmethod
    def busy_intervals(device_ops) -> list:
        """The union of device activity, as sorted (start, end) us."""
        out = []
        for _, s, d in sorted(device_ops, key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], s + d)
            else:
                out.append([s, s + d])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in
                   self.busy_intervals(self.device_ops)) * 1e-6

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the span traced with the host's operations, by the
        innermost host operation around each."""
        per = {}
        for name, _, d in self.device_ops:
            per[name] = per.get(name, 0.0) + d * 1e-6
        ops = sorted(per.items(), key=lambda x: -x[1])[:10]
        dev, cpu = self._host_span
        busy = self.busy_intervals(dev)
        gaps = sorted(((b[0] - a[1], a[1], b[0])
                       for a, b in zip(busy, busy[1:])), reverse=True)[:10]
        idle = []
        for length, s, e in gaps:
            mid = (s + e) / 2
            around = [c for c in cpu if c[1] <= mid <= c[2]
                      and not c[0].startswith("ProfilerStep")]
            name = min(around, key=lambda c: c[2] - c[1])[0] \
                if around else "host"
            idle.append([name[:120], length * 1e-6])
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": idle}


def load_metric(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, metric_names=None) -> dict:
    """Run ``cell`` once: set-up, the window of ``seconds``, the traced
    span (``trace``), the comparison.  Returns the result line's object,
    with ``metrics`` the end-to-end metrics (``trace`` off) or the named
    per-layer ones (``trace`` on)."""
    import torch

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.cuda.reset_peak_memory_stats(device)
    dm, tr = arch.dims(cell["config_file"]), cell["traffic_file"]
    stream = MarkovStream(dm["vocab_size"], tr["seq"], tr["batch"], seed,
                          tr["order_states"])
    phases = {"imports": time.perf_counter() - t_start}
    prog = Program(cell, seed, device)
    sync(device)
    phases["program"] = time.perf_counter() - t_start
    n_checked = checked_steps(tr)
    first = setup_steps(prog, stream, n_checked)

    # the measured window: no host wait a step; the events and the losses
    # are read once it has closed
    clock = StepClock(device)
    sync(device)
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    phases["setup_steps"] = setup_s
    alloc0 = allocator_counts(device)
    marks, losses, host = [clock.mark()], [], [time.perf_counter()]
    t = n_checked
    while True:
        batch = to_device(stream.batch(t), device)
        host.append(time.perf_counter())
        losses.append(prog(batch))
        marks.append(clock.mark())
        host.append(time.perf_counter())
        t += 1
        if time.perf_counter() - t_window >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t_window
    alloc = {k: v - alloc0.get(k, 0)
             for k, v in allocator_counts(device).items()}
    steps = len(losses)
    step_ms = clock.intervals_ms(marks)
    # the host's milliseconds a step: drawing the batch, and the program's
    # call until it returns
    host_ms = {"batch": [(b - a) * 1e3 for a, b in zip(host[0::2],
                                                        host[1::2])],
               "call": [(b - a) * 1e3 for a, b in zip(host[1::2],
                                                       host[2::2])]}
    window = {"steps": steps, "window_s": window_s, "step_ms": step_ms,
              "tokens_per_step": tr["batch"] * tr["seq"],
              "flops_per_step": FL.step_flops(dm, tr["batch"], tr["seq"])}
    traced = None
    if trace:
        n = cell["trace_steps"]
        dev_events, span = trace_span(prog, stream, t, n, host=False)
        host_events, _ = trace_span(prog, stream, t + n + 1, n, host=True)
        traced = TraceContext(dev_events, span, host_events, n, cell,
                              window, prog.leaf_sizes)
        del dev_events, host_events
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    window_losses = [float(x) for x in torch.stack(losses).cpu()]
    got = host_readings(first, prog.paths)
    bad_modules = forbidden_modules()
    prog.free()
    del first, losses

    want = reference_readings(cell, seed, stream, device)
    gaps = compare(got, want)
    limits = cell["limits"]
    failed = sum(not math.isfinite(x) for x in window_losses)
    correct = failed == 0 and all(gaps[k] <= v for k, v in limits.items())

    if trace:
        metrics = {}
        for name in metric_names or []:
            mod = load_metric(name)
            value = mod.read(traced)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
    else:
        p90 = (statistics.quantiles(step_ms, n=10, method="inclusive")[8]
               if len(step_ms) > 1 else step_ms[0])
        metrics = {
            "tokens_per_s": {"value": steps * window["tokens_per_step"]
                             / window_s, "unit": "tokens/s"},
            "step_ms_p90": {"value": p90, "unit": "ms"},
            "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        if metric_names is not None:
            metrics = {k: v for k, v in metrics.items() if k in metric_names}
    result = {
        "correct": bool(correct),
        "attempted": steps,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if trace:
        result["device"]["busy_s"] = traced.busy_s()
        result["device"]["window_s"] = traced.span_s
        result["breakdown"] = traced.breakdown()
    result["checks"] = {k: {"value": gaps[k], "limit": v}
                        for k, v in limits.items()}
    result["_extra"] = {"phases_s": phases,
                        "allocator_in_window": alloc,
                        "host_ms": host_ms,
                        "step_ms": step_ms,
                        "left_out": gaps["left_out"],
                        "worst": [gaps["grad1_worst"], gaps["change_worst"]],
                        "not_compared": {k: gaps[k] for k in CHECKS
                                         if k not in limits},
                        "bad_modules": bad_modules,
                        "program": got, "reference": {
                            k: want[k] for k in ("losses", "mu_steps",
                                                 "first", "change",
                                                 "grad0")}}
    return result
