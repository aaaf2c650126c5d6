"""Registry of every public per-step program of the port, at audit (smoke)
scale (counterpart of ``repro.analysis.entrypoints``).

One place that knows how to *build* each hot-path step the port ships —
the exact train step, the synchronous sync step per strategy, the
bounded-staleness async step per (tau_max, compressor), the simulator's
run per kind, the cluster event loop, and the serving prefill/decode steps
(dense and paged) — with the reference's entry names, groups, strategy
tags and variant twins.  `repro_torch.analysis.audit` runs each one step
(collective inventory, host-sync detection, op-sequence hashing) and runs
the ones with an in-place contract again to check it.

``build()`` returns ``(step, args)``: the port's own step and real tensors
on the registry's device (the card unless the caller asks for the CPU).
``donate`` is the **in-place contract**, the counterpart of the
reference's ``donate_argnums``: the indices of the arguments whose leaves
the step updates in place.  Builders are lazy and deterministic, so two
builds of one entry must run the same op sequence; ``variant`` builds a
twin whose configuration must not change the program (an async schedule
seed, a cluster shape, a simulator knob value).

Scale: the reference's — ``qwen3-1.7b-smoke`` (2 layers, d 128), batch 4
x 32, one worker by default (``data_parallel`` sizes a one-process
`WorkerGroup`, the counterpart of the reference's forced host devices);
the simulator at P 4, T 8, dim 8; serving at B 2, S 16, paged pages of 4
x 8; the cluster at T 16, p 4, tau 3.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

SMOKE_ARCH = "qwen3-1.7b"
BATCH, SEQ = 4, 32


@dataclass(frozen=True)
class EntryPoint:
    """One auditable per-step program.

    ``build()`` returns ``(fn, args)`` — the step and a tuple of example
    arguments.  ``donate`` is the in-place contract (argument indices the
    step updates in place); entries with one are run again by the
    in-place check.  ``strategy`` tags entries that take part in the
    per-strategy bytes-on-wire comparison.
    """

    name: str
    group: str                       # train | elastic | async | sim | serve | cluster
    build: callable
    donate: tuple = ()
    strategy: str | None = None
    compile_entry: bool = False
    variant: callable | None = None  # must run the SAME op sequence
    notes: str = ""


def _smoke_cfg():
    from repro_torch.configs import get_config
    return get_config(SMOKE_ARCH + "-smoke")


def _params(cfg, device):
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params
    gen = torch.Generator(device=device).manual_seed(0)
    return init_params(TF.model_defs(cfg), gen, device)


def _train_fixture(device):
    from repro_torch import tree as T
    from repro_torch.data.pipeline import SyntheticLMDataset, to_device
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import param_specs
    from repro_torch.optim import momentum
    cfg = _smoke_cfg()
    specs = param_specs(TF.model_defs(cfg))
    params = _params(cfg, device)
    opt = momentum(1e-2, 0.9)
    opt_state = opt.init(T.leaves(params))
    batch = to_device(SyntheticLMDataset(cfg.vocab_size, SEQ, BATCH,
                                         seed=0).batch(0), device)
    return cfg, specs, params, opt, opt_state, batch


def _build_train_exact(device):
    from repro_torch.dist.train import make_train_step
    cfg, _, params, opt, opt_state, batch = _train_fixture(device)
    return make_train_step(cfg, opt), (params, opt_state, batch)


def _build_elastic(strategy: str, data_parallel: int, device, *,
                   track_gap: bool = False):
    from repro_torch.core.scheduler import SyncConfig
    from repro_torch.dist.train import (init_dist_sync_state,
                                        make_elastic_train_step)
    from repro_torch.dist.workers import WorkerGroup
    cfg, specs, params, opt, opt_state, batch = _train_fixture(device)
    group = WorkerGroup(data_parallel)
    scfg = SyncConfig(strategy=strategy,
                      gate="static" if strategy == "elastic" else "norm",
                      track_gap=track_gap)
    state = init_dist_sync_state(scfg, group, params)
    step = make_elastic_train_step(cfg, opt, scfg, group, specs)
    return step, (params, opt_state, state, batch)


def _build_async(tau_max: int, compressor: str, data_parallel: int, device,
                 seed: int = 0, overlap: bool = True):
    from repro_torch.dist.async_engine import (AsyncConfig, init_async_state,
                                               make_async_train_step)
    from repro_torch.dist.workers import WorkerGroup
    cfg, specs, params, opt, opt_state, batch = _train_fixture(device)
    group = WorkerGroup(data_parallel)
    acfg = AsyncConfig(tau_max=tau_max, schedule="uniform",
                       compressor=compressor,
                       error_feedback=compressor != "none",
                       topk_ratio=1 / 8, horizon=64, seed=seed,
                       track_gap=False, overlap=overlap)
    state = init_async_state(acfg, group, params,
                             specs if acfg.fused else None)
    step = make_async_train_step(cfg, opt, acfg, group, specs)
    return step, (params, opt_state, state, batch)


SIM_KINDS = ("sync", "crash", "crash_subst", "omission", "async", "ef_comp",
             "elastic_norm", "elastic_variance", "adversarial")
_SIM_P, _SIM_T, _SIM_DIM = 4, 8, 8


def _sim_relax(kind: str, *, beta: float = 0.8):
    from repro_torch.core import compression as C
    from repro_torch.core.sim_types import Relaxation
    comp = C.topk_compressor(0.25) if kind == "ef_comp" else None
    return Relaxation(kind=kind, f=1 if kind.startswith("crash")
                      or kind == "omission" else 0,
                      tau_max=2, compressor=comp, beta=beta,
                      B_adv=0.5 if kind == "adversarial" else 0.0)


def _build_sim(kind: str, device, *, beta: float = 0.8):
    """The simulator's run of ``kind`` over its T steps (one case): ``run(x0,
    cases)`` with the schedule, the knobs and the gradient draws as the
    stacked case tensors."""
    from repro_torch.core.problems import Quadratic
    from repro_torch.core.sim_engine import (_resolve_fused, _run_cases,
                                             _stack_cases)
    from repro_torch.core.sim_ref import default_draws
    from repro_torch.core.sim_types import make_schedule
    problem = Quadratic(dim=_SIM_DIM, seed=0, device=device)
    relax = _sim_relax(kind, beta=beta)
    sched = make_schedule(relax, _SIM_P, _SIM_DIM, _SIM_T, seed=0)
    draws = default_draws(problem, 0, _SIM_T, _SIM_P)
    cases = _stack_cases([relax], [sched], [0.05], [draws], device)
    fused = _resolve_fused(problem, relax, "auto")

    def run(x0, cases):
        return _run_cases([problem], relax, _SIM_P, _SIM_T, x0, cases,
                          fused)

    return run, (torch.zeros(_SIM_DIM, device=device), cases)


_SERVE_B, _SERVE_S = 2, 16


def _build_prefill_dense(device):
    from repro_torch.dist.train import make_prefill_step
    cfg = _smoke_cfg()
    step = make_prefill_step(cfg, _SERVE_S)
    batch = {"tokens": torch.zeros((_SERVE_B, _SERVE_S), dtype=torch.long,
                                   device=device)}
    return step, (_params(cfg, device), batch)


def _build_decode_dense(device):
    from repro_torch.dist.train import make_decode_step
    from repro_torch.models import transformer as TF
    cfg = _smoke_cfg()
    cache = TF.init_cache(cfg, _SERVE_B, _SERVE_S, device)
    tokens = torch.zeros((_SERVE_B, 1), dtype=torch.long, device=device)
    return make_decode_step(cfg), (_params(cfg, device), cache, tokens)


def _paged_fixture(device):
    from repro_torch.serve.paged_cache import PagedCacheConfig, init_page_pool
    cfg = _smoke_cfg()
    pcfg = PagedCacheConfig(page_size=4, num_pages=8, max_requests=2,
                            max_pages_per_seq=4)
    pools = init_page_pool(cfg.n_layers, cfg.n_kv_heads or cfg.n_heads,
                           cfg.d_model // cfg.n_heads, pcfg, device)
    return cfg, _params(cfg, device), pcfg, pools


def _build_decode_paged(device):
    from repro_torch.serve.engine import make_paged_decode_step
    cfg, params, pcfg, (kp, vp) = _paged_fixture(device)
    r = pcfg.max_requests
    step = make_paged_decode_step(cfg, pcfg)
    table = torch.arange(r * pcfg.max_pages_per_seq, dtype=torch.int32,
                         device=device).reshape(r, -1) % pcfg.num_pages
    args = (params, kp, vp,
            torch.zeros((r,), dtype=torch.int32, device=device),
            torch.tensor([3, 6], dtype=torch.int32, device=device),
            table, torch.ones((r,), dtype=torch.bool, device=device))
    return step, args


def _build_prefill_paged(device):
    from repro_torch.serve.engine import make_paged_prefill_step
    cfg, params, pcfg, (kp, vp) = _paged_fixture(device)
    bucket_pages = 2
    step = make_paged_prefill_step(cfg, pcfg, bucket_pages)
    args = (params, kp, vp,
            torch.zeros((1, bucket_pages * pcfg.page_size), dtype=torch.long,
                        device=device),
            5, torch.arange(bucket_pages, dtype=torch.long, device=device))
    return step, args


_CLUSTER_T, _CLUSTER_P, _CLUSTER_TAU = 16, 4, 3


def _build_cluster(preset_name: str, device):
    from repro_torch.cluster import preset
    from repro_torch.cluster.perf import durations_table, event_loop
    spec = preset(preset_name, p=_CLUSTER_P, steps=_CLUSTER_T)
    d, alive = durations_table(spec, _CLUSTER_T, 4e8, 4.7e6)

    def loop(d, alive, apply_s):
        return event_loop(d, alive, apply_s, _CLUSTER_TAU)

    return loop, (torch.as_tensor(d).to(device),
                  torch.as_tensor(alive).to(device),
                  torch.tensor(spec.apply_s, dtype=torch.float32,
                               device=device))


def make_registry(data_parallel: int = 1, device="cuda") -> list:
    """Every public per-step program at audit scale, on ``device``.

    ``data_parallel`` is the number of in-process workers of the sync and
    async steps (the CLI's ``--devices``); at 1 the *set* of collectives
    and the between-strategy byte ordering are those at any p."""
    p = data_parallel
    reg = [
        EntryPoint(
            "train/exact", "train", lambda: _build_train_exact(device),
            donate=(0, 1), compile_entry=True,
            notes="the whole-batch exact step of one process: no "
                  "collective (the reference's GSPMD all-reduce has no "
                  "counterpart here; elastic/sync is the dense-wire "
                  "baseline)"),
        EntryPoint(
            "elastic/sync", "elastic",
            lambda: _build_elastic("exact", p, device),
            donate=(0, 1, 2), strategy="sync", compile_entry=True,
            notes="the worker group's psum of every gradient — the "
                  "dense-wire baseline every compressed strategy must "
                  "beat"),
        EntryPoint(
            "elastic/topk_ef", "elastic",
            lambda: _build_elastic("topk_ef", p, device),
            donate=(0, 1, 2), strategy="topk_ef", compile_entry=True,
            variant=lambda: _build_elastic("topk_ef", p, device)),
        EntryPoint(
            "elastic/onebit_ef", "elastic",
            lambda: _build_elastic("onebit_ef", p, device),
            donate=(0, 1, 2), strategy="onebit_ef", compile_entry=True),
        EntryPoint(
            "elastic/elastic", "elastic",
            lambda: _build_elastic("elastic", p, device),
            donate=(0, 1, 2), strategy="elastic", compile_entry=True,
            notes="static gate, phase 0"),
        EntryPoint(
            "elastic/topk_ef+gap", "elastic",
            lambda: _build_elastic("topk_ef", p, device, track_gap=True),
            strategy="topk_ef+gap",
            notes="track_gap=True costs a full-width psum of the EF "
                  "residual for the gap2 metric — kept OUT of the "
                  "hot-path wire comparison on purpose"),
        EntryPoint(
            "async/tau0", "async",
            lambda: _build_async(0, "none", p, device),
            donate=(0, 1, 2), strategy="async_tau0", compile_entry=True,
            variant=lambda: _build_async(0, "none", p, device, seed=7),
            notes="capacity-1 ring == synchronous; the seed variant must "
                  "run the same ops (the tau table is state, not "
                  "program)"),
        EntryPoint(
            "async/tau4", "async",
            lambda: _build_async(4, "none", p, device),
            donate=(0, 1, 2), strategy="async_tau4", compile_entry=True,
            variant=lambda: _build_async(4, "none", p, device, seed=7)),
        EntryPoint(
            "async/tau4_topk_ef", "async",
            lambda: _build_async(4, "topk", p, device),
            donate=(0, 1, 2), strategy="async_tau4_topk_ef",
            compile_entry=True,
            variant=lambda: _build_async(4, "topk", p, device, seed=7),
            notes="fused overlap path: the wire is one compact (vals, "
                  "idx) gather per leaf a step; delivery is the deposit "
                  "kernel into the accumulator ring — no dense psum"),
        EntryPoint(
            "async/tau4_topk_ef_densified", "async",
            lambda: _build_async(4, "topk", p, device, overlap=False),
            donate=(0, 1, 2), strategy="async_tau4_topk_ef_densified",
            compile_entry=True,
            notes="overlap=False: compressed deposits densify into the "
                  "per-worker rings and the mean is dense — the same "
                  "trajectory as the fused path, a sync-sized wire"),
        EntryPoint(
            "async/tau4_onebit_ef", "async",
            lambda: _build_async(4, "onebit", p, device),
            donate=(0, 1, 2), strategy="async_tau4_onebit_ef",
            compile_entry=True,
            variant=lambda: _build_async(4, "onebit", p, device, seed=7),
            notes="fused overlap path, sign/mean wire form (bool bitmap "
                  "+ 2 means per row)"),
        EntryPoint(
            "cluster/event_scan", "cluster",
            lambda: _build_cluster("uniform", device),
            variant=lambda: _build_cluster("straggler_heavy", device),
            notes="the discrete-event cluster loop (cluster/perf."
                  "event_loop): the trace tables are data, not program — "
                  "a different cluster shape must run the same ops; "
                  "collective-free"),
        EntryPoint(
            "serve/prefill_dense", "serve",
            lambda: _build_prefill_dense(device), compile_entry=True),
        EntryPoint(
            "serve/decode_dense", "serve",
            lambda: _build_decode_dense(device), donate=(1,),
            compile_entry=True),
        EntryPoint(
            "serve/prefill_paged", "serve",
            lambda: _build_prefill_paged(device), donate=(1, 2),
            compile_entry=True),
        EntryPoint(
            "serve/decode_paged", "serve",
            lambda: _build_decode_paged(device), donate=(1, 2),
            compile_entry=True),
    ]
    for kind in SIM_KINDS:
        reg.append(EntryPoint(
            f"sim/{kind}", "sim",
            lambda kind=kind: _build_sim(kind, device),
            variant=(lambda kind=kind: _build_sim(kind, device, beta=0.5))
            if kind == "elastic_norm" else None,
            notes="the whole run's loop; knobs are case tensors, so knob "
                  "changes must not change the ops"))
    return reg


def by_name(registry: list) -> dict:
    return {e.name: e for e in registry}
