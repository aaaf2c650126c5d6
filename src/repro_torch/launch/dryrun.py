"""Multi-pod dry run of the port (counterpart of ``repro.launch.dryrun``):
trace rank 0's step of every (architecture x input shape x layout) on the
``meta`` device, at the published width and full depth, and extract what
the reference reads off XLA: memory per device, FLOPs, bytes accessed and
collective bytes, with roofline terms for an H100.

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
        --out experiments/dryrun_torch

Rank 0 of the production layout (`repro_torch.launch.mesh.
make_production_mesh`: data 16 x model 16, or pod 2 x data 16 x model 16)
holds its shard of every leaf (the reference's ``param_specs``; with
``use_fsdp`` and ``--sync exact`` also over ``data``) and its share of the
batch (the batch dim over the data axes when they divide it, else whole).
Its step runs under a *recording* model group and worker group: every
collective returns a ``meta`` tensor of the right shape and counts its
bytes, by axis and kind, with the audit's byte model (a sum twice its
payload, a gather its output, a reduce-scatter its input).  Nothing is
allocated and nothing crosses a wire.  Torch counts every layer of the
Python loop, so there is no depth or sequence extrapolation (the
reference's ``reduced_depths`` / ``scan_aware_costs``) and no HLO parser
(``collective_bytes``).

What a record holds (the reference's keys):

* ``cost_analysis_raw`` / ``costs``: FLOPs from
  ``torch.utils.flop_counter.FlopCounterMode`` (the products, forward and
  backward); **bytes accessed**: every op's tensor inputs read once and its
  outputs written once (view and metadata ops move nothing), the
  counterpart of ``cost_analysis``' ``bytes accessed``; collective bytes
  by kind, and by axis in ``collectives_by_axis``.
* ``memory``: ``argument_bytes`` (the rank's shard of params, optimizer
  state and sync state, or a serving step's params and cache), ``temp_bytes``
  (the bytes saved for backward, ``torch.autograd.graph.
  saved_tensors_hooks``, each storage once and none of the arguments'),
  ``output_bytes`` and ``alias_bytes`` (outputs on an argument's storage:
  updated in place), ``peak_per_device_gb`` = arguments + outputs +
  saved - aliased, in GiB, and ``fits`` against the card's 80 GiB.
* ``roofline``: computed, not measured, per rank, from the H100 SXM5 80GB
  (700 W) datasheet: FLOPs over 989.4 TFLOP/s (bf16 dense), bytes over
  3.35 TB/s, and each axis's collective bytes over the link it crosses:
  NVLink at 450 GB/s each way when the axis's cards fit in one 8-card
  node, else InfiniBand NDR at 50 GB/s a card.  The reference's model
  axis of 16 spans two such nodes, so it takes InfiniBand.

The steps are the port's: ``--sync exact`` is the data-parallel exact
step (`dist/train.make_elastic_train_step` with the ``exact`` strategy:
the gradient mean over the data ranks), or with FSDP its sharded form
(each leaf gathered over ``data``, the gradient reduce-scattered, the
optimizer on the shard); the other strategies the same step with theirs;
``prefill`` and ``decode`` the dense-cache serving steps
(`dist/train.make_prefill_step`, `make_decode_step`) over bf16 matrices,
as the port serves.  Where a step reads a value on the host, which a meta
tensor cannot give, the dry run builds it without that read: no skip
guard (``make_train_step``'s default).  ``--sp`` shards the residual on S
over ``model`` (`repro_torch.models.actx` sequence parallelism).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as T
from repro_torch.configs import INPUT_SHAPES, REGISTRY, get_config
from repro_torch.core.scheduler import SyncConfig
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.dist import sharding as SH
from repro_torch.dist.async_engine import (AsyncConfig, init_async_state,
                                           make_async_train_step)
from repro_torch.dist.train import (init_dist_sync_state, make_decode_step,
                                    make_elastic_train_step,
                                    make_prefill_step, mean_grads)
from repro_torch.dist.workers import WorkerGroup
from repro_torch.launch.mesh import (ProductionMesh, RankLayout,
                                     make_production_mesh)
from repro_torch.models import actx
from repro_torch.models import transformer as TF
from repro_torch.models.params import (ParamDef, _is_matrix, param_specs,
                                       shard_shape)
from repro_torch.optim import apply_updates, momentum, sgd

# the H100 SXM5 80GB (700 W) datasheet
H100_BF16_FLOPS = 989.4e12          # dense bf16 tensor-core FLOP/s
H100_HBM_BYTES_S = 3.35e12          # HBM3
H100_MEMORY_BYTES = 80 * 2 ** 30
NVLINK_BYTES_S = 450e9              # each way, within an 8-card node
IB_BYTES_S = 50e9                   # InfiniBand NDR, a card, across nodes
NODE_CARDS = 8

SEQUENCE_PARALLEL = False  # baseline off; flipped by --sp
GRAD_ACCUM = 1             # microbatching lever (--accum)
WIRE_DTYPE = "f32"         # the exact / elastic mean's wire (--wire-dtype)


# ---------------------------------------------------------------------------
# inputs, optimizer, FSDP (the reference's choices)
# ---------------------------------------------------------------------------

def input_specs(cfg, shape, device="meta") -> dict:
    """Meta stand-ins for one workload: the batch dict, and a decode's
    cache (`models/transformer.init_cache` at the shape's length)."""
    batch = make_batch_specs(cfg, shape, device)
    if shape.kind != "decode":
        return {"batch": batch}
    cache = TF.init_cache(cfg, shape.global_batch, shape.seq_len, device)
    return {"batch": batch, "cache": cache}


def pick_optimizer(cfg):
    """SGD + momentum 0.9; grok-1's 314 B of f32 master and momentum state
    does not fit 256 cards, so it takes stateless SGD."""
    if cfg.name.startswith("grok"):
        return sgd(1e-2), "sgd"
    return momentum(1e-2, 0.9), "momentum"


def use_fsdp(cfg) -> bool:
    """Shard params over the data axis too when replicated f32 params and
    momentum would exceed ~6 GB a device on the single-pod layout."""
    per_dev = cfg.param_count() * 4 * 2 / 16
    return per_dev > 6e9


def should_skip(cfg, shape):
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("long_500k requires sub-quadratic attention; "
                f"{cfg.name} is full-attention (see DESIGN.md)")
    return None


def act_rules_for(cfg, mesh, shape) -> dict:
    return SH.make_act_rules(
        cfg, mesh, batch_size=shape.global_batch,
        seq_len=shape.seq_len if shape.kind != "decode" else 1,
        sequence_parallel=SEQUENCE_PARALLEL and shape.kind != "decode")


# ---------------------------------------------------------------------------
# the recording groups
# ---------------------------------------------------------------------------

class Recorder:
    """Collective bytes and counts by axis and kind."""

    def __init__(self):
        self.by_axis: dict = {}

    def count(self, axis: str, kind: str, n_bytes: int) -> None:
        slot = self.by_axis.setdefault(axis, {}).setdefault(
            kind, {"count": 0, "bytes": 0})
        slot["count"] += 1
        slot["bytes"] += int(n_bytes)

    def by_kind(self) -> dict:
        out: dict = {}
        for kinds in self.by_axis.values():
            for kind, v in kinds.items():
                out[kind] = out.get(kind, 0) + v["bytes"]
        return out

    def axis_bytes(self) -> dict:
        return {axis: sum(v["bytes"] for v in kinds.values())
                for axis, kinds in self.by_axis.items()}


class RecordingModelGroup:
    """`repro_torch.models.actx.ModelGroup`'s interface over ``size``
    model ranks, this one ``rank``: each collective counts its bytes and
    returns an empty tensor of its result's shape on the input's device."""

    backend = "record"

    def __init__(self, size: int, rank: int, recorder: Recorder):
        self.size, self.rank, self.rec = size, rank, recorder

    def _counted(self, kind: str, n_bytes: int) -> None:
        self.rec.count("model", kind, n_bytes)

    def gather(self, x):
        self._counted("model_all_gather", x.nbytes * self.size)
        return x.new_empty((self.size, *x.shape))

    def gather_dim(self, x, dim: int, device=None, counted: bool = True):
        if counted:
            self._counted("model_all_gather", x.nbytes * self.size)
        shape = list(x.shape)
        shape[dim] *= self.size
        return x.new_empty(shape)

    def sum(self, x):
        self._counted("model_psum", 2 * x.nbytes)
        return torch.empty_like(x)

    def reduce_scatter(self, x, dim: int):
        self._counted("model_reduce_scatter", x.nbytes)
        shape = list(x.shape)
        shape[dim] //= self.size
        return x.new_empty(shape)

    def group_all(self, flag, device=None):
        raise ValueError("the dry run cannot read a flag on the host")

    world_all = group_all


class RecordingWorkerGroup(WorkerGroup):
    """A `WorkerGroup` of ``n_workers`` over ``layout`` whose gathers over
    the data ranks return empty tensors and whose counted collectives also
    go to ``recorder`` under ``axis``."""

    def __init__(self, n_workers: int, layout: RankLayout,
                 recorder: Recorder, axis: str):
        super().__init__(n_workers, layout)
        self.rec, self.axis = recorder, axis

    def _count(self, kind: str, n_bytes: int) -> None:
        super()._count(kind, n_bytes)
        self.rec.count(self.axis, kind, n_bytes)

    def gather_rows(self, local, device=None):
        return local.new_empty((self.layout.data_world * local.shape[0],
                                *local.shape[1:]))


# ---------------------------------------------------------------------------
# the measurements: bytes accessed, saved tensors, storages
# ---------------------------------------------------------------------------

class BytesAccessed(TorchDispatchMode):
    """Every op's tensor inputs read once and its outputs written once;
    view and metadata ops (``OpOverload.is_view``, ``detach``) move
    nothing."""

    _FREE = ("detach", "alias", "lift_fresh")

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.__name__.split(".")[0] not in self._FREE:
            for a in T.tensors((args, kwargs or {}, out)):
                self.total += a.nbytes
        return out


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def storage_bytes(tree) -> tuple[int, set]:
    """(bytes of the distinct storages of ``tree``'s tensors, their
    keys)."""
    seen, total = set(), 0
    for t in T.tensors(tree):
        key = _storage_key(t)
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total, seen


class SavedBytes:
    """The distinct storages autograd saves for backward over the step,
    less those in ``exclude`` (the arguments').  Each counted storage is
    kept until the trace ends, so that a storage freed by one worker's
    backward cannot lend its address to another's and go uncounted."""

    def __init__(self, exclude: set):
        self.exclude, self.seen, self.total = exclude, set(), 0
        self._kept = []

    def pack(self, t):
        key = _storage_key(t)
        if key not in self.exclude and key not in self.seen:
            self.seen.add(key)
            self._kept.append(t.untyped_storage())
            self.total += t.untyped_storage().nbytes()
        return t

    @staticmethod
    def unpack(t):
        return t


# ---------------------------------------------------------------------------
# the steps of rank 0
# ---------------------------------------------------------------------------

def _rank_leaves(defs, specs, sizes: dict, device, dtype_of=None):
    """Rank 0's shard of every leaf: an empty tensor of its shard shape."""
    return T.tree_map(
        lambda d, sp: torch.empty(
            shard_shape(d.shape, sp, sizes), device=device,
            dtype=torch.float32 if dtype_of is None else dtype_of(d)),
        defs, specs)


def _serving_dtype(d: ParamDef):
    """The port's serving layout: matrices bf16, vectors f32."""
    return torch.bfloat16 if _is_matrix(d) else torch.float32


def _local_batch(cfg, shape, mesh: ProductionMesh, device) -> dict:
    """Rank 0's share of the workload's batch: the batch dim over the data
    axes when they divide it, else whole."""
    dsize = SH.data_size(mesh)
    b = shape.global_batch
    rows = b // dsize if b % dsize == 0 else b
    return {k: v.new_empty((rows, *v.shape[1:]))
            for k, v in make_batch_specs(cfg, shape, device).items()}


def _fsdp_exact_step(cfg, opt, mshapes, group):
    """The exact step's FSDP form on rank 0: each param leaf gathered over
    ``data`` (counted ``all_gather``, its output) into its model shard
    (``mshapes``), the rank's gradient, the gradient reduce-scattered over
    ``data`` (counted ``reduce_scatter``, its input: a mean over the data
    ranks), and the optimizer on the rank's shards of params and
    state."""
    def gather(a, shape):
        whole = a.new_empty(shape)
        group._count("all_gather", whole.nbytes)
        return whole

    def step(params, opt_state, batch):
        batch = group.shard_batch(batch)[0]
        full = T.tree_map(gather, params, mshapes)
        loss, parts, grads = mean_grads(cfg, full, batch, GRAD_ACCUM)
        flat_g = []
        for g, p in zip(T.leaves(grads), T.leaves(params)):
            group._count("reduce_scatter", g.nbytes)
            flat_g.append(g.new_empty(p.shape))
        del grads, full
        with torch.no_grad():
            updates, opt_state = opt.update(flat_g, opt_state,
                                            T.leaves(params))
            apply_updates(T.leaves(params), updates)
        return params, opt_state, {"loss": loss, **parts}

    return step


def build_train(cfg, mesh: ProductionMesh, batch: dict, sync: str = "exact",
                *, static_phase: int = 0, workers: int = 1,
                async_cfg: AsyncConfig | None = None, device="meta",
                recorder: Recorder | None = None, params=None):
    """``(step, args)`` of rank 0's training step on ``mesh`` over the
    global ``batch`` (of which the step takes rank 0's rows), ``workers``
    in-process workers a data rank; ``sync`` is ``exact``, a `SyncConfig`
    strategy (its defaults, as the reference's dry run) or ``async`` (with
    ``async_cfg``).  On ``meta`` the leaves are empty shards; on another
    device ``params`` (rank 0's shards) must be given, and the state is
    made as the trainer makes it."""
    rec = recorder or Recorder()
    sizes = SH.axis_sizes(mesh)
    m = sizes.get("model", 1)
    d_world = SH.data_size(mesh)
    axis = "+".join(SH.data_axes(mesh))
    layout = RankLayout(world=d_world * m, rank=0,
                        backend="record" if d_world * m > 1 else "",
                        model=m)
    group = RecordingWorkerGroup(d_world * workers, layout, rec, axis)
    defs = TF.model_defs(cfg)
    mspecs = param_specs(defs, {"model": m})
    fsdp = ("data",) if (use_fsdp(cfg) and sync == "exact"
                         and sizes.get("data", 1) > 1) else ()
    fspecs = param_specs(defs, sizes, fsdp_axes=fsdp)
    if params is None:
        params = _rank_leaves(defs, fspecs, sizes, device)
    opt, _ = pick_optimizer(cfg)
    opt_state = opt.init(T.leaves(params))
    if sync == "exact" and fsdp:
        mshapes = T.tree_map(lambda d, sp: shard_shape(d.shape, sp, sizes),
                             defs, mspecs)
        step = _fsdp_exact_step(cfg, opt, mshapes, group)
        return step, (params, opt_state, batch)
    if sync == "async":
        acfg = async_cfg or AsyncConfig()
        state = init_async_state(acfg, group, params,
                                 mspecs if acfg.fused else None)
        step = make_async_train_step(cfg, opt, acfg, group, mspecs,
                                     GRAD_ACCUM)
    else:
        scfg = SyncConfig(strategy=sync, wire_dtype=WIRE_DTYPE,
                          gate="static" if sync == "elastic" else "norm")
        state = init_dist_sync_state(scfg, group, params)
        step = make_elastic_train_step(cfg, opt, scfg, group, mspecs,
                                       static_phase, GRAD_ACCUM)
    return step, (params, opt_state, state, batch)


def _build_serve(cfg, mesh, shape, device):
    sizes = SH.axis_sizes(mesh)
    defs = TF.model_defs(cfg)
    specs = param_specs(defs, sizes)
    params = _rank_leaves(defs, specs, sizes, device, _serving_dtype)
    batch = _local_batch(cfg, shape, mesh, device)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape.seq_len), (params, batch)
    rows = batch["tokens"].shape[0]
    cache = TF.init_cache(cfg, rows, shape.seq_len, device)
    return make_decode_step(cfg), (params, cache, batch["tokens"])


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def trace(step, args) -> dict:
    """Run ``step(*args)`` once under the FLOP counter, the bytes-accessed
    mode and the saved-tensor hooks: ``{"flops", "bytes", "memory",
    "out"}``.  The arguments' bytes are those of every argument but the
    batch (:func:`_is_state`)."""
    arg_bytes, arg_keys = storage_bytes([a for a in args if _is_state(a)])
    saved = SavedBytes(arg_keys)
    flops = FlopCounterMode(display=False)
    moved = BytesAccessed()
    with flops, moved, torch.autograd.graph.saved_tensors_hooks(
            saved.pack, saved.unpack):
        out = step(*args)
    out_bytes, _ = storage_bytes(out)
    alias = sum(t.untyped_storage().nbytes() for t in _unique(out)
                if _storage_key(t) in arg_keys)
    peak = arg_bytes + out_bytes + saved.total - alias
    return {"flops": int(flops.get_total_flops()), "bytes": int(moved.total),
            "memory": {"argument_bytes": int(arg_bytes),
                       "output_bytes": int(out_bytes),
                       "temp_bytes": int(saved.total),
                       "alias_bytes": int(alias),
                       "peak_per_device_gb": round(peak / 2 ** 30, 3)},
            "out": out}


def _is_state(x) -> bool:
    """An argument that is state (params, optimizer or sync state, a
    cache), not the batch (a dict with ``tokens``, or a decode step's
    int64 tokens)."""
    return not (isinstance(x, dict) and "tokens" in x) \
        and not (isinstance(x, torch.Tensor) and x.dtype == torch.long)


def _unique(tree):
    seen = set()
    for t in T.tensors(tree):
        key = _storage_key(t)
        if key not in seen:
            seen.add(key)
            yield t


def _link(mesh: ProductionMesh, axis: str) -> tuple[str, float]:
    """The link an axis's collectives cross: NVLink when its group of
    cards (the axes inside it set its stride) fits in one node, else
    InfiniBand."""
    names = axis.split("+")
    stride = 1
    for a, n in zip(reversed(mesh.axis_names), reversed(mesh.shape)):
        if a in names:
            break
        stride *= n
    span = stride * math.prod(mesh.sizes[a] for a in names)
    if span <= NODE_CARDS:
        return "nvlink", NVLINK_BYTES_S
    return f"infiniband ({span} cards span {span // NODE_CARDS} nodes)", \
        IB_BYTES_S


def roofline(flops: int, n_bytes: int, by_axis: dict,
             mesh: ProductionMesh) -> dict:
    """Per-rank roofline terms (computed from the datasheet)."""
    coll, links = {}, {}
    for axis, b in by_axis.items():
        name, rate = _link(mesh, axis)
        links[axis] = name
        coll[axis] = b / rate
    terms = {"compute": flops / H100_BF16_FLOPS,
             "memory": n_bytes / H100_HBM_BYTES_S,
             **{f"collective_{a}": s for a, s in coll.items()}}
    bound_by = max(terms, key=terms.get)
    return {"compute_s": terms["compute"], "memory_s": terms["memory"],
            "collective_s": coll, "links": links,
            "bound_s": terms[bound_by], "bound_by": bound_by,
            "source": "computed from the H100 SXM5 80GB (700 W) datasheet: "
                      "989.4 TFLOP/s bf16 dense, 3.35 TB/s HBM3, NVLink "
                      "450 GB/s each way in an 8-card node, InfiniBand NDR "
                      "50 GB/s a card; not measured"}


def trace_record(step, args, rec: Recorder, mesh) -> dict:
    """The record's measured part for one traced step."""
    t0 = time.time()
    got = trace(step, args)
    lower_s = round(time.time() - t0, 1)
    by_axis = rec.axis_bytes()
    mem = got["memory"]
    costs = {"flops": float(got["flops"]), "bytes": float(got["bytes"]),
             "collectives": {**{k: float(v)
                                for k, v in rec.by_kind().items()},
                             "total": float(sum(by_axis.values()))}}
    return {
        "lower_s": lower_s,
        "compile_s": 0.0,               # nothing compiles: eager tracing
        "memory": mem,
        "fits": mem["peak_per_device_gb"] * 2 ** 30 <= H100_MEMORY_BYTES,
        "cost_analysis_raw": {"flops": costs["flops"],
                              "bytes": costs["bytes"]},
        "costs": costs,
        "collectives_by_axis": rec.by_axis,
        "roofline": roofline(got["flops"], got["bytes"], by_axis, mesh),
    }


def run_one(arch: str, shape_name: str, multi_pod: bool,
            sync: str = "exact", with_costs: bool = True,
            static_phase: int = 0) -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "multi_pod_2x16x16" if multi_pod else "single_pod_16x16"
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "sync": sync,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "sequence_parallel": SEQUENCE_PARALLEL,
        "status": "ok",
    }
    skip = should_skip(cfg, shape)
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec
    rec.update(trace_cell(cfg, mesh, shape, sync, static_phase))
    if not with_costs:
        rec.pop("costs")
    return rec


def trace_cell(cfg, mesh: ProductionMesh, shape, sync: str = "exact",
               static_phase: int = 0) -> dict:
    """Trace rank 0's step of ``cfg`` on ``mesh`` at ``shape``."""
    sizes = SH.axis_sizes(mesh)
    recorder = Recorder()
    device = "meta"
    old = actx.current()
    actx.install(RecordingModelGroup(sizes.get("model", 1), 0, recorder)
                 if sizes.get("model", 1) > 1 else None)
    try:
        with actx.rules(act_rules_for(cfg, mesh, shape)):
            if shape.kind == "train":
                step, args = build_train(
                    cfg, mesh, make_batch_specs(cfg, shape, device), sync,
                    static_phase=static_phase, device=device,
                    recorder=recorder)
            else:
                step, args = _build_serve(cfg, mesh, shape, device)
            out = trace_record(step, args, recorder, mesh)
    finally:
        actx.install(old)
    out["layout"] = {"axes": dict(sizes), "rank": 0,
                     "fsdp": bool(shape.kind == "train" and sync == "exact"
                                  and use_fsdp(cfg))}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--sync", default="exact")
    ap.add_argument("--static-phase", type=int, default=0)
    ap.add_argument("--no-costs", action="store_true")
    ap.add_argument("--sp", action="store_true",
                    help="sequence parallelism (the residual's S over "
                         "model; baseline off)")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches")
    ap.add_argument("--wire-dtype", default="f32", choices=["f32", "bf16"],
                    help="gradient-sync wire dtype")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    global SEQUENCE_PARALLEL, GRAD_ACCUM, WIRE_DTYPE
    SEQUENCE_PARALLEL = args.sp
    GRAD_ACCUM = args.accum
    WIRE_DTYPE = args.wire_dtype

    archs = list(REGISTRY) if args.arch == "all" else args.arch.split(",")
    shapes = (list(INPUT_SHAPES) if args.shape == "all"
              else args.shape.split(","))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    t_sweep = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = (f"{arch}__{shape}__"
                       f"{'multi' if mp else 'single'}__{args.sync}"
                       + ("__sp" if args.sp else "")
                       + (f"__accum{args.accum}" if args.accum > 1 else "")
                       + ("__bf16wire" if args.wire_dtype == "bf16" else ""))
                out_path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(out_path):
                    with open(out_path) as fh:
                        rec = json.load(fh)
                    if rec.get("status") in ("ok", "skipped"):
                        print(f"=== {tag} === (cached)", flush=True)
                        continue
                print(f"=== {tag} ===", flush=True)
                try:
                    rec = run_one(arch, shape, mp, args.sync,
                                  with_costs=not args.no_costs and not mp,
                                  static_phase=args.static_phase)
                except Exception as e:  # noqa: BLE001 — a failed cell is a record
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "sync": args.sync, "status": "failed",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=2)
                mem = rec.get("memory", {})
                print(f"  -> {rec['status']}"
                      + (f" peak {mem['peak_per_device_gb']} GiB, "
                         f"{rec['cost_analysis_raw']['flops']:.3e} FLOPs, "
                         f"traced in {rec['lower_s']} s"
                         if rec["status"] == "ok" else ""), flush=True)
    print(f"done; failures={failures}; sweep {time.time() - t_sweep:.1f} s")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
