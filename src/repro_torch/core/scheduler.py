"""Gradient-synchronization strategies across in-process workers, and the
row-space geometry and local EF compression of one leaf (counterpart of
``repro.core.scheduler``).

Strategies (``SyncConfig.strategy``):

exact      : the mean over workers (the perfectly-consistent baseline).
topk_ef    : per-worker row top-k + error feedback (Alg 6); the wire
             carries (bf16 values, int32 indices) and the reduce is K4.
onebit_ef  : sign/mean one-bit quantization + EF (Eq. 30); the wire
             carries a sign map and two means per row, the reduce is K5.
elastic    : §5's elastic scheduler run synchronously — per-step partial
             sync over layer buckets (norm- or static-gated), deferred
             mass kept in per-worker residuals and synced on the bucket's
             next turn; ``budget_b`` forces a full sync when last step's
             gap exceeds it.

The reference runs inside ``shard_map``, one shard per worker.  Here a
`repro_torch.dist.workers.WorkerGroup` lays the ``p`` workers over one or
more processes: each process's workers' gradients arrive in worker order
and are consumed one worker at a time (compressed into the wire payload,
or added into the residual, in place), so at most one worker's dense
gradient is alive at once; the cross-worker collectives are the group's
gathers and sums in worker order.  Per-worker state carries a leading
worker dim over the process's own workers, (p / N, *leaf).

A leaf is viewed as (M, R) rows: M = product of the ``model``-sharded dims
(kept local), R = the rest (compressed).  With a ``model`` axis of size 1
every spec is all-``None``, so M = 1 and the single row is the whole
stacked leaf — the shape the port's kernels are built for.  Under
``--model-shards m`` (a `repro_torch.models.actx` model group) a rank
holds its model shard of each leaf: its rows are the whole leaf's rows
``[j M / m, (j + 1) M / m)`` with the whole R, so it compresses, gathers
over its data group and reduces those rows alone, with ``k`` from the
whole R; a replicated leaf (M = 1) is compressed whole on every model
rank.  The elastic buckets are balanced on whole-leaf sizes, and the
bucket norms and gap metrics count a sharded leaf's squares summed over
the model group and a replicated leaf's once (:class:`_Squares`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import trace
from repro_torch import tree as T
from repro_torch.dist.workers import WorkerGroup, WorkerSum, as_group
from repro_torch.kernels.cr_reduce import ops as CR
from repro_torch.models import actx


@dataclass(frozen=True)
class SyncConfig:
    """The reference's fields.  ``axis_names`` is kept for parity of the
    configuration; the in-process workers stand for the data axes."""

    strategy: str = "exact"       # exact | topk_ef | onebit_ef | elastic
    axis_names: tuple = ("data",)
    wire_dtype: str = "f32"       # f32 | bf16: dtype of the exact /
    #                               elastic mean's wire
    topk_ratio: float = 1.0 / 64.0
    n_buckets: int = 8
    beta: float = 0.9             # norm gate: sync buckets covering beta
    gate: str = "norm"            # norm | static
    phase_period: int = 4         # static gate: bucket b syncs when
    #                               step % period == b % period
    budget_b: float = 0.0         # force a full sync when the gap exceeds
    #                               it (0 = off)
    track_gap: bool = True        # gap2_over_alpha2 metric (0 when off)


STRATEGIES = ("exact", "topk_ef", "onebit_ef", "elastic")


def init_sync_state(cfg: SyncConfig, grads_like, workers) -> dict:
    """``{"step": 0}``, plus ``err`` (topk_ef, onebit_ef) or ``residual``
    (elastic): a tree of (p / N, *leaf) f32 zeros, one row per worker of
    this process.  ``workers`` is a `WorkerGroup` or a count of in-process
    workers."""
    if cfg.strategy not in STRATEGIES:
        raise ValueError(cfg.strategy)
    n_local = as_group(workers).n_local
    state = {"step": 0}
    key = {"topk_ef": "err", "onebit_ef": "err",
           "elastic": "residual"}.get(cfg.strategy)
    if key is not None:
        state[key] = T.tree_map(
            lambda g: torch.zeros((n_local, *g.shape), dtype=torch.float32,
                                  device=g.device), grads_like)
    return state


def _split_model_dims(spec, ndim: int):
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    model = [i for i, s in enumerate(spec) if s is not None]
    other = [i for i in range(ndim) if i not in model]
    return model, other


def _to_rows(g: torch.Tensor, spec):
    """Leaf -> contiguous (M, R) rows, as the kernels take them: a view
    when the model-sharded dim leads (or no dim is sharded), else a copy
    (a (L, d) leaf sharded on d permutes to (d, L) without one)."""
    model, other = _split_model_dims(spec, g.ndim)
    perm = model + other
    gt = g.permute(perm)
    m = 1
    for i in model:
        m *= g.shape[i]
    return gt.reshape(m, -1).contiguous(), perm, tuple(gt.shape)


def _from_rows(rows: torch.Tensor, perm, tshape):
    inv = [0] * len(perm)
    for i, p_ in enumerate(perm):
        inv[p_] = i
    return rows.reshape(tshape).permute(inv)


def leaf_rows_geometry(shape, spec):
    """``(m, r, perm, tshape)`` of the (M, R) layout :func:`_to_rows`
    gives a leaf of ``shape``."""
    model, other = _split_model_dims(spec, len(shape))
    perm = model + other
    tshape = tuple(shape[i] for i in perm)
    m = 1
    for i in model:
        m *= shape[i]
    size = 1
    for s in shape:
        size *= s
    r = size // m if m else 0
    return m, r, perm, tshape


def ef_compress_leaf(g, err, spec, method: str, topk_ratio: float = 1 / 64):
    """One local compression round of a leaf, densified: returns
    ``(payload, new_err)`` with ``payload = Q(err + g)`` in the leaf's
    shape and ``new_err = (err + g) - payload``.  ``err=None`` compresses
    without error feedback (a zero residual)."""
    if err is None:
        err = torch.zeros_like(g, dtype=torch.float32)
    w = err + g.float()
    if w.numel() == 0:
        return w, w
    rows, perm, tshape = _to_rows(w, spec)
    if method == "topk":
        vals, idx, _ = CR.topk_compress_rows(rows, None, topk_ratio)
        q = torch.zeros_like(rows).scatter_add_(1, idx.long(), vals)
    elif method == "onebit":
        pos, means, _ = CR.onebit_compress_rows(rows, None)
        q = torch.where(pos, means[:, 0:1], means[:, 1:2])
    else:
        raise ValueError(f"unknown compressor {method!r}")
    payload = _from_rows(q, perm, tshape)
    return payload, w - payload


def ef_compress_leaf_compact(g, err, spec, method: str,
                             topk_ratio: float = 1 / 64):
    """One local compression round kept in *wire form*.

    Returns ``(payload, new_err)``: ``{"vals" (M, k) f32, "idx" (M, k)
    i32}`` for top-k or ``{"pos" (M, R) bool, "means" (M, 2) f32}`` for
    one-bit, and the residual in the leaf's shape.  ``err=None`` means no
    error feedback; otherwise the residual is written into ``err``, which
    is returned (when the rows are a view of ``err``, as at M = 1, the
    compressor writes it there directly).  Densified, the payload equals
    :func:`ef_compress_leaf`'s bit for bit.
    """
    m, r, perm, tshape = leaf_rows_geometry(tuple(g.shape), spec)
    if g.numel() == 0:
        if method == "topk":
            payload = {"vals": g.new_zeros((m, 0), dtype=torch.float32),
                       "idx": g.new_zeros((m, 0), dtype=torch.int32)}
        else:
            payload = {"pos": g.new_zeros((m, r), dtype=torch.bool),
                       "means": g.new_zeros((m, 2), dtype=torch.float32)}
        return payload, (err if err is not None else g.float())
    rows_g, _, _ = _to_rows(g, spec)
    rows_e = _to_rows(err, spec)[0] if err is not None else None
    out = rows_e if (rows_e is not None
                     and rows_e.data_ptr() == err.data_ptr()
                     and rows_e.is_contiguous()) else None
    if method == "topk":
        vals, idx, err_rows = CR.topk_compress_rows(rows_g, rows_e,
                                                    topk_ratio, out_err=out)
        payload = {"vals": vals, "idx": idx}
    elif method == "onebit":
        pos, means, err_rows = CR.onebit_compress_rows(rows_g, rows_e,
                                                       out_err=out)
        payload = {"pos": pos, "means": means}
    else:
        raise ValueError(f"unknown compressor {method!r}")
    if err is None:
        return payload, _from_rows(err_rows, perm, tshape)
    if err_rows is not out:
        err.copy_(_from_rows(err_rows, perm, tshape))
    return payload, err


# ---------------------------------------------------------------------------
# the reduce half of the compressed strategies (the compress half is
# ef_compress_leaf_compact, run per worker)
# ---------------------------------------------------------------------------

def _leaf_topk_sync(group, payloads, r: int, perm, tshape):
    """The p workers' top-k payloads of one leaf (this process's in
    ``payloads``) -> their mean, in the leaf's shape.  The values cross the
    wire in bf16, as in the reference; K4 scatter-adds the gathered panel
    with unit weights, then the sum is divided by p."""
    p = group.n
    vals = group.all_gather([pl["vals"].to(torch.bfloat16)
                             for pl in payloads])
    idx = group.all_gather([pl["idx"] for pl in payloads])
    ones = torch.ones((p,), dtype=torch.float32, device=vals.device)
    dense = CR.topk_reduce(vals, idx, ones, r)
    return _from_rows(dense.div_(p), perm, tshape)


def _leaf_onebit_sync(group, payloads, perm, tshape):
    """The p workers' sign/mean payloads of one leaf -> their mean (K5 with
    unit weights, then divided by p)."""
    p = group.n
    pos = group.all_gather([pl["pos"] for pl in payloads])
    means = group.all_gather([pl["means"] for pl in payloads])
    ones = torch.ones((p,), dtype=torch.float32, device=pos.device)
    dense = CR.onebit_reduce(pos, means, ones)
    return _from_rows(dense.div_(p), perm, tshape)


# ---------------------------------------------------------------------------
# elastic bucketing
# ---------------------------------------------------------------------------

def bucket_assignment(grads_like, n_buckets: int,
                      sizes: list[int] | None = None) -> list[int]:
    """Assign leaves (a tree, or a list of leaves in tree order) to buckets
    contiguously by traversal order, balancing by element count (or by
    ``sizes``, the whole leaves' under a model group)."""
    if sizes is None:
        leaves = grads_like if isinstance(grads_like, (list, tuple)) \
            else T.leaves(grads_like)
        sizes = [x.numel() for x in leaves]
    target = sum(sizes) / n_buckets
    assign, b, acc = [], 0, 0.0
    for s in sizes:
        assign.append(min(b, n_buckets - 1))
        acc += s
        if acc >= target * (b + 1) and b < n_buckets - 1:
            b += 1
    return assign


def _bucket_norms(leaves, assign, n_buckets: int,
                  sharded=None) -> torch.Tensor:
    """(n_buckets,) f32: the squared norm of each bucket's leaves (under a
    model group, ``sharded`` flags each leaf the model shards)."""
    norms = [torch.zeros((n_buckets,), dtype=torch.float32,
                         device=leaves[0].device)
             for _ in range(1 if sharded is None else 2)]
    for i, (a, leaf) in enumerate(zip(assign, leaves)):
        norms[0 if sharded is None else sharded[i]][a] += \
            torch.sum(torch.square(leaf))
    return norms[0] if sharded is None else actx.model_total(norms[1],
                                                             norms[0])


def norm_gate_mask(norms: torch.Tensor, beta: float, budget_b2: float = 0.0,
                   gap2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Select buckets (largest first) until >= beta of the total norm^2 is
    covered; if a budget is set and the gap exceeds it, select all."""
    total = torch.sum(norms)
    order = torch.argsort(-norms, stable=True)
    sorted_norms = norms[order]
    cum = torch.cumsum(sorted_norms, 0)
    sel_sorted = (cum - sorted_norms) < beta * total
    mask = torch.zeros_like(sel_sorted).scatter_(0, order, sel_sorted)
    if budget_b2 > 0.0 and gap2 is not None:
        mask = torch.where(gap2 > budget_b2, torch.ones_like(mask), mask)
    return mask


def static_gate_mask(step: int, n_buckets: int, period: int) -> list[bool]:
    """Round-robin: bucket b syncs when step % period == b % period."""
    return [b % period == step % period for b in range(n_buckets)]


# ---------------------------------------------------------------------------
# strategy entry point
# ---------------------------------------------------------------------------

class _Squares:
    """A running sum over leaves of the whole model, fed leaf ``i``'s
    squares: one sum in feeding order, or under a model group (``sharded``
    flags each leaf the model shards) a sum of the sharded leaves' added
    over the group and one of the replicated leaves' counted once."""

    def __init__(self, device, sharded=None):
        self.sharded = sharded
        self.parts = [torch.zeros((), dtype=torch.float32, device=device)
                      for _ in range(1 if sharded is None else 2)]

    def add(self, i: int, value: torch.Tensor) -> None:
        k = 0 if self.sharded is None else self.sharded[i]
        self.parts[k] = self.parts[k] + value

    def total(self) -> torch.Tensor:
        return self.parts[0] if self.sharded is None \
            else actx.model_total(self.parts[1], self.parts[0])


def model_sharded(specs) -> list[bool] | None:
    """Under a model group, whether the model shards each leaf of the
    param ``specs``; ``None`` without one."""
    if actx.current() is None:
        return None
    if specs is None:
        raise ValueError("under a model group the sync needs the param "
                         "specs")
    return [actx.model_dim(s) is not None for s in T.leaves(specs)]


def _gap2(means, device, sharded=None) -> torch.Tensor:
    gap2 = _Squares(device, sharded)
    for i, x in enumerate(means):
        gap2.add(i, torch.sum(torch.square(x)))
    return gap2.total()


def _worker_mean(group, stack: torch.Tensor, wire) -> torch.Tensor:
    """Mean over the workers (this process's rows: the leading dim) in the
    wire dtype (a bf16 wire's mean is rounded to bf16, as the reference's
    bf16 pmean is)."""
    mean = group.pmean([x.to(wire) for x in stack])
    return mean.to(wire).float() if wire != torch.float32 else mean


def sync_gradients(cfg: SyncConfig, worker_grads, state: dict, specs=None,
                   static_phase: Optional[int] = None,
                   group: Optional[WorkerGroup] = None):
    """Synchronize the workers' gradients.

    ``worker_grads`` yields one gradient tree per worker of this process,
    in worker order (a list, or a generator such as
    ``ElasticTrainStep.worker_grads``'s); each is consumed before the next
    is asked for.  ``state`` is :func:`init_sync_state`'s, updated in
    place.  ``specs`` (the param spec tree) is needed by the compressed
    strategies; ``static_phase`` (a Python int) by the static gate.
    ``group`` lays the workers over processes (default: every worker in
    this one, as many as the state has rows, or as yielded for ``exact``).
    Returns ``(synced tree, state, {"gap2_over_alpha2": scalar tensor})``.
    """
    if cfg.strategy not in STRATEGIES:
        raise ValueError(cfg.strategy)
    wire = torch.bfloat16 if cfg.wire_dtype == "bf16" else torch.float32
    step = state["step"]
    n, td = 0, None
    sharded = None if cfg.strategy == "exact" else model_sharded(specs)

    if cfg.strategy == "exact":
        # each worker's leaves in the wire dtype, summed in worker order
        sums, sum_group = None, group or WorkerGroup(1)
        for grads in worker_grads:
            flat_g, td = T.flatten(grads)
            del grads
            if sums is None:
                sums = [WorkerSum(sum_group) for _ in flat_g]
            for i, g in enumerate(flat_g):
                sums[i].add(g.to(wire))
                flat_g[i] = None
            del flat_g
            n += 1
        if sums is None:
            raise ValueError("no worker gradients")
        group = group or WorkerGroup(n)
        _check_workers(n, group.n_local)
        synced = []
        for i in range(len(sums)):
            synced.append(sums[i].mean(group.n))
            sums[i] = None
        if wire != torch.float32:
            synced = [s.to(wire).float() for s in synced]
        state["step"] = step + 1
        return (T.unflatten(td, synced), state,
                {"gap2_over_alpha2": torch.zeros((), device=synced[0].device)})

    per_worker = T.leaves(state["err" if cfg.strategy != "elastic"
                                else "residual"])
    group = group or WorkerGroup(per_worker[0].shape[0])
    n_local, device = per_worker[0].shape[0], per_worker[0].device

    if cfg.strategy in ("topk_ef", "onebit_ef"):
        if specs is None:
            raise ValueError("compressed sync needs the param specs")
        flat_s = T.leaves(specs)
        method = "topk" if cfg.strategy == "topk_ef" else "onebit"
        payloads = [[] for _ in per_worker]
        for grads in worker_grads:
            flat_g, td = T.flatten(grads)
            del grads
            with trace.span("step.compress"):
                for i, g in enumerate(flat_g):
                    payload, _ = ef_compress_leaf_compact(
                        g, per_worker[i][n], flat_s[i], method,
                        cfg.topk_ratio)
                    payloads[i].append(payload)
                    flat_g[i] = None
            del flat_g
            n += 1
        _check_workers(n, n_local)
        synced = []
        with trace.span("step.deliver"):
            for i, err in enumerate(per_worker):
                _, r, perm, tshape = leaf_rows_geometry(
                    tuple(err.shape[1:]), flat_s[i])
                if method == "topk":
                    synced.append(_leaf_topk_sync(group, payloads[i], r,
                                                  perm, tshape))
                else:
                    synced.append(_leaf_onebit_sync(group, payloads[i],
                                                    perm, tshape))
                payloads[i] = None
        with trace.span("step.gap"):
            gap2 = (_gap2((group.pmean(list(e)) for e in per_worker),
                          device, sharded)
                    if cfg.track_gap else torch.zeros((), device=device))
        state["step"] = step + 1
        return T.unflatten(td, synced), state, {"gap2_over_alpha2": gap2}

    # elastic: add each worker's gradient into its residual, in place
    assign = bucket_assignment(
        [r[0] for r in per_worker], cfg.n_buckets,
        None if sharded is None else
        [r[0].numel() * (actx.current().size if sh else 1)
         for r, sh in zip(per_worker, sharded)])
    norm_gate = cfg.gate != "static"
    if not norm_gate and static_phase is None:
        raise ValueError("the static gate needs a phase fixed when the "
                         "step is built")
    # the budget needs LAST step's gap: the residual before this step's
    # gradients are added
    gap_prev = (_gap2((group.pmean(list(r)) for r in per_worker), device,
                      sharded)
                if norm_gate and cfg.budget_b > 0.0 else None)
    norms = WorkerSum(group)
    for grads in worker_grads:
        flat_g, td = T.flatten(grads)
        del grads
        resid = [r[n] for r in per_worker]
        for i, g in enumerate(flat_g):
            resid[i].add_(g)
            flat_g[i] = None
        del flat_g
        if norm_gate:
            norms.add(_bucket_norms(resid, assign, cfg.n_buckets, sharded))
        n += 1
    _check_workers(n, n_local)
    if norm_gate:
        # the bucket norms of every worker, summed in worker order
        mask = norm_gate_mask(norms.total(), cfg.beta,
                              cfg.budget_b * cfg.budget_b, gap_prev)
        mask = [mask[a].float() for a in range(cfg.n_buckets)]
    else:
        mask = static_gate_mask(static_phase, cfg.n_buckets,
                                cfg.phase_period)
    synced = []
    gap2 = _Squares(device, sharded)
    for i, (a, r) in enumerate(zip(assign, per_worker)):
        m = mask[a]
        if not norm_gate and not m:
            synced.append(torch.zeros(r.shape[1:], dtype=torch.float32,
                                      device=device))
            if cfg.track_gap:
                gap2.add(i, torch.sum(torch.square(group.pmean(list(r)))))
            continue
        mean = _worker_mean(group, r, wire)
        if not norm_gate:            # a synced bucket: its backlog is sent
            synced.append(mean)
            r.zero_()
            continue
        keep = 1.0 - m
        if cfg.track_gap:
            # pmean(r * keep) == pmean(r) * keep bit for bit: keep is 0 or 1
            f32 = mean if wire == torch.float32 else group.pmean(list(r))
            gap2.add(i, torch.sum(torch.square(f32 * keep)))
        synced.append(mean.mul_(m))
        r.mul_(keep)
    state["step"] = step + 1
    return T.unflatten(td, synced), state, {"gap2_over_alpha2":
                                            gap2.total()}


def _check_workers(got: int, want: int) -> None:
    if got != want:
        raise ValueError(f"got gradients of {got} workers, expected {want}")
