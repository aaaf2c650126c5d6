"""Loss, gradients, the training steps and the dense-cache serving steps
(counterpart of ``repro.dist.train``).

Two training paths share one loss:

* :func:`make_train_step` — the exact step on the whole batch, the
  perfectly-consistent baseline;
* :func:`make_elastic_train_step` — the relaxed-consistency path: ``p``
  workers (in this process, or laid over processes by a
  `repro_torch.dist.workers.WorkerGroup`) each take the gradient of their
  batch shard, and `repro_torch.core.scheduler.sync_gradients` decides
  what is applied (the exact mean, top-k / one-bit with error feedback,
  or the elastic norm- / static-gated partial sync).

Parameters are a nested dict of float32 tensors in the reference's layout;
gradients come back as a tree of the same structure.  Optimizer state and
updates work on the flat leaf list (sorted-key order), and parameters are
updated in place.  Under a model group (``--model-shards m``,
`repro_torch.models.actx`) both are this rank's model shards: the loss is
the vocab-parallel cross entropy when the logits are sharded on the
vocab, the ``grad_norm`` metric counts a sharded leaf's squares summed
over the group and a replicated leaf's once (:func:`model_norm`), and the
skip-step guard's decision is the world's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.core.scheduler import (SyncConfig, init_sync_state,
                                        sync_gradients)
from repro_torch.dist.workers import as_group, shard_batch
from repro_torch.models import actx
from repro_torch.models import transformer as TF
from repro_torch.optim import apply_updates, global_norm
from repro_torch.serve.sampling import SampleConfig, sample_tokens


def loss_fn(cfg: ArchConfig, params, batch: dict, layer_sinks=None):
    """Token-level cross entropy (+ weighted router aux loss, zero for the
    dense stack).  An optional ``batch["loss_scale"]`` (B,) multiplies the
    loss, as in the reference's fault-injection channel."""
    logits, aux = TF.forward(cfg, params, batch, layer_sinks)
    start = TF.logits_vocab_start(cfg)
    if start is None:
        logp = F.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])
    else:
        nll = actx.vocab_parallel_nll(logits.float(), batch["labels"], start)
    ce = torch.mean(nll)
    loss = ce + cfg.router_aux_weight * aux
    if "loss_scale" in batch:
        loss = loss * torch.mean(batch["loss_scale"].float())
    return loss, {"ce": ce.detach(), "aux_loss": aux.detach()}


def _grads(cfg: ArchConfig, params, batch: dict):
    """Loss + gradient tree of one batch in one backward pass: ``(loss,
    parts, grads)``.  The layer leaves' gradients land in fresh sinks (one
    buffer per stacked leaf, filled a layer at a time); the other leaves'
    come from ``backward``.  The forward runs in a ``step.forward`` span
    and the backward, with the gradients' collection, in a
    ``step.backward`` span (autograd launches its kernels from its own
    thread, inside the span's host interval)."""
    flat_p, td = T.flatten(params)
    with trace.span("step.forward"):
        sinks = T.tree_map(torch.zeros_like, params["layers"])
        for p in flat_p:
            p.requires_grad_(True)
            p.grad = None
        loss, parts = loss_fn(cfg, params, batch, sinks)
    with trace.span("step.backward"):
        loss.backward()
        layer_ids = {id(p) for p in T.leaves(params["layers"])}
        sink_of = dict(zip((id(p) for p in T.leaves(params["layers"])),
                           T.leaves(sinks)))
        grads = []
        for p in flat_p:
            if id(p) in layer_ids:
                grads.append(sink_of[id(p)])
            else:
                grads.append(p.grad if p.grad is not None
                             else torch.zeros_like(p))
                p.grad = None
    return loss.detach(), parts, T.unflatten(td, grads)


def mean_grads(cfg: ArchConfig, params, batch: dict, grad_accum: int = 1):
    """Loss + mean gradient tree: ``(loss, parts, grads)``.  With
    ``grad_accum > 1`` the batch is split into that many contiguous
    microbatches, one backward each; their losses, parts and f32
    gradients are summed in microbatch order and then multiplied by
    ``1 / grad_accum``, as the reference's ``mean_grads`` does.  With 1 it
    is one backward pass over the whole batch."""
    if grad_accum <= 1:
        return _grads(cfg, params, batch)
    micro = shard_batch(batch, grad_accum)
    loss, parts, grads = _grads(cfg, params, micro[0])
    acc = T.leaves(grads)
    for mb in micro[1:]:
        mloss, mparts, mgrads = _grads(cfg, params, mb)
        loss = loss + mloss
        parts = {k: parts[k] + mparts[k] for k in parts}
        for a, g in zip(acc, T.leaves(mgrads)):
            a.add_(g)
        del mgrads
    inv = 1.0 / grad_accum
    for a in acc:
        a.mul_(inv)
    return loss * inv, {k: v * inv for k, v in parts.items()}, grads


def worker_grads(cfg: ArchConfig, params, batch: dict, workers,
                 grad_accum: int = 1):
    """Yield ``(loss, grads)`` of each local worker's contiguous batch
    shard at ``params``, in worker order, each over ``grad_accum``
    microbatches (``workers``: a `WorkerGroup`, or a count of in-process
    workers).  The generator keeps no reference to what it yielded, so a
    consumer that drops a worker's gradients frees them before the next
    worker's backward."""
    for shard in as_group(workers).shard_batch(batch):
        yield mean_grads(cfg, params, shard, grad_accum)[::2]


def model_norm(leaves, specs) -> torch.Tensor:
    """The global norm of the whole model's ``leaves`` from this rank's
    shards of them: under a model group a leaf its spec (``specs``, the
    param specs) shards counts its squares summed over the group, a
    replicated leaf once; without one, ``optim.global_norm``."""
    if actx.current() is None:
        return global_norm(leaves)
    parts = [torch.zeros((), dtype=torch.float32, device=leaves[0].device)
             for _ in range(2)]
    for x, spec in zip(leaves, T.leaves(specs)):
        sharded = actx.model_dim(spec) is not None
        parts[sharded] = parts[sharded] + torch.sum(torch.square(x.float()))
    return torch.sqrt(actx.model_total(parts[1], parts[0]))


def tree_all_finite(leaves) -> torch.Tensor:
    """Scalar bool tensor: every leaf is finite everywhere."""
    out = torch.all(torch.isfinite(leaves[0]))
    for x in leaves[1:]:
        out = torch.logical_and(out, torch.all(torch.isfinite(x)))
    return out


@torch.no_grad()
def guarded_update(opt, grads, opt_state, params, *, skip_nonfinite: bool):
    """Optimizer update of the ``params`` leaves in place, with the
    optional skip-step guard: when ``skip_nonfinite`` and any gradient leaf
    is NaN/Inf, params and the whole optimizer state (``count`` included)
    keep their old values, as the reference's ``jnp.where`` over every
    leaf does.  The guard reads the finiteness flag on the host once and
    then either applies the update or skips it, so it keeps no copy of any
    leaf.  Returns ``(params, opt_state, nonfinite)``; with the guard off
    no finiteness reduction runs.  The update runs in a ``step.update``
    span; the guard, before it, in none but its host reads' ``wait.*``."""
    if skip_nonfinite:
        with trace.span("wait.finite"):
            finite = bool(tree_all_finite(grads))
        ctx = actx.current()
        if ctx is not None:
            with trace.span("wait.finite_world"):
                finite = ctx.world_all(finite, grads[0].device)
        if not finite:
            return params, opt_state, torch.ones((), device=params[0].device)
    with trace.span("step.update"):
        updates, opt_state = opt.update(grads, opt_state, params)
        apply_updates(params, updates)
        return params, opt_state, torch.zeros((), device=params[0].device)


def make_train_step(cfg: ArchConfig, opt, grad_accum: int = 1, *,
                    skip_nonfinite: bool = False, specs=None):
    """Exact-sync step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on the whole batch (over ``grad_accum`` microbatches) — the
    perfectly-consistent baseline every relaxation is compared against.
    ``skip_nonfinite`` arms the :func:`guarded_update` skip-step guard and
    adds a ``nonfinite`` 0/1 metric; off (the default) the step is
    unchanged.  Under a model group ``specs`` (the param specs) is
    needed for the ``grad_norm`` metric."""

    def step(params, opt_state, batch):
        loss, parts, grads = mean_grads(cfg, params, batch, grad_accum)
        flat_g = T.leaves(grads)
        metrics = {"loss": loss, "grad_norm": model_norm(flat_g, specs),
                   **parts}
        _, opt_state, nonfinite = guarded_update(
            opt, flat_g, opt_state, T.leaves(params),
            skip_nonfinite=skip_nonfinite)
        if skip_nonfinite:
            metrics["nonfinite"] = nonfinite
        return params, opt_state, metrics

    return step


def init_dist_sync_state(scfg: SyncConfig, workers, params_like) -> dict:
    """State of :func:`make_elastic_train_step`: ``step`` and, for the
    compressed and elastic strategies, one f32 accumulator per local
    worker (EF residual or deferred residual) with a leading worker dim,
    on the params' device (``workers``: a `WorkerGroup`, or a count of
    in-process workers)."""
    return init_sync_state(scfg, params_like, workers)


class _CollectLosses:
    """Iterate the gradient trees of ``(loss, grads)`` pairs, keeping the
    losses.  ``__next__`` holds no reference to what it returned."""

    def __init__(self, pairs):
        self._it = iter(pairs)
        self.losses = []

    def __iter__(self):
        return self

    def __next__(self):
        loss, grads = next(self._it)
        self.losses.append(loss)
        return grads


class ElasticTrainStep:
    """Synchronous sync-strategy step ``(params, opt_state, sync_state,
    batch) -> (params, opt_state, sync_state, metrics)`` over ``workers``
    (a `WorkerGroup`, or a count of in-process workers).  Metrics: ``loss``
    (mean over every worker, on every process) and ``gap2_over_alpha2``.

    A step is two halves, as in `repro_torch.dist.async_engine`:
    :meth:`worker_grads` yields each worker's ``(loss, grads)`` and
    :meth:`sync_update` consumes them one worker at a time, syncs them and
    applies the optimizer, so that a test can feed it gradients from
    elsewhere (one pair per local worker).  Params, optimizer state and
    sync state are updated in
    place.  ``static_phase`` is the elastic static gate's phase, fixed when
    the step is built (as the reference compiles one program a phase);
    each worker's gradient is the mean over ``grad_accum`` microbatches of
    its shard."""

    def __init__(self, cfg: ArchConfig, opt, scfg: SyncConfig, workers,
                 specs, static_phase: int = 0, grad_accum: int = 1):
        self.cfg, self.opt, self.scfg = cfg, opt, scfg
        self.group = as_group(workers)
        self.n, self.specs, self.static_phase = (self.group.n, specs,
                                                 static_phase)
        self.grad_accum = grad_accum

    def worker_grads(self, params, batch: dict):
        """Gradient half: yield ``(loss, grads)`` per local worker, in
        order."""
        yield from worker_grads(self.cfg, params, batch, self.group,
                                self.grad_accum)

    def __call__(self, params, opt_state, state: dict, batch: dict):
        return self.sync_update(params, opt_state, state,
                                self.worker_grads(params, batch))

    def sync_update(self, params, opt_state, state: dict, worker_grads):
        """Sync/update half over an iterable of per-worker ``(loss,
        grads)``."""
        pairs = _CollectLosses(worker_grads)
        synced, state, smetrics = sync_gradients(
            self.scfg, pairs, state, specs=self.specs,
            static_phase=self.static_phase, group=self.group)
        if len(pairs.losses) != self.group.n_local:
            raise ValueError(f"got gradients of {len(pairs.losses)} "
                             f"workers, expected {self.group.n_local}")
        _, opt_state, _ = guarded_update(self.opt, T.leaves(synced),
                                         opt_state, T.leaves(params),
                                         skip_nonfinite=False)
        metrics = {"loss": self.group.pmean(pairs.losses),
                   "gap2_over_alpha2": smetrics["gap2_over_alpha2"]}
        return params, opt_state, state, metrics


def make_elastic_train_step(cfg: ArchConfig, opt, scfg: SyncConfig, workers,
                            specs, static_phase: int = 0,
                            grad_accum: int = 1):
    """The relaxed-sync step over ``workers`` (a `WorkerGroup`, or a count
    of in-process workers), each over ``grad_accum`` microbatches of its
    shard."""
    return ElasticTrainStep(cfg, opt, scfg, workers, specs, static_phase,
                            grad_accum)


# ---------------------------------------------------------------------------
# serving steps (the dense legacy loop: the paged engine's oracle)
# ---------------------------------------------------------------------------

def _next_tokens(cfg: ArchConfig, logits, sc: SampleConfig, gen):
    """(B, V) last-position logits -> (B,) tokens.  Under a model group
    whose logits are sharded on the vocab, greedy decoding takes the
    group's largest logit (the lowest vocab id of a tie, as ``argmax``
    over the whole vocab); sampled decoding there is not ported."""
    start = TF.logits_vocab_start(cfg)
    if start is None:
        return sample_tokens(logits, sc, gen)
    if not sc.is_greedy:
        raise NotImplementedError("sampled decoding over vocab-sharded "
                                  "logits is not ported")
    ctx = actx.current()
    best, idx = torch.max(logits.float(), dim=-1)
    bests = ctx.gather(best)                                  # (m, B)
    ids = ctx.gather(idx + start)
    rank = torch.argmax(bests, dim=0, keepdim=True)
    return torch.gather(ids, 0, rank)[0].to(torch.int32)


def make_prefill_step(cfg: ArchConfig, max_len: int, sample=None):
    """``(params, batch, gen=None) -> (tokens (B,), cache)``: run the
    prompt, allocate a ``max_len`` cache, emit the first continuation
    token (greedy unless ``sample`` is a sampled
    `repro_torch.serve.sampling.SampleConfig`; its noise comes from
    ``gen``)."""
    sc = sample or SampleConfig()

    @torch.no_grad()
    def prefill_step(params, batch, gen=None):
        logits, cache = TF.prefill(cfg, params, batch, max_len)
        return _next_tokens(cfg, logits[:, -1, :], sc, gen), cache

    return prefill_step


def make_decode_step(cfg: ArchConfig, sample=None):
    """``(params, cache, tokens (B, 1), gen=None) -> (tokens (B,),
    cache)``: one batched decode step at position ``cache["pos"]``; the
    cache is updated in place."""
    sc = sample or SampleConfig()

    @torch.no_grad()
    def decode_step(params, cache, tokens, gen=None):
        logits, cache = TF.decode_step(cfg, params, cache, tokens)
        return _next_tokens(cfg, logits[:, -1, :], sc, gen), cache

    return decode_step
