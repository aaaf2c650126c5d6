"""Loss, gradients, the training steps and the dense-cache serving steps
(counterpart of ``repro.dist.train``).

Two training paths share one loss:

* :func:`make_train_step` — the exact step on the whole batch, the
  perfectly-consistent baseline;
* :func:`make_elastic_train_step` — the relaxed-consistency path: ``p``
  in-process workers each take the gradient of their batch shard, and
  `repro_torch.core.scheduler.sync_gradients` decides what is applied
  (the exact mean, top-k / one-bit with error feedback, or the elastic
  norm- / static-gated partial sync).

Parameters are a nested dict of float32 tensors in the reference's layout;
gradients come back as a tree of the same structure.  Optimizer state and
updates work on the flat leaf list (sorted-key order), and parameters are
updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.core.scheduler import (SyncConfig, init_sync_state,
                                        sync_gradients)
from repro_torch.dist.workers import pmean, shard_batch
from repro_torch.models import transformer as TF
from repro_torch.optim import apply_updates, global_norm
from repro_torch.serve.sampling import SampleConfig, sample_tokens


def loss_fn(cfg: ArchConfig, params, batch: dict, layer_sinks=None):
    """Token-level cross entropy (+ weighted router aux loss, zero for the
    dense stack).  An optional ``batch["loss_scale"]`` (B,) multiplies the
    loss, as in the reference's fault-injection channel."""
    logits, aux = TF.forward(cfg, params, batch, layer_sinks)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"][..., None])
    ce = torch.mean(nll)
    loss = ce + cfg.router_aux_weight * aux
    if "loss_scale" in batch:
        loss = loss * torch.mean(batch["loss_scale"].float())
    return loss, {"ce": ce.detach(), "aux_loss": aux.detach()}


def mean_grads(cfg: ArchConfig, params, batch: dict):
    """Loss + mean gradient tree in one backward pass: ``(loss, parts,
    grads)``.  The layer leaves' gradients land in fresh sinks (one buffer
    per stacked leaf, filled a layer at a time); the other leaves' come
    from ``backward``."""
    flat_p, td = T.flatten(params)
    sinks = T.tree_map(torch.zeros_like, params["layers"])
    for p in flat_p:
        p.requires_grad_(True)
        p.grad = None
    loss, parts = loss_fn(cfg, params, batch, sinks)
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


def worker_grads(cfg: ArchConfig, params, batch: dict, n: int):
    """Yield ``(loss, grads)`` of each of ``n`` workers' contiguous batch
    shards at ``params``, in worker order.  The generator keeps no
    reference to what it yielded, so a consumer that drops a worker's
    gradients frees them before the next worker's backward."""
    for shard in shard_batch(batch, n):
        yield mean_grads(cfg, params, shard)[::2]


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
    is NaN/Inf, params and optimizer state keep their old values.
    Returns ``(params, opt_state, nonfinite)``."""
    if not skip_nonfinite:
        updates, opt_state = opt.update(grads, opt_state, params)
        apply_updates(params, updates)
        return params, opt_state, torch.zeros((), device=params[0].device)
    finite = tree_all_finite(grads)
    old_p = [p.clone() for p in params]
    old_mu = [m.clone() for m in opt_state.get("mu", [])]
    updates, new_state = opt.update(grads, opt_state, params)
    apply_updates(params, updates)
    for p, o in zip(params, old_p):
        p.copy_(torch.where(finite, p, o))
    for m, o in zip(new_state.get("mu", []), old_mu):
        m.copy_(torch.where(finite, m, o))
    return params, new_state, 1.0 - finite.float()


def make_train_step(cfg: ArchConfig, opt):
    """Exact-sync step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on the whole batch — the perfectly-consistent baseline every
    relaxation is compared against."""

    def step(params, opt_state, batch):
        loss, parts, grads = mean_grads(cfg, params, batch)
        flat_g = T.leaves(grads)
        metrics = {"loss": loss, "grad_norm": global_norm(flat_g), **parts}
        _, opt_state, _ = guarded_update(opt, flat_g, opt_state,
                                         T.leaves(params),
                                         skip_nonfinite=False)
        return params, opt_state, metrics

    return step


def init_dist_sync_state(scfg: SyncConfig, n_workers: int,
                         params_like) -> dict:
    """State of :func:`make_elastic_train_step`: ``step`` and, for the
    compressed and elastic strategies, one f32 accumulator per worker (EF
    residual or deferred residual) with a leading worker dim, on the
    params' device."""
    return init_sync_state(scfg, params_like, n_workers)


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
    batch) -> (params, opt_state, sync_state, metrics)`` over ``n_workers``
    in-process workers.  Metrics: ``loss`` (mean over workers) and
    ``gap2_over_alpha2``.

    A step is two halves, as in `repro_torch.dist.async_engine`:
    :meth:`worker_grads` yields each worker's ``(loss, grads)`` and
    :meth:`sync_update` consumes them one worker at a time, syncs them and
    applies the optimizer, so that a test can feed it gradients from
    elsewhere.  Params, optimizer state and sync state are updated in
    place.  ``static_phase`` is the elastic static gate's phase, fixed when
    the step is built (as the reference compiles one program a phase)."""

    def __init__(self, cfg: ArchConfig, opt, scfg: SyncConfig,
                 n_workers: int, specs, static_phase: int = 0):
        self.cfg, self.opt, self.scfg = cfg, opt, scfg
        self.n, self.specs, self.static_phase = n_workers, specs, static_phase

    def worker_grads(self, params, batch: dict):
        """Gradient half: yield ``(loss, grads)`` per worker, in order."""
        yield from worker_grads(self.cfg, params, batch, self.n)

    def __call__(self, params, opt_state, state: dict, batch: dict):
        return self.sync_update(params, opt_state, state,
                                self.worker_grads(params, batch))

    def sync_update(self, params, opt_state, state: dict, worker_grads):
        """Sync/update half over an iterable of per-worker ``(loss,
        grads)``."""
        pairs = _CollectLosses(worker_grads)
        synced, state, smetrics = sync_gradients(
            self.scfg, pairs, state, specs=self.specs,
            static_phase=self.static_phase)
        if len(pairs.losses) != self.n:
            raise ValueError(f"got gradients of {len(pairs.losses)} "
                             f"workers, expected {self.n}")
        _, opt_state, _ = guarded_update(self.opt, T.leaves(synced),
                                         opt_state, T.leaves(params),
                                         skip_nonfinite=False)
        metrics = {"loss": pmean(pairs.losses),
                   "gap2_over_alpha2": smetrics["gap2_over_alpha2"]}
        return params, opt_state, state, metrics


def make_elastic_train_step(cfg: ArchConfig, opt, scfg: SyncConfig,
                            n_workers: int, specs, static_phase: int = 0):
    """The relaxed-sync step over ``n_workers`` in-process workers
    (gradient accumulation is not ported: one microbatch a worker)."""
    return ElasticTrainStep(cfg, opt, scfg, n_workers, specs, static_phase)


# ---------------------------------------------------------------------------
# serving steps (the dense legacy loop: the paged engine's oracle)
# ---------------------------------------------------------------------------

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
        return sample_tokens(logits[:, -1, :], sc, gen), cache

    return prefill_step


def make_decode_step(cfg: ArchConfig, sample=None):
    """``(params, cache, tokens (B, 1), gen=None) -> (tokens (B,),
    cache)``: one batched decode step at position ``cache["pos"]``; the
    cache is updated in place."""
    sc = sample or SampleConfig()

    @torch.no_grad()
    def decode_step(params, cache, tokens, gen=None):
        logits, cache = TF.decode_step(cfg, params, cache, tokens)
        return sample_tokens(logits[:, -1, :], sc, gen), cache

    return decode_step
