"""Loss, gradients and the exact-sync train step (counterpart of
``repro.dist.train``).

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
from repro_torch.models import transformer as TF
from repro_torch.optim import apply_updates, global_norm


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
