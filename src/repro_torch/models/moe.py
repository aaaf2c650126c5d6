"""GShard-style capacity-based Mixture-of-Experts layer (counterpart of
``repro.models.moe``).

Routing produces dense dispatch/combine tensors over fixed-size token
groups, and the expert FFN is a batched product over the expert dim.  The
semantics are the reference's exactly: top-k by a *stable* descending sort
of the router probabilities (the lowest expert index wins a tie), each
(token, choice) placed in its expert's capacity buffer by an exclusive
cumulative count over (token, choice), and tokens past the capacity
dropped.  Routing is per group, so tokens of one group (rows of one batch)
compete for capacity: batch rows are coupled.

Under a `repro_torch.models.actx` model group (expert parallelism) the
expert leaves are this rank's ``E / m`` experts.  Routing stays
replicated: every model rank computes the same bits of ``route`` from the
whole (gathered) router, so capacity drops are the same on every rank.
The rank slices ``dispatch`` and ``combine`` to its experts, runs the
three expert products on its shards, and the combined outputs are summed
over the group (``reduce_out``).  The router's gradient has two parts: the
aux loss's is whole on every rank, the combine weights' partial (this
rank's experts only).  So the combine takes its logits through
``copy_in`` (summed backward) and the aux loss takes them as they are:
each part reaches the router once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import actx
from repro_torch.models.params import ParamDef

# Tokens are routed within fixed-size groups so the dispatch tensor is
# O(tokens * k * capacity_factor) rather than O(tokens * seq * ...).
GROUP_SIZE = 512


def moe_defs(cfg) -> dict:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    return {
        "router": ParamDef((d, e), ("embed", None), scale=d ** -0.5),
        "w_gate": ParamDef((e, d, ff), ("experts", "embed", "ff")),
        "w_up": ParamDef((e, d, ff), ("experts", "embed", "ff")),
        "w_down": ParamDef((e, ff, d), ("experts", "ff", "embed")),
    }


def capacity(group: int, k: int, n_experts: int, factor: float) -> int:
    """Per-expert slots of a group: rounded up to a multiple of 4, at
    least 4."""
    cap = int(group * k * factor / n_experts)
    return max(4, -(-cap // 4) * 4)


def route(router_logits: torch.Tensor, k: int, cap: int,
          aux_logits: torch.Tensor | None = None):
    """Top-k routing with per-expert capacity.

    router_logits: (G, T, E).  Returns (dispatch (G, T, E, C) 0/1 f32,
    combine (G, T, E, C) f32, aux_loss scalar f32).  ``aux_logits`` (the
    same values; default ``router_logits``) are the logits the aux loss's
    router probabilities are taken from, for a gradient routed apart."""
    g, t, e = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    aux_probs = probs if aux_logits is None \
        else torch.softmax(aux_logits.float(), dim=-1)
    topk_idx = torch.argsort(-probs, dim=-1, stable=True)[..., :k]
    topk_probs = torch.gather(probs, -1, topk_idx)
    topk_probs = topk_probs / torch.sum(topk_probs, dim=-1, keepdim=True)

    # load-balancing auxiliary loss (Switch/GShard form)
    sel = F.one_hot(topk_idx, e)                               # (G, T, k, E)
    me = torch.mean(aux_probs, dim=1)                          # (G, E)
    ce = torch.mean(torch.sum(sel, dim=2).float(), dim=1)      # (G, E)
    aux = torch.mean(me * ce) * e * e

    # position of each (token, choice) within its expert's capacity buffer
    flat = sel.reshape(g, t * k, e)
    pos_in_expert = torch.cumsum(flat, dim=1) - flat           # (G, T*k, E)
    pos = torch.sum(pos_in_expert * flat, dim=-1).reshape(g, t, k)
    fits = pos < cap

    w = topk_probs * fits.float()                              # (G, T, k)
    onehot_cap = F.one_hot(torch.where(fits, pos, cap),
                           cap + 1).float()[..., :cap]         # (G, T, k, C)
    sel_f = sel.float()
    combine = torch.einsum("gtk,gtke,gtkc->gtec", w, sel_f, onehot_cap)
    dispatch = torch.einsum("gtke,gtkc->gtec", sel_f,
                            onehot_cap * fits[..., None].float())
    return dispatch, combine, aux


def moe_block(params, cfg, x: torch.Tensor):
    """x: (B, S, d) -> (B, S, d), plus the aux loss.  The B * S tokens are
    routed in groups of ``min(GROUP_SIZE, B * S)``, which must divide
    them.  Under a model group the expert leaves are this rank's experts
    (see the module docstring)."""
    b, s, d = x.shape
    dt = x.dtype
    e, k = cfg.n_experts, cfg.experts_per_token
    tokens = x.reshape(-1, d)
    n = tokens.shape[0]
    gsz = min(GROUP_SIZE, n)
    if n % gsz:
        raise ValueError(f"moe_block: {n} tokens are not a multiple of the "
                         f"routing group {gsz}")
    groups = tokens.reshape(n // gsz, gsz, d)

    # the profiler's "moe_dispatch" range: routing and the dispatch product
    with torch.profiler.record_function("moe_dispatch"):
        logits = torch.einsum("gtd,de->gte", groups,
                              params["router"].to(dt))
        cap = capacity(gsz, k, e, cfg.capacity_factor)
        ctx = actx.current()
        if ctx is None:
            dispatch, combine, aux = route(logits, k, cap)
        else:
            dispatch, combine, aux = route(actx.copy_in(logits), k, cap,
                                           aux_logits=logits)
            n = e // ctx.size
            dispatch = dispatch[:, :, ctx.rank * n:(ctx.rank + 1) * n]
            combine = combine[:, :, ctx.rank * n:(ctx.rank + 1) * n]
        xe = torch.einsum("gtec,gtd->egcd", dispatch.to(dt),
                          actx.copy_in(groups))
    gate = F.silu(torch.einsum("egcd,edf->egcf", xe,
                               params["w_gate"].to(dt)))
    up = torch.einsum("egcd,edf->egcf", xe, params["w_up"].to(dt))
    out_e = torch.einsum("egcf,efd->egcd", gate * up,
                         params["w_down"].to(dt))
    out = torch.einsum("egcd,gtec->gtd", out_e, combine.to(dt))
    return actx.reduce_out(out.reshape(b, s, d)), aux
