"""Model assembly for the dense attention stack (counterpart of the
uniform-window branch of ``repro.models.transformer``).

Parameters keep the reference's stacked layout (leading ``n_layers`` dim
on every layer leaf); the stack loops over layers in Python.  Each layer's
slice of a stacked leaf is taken by :class:`_LayerSlice`, whose backward
writes that layer's gradient straight into row ``i`` of a preallocated
gradient of the whole leaf (a *sink*).  Taking the slices with ``unbind``
instead would hold all 28 per-layer gradients until the last arrives and
then stack them into a new tensor: two copies of every layer gradient at
once, about 6.4 GB more at the peak of the full-width step.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import BLOCK_ATTN, FRONTEND_NONE, ArchConfig
from repro_torch import tree as T
from repro_torch.models.layers import (COMPUTE_DTYPE, attention_block,
                                       attention_defs, mlp_block, mlp_defs,
                                       rmsnorm, rmsnorm_def)
from repro_torch.models.params import ParamDef, stack_defs


def _check_supported(cfg: ArchConfig) -> None:
    if (cfg.block_type != BLOCK_ATTN or cfg.is_moe or cfg.shared_attn_every
            or cfg.frontend != FRONTEND_NONE
            or len(set(cfg.layer_window_sizes())) > 1):
        raise NotImplementedError(
            f"{cfg.name}: the port runs only the dense uniform-window "
            "attention stack")


def model_defs(cfg: ArchConfig) -> dict:
    """Full ParamDef tree (same keys, shapes and axes as the reference)."""
    _check_supported(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    defs: dict = {
        "embed": ParamDef((v, d), ("vocab", "embed"), scale=d ** -0.5),
        "final_norm": rmsnorm_def(d),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v), ("embed", "vocab"))
    layer = {
        "ln_attn": rmsnorm_def(d),
        "attn": attention_defs(cfg),
        "ln_mlp": rmsnorm_def(d),
        "mlp": mlp_defs(d, cfg.d_ff),
    }
    defs["layers"] = stack_defs(layer, cfg.n_layers)
    return defs


def embed_input(cfg: ArchConfig, params, batch: dict) -> torch.Tensor:
    """Token embedding -> (B, S, d) in the compute dtype."""
    return params["embed"][batch["tokens"]].to(COMPUTE_DTYPE)


def lm_logits(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head (tied to the embedding when configured); bf16
    operands, f32 logits."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", x.float(),
                        head.to(x.dtype).float())


class _LayerSlice(torch.autograd.Function):
    """``stacked[i]``, with the gradient written into ``sink[i]``."""

    @staticmethod
    def forward(ctx, stacked, i, sink):
        ctx.i, ctx.sink = i, sink
        return stacked[i]

    @staticmethod
    def backward(ctx, grad):
        ctx.sink[ctx.i].copy_(grad)
        return None, None, None


def _layer_slices(stacked, n_layers: int, sinks=None) -> list[dict]:
    """Per-layer parameter dicts.  With ``sinks`` (a tree like ``stacked``
    of gradient buffers) the slices route their gradients into the sinks;
    without, they are plain views ``stacked[i]``."""
    flat, td = T.flatten(stacked)
    flat_s = T.leaves(sinks) if sinks is not None else [None] * len(flat)
    return [T.unflatten(td, [a[i] if s is None else _LayerSlice.apply(a, i, s)
                             for a, s in zip(flat, flat_s)])
            for i in range(n_layers)]


def attn_stack(cfg: ArchConfig, stacked, x, positions, sinks=None):
    """Run the uniform attention stack.  Returns (x, aux_sum)."""
    window = cfg.layer_window_sizes()[0] if cfg.n_layers else 0
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _layer_slices(stacked, cfg.n_layers, sinks):
        h = attention_block(lp["attn"], cfg,
                            rmsnorm(x, lp["ln_attn"], cfg.norm_eps),
                            positions, window=window)
        x = x + h
        x = x + mlp_block(lp["mlp"], rmsnorm(x, lp["ln_mlp"], cfg.norm_eps))
    return x, aux


def forward(cfg: ArchConfig, params, batch: dict, layer_sinks=None):
    """Training forward: returns (logits (B, S, V) f32, aux_loss).
    ``layer_sinks`` (a tree like ``params["layers"]``) receives the layer
    leaves' gradients on backward (see :class:`_LayerSlice`)."""
    x = embed_input(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = attn_stack(cfg, params["layers"], x, positions, layer_sinks)
    return lm_logits(cfg, params, x), aux
