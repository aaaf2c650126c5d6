"""Model assembly (counterpart of ``repro.models.transformer``) for two
stacks: the uniform-window attention stack, dense or MoE, and the Mamba2
stack with zamba2's shared attention block.  Each has the training
forward and the serving ``prefill`` / ``decode_step`` over dense caches
(for attention, the paged engine's oracle).

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
import torch.nn.functional as F

from repro_torch.configs.base import (BLOCK_ATTN, BLOCK_MAMBA2,
                                      FRONTEND_NONE, ArchConfig)
from repro_torch import tree as T
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models.layers import (COMPUTE_DTYPE, attention_block,
                                       attention_defs, mlp_block, mlp_defs,
                                       rmsnorm, rmsnorm_def)
from repro_torch.models.params import ParamDef, stack_defs


def _check_supported(cfg: ArchConfig) -> None:
    mamba = cfg.block_type == BLOCK_MAMBA2
    attn = (cfg.block_type == BLOCK_ATTN and not cfg.shared_attn_every
            and len(set(cfg.layer_window_sizes())) <= 1)
    if not (mamba or attn) or cfg.frontend != FRONTEND_NONE:
        raise NotImplementedError(
            f"{cfg.name}: the port runs only the uniform-window attention "
            "stack (dense or MoE) and the Mamba2 stack (optionally with a "
            "shared attention block)")


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
    if cfg.block_type == BLOCK_MAMBA2:
        layer = {"ln": rmsnorm_def(d), "mamba": M2.mamba2_defs(cfg)}
    else:
        layer = {
            "ln_attn": rmsnorm_def(d),
            "attn": attention_defs(cfg),
            "ln_mlp": rmsnorm_def(d),
        }
        if cfg.is_moe:
            layer["moe"] = MOE.moe_defs(cfg)
        else:
            layer["mlp"] = mlp_defs(d, cfg.d_ff)
    defs["layers"] = stack_defs(layer, cfg.n_layers)
    if cfg.shared_attn_every:
        defs["shared_attn"] = {
            "ln_attn": rmsnorm_def(d),
            "attn": attention_defs(cfg),
            "ln_mlp": rmsnorm_def(d),
            "mlp": mlp_defs(d, cfg.d_ff),
        }
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


def attn_stack(cfg: ArchConfig, stacked, x, positions, sinks=None, *,
               kv_caches=None, cache_index=None, collect_kv=False):
    """Run the uniform attention stack.  Returns ``(x, aux_sum, kvs)``:
    ``kvs`` is the stacked (L, B, S, K, D) ``(k, v)`` of every layer with
    ``collect_kv``, the caches ``kv_caches`` (each (L, B, T, K, D),
    written in place at ``cache_index``) when decoding, else None."""
    window = cfg.layer_window_sizes()[0] if cfg.n_layers else 0
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = kv_caches
    for i, lp in enumerate(_layer_slices(stacked, cfg.n_layers, sinks)):
        cache = None if kv_caches is None else (kv_caches[0][i],
                                                kv_caches[1][i])
        h, kv = attention_block(lp["attn"], cfg,
                                rmsnorm(x, lp["ln_attn"], cfg.norm_eps),
                                positions, window=window, kv_cache=cache,
                                cache_index=cache_index)
        if collect_kv:
            if kvs is None:
                kvs = tuple(torch.empty((cfg.n_layers, *a.shape),
                                        dtype=a.dtype, device=a.device)
                            for a in kv)
            kvs[0][i].copy_(kv[0])
            kvs[1][i].copy_(kv[1])
        x = x + h
        y = rmsnorm(x, lp["ln_mlp"], cfg.norm_eps)
        if cfg.is_moe:
            out, a = MOE.moe_block(lp["moe"], cfg, y)
            aux = aux + a
        else:
            out = mlp_block(lp["mlp"], y)
        x = x + out
    return x, aux, kvs


def _shared_attn(cfg: ArchConfig, sp, x, positions, cache=None,
                 cache_index=None):
    """zamba2's shared transformer block (attention over a full causal
    window, then the gated MLP).  Returns (x, kv) as ``attention_block``.
    The attention runs inside a ``shared_attention`` profiler range."""
    with torch.profiler.record_function("shared_attention"):
        h, kv = attention_block(sp["attn"], cfg,
                                rmsnorm(x, sp["ln_attn"], cfg.norm_eps),
                                positions, window=cfg.sliding_window,
                                kv_cache=cache, cache_index=cache_index)
    x = x + h
    return x + mlp_block(sp["mlp"], rmsnorm(x, sp["ln_mlp"],
                                            cfg.norm_eps)), kv


def ssm_stack(cfg: ArchConfig, params, x, positions, sinks=None, *,
              states=None, attn_caches=None, cache_index=None,
              collect_len: int = 0):
    """Run the Mamba2 stack, layer by layer.  With ``shared_attn_every``
    (zamba2) the shared block runs before layers 0, every, 2 every, ...:
    ``ceil(n_layers / every)`` invocations, each with its own KV cache.

    Prefill (``collect_len > 0``): returns the per-layer states stacked
    ``{"conv_x", "conv_bc", "ssm"}`` (L, ...) and the invocations' caches
    ``(k, v)``, each (n_seg, B, collect_len, K, D) in the compute dtype
    with the prompt's keys and values in its first S positions.  Decode
    (``states`` and ``attn_caches`` given, x (B, 1, d)): both are updated
    in place at layer i / position ``cache_index`` and returned.
    Otherwise (training forward) returns ``(x, None, None)``."""
    every = cfg.shared_attn_every
    n_seg = -(-cfg.n_layers // every) if every else 0
    kvs, sts = attn_caches, states
    for i, lp in enumerate(_layer_slices(params["layers"], cfg.n_layers,
                                         sinks)):
        if every and i % every == 0:
            seg = i // every
            cache = None if attn_caches is None else (attn_caches[0][seg],
                                                      attn_caches[1][seg])
            x, kv = _shared_attn(cfg, params["shared_attn"], x, positions,
                                 cache, cache_index)
            if collect_len:
                if kvs is None:
                    shape = (n_seg, kv[0].shape[0], collect_len,
                             *kv[0].shape[2:])
                    kvs = tuple(torch.zeros(shape, dtype=COMPUTE_DTYPE,
                                            device=x.device)
                                for _ in range(2))
                for buf, a in zip(kvs, kv):
                    buf[seg, :, :a.shape[1]].copy_(a)
        st = None if states is None else {k: a[i] for k, a in states.items()}
        h, new_st = M2.mamba2_block(lp["mamba"], cfg,
                                    rmsnorm(x, lp["ln"], cfg.norm_eps),
                                    state=st)
        x = x + h
        if collect_len and sts is None:
            sts = {k: torch.empty((cfg.n_layers, *a.shape), dtype=a.dtype,
                                  device=a.device)
                   for k, a in new_st.items()}
        if sts is not None:
            for k, a in new_st.items():
                sts[k][i].copy_(a)
    return x, sts, kvs


def forward(cfg: ArchConfig, params, batch: dict, layer_sinks=None):
    """Training forward: returns (logits (B, S, V) f32, aux_loss).
    ``layer_sinks`` (a tree like ``params["layers"]``) receives the layer
    leaves' gradients on backward (see :class:`_LayerSlice`)."""
    x = embed_input(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.block_type == BLOCK_MAMBA2:
        x, _, _ = ssm_stack(cfg, params, x, positions, layer_sinks)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        x, aux, _ = attn_stack(cfg, params["layers"], x, positions,
                               layer_sinks)
    return lm_logits(cfg, params, x), aux


# ---------------------------------------------------------------------------
# serving over dense (B, max_len) caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch_size: int, max_len: int,
               device=None) -> dict:
    """Zeroed serving cache.  Attention stack: ``{"pos": 0, "kv": (k,
    v)}``, each (L, B, max_len, K, D) in the compute dtype.  Mamba2 stack:
    ``{"pos": 0, "state": {...}}`` of f32 zeros stacked over layers, and
    with a shared attention block ``"attn_kv"``, each (n_seg, B, max_len,
    K, D)."""
    def kv(n):
        shape = (n, batch_size, max_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return tuple(torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)
                     for _ in range(2))

    if cfg.block_type != BLOCK_MAMBA2:
        return {"pos": 0, "kv": kv(cfg.n_layers)}
    init = M2.mamba2_init_state(cfg, batch_size, device)
    cache = {"pos": 0, "state": {
        k: torch.zeros((cfg.n_layers, *a.shape), dtype=a.dtype,
                       device=device) for k, a in init.items()}}
    if cfg.shared_attn_every:
        cache["attn_kv"] = kv(-(-cfg.n_layers // cfg.shared_attn_every))
    return cache


def prefill(cfg: ArchConfig, params, batch: dict, max_len: int):
    """Run the prompt; returns (last-token logits (B, 1, V), cache) with the
    KV caches padded to ``max_len`` positions, in the compute dtype (the
    Mamba2 stack: its per-layer states, conv carries in the compute dtype
    and SSM states f32, and its shared block's caches)."""
    x = embed_input(cfg, params, batch)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    if cfg.block_type == BLOCK_MAMBA2:
        x, states, kvs = ssm_stack(cfg, params, x, positions,
                                   collect_len=max_len)
        cache = {"pos": s, "state": states}
        if cfg.shared_attn_every:
            cache["attn_kv"] = kvs
        return lm_logits(cfg, params, x[:, -1:]), cache
    x, _, kvs = attn_stack(cfg, params["layers"], x, positions,
                           collect_kv=True)
    kv = tuple(F.pad(a, (0, 0, 0, 0, 0, max_len - s)).to(COMPUTE_DTYPE)
               for a in kvs)
    return lm_logits(cfg, params, x[:, -1:]), {"pos": s, "kv": kv}


def decode_step(cfg: ArchConfig, params, cache: dict, tokens):
    """One decode step: tokens (B, 1) at position ``cache["pos"]``.  The
    cache's tensors are updated in place.  Returns (logits (B, 1, V),
    new_cache)."""
    pos = cache["pos"]
    x = params["embed"][tokens.long()].to(COMPUTE_DTYPE)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.long,
                           device=x.device)
    if cfg.block_type == BLOCK_MAMBA2:
        x, _, _ = ssm_stack(cfg, params, x, positions,
                            states=cache["state"],
                            attn_caches=cache.get("attn_kv"),
                            cache_index=pos)
        return lm_logits(cfg, params, x), {**cache, "pos": pos + 1}
    x, _, kvs = attn_stack(cfg, params["layers"], x, positions,
                           kv_caches=cache["kv"], cache_index=pos)
    return lm_logits(cfg, params, x), {"pos": pos + 1, "kv": kvs}
