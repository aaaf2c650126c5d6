"""Model assembly (counterpart of ``repro.models.transformer``) for three
stacks: the attention stack, dense or MoE, with a uniform window or
gemma3's local:global pattern; the Mamba2 stack with zamba2's shared
attention block; and the RWKV6 stack.  Each has the training forward and
the serving ``prefill`` / ``decode_step`` over dense caches (for
attention, the paged engine's oracle).  ``forward`` and ``prefill`` take
the vision and audio frontend stubs' embeddings from the batch
(:func:`embed_input`); ``decode_step`` embeds tokens.

Parameters keep the reference's stacked layout (leading ``n_layers`` dim
on every layer leaf); the stack loops over layers in Python, so each
layer takes its own window from ``cfg.layer_window_sizes()`` and the
reference's grouping of gemma3's layers (a ``lax.scan`` needs a static
window) has no counterpart.  Each layer's slice of a stacked leaf is
taken by :class:`_LayerSlice`, whose backward writes that layer's
gradient straight into row ``i`` of a preallocated gradient of the whole
leaf (a *sink*).  Taking the slices with ``unbind`` instead would hold all
28 per-layer gradients until the last arrives and then stack them into a
new tensor: two copies of every layer gradient at once, about 6.4 GB more
at the peak of the full-width step.

Under autograd each RWKV6 layer runs under ``torch.utils.checkpoint``
(the counterpart of the reference's default ``RunFlags(remat=True)``):
its WKV keeps three (B, C, C, H, N) f32 tensors a chunk for backward,
about 0.8 GB a layer of full-width rwkv6-1.6b at 2 sequences of 256, so
the layer's activations are recomputed in backward instead of kept for
all 24 layers.  The slices are taken outside the checkpointed function,
so each sink row is written once, by the recomputed graph's backward.

Tensor parallelism (``--model-shards m``): under a
`repro_torch.models.actx` model group each rank holds its model shard of
every leaf, by the reference's spec (:func:`tp_specs`), and runs the
Megatron layout.  The attention runs the rank's ``H / m`` query heads and
``K / m`` kv heads, ``wo`` row-parallel; the MLP is column-parallel on
``ff`` and row-parallel on ``w_down``; the MoE runs the rank's ``E / m``
experts (`repro_torch.models.moe`); Mamba2 and RWKV6 run the rank's ``H /
m`` heads (`repro_torch.models.mamba2`, `repro_torch.models.rwkv6`), and
zamba2's shared block runs as the attention stack's layers do.  The
embedding is a vocab-parallel lookup and the LM head gives logits sharded
on the vocab.  A leaf sharded on a dim its layer does not split (the norm
scales on ``embed``, the router, RWKV6's mixes; ``embed`` and ``lm_head``
on ``embed`` when the vocab does not divide ``m``) is gathered whole; a
replicated leaf that only head-local activations use (``q_norm``,
``k_norm``, RWKV6's ``bonus_u``, of which the rank takes its heads' rows)
goes through ``copy_in``, so that its partial gradients are summed over
the group.  Each family's split leaves are in :data:`_TP`; an ``m`` at
which the reference's spec would put one of them on another dim is
refused (:func:`check_tensor_parallel`).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (BLOCK_ATTN, BLOCK_MAMBA2, BLOCK_RWKV6,
                                      FRONTEND_AUDIO, FRONTEND_VISION,
                                      ArchConfig)
from repro_torch import tree as T
from repro_torch.models import actx
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R6
from repro_torch.models.layers import (COMPUTE_DTYPE, attention_block,
                                       attention_defs, mlp_block, mlp_defs,
                                       rmsnorm, rmsnorm_def)
from repro_torch.models.params import ParamDef, param_specs, stack_defs


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.block_type not in (BLOCK_ATTN, BLOCK_MAMBA2, BLOCK_RWKV6):
        raise ValueError(f"{cfg.name}: unknown block {cfg.block_type!r}")


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
    elif cfg.block_type == BLOCK_RWKV6:
        layer = R6.rwkv6_defs(cfg)
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


# per family: the per-layer dim each split leaf must be sharded on (the
# reference's attn_q / attn_kv, ffn_hidden, moe_expert and ssm points;
# RWKV6's ln_x and decay_bias are used on the rank's heads, their embed
# slice), and the replicated leaves that only head-local activations use,
# with the dim of which the rank takes its heads' share (None: whole)
_ATTN = {("attn", "wq"): 1, ("attn", "wk"): 1, ("attn", "wv"): 1,
         ("attn", "wo"): 0}
_MLP = {("mlp", "w_gate"): 1, ("mlp", "w_up"): 1, ("mlp", "w_down"): 0}
_QK_NORMS = {("attn", "q_norm"): None, ("attn", "k_norm"): None}
_TP = {
    "attention": ({**_ATTN, **_MLP}, _QK_NORMS),
    "MoE": ({**_ATTN, ("moe", "w_gate"): 0, ("moe", "w_up"): 0,
             ("moe", "w_down"): 0}, _QK_NORMS),
    "Mamba2": ({("mamba", k): dim for k, dim in (
        ("z_proj", 1), ("x_proj", 1), ("dt_proj", 1), ("conv_x_w", 1),
        ("conv_x_b", 0), ("a_log", 0), ("dt_bias", 0), ("d_skip", 0),
        ("gate_norm", 0), ("out_proj", 0))}, {}),
    "RWKV6": ({(k,): dim for k, dim in (
        ("w_r", 1), ("w_k", 1), ("w_v", 1), ("w_g", 1), ("w_decay", 1),
        ("cm_r", 1), ("cm_k", 1), ("w_o", 0), ("cm_v", 0), ("ln_x", 0),
        ("decay_bias", 0))}, {("bonus_u",): 0}),
}


def _family(cfg: ArchConfig) -> str:
    """The key of ``cfg``'s layers in :data:`_TP`."""
    if cfg.block_type == BLOCK_MAMBA2:
        return "Mamba2"
    if cfg.block_type == BLOCK_RWKV6:
        return "RWKV6"
    return "MoE" if cfg.is_moe else "attention"


def tp_specs(cfg: ArchConfig, m: int):
    """The reference's param specs of ``cfg`` at a model axis of ``m``."""
    return param_specs(model_defs(cfg), {"model": m})


def check_tensor_parallel(cfg: ArchConfig, m: int) -> None:
    """Raise ``ValueError`` unless ``cfg`` runs over ``m`` model shards:
    every split leaf of its family (and of zamba2's shared block) must be
    sharded on its dim by the reference's spec, and RWKV6's heads must not
    be cut (its ``dinner`` is ``ssm_heads`` x ``ssm_state``).  The message
    names each such dim that ``m`` does not divide, and the leaves that
    the reference would shard on another dim instead."""
    if m <= 1:
        return
    defs, specs = model_defs(cfg), tp_specs(cfg, m)
    blocks = [("layers", _TP[_family(cfg)][0], 1)]
    if cfg.shared_attn_every:
        blocks.append(("shared_attn", _TP["attention"][0], 0))
    dims, fell = {}, []
    for block, split, lead in blocks:
        for key, dim in split.items():
            spec = functools.reduce(dict.__getitem__, key, specs[block])
            if actx.model_dim(spec) != dim + lead:
                d = functools.reduce(dict.__getitem__, key, defs[block])
                dims[d.axes[dim + lead]] = d.shape[dim + lead]
                fell.append("/".join((block, *key)))
    if cfg.block_type == BLOCK_RWKV6 and cfg.ssm_heads % m:
        dims["heads"] = cfg.ssm_heads
    if dims:
        raise ValueError(
            f"{cfg.name}: --model-shards {m} must divide "
            + ", ".join(f"{axis} {n}" for axis, n in dims.items())
            + (f" (the reference would shard {', '.join(fell)} on another "
               "dim)" if fell else " (it would cut an RWKV6 head)"))


def _tp_layer(lp: dict, specs: dict, family: str, lead: int = 1) -> dict:
    """One layer's leaves (or zamba2's shared block's, ``lead`` 0: no
    stacked layers dim) as its blocks use them under a model group: the
    split leaves of ``family`` as they are, the other sharded leaves
    gathered whole, the head-local replicated leaves behind ``copy_in``
    (and cut to the rank's heads where :data:`_TP` names a dim)."""
    split, local = _TP[family]
    ctx = actx.current()
    flat, td = T.flatten(lp)
    out = []
    for path, a, spec in zip(T.paths(lp), flat, T.leaves(specs)):
        key, dim = tuple(path.split("/")), actx.model_dim(spec)
        if key in split:
            out.append(a)
        elif dim is not None:
            out.append(actx.gather_leaf(a, dim - lead))
        elif key in local:
            a = actx.copy_in(a)
            cut = local[key]
            if cut is not None:
                n = a.shape[cut] // ctx.size
                a = a.narrow(cut, ctx.rank * n, n)
            out.append(a)
        else:
            out.append(a)
    return T.unflatten(td, out)


def _head_dim(cfg: ArchConfig, m: int):
    """Under a model group: the dim ``embed`` (tied) or ``lm_head`` is
    sharded on, and whether that splits the vocab."""
    specs = tp_specs(cfg, m)
    if cfg.tie_embeddings:
        dim = actx.model_dim(specs["embed"])
        return dim, dim == 0
    dim = actx.model_dim(specs["lm_head"])
    return dim, dim == 1


def logits_vocab_start(cfg: ArchConfig) -> int | None:
    """The first vocab id of this rank's logits when :func:`lm_logits`
    gives them sharded on the vocab; ``None`` when they are whole."""
    ctx = actx.current()
    if ctx is None or not _head_dim(cfg, ctx.size)[1]:
        return None
    return ctx.rank * (cfg.vocab_size // ctx.size)


def embed_input(cfg: ArchConfig, params, batch: dict) -> torch.Tensor:
    """Token or frontend embedding -> (B, S, d) in the compute dtype.

    The audio and vision frontends are stubs, as in the reference: an
    audio batch's ``frame_embeds`` (B, S, d) replace the token embeddings,
    a vision batch's ``patch_embeds`` (B, P, d) replace the first P
    positions' token embeddings.  A batch without them embeds its tokens
    only."""
    if cfg.frontend == FRONTEND_AUDIO and "frame_embeds" in batch:
        return batch["frame_embeds"].to(COMPUTE_DTYPE)
    ctx = actx.current()
    if ctx is None:
        x = params["embed"][batch["tokens"].long()].to(COMPUTE_DTYPE)
    elif actx.model_dim(tp_specs(cfg, ctx.size)["embed"]) == 0:
        # vocab-parallel: this rank's rows, zero elsewhere, summed
        emb = params["embed"]
        v = emb.shape[0]
        local = batch["tokens"].long() - ctx.rank * v
        inside = (local >= 0) & (local < v)
        rows = emb[torch.where(inside, local, torch.zeros_like(local))]
        x = actx.reduce_out((rows * inside[..., None]).to(COMPUTE_DTYPE))
    else:
        emb = actx.gather_leaf(params["embed"], 1)
        x = emb[batch["tokens"].long()].to(COMPUTE_DTYPE)
    if cfg.frontend == FRONTEND_VISION and "patch_embeds" in batch:
        p = batch["patch_embeds"].shape[1]
        x = torch.cat([batch["patch_embeds"].to(COMPUTE_DTYPE), x[:, p:]],
                      dim=1)
    return x


def lm_logits(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head (tied to the embedding when configured); bf16
    operands, f32 logits."""
    ctx = actx.current()
    if ctx is None:
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        head = params["embed"].t() if cfg.tie_embeddings \
            else params["lm_head"]
    else:
        specs = tp_specs(cfg, ctx.size)
        x = rmsnorm(x, actx.gather_leaf(
            params["final_norm"], actx.model_dim(specs["final_norm"])),
            cfg.norm_eps)
        dim, split = _head_dim(cfg, ctx.size)
        leaf = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        if split:
            x = actx.copy_in(x)
        else:
            leaf = actx.gather_leaf(leaf, dim)
        head = leaf.t() if cfg.tie_embeddings else leaf
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
    """Run the attention stack, layer ``i`` with its own window
    ``cfg.layer_window_sizes()[i]``.  Returns ``(x, aux_sum, kvs)``:
    ``kvs`` is the stacked (L, B, S, K, D) ``(k, v)`` of every layer with
    ``collect_kv``, the caches ``kv_caches`` (each (L, B, T, K, D),
    written in place at ``cache_index``) when decoding, else None."""
    windows = cfg.layer_window_sizes()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = kv_caches
    ctx = actx.current()
    specs = tp_specs(cfg, ctx.size)["layers"] if ctx is not None else None
    for i, lp in enumerate(_layer_slices(stacked, cfg.n_layers, sinks)):
        if ctx is not None:
            lp = _tp_layer(lp, specs, _family(cfg))
        cache = None if kv_caches is None else (kv_caches[0][i],
                                                kv_caches[1][i])
        h, kv = attention_block(
            lp["attn"], cfg,
            actx.copy_in(rmsnorm(x, lp["ln_attn"], cfg.norm_eps)),
            positions, window=windows[i], kv_cache=cache,
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
            out = mlp_block(lp["mlp"], actx.copy_in(y))
        x = x + out
    return x, aux, kvs


def _shared_attn(cfg: ArchConfig, sp, x, positions, cache=None,
                 cache_index=None):
    """zamba2's shared transformer block (attention over a full causal
    window, then the gated MLP).  Returns (x, kv) as ``attention_block``.
    The attention runs inside a ``shared_attention`` profiler range.
    Under a model group ``sp`` is :func:`_tp_layer`'s, and the attention
    and the MLP take their inputs through ``copy_in``."""
    with torch.profiler.record_function("shared_attention"):
        h, kv = attention_block(
            sp["attn"], cfg,
            actx.copy_in(rmsnorm(x, sp["ln_attn"], cfg.norm_eps)),
            positions, window=cfg.sliding_window, kv_cache=cache,
            cache_index=cache_index)
    x = x + h
    return x + mlp_block(sp["mlp"], actx.copy_in(
        rmsnorm(x, sp["ln_mlp"], cfg.norm_eps))), kv


def _ssm_layer(cfg: ArchConfig, lp, x, st):
    """One Mamba2 or RWKV6 layer with its residual: ``(x, new state)``.
    The RWKV6 block applies its own pre-norms; under autograd it runs
    under ``checkpoint``."""
    if cfg.block_type == BLOCK_RWKV6:
        if torch.is_grad_enabled():
            h, new_st = checkpoint(R6.rwkv6_block, lp, cfg, x, st,
                                   use_reentrant=False)
        else:
            h, new_st = R6.rwkv6_block(lp, cfg, x, st)
        return x + h, new_st
    h, new_st = M2.mamba2_block(lp["mamba"], cfg,
                                rmsnorm(x, lp["ln"], cfg.norm_eps), state=st)
    return x + h, new_st


def ssm_stack(cfg: ArchConfig, params, x, positions, sinks=None, *,
              states=None, attn_caches=None, cache_index=None,
              collect_len: int = 0):
    """Run the Mamba2 or RWKV6 stack, layer by layer.  With
    ``shared_attn_every`` (zamba2) the shared block runs before layers 0,
    every, 2 every, ...: ``ceil(n_layers / every)`` invocations, each with
    its own KV cache.

    Prefill (``collect_len > 0``): returns the per-layer states stacked
    (L, ...): Mamba2's ``{"conv_x", "conv_bc", "ssm"}``, RWKV6's
    ``{"tm_last", "cm_last", "wkv"}``; and the invocations' caches
    ``(k, v)``, each (n_seg, B, collect_len, K, D) in the compute dtype
    with the prompt's keys and values in its first S positions.  Decode
    (``states`` and ``attn_caches`` given, x (B, 1, d)): both are updated
    in place at layer i / position ``cache_index`` and returned.
    Otherwise (training forward) returns ``(x, None, None)``.  Under a
    model group each layer's leaves (and the shared block's, once a
    forward) go through :func:`_tp_layer` outside the layer's
    ``checkpoint``, so a recompute gathers no leaf again."""
    every = cfg.shared_attn_every
    n_seg = -(-cfg.n_layers // every) if every else 0
    kvs, sts = attn_caches, states
    ctx = actx.current()
    specs = tp_specs(cfg, ctx.size) if ctx is not None else None
    shared = params.get("shared_attn")
    if ctx is not None and every:
        shared = _tp_layer(shared, specs["shared_attn"], "attention", 0)
    for i, lp in enumerate(_layer_slices(params["layers"], cfg.n_layers,
                                         sinks)):
        if ctx is not None:
            lp = _tp_layer(lp, specs["layers"], _family(cfg))
        if every and i % every == 0:
            seg = i // every
            cache = None if attn_caches is None else (attn_caches[0][seg],
                                                      attn_caches[1][seg])
            x, kv = _shared_attn(cfg, shared, x, positions, cache,
                                 cache_index)
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
        x, new_st = _ssm_layer(cfg, lp, x, st)
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
    leaves' gradients on backward (see :class:`_LayerSlice`).  Under a
    model group the logits are this rank's vocab shard when
    :func:`logits_vocab_start` says so."""
    ctx = actx.current()
    if ctx is not None:
        check_tensor_parallel(cfg, ctx.size)
    x = embed_input(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.block_type != BLOCK_ATTN:
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
    v)}``, each (L, B, max_len, K, D) in the compute dtype.  Mamba2 and
    RWKV6 stacks: ``{"pos": 0, "state": {...}}`` of zeros stacked over
    layers (the dtypes of the block's own initial state), and with a
    shared attention block ``"attn_kv"``, each (n_seg, B, max_len, K,
    D)."""
    def kv(n):
        shape = (n, batch_size, max_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return tuple(torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)
                     for _ in range(2))

    if cfg.block_type == BLOCK_ATTN:
        return {"pos": 0, "kv": kv(cfg.n_layers)}
    init = (R6.rwkv6_init_state(cfg, batch_size, device)
            if cfg.block_type == BLOCK_RWKV6
            else M2.mamba2_init_state(cfg, batch_size, device))
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
    and SSM states f32, and its shared block's caches; the RWKV6 stack:
    its per-layer states, all f32)."""
    x = embed_input(cfg, params, batch)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    if cfg.block_type != BLOCK_ATTN:
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
    if cfg.block_type != BLOCK_ATTN:
        x, _, _ = ssm_stack(cfg, params, x, positions,
                            states=cache["state"],
                            attn_caches=cache.get("attn_kv"),
                            cache_index=pos)
        return lm_logits(cfg, params, x), {**cache, "pos": pos + 1}
    x, _, kvs = attn_stack(cfg, params["layers"], x, positions,
                           kv_caches=cache["kv"], cache_index=pos)
    return lm_logits(cfg, params, x), {"pos": pos + 1, "kv": kvs}
