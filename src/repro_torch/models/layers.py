"""Transformer layers (counterpart of ``repro.models.layers``): RMSNorm,
RoPE, GQA attention (training/prefill and the dense-cache decode) and the
gated MLP, in the reference's layouts and precisions.

Activations are bf16 (``COMPUTE_DTYPE``); weights are stored f32 (bf16 for
serving) and cast to bf16 at each use. Where the reference asks for an f32
result from bf16 operands (``preferred_element_type=f32``: attention
scores, the attention output and the LM head), the operands are widened to
f32 first — a product of two bf16 values is exact in f32, so this is bf16
inputs with f32 accumulation. The reference attention is plain jnp, not
Pallas, so it is plain torch here too.

Under a `repro_torch.models.actx` model group the weights are this rank's
shards: the attention runs its heads, the MLP its ``ff`` slice, and the
row-parallel ``wo`` and ``w_down`` products are summed over the group
(``reduce_out``, or under sequence parallelism ``scatter_seq``: the
``actx.block_out`` exit); without one that sum is the identity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.models import actx
from repro_torch.models.params import ParamDef

COMPUTE_DTYPE = torch.bfloat16
NEG_INF = -1e30


def rmsnorm_def(d: int) -> ParamDef:
    return ParamDef((d,), ("embed",), init="ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *,
            sharded: bool = False) -> torch.Tensor:
    """RMSNorm over the last dim.  ``sharded``: under a model group that
    dim is this rank's shard of one split over the group (``scale`` its
    slice), and the sum of squares is summed over the group, forward and
    backward (`repro_torch.models.actx.psum`); without one it is whole."""
    dt = x.dtype
    x = x.float()
    ctx = actx.current() if sharded else None
    if ctx is None:
        ms = torch.mean(x * x, dim=-1, keepdim=True)
    else:
        ms = actx.psum(torch.sum(x * x, dim=-1, keepdim=True)) \
            / (x.shape[-1] * ctx.size)
    x = x * torch.rsqrt(ms + eps)
    return (x * scale.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a host scalar copied to a card from pageable memory: the copy waits
    # for the stream
    with trace.span("wait.rope_theta"):
        base = torch.tensor(theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,).  Rotates the two
    *halves* of D (not interleaved pairs), as the reference does."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., None].float() * freqs
    if angles.ndim == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention_defs(cfg) -> dict:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    defs = {
        "wq": ParamDef((d, h, hd), ("embed", "heads", None)),
        "wk": ParamDef((d, k, hd), (None, "kv_heads", None)),
        "wv": ParamDef((d, k, hd), (None, "kv_heads", None)),
        "wo": ParamDef((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), init="ones")
        defs["k_norm"] = ParamDef((hd,), (None,), init="ones")
    return defs


def masked_attn_chunk(q, k, v, q_pos, k_pos, window: int, scale: float):
    """One query chunk over a KV span.  q: (B, C, K, G, D); k/v:
    (B, T, K, D); absolute positions, ``k_pos == -1`` marks invalid slots.
    Returns (B, C, K, G, D) f32."""
    scores = torch.einsum("bckgd,btkd->bkgct", q.float(), k.float()) * scale
    if q_pos.ndim == 1:
        q_pos = q_pos[None].expand(q.shape[0], -1)
    if k_pos.ndim == 1:
        k_pos = k_pos[None].expand(k.shape[0], -1)
    mask = (q_pos[:, :, None] >= k_pos[:, None, :]) & (k_pos[:, None, :] >= 0)
    if window:
        mask = mask & ((q_pos[:, :, None] - k_pos[:, None, :]) < window)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full((), NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    row_valid = torch.any(mask, dim=-1)
    probs = probs * row_valid[:, None, None, :, None].to(probs.dtype)
    return torch.einsum("bkgct,btkd->bckgd", probs.to(v.dtype).float(),
                        v.float())


def gqa_attention(q, k, v, *, window: int = 0, chunk: int = 256,
                  q_offset: int = 0) -> torch.Tensor:
    """Causal GQA attention, query-chunked.  q: (B, S, H, D); k/v:
    (B, T, K, D); query i sits at absolute position ``q_offset + i``."""
    b, s, h, d = q.shape
    t, nk = k.shape[1], k.shape[2]
    g = h // nk
    scale = d ** -0.5
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"seq {s} not a multiple of the chunk {c}")
    nq = s // c
    qc = q.reshape(b, nq, c, nk, g, d)
    k_pos_all = torch.arange(t, device=q.device)
    outs = []
    for i in range(nq):
        q_pos = q_offset + i * c + torch.arange(c, device=q.device)
        if window and t > window + c:
            span = window + c
            start = min(max(q_offset + i * c + c - span, 0), t - span)
            ks, vs = k[:, start:start + span], v[:, start:start + span]
            k_pos = start + torch.arange(span, device=q.device)
            outs.append(masked_attn_chunk(qc[:, i], ks, vs, q_pos, k_pos,
                                          window, scale))
        else:
            outs.append(masked_attn_chunk(qc[:, i], k, v, q_pos, k_pos_all,
                                          window, scale))
    out = torch.stack(outs, dim=1)
    return out.reshape(b, s, h, d).to(q.dtype)


def project_qkv(params, cfg, x, positions):
    """q/k/v projections + optional qk-norm + rope.  x: (B, S, d) ->
    q (B, S, H, hd), k/v (B, S, K, hd)."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(params, cfg, x, positions, *, window: int,
                    kv_cache=None, cache_index=None):
    """Attention sub-block: qkv proj, rope, attention, out proj.

    Training/prefill (``kv_cache`` None): attends within x; returns
    ``(out, (k, v))``.  Decode: ``kv_cache = (k_cache, v_cache)``, each
    (B, T, K, D), x is (B, 1, d) and ``cache_index`` the write position;
    the new k, v are written into the caches in place (the reference
    returns updated copies) and ``(out, kv_cache)`` is returned."""
    dt = x.dtype
    q, k, v = project_qkv(params, cfg, x, positions)
    if kv_cache is None:
        out = gqa_attention(q, k, v, window=window)
        kv = (k, v)
    else:
        k_cache, v_cache = kv_cache
        s_new = k.shape[1]
        k_cache[:, cache_index:cache_index + s_new] = k.to(k_cache.dtype)
        v_cache[:, cache_index:cache_index + s_new] = v.to(v_cache.dtype)
        b, t, nk, hd = k_cache.shape
        hq = q.shape[2]                  # the rank's heads under a group
        q5 = q.reshape(b, 1, nk, hq // nk, hd)
        k_pos = torch.arange(t, device=x.device)
        k_pos = torch.where(k_pos <= cache_index, k_pos, -1)
        out = masked_attn_chunk(
            q5, k_cache.to(dt), v_cache.to(dt), positions, k_pos, window,
            hd ** -0.5).reshape(b, 1, hq, hd).to(dt)
        kv = kv_cache
    # row-parallel under a model group: the heads' partial sums, summed
    # (under sequence parallelism, summed and scattered over S)
    return actx.block_out(
        torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))), kv


def mlp_defs(d: int, ff: int) -> dict:
    return {
        "w_gate": ParamDef((d, ff), ("embed", "ff")),
        "w_up": ParamDef((d, ff), ("embed", "ff")),
        "w_down": ParamDef((ff, d), ("ff", "embed")),
    }


def mlp_block(params, x):
    """The gated MLP; under a model group ``ff`` is this rank's shard and
    the row-parallel ``w_down``'s partial sums are summed (under sequence
    parallelism, summed and scattered over S)."""
    dt = x.dtype
    gate = F.silu(x @ params["w_gate"].to(dt))
    up = x @ params["w_up"].to(dt)
    return actx.block_out((gate * up) @ params["w_down"].to(dt))
