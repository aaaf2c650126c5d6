"""RWKV-6 (Finch) block (counterpart of ``repro.models.rwkv6``):
attention-free, with a data-dependent per-channel decay, in the
reference's names, layouts and precisions.

Time-mixing recurrence per head (k/v dim N):

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t        w_t = exp(-exp(w_raw(x_t)))
    o_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)

:func:`wkv6_chunked` evaluates it a chunk of C steps at a time, as the
reference does: the intra-chunk kernel L[t, j, i] = exp(lw_t[i] - lw_j[i])
for j < t is a (C, C, N) tensor per (batch, head), safe since lw is a
running sum of negative log-decays.  The entries j >= t are masked before
the exponential (the reference masks after it): the forward is the same,
and the backward stays finite where exp(lw_t - lw_j) would overflow.  The
reference's WKV is plain jnp (a ``lax.scan`` over chunks), not a Pallas
kernel, so this is plain torch: a Python loop over chunks in f32.  Its
three-operand contractions are taken in a fixed order (products first,
then one sum or matmul), so the result does not depend on the order
``torch.einsum`` would pick.

Under a `repro_torch.models.actx` model group the ``dinner`` and ``ff``
leaves are this rank's shards: ``r`` / ``k`` / ``v`` / ``g`` and the decay
are column-parallel on the rank's ``H / m`` heads (each mixed input
through ``copy_in``), so the WKV runs on those heads with their rows of
``bonus_u``; ``w_o`` and ``cm_v`` are row-parallel (``reduce_out``).
``ln_x`` normalizes over the whole ``d``: the rank's slice of it (and of
``decay_bias``, both sharded on ``embed`` alike) is used on its heads, and
its sum of squares is summed over the group both ways.  ``cm_r`` is
column-parallel, but its sigmoid gates ``cm_v``'s whole output, so the
gate is gathered whole.  The norms and mixes of the whole ``d`` (``ln1``,
``ln2``, ``mix``, ``cm_mix``) are gathered leaves.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.models import actx
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import ParamDef

CHUNK = 64
MIX_KEYS = ("r", "k", "v", "w", "g")


def rwkv6_defs(cfg) -> dict:
    d = cfg.d_model
    h, n = cfg.ssm_heads, cfg.ssm_state
    if h * n != d:
        raise ValueError(f"rwkv6: ssm_heads {h} x ssm_state {n} != d {d}")
    return {
        "ln1": ParamDef((d,), ("embed",), init="ones"),
        "ln2": ParamDef((d,), ("embed",), init="ones"),
        "mix": ParamDef((len(MIX_KEYS), d), (None, "embed"), init="zeros"),
        "w_r": ParamDef((d, d), ("embed", "dinner")),
        "w_k": ParamDef((d, d), ("embed", "dinner")),
        "w_v": ParamDef((d, d), ("embed", "dinner")),
        "w_g": ParamDef((d, d), ("embed", "dinner")),
        # data-dependent decay projection (low-rank in the release; dense)
        "w_decay": ParamDef((d, d), ("embed", "dinner"), scale=0.01),
        "decay_bias": ParamDef((d,), ("embed",), init="constant",
                               constant=-4.0),
        "bonus_u": ParamDef((h, n), (None, None), init="zeros",
                            serve_f32=True),
        "ln_x": ParamDef((d,), ("embed",), init="ones"),
        "w_o": ParamDef((d, d), ("dinner", "embed")),
        # channel-mix
        "cm_mix": ParamDef((2, d), (None, "embed"), init="zeros"),
        "cm_k": ParamDef((d, cfg.d_ff), ("embed", "ff")),
        "cm_v": ParamDef((cfg.d_ff, d), ("ff", "embed")),
        "cm_r": ParamDef((d, d), ("embed", "dinner")),
    }


def _token_shift(x, last):
    """x (B, T, d); last (B, 1, d) f32: the previous segment's final token
    (or zeros), cast to x's dtype."""
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


def wkv6_chunked(r, k, v, log_w, u, state0=None):
    """r / k / v (B, T, H, N); log_w (B, T, H, N) (< 0); u (H, N); state0
    (B, H, N, N) f32 or None.  Returns (out (B, T, H, N) in r's dtype,
    final state (B, H, N, N) f32).  T is a multiple of the chunk
    ``min(64, T)``: a prompt is a multiple of 64 or shorter than 64, a
    decode step a chunk of one.  The loop runs inside a ``wkv6_chunked``
    profiler range."""
    b, t, h, n = r.shape
    c = min(CHUNK, t)
    assert t % c == 0, (t, c)
    state = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
             if state0 is None else state0)
    uf = u.float()
    # strictly causal (j < t): o_t sees S_{t-1}
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      diagonal=-1)[None, :, :, None, None]
    outs = []
    with trace.span("wkv6_chunked"):
        for i in range(0, t, c):
            rc, kc, vc, wc = (a[:, i:i + c].float()
                              for a in (r, k, v, log_w))
            lw = torch.cumsum(wc, dim=1)                 # inclusive
            lw_excl = lw - wc                            # exclusive
            # k_j decays by prod_{s=j+1..t-1} w_s = exp(lw_excl_t - lw_j)
            ldiff = lw_excl[:, :, None] - lw[:, None]    # (b, t, j, h, n)
            # exp(-inf) = 0 above the diagonal, where ldiff > 0 may
            # overflow: its backward then multiplies by 0, never by inf
            lmat = torch.exp(torch.where(mask, ldiff, -torch.inf))
            amat = ((rc[:, :, None] * lmat) * kc[:, None]).sum(-1)
            diag = ((rc * uf) * kc).sum(-1)              # (b, t, h)
            y = torch.einsum("btjh,bjhn->bthn", amat, vc)
            y = y + diag[..., None] * vc
            # inter-chunk: the carried state seen after decaying to t-1
            y = y + torch.einsum("bthn,bhnm->bthm", rc * torch.exp(lw_excl),
                                 state)
            ktil = kc * torch.exp(lw[:, -1:] - lw)
            state = torch.exp(lw[:, -1])[..., None] * state + torch.einsum(
                "bchn,bchm->bhnm", ktil, vc)
            outs.append(y.to(r.dtype))
    return torch.cat(outs, dim=1), state


def rwkv6_block(params, cfg, x, state=None):
    """Time-mix + channel-mix, with the block's own pre-norms: returns
    ``(residual delta, new state)`` (the caller adds the delta to x).
    ``state``: None (zeros) or ``{"tm_last", "cm_last", "wkv"}``, all
    f32.  Under a model group the heads are the rank's share."""
    b, t, d = x.shape
    dt = x.dtype
    n = cfg.ssm_state
    dl = params["w_r"].shape[1]                          # H n, or H / m n
    h = dl // n

    a = rmsnorm(x, params["ln1"], cfg.norm_eps)
    tm_last = (torch.zeros((b, 1, d), dtype=torch.float32, device=x.device)
               if state is None else state["tm_last"])
    shifted = _token_shift(a, tm_last)
    mix = params["mix"].to(dt)
    xr, xk, xv, xw, xg = (actx.copy_in(a + mix[i][None, None]
                                       * (shifted - a))
                          for i in range(len(MIX_KEYS)))
    r = (xr @ params["w_r"].to(dt)).reshape(b, t, h, n)
    k = (xk @ params["w_k"].to(dt)).reshape(b, t, h, n)
    v = (xv @ params["w_v"].to(dt)).reshape(b, t, h, n)
    g = F.silu(xg @ params["w_g"].to(dt))
    w_raw = (xw @ params["w_decay"].to(dt)).float() \
        + params["decay_bias"].float()
    log_w = -torch.exp(w_raw).reshape(b, t, h, n)        # < 0

    wkv0 = None if state is None else state["wkv"]
    o, new_wkv = wkv6_chunked(r, k, v, log_w, params["bonus_u"], wkv0)
    o = rmsnorm(o.reshape(b, t, dl), params["ln_x"], cfg.norm_eps,
                sharded=True) * g
    tm_out = actx.reduce_out(o @ params["w_o"].to(dt))

    x2 = x + tm_out
    b2 = rmsnorm(x2, params["ln2"], cfg.norm_eps)
    cm_last = (torch.zeros((b, 1, d), dtype=torch.float32, device=x.device)
               if state is None else state["cm_last"])
    shifted2 = _token_shift(b2, cm_last)
    cmix = params["cm_mix"].to(dt)
    xk2 = b2 + cmix[0][None, None] * (shifted2 - b2)
    xr2 = b2 + cmix[1][None, None] * (shifted2 - b2)
    kk = torch.square(F.relu(actx.copy_in(xk2) @ params["cm_k"].to(dt)))
    gate = actx.gather_leaf(
        torch.sigmoid(actx.copy_in(xr2) @ params["cm_r"].to(dt)), 2)
    cm_out = gate * actx.reduce_out(kk @ params["cm_v"].to(dt))

    new_state = {"tm_last": a[:, -1:].float(), "cm_last": b2[:, -1:].float(),
                 "wkv": new_wkv}
    return tm_out + cm_out, new_state


def rwkv6_init_state(cfg, batch: int, device=None, *,
                     model: int = 1) -> dict:
    """Zero decode state; over ``model`` ranks, a rank's heads."""
    d, h, n = cfg.d_model, cfg.ssm_heads // model, cfg.ssm_state
    return {
        "tm_last": torch.zeros((batch, 1, d), dtype=torch.float32,
                               device=device),
        "cm_last": torch.zeros((batch, 1, d), dtype=torch.float32,
                               device=device),
        "wkv": torch.zeros((batch, h, n, n), dtype=torch.float32,
                           device=device),
    }
