"""Mamba2 (SSD) block (counterpart of ``repro.models.mamba2``), in the
reference's names, layouts and precisions.

State-space recurrence per head h (scalar decay a_t, state S in R^{hd x N}):

    S_t = a_t * S_{t-1} + dt_t * x_t (x) B_t          a_t = exp(A_h * dt_t)
    y_t = S_t @ C_t + D_h * x_t

With no state (prefill, training forward) the scan goes through
``kernels.ssd.ops.ssd``: the K10 kernel on the card, its plain version on
the CPU.  Both compute the Pallas kernel's form, in f32 throughout.  Under
autograd (training) K10 runs the forward on the card and its plain
version, recomputed, gives the backward (``kernels/ssd/kernel.py``): one
K10 launch a Mamba2 layer a forward, none in backward.  With a
state (decode, T = 1) the block runs the model's own chunked form
:func:`ssd_chunked`, which casts the (C, C) decay-masked matrix to x's
dtype before the product with X, exactly as the reference does.  So a
bf16 prefill here may differ from the reference's by one bf16 rounding
step of y.

Under a `repro_torch.models.actx` model group the ``dinner`` and
``heads`` leaves are this rank's shards: ``z``, ``x`` and ``dt`` are
column-parallel (their input through ``copy_in``), the depthwise
``conv_x`` is local, the scan runs on the rank's ``H / m`` heads, and
``out_proj`` is row-parallel (``reduce_out``).  ``B`` and ``C`` come from
the replicated ``b_proj`` / ``c_proj`` / ``conv_bc_*`` but feed the rank's
heads only, so their gradient is summed over the group where they enter
the scan (``copy_in``).  ``gate_norm`` normalizes over the whole
``dinner``: its sum of squares is summed over the group both ways.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ops as SSD
from repro_torch.kernels.ssd.ref import CHUNK, chunk_len
from repro_torch.models import actx
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import ParamDef


def mamba2_defs(cfg) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n, h = cfg.ssm_state, cfg.ssm_heads
    return {
        "z_proj": ParamDef((d, di), ("embed", "dinner")),
        "x_proj": ParamDef((d, di), ("embed", "dinner")),
        "b_proj": ParamDef((d, n), (None, None)),
        "c_proj": ParamDef((d, n), (None, None)),
        "dt_proj": ParamDef((d, h), (None, "heads")),
        "conv_x_w": ParamDef((cfg.conv_width, di), (None, "dinner"),
                             scale=cfg.conv_width ** -0.5),
        "conv_x_b": ParamDef((di,), ("dinner",), init="zeros"),
        "conv_bc_w": ParamDef((cfg.conv_width, 2 * n), (None, None),
                              scale=cfg.conv_width ** -0.5),
        "conv_bc_b": ParamDef((2 * n,), (None,), init="zeros"),
        "a_log": ParamDef((h,), ("heads",), init="constant", constant=0.0),
        "dt_bias": ParamDef((h,), ("heads",), init="zeros"),
        "d_skip": ParamDef((h,), ("heads",), init="ones"),
        "gate_norm": ParamDef((di,), ("dinner",), init="ones"),
        "out_proj": ParamDef((di, d), ("dinner", "embed")),
    }


def _causal_conv(x, w, b, carry=None):
    """Depthwise causal conv in x's dtype.  x: (B, T, Cd); w: (W, Cd);
    carry: (B, W-1, Cd) trailing inputs of the previous segment, or None
    (zeros).  Returns (silu(conv + b), new carry (B, W-1, Cd) in x's
    dtype)."""
    width = w.shape[0]
    if carry is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = carry.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    t = x.shape[1]
    out = xp[:, 0:t] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + t] * w[i]
    return F.silu(out + b), xp[:, -(width - 1):]


def ssd_chunked(xh, a, bmat, cmat, state0=None):
    """The model's chunked SSD scan (the reference's ``ssd_chunked``).

    xh (B, T, H, hd) dt-scaled inputs; a (B, T, H) log-decays (<= 0);
    bmat, cmat (B, T, N); state0 (B, H, hd, N) f32 or None.  Returns
    (y (B, T, H, hd) in xh's dtype, final state f32).  The products take
    x-dtype operands with f32 accumulation; the (C, C) matrix is cast to
    x's dtype first."""
    b, t, h, hd = xh.shape
    n = bmat.shape[-1]
    c = chunk_len(t, CHUNK)
    dt = xh.dtype
    state = (torch.zeros((b, h, hd, n), dtype=torch.float32,
                         device=xh.device) if state0 is None
             else state0.float())
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=xh.device))
    ys = []
    for t0 in range(0, t, c):
        xc, ac = xh[:, t0:t0 + c], a[:, t0:t0 + c]
        bc, cc = bmat[:, t0:t0 + c], cmat[:, t0:t0 + c]
        cum = torch.cumsum(ac, dim=1)                        # (B, C, H)
        ldiff = cum[:, :, None, :] - cum[:, None, :, :]      # (B, C, C, H)
        lmat = torch.where(mask[None, :, :, None], torch.exp(ldiff), 0.0)
        cb = torch.einsum("btn,bjn->btj", cc.float(), bc.float())
        amat = cb[:, :, :, None] * lmat                      # (B, C, C, H)
        y = torch.einsum("btjh,bjhd->bthd", amat.to(dt).float(),
                         xc.float())
        decay_t = torch.exp(cum)
        y = y + torch.einsum("bth,bhdn,btn->bthd", decay_t, state,
                             cc.float())
        decay_rest = torch.exp(cum[:, -1:, :] - cum)         # (B, C, H)
        kd = bc[:, :, None, :] * decay_rest[..., None]       # (B, C, H, N)
        state = (torch.exp(cum[:, -1])[:, :, None, None] * state
                 + torch.einsum("bchn,bchd->bhdn", kd, xc.float()))
        ys.append(y.to(dt))
    return torch.cat(ys, dim=1), state


def mamba2_block(params, cfg, x, *, state=None):
    """x: (B, T, d).  ``state``: None (prefill / training forward: zero
    state, the scan through K10 on the card) or ``{"conv_x", "conv_bc",
    "ssm"}`` to continue from (decode).  Returns (out (B, T, d), new state
    ``{"conv_x", "conv_bc"}`` in x's dtype and ``"ssm"`` f32).  Under a
    model group ``dinner`` and H are the rank's shares."""
    b, t, d = x.shape
    dt_ = x.dtype
    n = cfg.ssm_state
    di, h = params["x_proj"].shape[1], params["dt_proj"].shape[1]
    hd = di // h

    xc = actx.copy_in(x)
    z = xc @ params["z_proj"].to(dt_)
    xin = xc @ params["x_proj"].to(dt_)
    bc = torch.cat([x @ params["b_proj"].to(dt_),
                    x @ params["c_proj"].to(dt_)], dim=-1)
    dt_raw = xc @ params["dt_proj"].to(dt_)                  # (B, T, H)

    cx = None if state is None else state["conv_x"]
    cbc = None if state is None else state["conv_bc"]
    xin, new_cx = _causal_conv(xin, params["conv_x_w"].to(dt_),
                               params["conv_x_b"].to(dt_), cx)
    bc, new_cbc = _causal_conv(bc, params["conv_bc_w"].to(dt_),
                               params["conv_bc_b"].to(dt_), cbc)
    bc = actx.copy_in(bc)
    bmat, cmat = bc[..., :n].contiguous(), bc[..., n:].contiguous()

    dtf = dt_raw.float() + params["dt_bias"].float()
    dt = torch.logaddexp(dtf, torch.zeros_like(dtf))         # softplus
    a_neg = -torch.exp(params["a_log"].float())              # (H,) < 0
    log_decay = dt * a_neg                                   # (B, T, H)

    xh = xin.reshape(b, t, h, hd) * dt[..., None].to(dt_)
    if state is None:
        y, new_ssm = SSD.ssd(xh, log_decay, bmat, cmat)
    else:
        y, new_ssm = ssd_chunked(xh, log_decay, bmat, cmat, state["ssm"])
    y = y + params["d_skip"].to(dt_)[None, None, :, None] \
        * xin.reshape(b, t, h, hd)
    y = y.reshape(b, t, di)
    y = rmsnorm(y * F.silu(z), params["gate_norm"], cfg.norm_eps,
                sharded=True)
    out = actx.reduce_out(y @ params["out_proj"].to(dt_))
    return out, {"conv_x": new_cx, "conv_bc": new_cbc, "ssm": new_ssm}


def mamba2_init_state(cfg, batch: int, device=None) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n, h = cfg.ssm_state, cfg.ssm_heads
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return {"conv_x": z(batch, cfg.conv_width - 1, di),
            "conv_bc": z(batch, cfg.conv_width - 1, 2 * n),
            "ssm": z(batch, h, di // h, n)}
