"""Sequential (one timestep at a time) recurrences (counterpart of
``repro.models.ref_recurrent``).

The model runs chunked forms of the Mamba2 and RWKV6 recurrences; these
step-by-step versions implement the defining recurrences directly, in
f32, so that tests can hold the chunked algebra to the recurrence itself.
Nothing on a path of the port calls them.
"""
from __future__ import annotations

import torch


def ssd_sequential(xh, a, bmat, cmat, state0=None):
    """Mamba2 SSD, stepwise:  S_t = exp(a_t) S_{t-1} + x_t (x) B_t,
    y_t = S_t @ C_t.  xh (B, T, H, hd), a (B, T, H), bmat / cmat (B, T, N),
    state0 (B, H, hd, N) f32 or None.  Returns (y in xh's dtype, final
    state f32)."""
    b, t, h, hd = xh.shape
    n = bmat.shape[-1]
    state = (torch.zeros((b, h, hd, n), dtype=torch.float32,
                         device=xh.device) if state0 is None
             else state0.float())
    ys = []
    for i in range(t):
        x_t, b_t, c_t = (z[:, i].float() for z in (xh, bmat, cmat))
        decay = torch.exp(a[:, i].float())[:, :, None, None]
        state = decay * state + torch.einsum("bhd,bn->bhdn", x_t, b_t)
        ys.append(torch.einsum("bhdn,bn->bhd", state, c_t))
    return torch.stack(ys, dim=1).to(xh.dtype), state


def wkv6_sequential(r, k, v, log_w, u, state0=None):
    """RWKV6 WKV, stepwise:  o_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t);
    S_t = diag(w_t) S_{t-1} + k_t (x) v_t.  r / k / v / log_w (B, T, H, N),
    u (H, N), state0 (B, H, N, N) f32 or None.  Returns (o in r's dtype,
    final state f32)."""
    b, t, h, n = r.shape
    state = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
             if state0 is None else state0.float())
    uf = u.float()[None, :, :, None]
    ys = []
    for i in range(t):
        r_t, k_t, v_t, w_t = (z[:, i].float() for z in (r, k, v, log_w))
        kv = torch.einsum("bhn,bhm->bhnm", k_t, v_t)
        ys.append(torch.einsum("bhn,bhnm->bhm", r_t, state + uf * kv))
        state = torch.exp(w_t)[..., None] * state + kv
    return torch.stack(ys, dim=1).to(r.dtype), state
