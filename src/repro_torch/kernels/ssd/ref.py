"""Plain PyTorch version of the chunked SSD scan kernel (counterpart of
``repro.kernels.ssd.kernel.ssd_chunked_kernel``'s body, and of
``repro.kernels.ssd.ref.ssd_ref``)."""
from __future__ import annotations

import torch

CHUNK = 128


def chunk_len(t: int, chunk: int = CHUNK) -> int:
    """The scan's chunk length ``min(chunk, T)``; ``T`` must be a multiple
    of it, as the reference asserts."""
    c = min(chunk, t)
    if c < 1 or t % c:
        raise ValueError(f"sequence length {t} is not a multiple of the "
                         f"chunk {c}")
    return c


def ssd_plain(xh, a, bmat, cmat, *, chunk: int = CHUNK):
    """Zero-initial-state chunked SSD scan, as the Pallas kernel computes
    it: per (b, h) and chunk in order, everything in f32,

        cum = cumsum(a_chunk);  L = tril(exp(cum_i - cum_j))
        y   = ((C B^T) * L) X + exp(cum) * (C S^T)
        S   = exp(cum_last) S + X^T (B * exp(cum_last - cum))

    xh (B, T, H, hd); a (B, T, H) log-decays (<= 0); bmat, cmat (B, T, N).
    Returns (y (B, T, H, hd) in xh's dtype, rounded once; the final state
    (B, H, hd, N) f32)."""
    b, t, h, hd = xh.shape
    n = bmat.shape[-1]
    c = chunk_len(t, chunk)
    x = xh.float().transpose(1, 2)                     # (B, H, T, hd)
    la = a.float().transpose(1, 2)                     # (B, H, T)
    bm, cm = bmat.float(), cmat.float()                # (B, T, N)
    state = torch.zeros((b, h, hd, n), dtype=torch.float32,
                        device=xh.device)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=xh.device))
    ys = []
    for t0 in range(0, t, c):
        xc, ac = x[:, :, t0:t0 + c], la[:, :, t0:t0 + c]
        bc, cc = bm[:, t0:t0 + c], cm[:, t0:t0 + c]
        cum = torch.cumsum(ac, dim=-1)                 # (B, H, C)
        lmat = torch.where(mask, torch.exp(cum[..., :, None]
                                           - cum[..., None, :]), 0.0)
        amat = (cc @ bc.transpose(1, 2))[:, None] * lmat   # (B, H, C, C)
        y = amat @ xc + torch.exp(cum)[..., None] * (
            cc[:, None] @ state.transpose(-1, -2))
        kd = bc[:, None] * torch.exp(cum[..., -1:] - cum)[..., None]
        state = (torch.exp(cum[..., -1])[..., None, None] * state
                 + xc.transpose(-1, -2) @ kd)
        ys.append(y)
    y = torch.cat(ys, dim=2).transpose(1, 2).to(xh.dtype).contiguous()
    return y, state
