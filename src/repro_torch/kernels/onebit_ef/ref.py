"""Plain PyTorch version of the onebit_ef kernel (counterpart of
``repro.kernels.onebit_ef.ref``), for any row length R: the sign map is
packed LSB first into ``ceil(R / 8)`` bytes, with zero pad bits."""
from __future__ import annotations

import torch

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def onebit_ef_plain(g: torch.Tensor, err: torch.Tensor):
    """g, err (M, R).  Returns ``(packed (M, ceil(R/8)) uint8, means (M, 2)
    f32, new_err (M, R) f32)`` for ``w = err + f32(g)``: Eq. 30 per row,
    ``[Q(w)]_i`` = the mean of w over i's sign class (``w >= 0`` or not,
    class counts clamped at 1), ``new_err = w - Q(w)``."""
    w = err + g.float()
    m, r = w.shape
    pos = w >= 0.0
    n_pos_raw = torch.sum(pos, dim=1)
    n_pos = torch.clamp(n_pos_raw, min=1)
    n_neg = torch.clamp(r - n_pos_raw, min=1)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    mean_pos = torch.sum(torch.where(pos, w, zero), dim=1) / n_pos
    mean_neg = torch.sum(torch.where(pos, zero, w), dim=1) / n_neg
    pad = (-r) % 8
    bits = torch.nn.functional.pad(pos, (0, pad)).reshape(m, -1, 8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=w.device)
    packed = (bits.to(torch.int32) * weights).sum(-1).to(torch.uint8)
    means = torch.stack([mean_pos, mean_neg], dim=1)
    q = torch.where(pos, mean_pos[:, None], mean_neg[:, None])
    return packed, means, w - q


def unpack(packed: torch.Tensor, means: torch.Tensor, r: int) -> torch.Tensor:
    """Reconstruct Q(w) (..., R) from the wire payload: packed (..., ceil(R/8))
    uint8, means (..., 2)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    pos = bits.reshape(*packed.shape[:-1], -1)[..., :r].bool()
    return torch.where(pos, means[..., 0:1], means[..., 1:2])
