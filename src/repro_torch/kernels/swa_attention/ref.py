"""Plain PyTorch version of the sliding-window decode attention kernel
(counterpart of ``repro.kernels.swa_attention.ref.swa_decode_ref``)."""
from __future__ import annotations

import torch

NEG_INF = -1e30
SPLIT_ROUND = 16


def rows_int32(x, b: int, device) -> torch.Tensor:
    """A scalar or (B,) position as a contiguous (B,) int32 tensor."""
    return torch.as_tensor(x, device=device).to(torch.int32).expand(
        b).contiguous()


def live_span(pos: int, base: int, t: int, window: int = 0):
    """-> (lo, hi): the live keys of a row are ``t`` in [lo, hi), with
    0 <= lo <= hi <= t and lo == hi when none is live.  Key ``base + t`` is
    live iff it is <= pos and, for window != 0, pos - key < window: the
    mask of :func:`swa_decode_plain`, in O(1).  The CUDA kernel
    (``csrc/swa_decode.cu``) computes the same interval."""
    rel = pos - base
    hi = min(max(rel + 1, 0), t)
    lo = min(max(rel - window + 1, 0), hi) if window else 0
    return lo, hi


def split_len(n: int, nsplit: int) -> int:
    """Keys of one of ``nsplit`` splits of a row's ``n`` keys, as the CUDA
    kernel cuts them: ceil(n / nsplit) rounded up to a multiple of 16."""
    per = -(-n // nsplit)
    return -(-per // SPLIT_ROUND) * SPLIT_ROUND


def swa_decode_plain(q, k_cache, v_cache, pos, base=None, *,
                     window: int = 0) -> torch.Tensor:
    """q: (B, KV, G, D); caches (B, T, KV, D); pos scalar or (B,); base
    optional (B,) absolute position of each row's key 0.  Returns
    (B, KV, G, D) in q's dtype."""
    b, _, _, d = q.shape
    t = k_cache.shape[1]
    s = torch.einsum("bkgd,btkd->bkgt", q.float(),
                     k_cache.float()) * (d ** -0.5)
    pos = rows_int32(pos, b, q.device)
    base = rows_int32(0 if base is None else base, b, q.device)
    key_pos = base[:, None] + torch.arange(t, device=q.device)[None]
    valid = key_pos <= pos[:, None]
    if window:
        valid &= (pos[:, None] - key_pos) < window
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", p,
                        v_cache.float()).to(q.dtype)
