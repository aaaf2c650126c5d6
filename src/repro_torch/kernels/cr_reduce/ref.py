"""Plain PyTorch versions of the deposit kernels (counterpart of
``repro.kernels.cr_reduce.ref``), with the message order pinned down: the
messages are added one after another, each one's products ``vals * w``
rounded before the add.  Both update ``acc`` in place (the reference
donates it) and return it.
"""
from __future__ import annotations

import torch


def topk_cr_deposit_plain(acc: torch.Tensor, vals: torch.Tensor,
                          idx: torch.Tensor, slots: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """acc (cap, M, R) f32, vals/idx (S, M, k), slots (S,) int, weights
    (S,) f32: ``acc[slots[s], m, idx[s, m, j]] += vals[s, m, j] * w[s]``
    for s in order; duplicates accumulate."""
    s, m, k = vals.shape
    if s == 0 or m == 0 or k == 0 or acc.numel() == 0:
        return acc
    _, _, r = acc.shape
    flat = acc.view(-1)
    row0 = torch.arange(m, device=acc.device, dtype=torch.int64)[:, None] * r
    for i in range(s):
        target = (slots[i].long() * m) * r + row0 + idx[i].long()
        flat.index_add_(0, target.reshape(-1),
                        (vals[i].float() * weights[i].float()).reshape(-1))
    return acc


def onebit_cr_deposit_plain(acc: torch.Tensor, pos: torch.Tensor,
                            means: torch.Tensor, slots: torch.Tensor,
                            weights: torch.Tensor) -> torch.Tensor:
    """acc (cap, M, R) f32, pos (S, M, R) bool, means (S, M, 2) f32:
    ``acc[slots[s]] += where(pos[s], mean_pos, mean_neg) * w[s]`` for s in
    order."""
    s, m, _ = pos.shape
    if s == 0 or m == 0 or acc.numel() == 0:
        return acc
    for i in range(s):
        q = torch.where(pos[i], means[i, :, 0:1].float(),
                        means[i, :, 1:2].float())
        acc.index_add_(0, slots[i:i + 1].long(),
                       (q * weights[i].float())[None])
    return acc
