"""Plain PyTorch versions of the reduce and deposit kernels (counterpart
of ``repro.kernels.cr_reduce.ref``), with the message order pinned down:
the messages are added one after another, each one's products ``vals * w``
rounded before the add.  The reduces start from zeros and return a new
(M, R) f32 tensor; the deposits update ``acc`` in place (the reference
donates it) and return it.
"""
from __future__ import annotations

import torch


def topk_cr_reduce_plain(vals: torch.Tensor, idx: torch.Tensor,
                         weights: torch.Tensor, r: int) -> torch.Tensor:
    """vals (S, M, k) f32 or bf16, idx (S, M, k) int, weights (S,) f32 ->
    (M, R) f32: ``out[m, idx[s, m, j]] += vals[s, m, j] * w[s]`` from
    zeros, for s in order; duplicates accumulate, a zero weight is not
    skipped (``inf * 0`` is NaN, as in the reference)."""
    s, m, k = vals.shape
    out = torch.zeros((m, r), dtype=torch.float32, device=vals.device)
    if s == 0 or m == 0 or r == 0 or k == 0:
        return out
    flat = out.view(-1)
    row0 = torch.arange(m, device=out.device, dtype=torch.int64)[:, None] * r
    for i in range(s):
        flat.index_add_(0, (row0 + idx[i].long()).reshape(-1),
                        (vals[i].float() * weights[i].float()).reshape(-1))
    return out


def onebit_cr_reduce_plain(pos: torch.Tensor, means: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """pos (S, M, R) bool, means (S, M, 2) f32, weights (S,) f32 -> (M, R)
    f32: ``out += where(pos[s], mean_pos, mean_neg) * w[s]`` from zeros,
    for s in order."""
    s, m, r = pos.shape
    out = torch.zeros((m, r), dtype=torch.float32, device=pos.device)
    if s == 0 or m == 0 or r == 0:
        return out
    for i in range(s):
        q = torch.where(pos[i], means[i, :, 0:1].float(),
                        means[i, :, 1:2].float())
        out.add_(q * weights[i].float())
    return out


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
