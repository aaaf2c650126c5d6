"""Dispatch for the deposit ops and the row-space compress (counterpart of
``repro.kernels.cr_reduce.ops``).

A CPU tensor takes the plain version; a CUDA tensor takes the kernel, which
raises on what it does not take — there is no ``auto`` that falls back and
no shape guard.  ``onebit_compress_rows`` is plain tensor math, as in the
reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cr_reduce.kernel import (onebit_cr_deposit,
                                                  topk_cr_deposit)
from repro_torch.kernels.cr_reduce.ref import (onebit_cr_deposit_plain,
                                               topk_cr_deposit_plain)


def topk_deposit(acc, vals, idx, slots, weights):
    """Decompress-deposit S top-k messages into their ring slots, in
    place: acc (cap, M, R) f32, vals/idx (S, M, k), slots/weights (S,)."""
    if acc.is_cuda:
        return topk_cr_deposit(acc, vals, idx, slots, weights)
    return topk_cr_deposit_plain(acc, vals, idx, slots, weights)


def onebit_deposit(acc, pos, means, slots, weights):
    """Deposit S sign/mean messages into their ring slots, in place:
    acc (cap, M, R) f32, pos (S, M, R) bool, means (S, M, 2) f32."""
    if acc.is_cuda:
        return onebit_cr_deposit(acc, pos, means, slots, weights)
    return onebit_cr_deposit_plain(acc, pos, means, slots, weights)


def topk_compress_rows(rows, err_rows, ratio: float, *, out_err=None):
    """(M, R) rows + EF residual (``None``: zero) -> (vals (M, k) f32,
    idx (M, k) i32, new_err (M, R) f32), k = max(1, round(R * ratio))."""
    from repro_torch.kernels.topk_ef.ops import compress_rows
    return compress_rows(rows, err_rows, ratio, out_err=out_err)


def onebit_compress_rows(rows, err_rows, *, out_err=None):
    """(M, R) rows + EF residual (``None``: zero) -> (pos (M, R) bool,
    means (M, 2) f32, new_err (M, R) f32): Eq. 30 per row, unpacked."""
    base = err_rows if err_rows is not None else torch.zeros_like(
        rows, dtype=torch.float32)
    w = base + rows.float()
    r = w.shape[1]
    pos = w >= 0.0
    n_pos_raw = torch.sum(pos, dim=1)
    n_pos = torch.clamp(n_pos_raw, min=1)
    n_neg = torch.clamp(r - n_pos_raw, min=1)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    mean_pos = torch.sum(torch.where(pos, w, zero), dim=1) / n_pos
    mean_neg = torch.sum(torch.where(pos, zero, w), dim=1) / n_neg
    means = torch.stack([mean_pos, mean_neg], dim=1)
    q = torch.where(pos, mean_pos[:, None], mean_neg[:, None])
    new_err = torch.sub(w, q, out=out_err) if out_err is not None else w - q
    return pos, means, new_err
