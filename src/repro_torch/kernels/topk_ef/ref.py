"""Plain PyTorch version of the topk_ef kernel (counterpart of
``repro.kernels.topk_ef.ref``), with ties pinned down: a stable descending
sort of ``|w|`` puts equal magnitudes in index order, so the lowest index
wins a tie, as ``lax.top_k`` does (``torch.topk`` promises no tie order).
"""
from __future__ import annotations

import torch


def topk_ef_plain(g: torch.Tensor, err: torch.Tensor | None, k: int):
    """g, err: (M, R) (``err=None``: a zero residual).  Returns
    ``(vals (M, k) f32, idx (M, k) int32, new_err (M, R) f32)``: the k
    entries of largest ``|w|`` per row of ``w = err + f32(g)``, signed,
    and ``w`` with those entries zeroed."""
    base = err if err is not None else torch.zeros_like(g, dtype=torch.float32)
    w = base + g.float()
    order = torch.sort(w.abs(), dim=1, descending=True, stable=True).indices
    idx = order[:, :k]
    vals = torch.gather(w, 1, idx)
    new_err = w.scatter(1, idx, 0.0)
    return vals, idx.to(torch.int32), new_err


def q_dense(vals: torch.Tensor, idx: torch.Tensor, r: int) -> torch.Tensor:
    """Densify a compact payload: (M, k) values at (M, k) indices of
    zeroed (M, R) rows."""
    q = torch.zeros((vals.shape[0], r), dtype=torch.float32,
                    device=vals.device)
    return q.scatter_add_(1, idx.long(), vals.float())
