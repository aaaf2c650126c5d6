"""Dispatch for topk_ef (counterpart of ``repro.kernels.topk_ef.ops``).

A CPU tensor takes the plain version; a CUDA tensor takes the kernel, which
raises on what it does not take.  There is no shape guard that hands work
back to the plain version: the kernel runs whole rows of any length.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.topk_ef.kernel import topk_ef
from repro_torch.kernels.topk_ef.ref import topk_ef_plain


def topk_k(r: int, ratio: float) -> int:
    """Entries kept per row: ``max(1, round(R * ratio))``."""
    return max(1, int(round(r * ratio)))


def compress_rows(g2d: torch.Tensor, err2d: torch.Tensor | None,
                  ratio: float, out_err: torch.Tensor | None = None):
    """(M, R) rows -> ``(vals, idx, new_err)``; ``out_err`` receives the
    residual in place when given."""
    k = topk_k(g2d.shape[1], ratio)
    if g2d.is_cuda:
        return topk_ef(g2d, err2d, k, out_err=out_err)
    vals, idx, new_err = topk_ef_plain(g2d, err2d, k)
    if out_err is not None:
        new_err = out_err.copy_(new_err)
    return vals, idx, new_err
