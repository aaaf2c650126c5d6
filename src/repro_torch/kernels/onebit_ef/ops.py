"""Dispatch for onebit_ef (counterpart of ``repro.kernels.onebit_ef.ops``).

A CPU tensor takes the plain version; a CUDA tensor takes the kernel, which
raises on what it does not take.  No shape guard hands work back: the
kernel takes any M and any R.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.onebit_ef.kernel import onebit_ef
from repro_torch.kernels.onebit_ef.ref import onebit_ef_plain


def compress_rows(g2d: torch.Tensor, err2d: torch.Tensor):
    """(M, R) rows + EF residual -> ``(packed, means, new_err)``."""
    if g2d.is_cuda:
        return onebit_ef(g2d, err2d)
    return onebit_ef_plain(g2d, err2d)
