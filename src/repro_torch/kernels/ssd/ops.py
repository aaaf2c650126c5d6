"""Dispatch for the zero-initial-state chunked SSD scan (counterpart of
``repro.kernels.ssd.ops``).

A CPU tensor takes the plain version; a CUDA tensor takes the kernel, or
the kernel raises.  There is no ``use_kernel`` switch and no shape guard
that hands work back to the plain version.
"""
from __future__ import annotations

from repro_torch.kernels.ssd.kernel import ssd_chunked
from repro_torch.kernels.ssd.ref import CHUNK, ssd_plain


def ssd(xh, a, bmat, cmat, *, chunk: int = CHUNK):
    """xh (B, T, H, hd), a (B, T, H) f32, bmat/cmat (B, T, N) -> (y in
    xh's dtype, final state (B, H, hd, N) f32)."""
    if xh.is_cuda:
        return ssd_chunked(xh, a, bmat, cmat, chunk=chunk)
    return ssd_plain(xh, a, bmat, cmat, chunk=chunk)
