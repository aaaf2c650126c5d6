"""Dispatch for sliding-window decode attention (counterpart of
``repro.kernels.swa_attention.ops``).

A CPU tensor takes the plain version; a CUDA tensor takes the kernel at any
key count T, or the kernel raises.  There is no ``use_kernel`` switch and no
``T % 128`` guard that hands work back to the plain version.
"""
from __future__ import annotations

from repro_torch.kernels.swa_attention.kernel import swa_decode_attention
from repro_torch.kernels.swa_attention.ref import swa_decode_plain


def decode_attention(q, k_cache, v_cache, pos, base=None, *,
                     window: int = 0):
    """q (B, KV, G, D) against caches (B, T, KV, D) -> (B, KV, G, D)."""
    if q.is_cuda:
        return swa_decode_attention(q, k_cache, v_cache, pos, base,
                                    window=window)
    return swa_decode_plain(q, k_cache, v_cache, pos, base, window=window)
