"""Launcher of the CUDA sliding-window decode attention kernel
(``csrc/swa_decode.cu``, K9).

The wrapper checks device, dtype, shape and contiguity, chooses the number
of splits of each row's live keys (:func:`num_splits`), allocates the
output and the per-split partials with ``torch.empty``, launches the kernel
(splits and their merge in one launch) on the current stream, raises on a
non-zero launch error and counts its launches in ``.launches``.  It keeps
one zeroed ticket counter per (row, kv head) and device across launches
(each launch leaves them zeroed), so its launches on one device must be
ordered: one stream at a time.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.swa_attention.ref import rows_int32, split_len

_VP, _LL = ctypes.c_void_p, ctypes.c_longlong
MAX_G, MAX_D = 16, 256
TARGET_BLOCKS = 256       # blocks of a call: two per SM of an H100, one wave
MIN_SPLIT_KEYS = 32       # no split shorter than one tile of a full row
SC_FLOATS = 8192          # a split's scores in shared memory, G * len


def num_splits(b: int, kv: int, g: int, t: int, window: int) -> int:
    """Splits of each row's keys: enough for ``TARGET_BLOCKS`` blocks of
    (split, kv head, row), no more than a full row of T keys can give
    ``MIN_SPLIT_KEYS`` each, and enough that a split's G x len scores fit
    ``SC_FLOATS``."""
    live_max = min(t, window) if window > 0 else t
    want = -(-TARGET_BLOCKS // (b * kv))
    most = max(1, -(-t // MIN_SPLIT_KEYS))
    n = max(1, min(want, most))
    while split_len(live_max, n) * g > SC_FLOATS:
        n *= 2
    return min(n, t)


def _lib():
    lib = _build.load("swa_decode")
    if not getattr(lib, "_typed", False):
        lib.swa_decode_launch.argtypes = ([_VP] * 10 + [_LL] * 7
                                          + [ctypes.c_float, ctypes.c_int,
                                             _VP])
        lib.swa_decode_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"swa_decode_attention: {msg}")


class SwaDecode:
    """``swa_decode_attention(q, k_cache, v_cache, pos, base=None, *,
    window=0) -> out`` on CUDA tensors: q (B, KV, G, D), caches
    (B, T, KV, D), all bf16 or all f32 and contiguous; pos, base scalars
    or (B,) integer tensors (base None: 0).  Any T and B, G <= 16,
    D <= 256."""

    name = "swa_decode_attention"
    source = "src/repro_torch/kernels/swa_attention/csrc/swa_decode.cu"
    replaces = "src/repro/kernels/swa_attention/kernel.py:77"

    def __init__(self):
        self.launches = 0
        self._ticket = _build.Tickets()

    def __call__(self, q, k_cache, v_cache, pos, base=None, *,
                 window: int = 0):
        _need(q.is_cuda, "q must be a CUDA tensor")
        _need(q.ndim == 4, f"q must be (B, KV, G, D), got {tuple(q.shape)}")
        b, nkv, g, d = q.shape
        dev = q.device
        _need(q.dtype in (torch.bfloat16, torch.float32),
              f"dtype {q.dtype} is neither bfloat16 nor float32")
        _need(1 <= g <= MAX_G and 1 <= d <= MAX_D,
              f"G={g}, D={d} outside G <= {MAX_G}, D <= {MAX_D}")
        _need(k_cache.ndim == 4 and k_cache.shape[0] == b
              and tuple(k_cache.shape[2:]) == (nkv, d),
              f"k_cache {tuple(k_cache.shape)} is not (B, T, {nkv}, {d})")
        t = k_cache.shape[1]
        _need(t >= 1 and 1 <= b <= 65535 and 1 <= nkv <= 65535,
              f"B={b}, T={t}, KV={nkv} out of range")
        for what, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
            _need(x.device == dev and x.dtype == q.dtype
                  and x.is_contiguous(),
                  f"{what} must be contiguous {q.dtype} on {dev}")
        _need(v_cache.shape == k_cache.shape,
              f"v_cache {tuple(v_cache.shape)} != k_cache "
              f"{tuple(k_cache.shape)}")
        window = int(window)
        pos_t = rows_int32(pos, b, dev)
        base_t = rows_int32(0 if base is None else base, b, dev)
        splits = num_splits(b, nkv, g, t, window)
        lib = _lib()
        with torch.cuda.device(dev):
            part_m = torch.empty((b, nkv, splits, g), dtype=torch.float32,
                                 device=dev)
            part_l = torch.empty_like(part_m)
            part_acc = torch.empty((b, nkv, splits, g, d),
                                   dtype=torch.float32, device=dev)
            out = torch.empty_like(q)
            ticket = self._ticket(dev, b * nkv)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.swa_decode_launch(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                pos_t.data_ptr(), base_t.data_ptr(), part_m.data_ptr(),
                part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
                ticket.data_ptr(), b, t, nkv, g, d, window, splits,
                float(d) ** -0.5, int(q.dtype == torch.bfloat16), stream)
        _build.check(rc, self.name)
        self.launches += 1
        return out


swa_decode_attention = SwaDecode()
