"""Launcher of the CUDA topk_ef kernel (``csrc/topk_ef.cu``, K1).

The wrapper checks device, dtype, shape and contiguity, allocates the
outputs and the per-call scratch (the look-back words, the row states and
the candidate lists) with ``torch.empty``, launches on the current stream,
raises on a non-zero launch error and counts its launches in
``topk_ef.launches``.  It also keeps, per device, the zeroed scratch the
kernel's histograms, tickets and counters live in (each call leaves it
zeroed), so its launches on one device must be ordered: one stream at a
time.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_VP, _LL = ctypes.c_void_p, ctypes.c_longlong
CAP_MIN, CAP_DIV = 1 << 16, 16     # the candidate list: see candidate_cap


def candidate_cap(r: int) -> int:
    """Keys a row's candidate list holds: ``max(R / 16, min(R, 65536))``,
    rounded up to a multiple of 4.  On Gaussian-like rows at ratio 1/16
    the threshold bin holds about 1.8% of the row; a row whose bin holds
    more takes the kernel's second route (its digit pass reads the row
    again), chosen on the device."""
    cap = max(r // CAP_DIV, min(r, CAP_MIN))
    return -(-cap // 4) * 4


def _lib():
    lib = _build.load("topk_ef")
    if not getattr(lib, "_typed", False):
        lib.topk_ef_scratch_words.argtypes = [_LL, _LL, _LL]
        lib.topk_ef_scratch_words.restype = _LL
        lib.topk_ef_zeroed_words.argtypes = [_LL]
        lib.topk_ef_zeroed_words.restype = _LL
        lib.topk_ef_launch.argtypes = [_VP] * 7 + [_LL] * 4 + [_VP]
        lib.topk_ef_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"topk_ef: {msg}")


class TopkEf:
    """``topk_ef(g, err, k, out_err=None) -> (vals, idx, new_err)`` on
    CUDA tensors; ``err=None`` is a zero residual and ``out_err`` (may be
    ``err`` itself) receives the residual in place."""

    name = "topk_ef"
    source = "src/repro_torch/kernels/topk_ef/csrc/topk_ef.cu"
    replaces = "src/repro/kernels/topk_ef/kernel.py:48"

    def __init__(self):
        self.launches = 0
        self._zeroed = _build.Tickets()

    def __call__(self, g: torch.Tensor, err: torch.Tensor | None, k: int,
                 out_err: torch.Tensor | None = None):
        _need(g.is_cuda, "g must be a CUDA tensor")
        _need(g.dtype == torch.float32 and g.ndim == 2 and g.is_contiguous(),
              f"g must be contiguous (M, R) float32, got {g.dtype} "
              f"{tuple(g.shape)}")
        m, r = g.shape
        _need(0 < r < 2 ** 31, f"row length {r} outside [1, 2^31)")
        _need(1 <= k <= r, f"k={k} outside [1, {r}]")
        for name, t in (("err", err), ("out_err", out_err)):
            if t is not None:
                _need(t.device == g.device and t.dtype == torch.float32
                      and tuple(t.shape) == (m, r) and t.is_contiguous(),
                      f"{name} must be contiguous float32 {(m, r)} on "
                      f"{g.device}")
        lib = _lib()
        cap = candidate_cap(r)
        with torch.cuda.device(g.device):
            new_err = out_err if out_err is not None else torch.empty_like(g)
            vals = torch.empty((m, k), dtype=torch.float32, device=g.device)
            idx = torch.empty((m, k), dtype=torch.int32, device=g.device)
            scratch = torch.empty(int(lib.topk_ef_scratch_words(m, r, cap)),
                                  dtype=torch.int32, device=g.device)
            zeroed = self._zeroed(g.device, int(lib.topk_ef_zeroed_words(m)))
            stream = torch.cuda.current_stream(g.device).cuda_stream
            rc = lib.topk_ef_launch(
                g.data_ptr(), err.data_ptr() if err is not None else None,
                new_err.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                scratch.data_ptr(), zeroed.data_ptr(), m, r, k, cap, stream)
        _build.check(rc, "topk_ef")
        self.launches += 1
        return vals, idx, new_err


topk_ef = TopkEf()
