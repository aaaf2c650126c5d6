"""Launcher of the Triton onebit_ef kernel (K8).

Replaces ``src/repro/kernels/onebit_ef/kernel.py::onebit_ef`` (Pallas TPU).
Computes, per row of ``w = err + g`` (M, R): the sign classes ``w >= 0``,
their means (Eq. 30, counts clamped at 1), the sign map packed LSB first
into ``ceil(R / 8)`` bytes (pad bits zero) and the residual ``w - Q(w)``.
Any M and any R: the reference's ``R % 8 == 0`` requirement does not
carry over.

What bounds it: device-memory bytes.  It reads g and err and writes the
residual (12 bytes per entry) plus R/8 bytes of signs; the arithmetic is a
few operations per entry.  At the simulator's sizes (M = p <= 32, R = d <=
512) one launch does far less than a microsecond of work, so the launch
itself bounds it.

Design: one program per row, looping over the row in chunks of
``8 * BYTES`` entries laid out as a (BYTES, 8) tile, so that each tile row
is one output byte: pass 1 accumulates the masked sums and the count in
per-lane partials, reduced in one fixed order at the end (deterministic,
no atomics); pass 2 reloads the chunk, writes the residual and packs each
tile row's 8 signs into its byte.  Launched with ``enable_fp_fusion=False``
so that ``w - q`` is rounded as in the plain version.

The wrapper checks device, dtype, shape and contiguity, allocates the
outputs, launches on the current stream and counts its launches in
``onebit_ef.launches``.  ``triton`` is imported inside the launching
function, so this module imports on machines without it.
"""
from __future__ import annotations

import torch

# triton.language, bound at the first launch (the kernel body names it as a
# module global, as Triton resolves names in the function's globals)
tl = None
_KERNEL = None


def _onebit_ef_body(g_ptr, e_ptr, packed_ptr, means_ptr, err_ptr, R, NBYTES,
                    BYTES: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    g_row = g_ptr + row * R
    e_row = e_ptr + row * R
    byte = tl.arange(0, BYTES)
    bit = tl.arange(0, 8)
    s_pos = tl.zeros((BYTES, 8), dtype=tl.float32)
    s_neg = tl.zeros((BYTES, 8), dtype=tl.float32)
    n_pos = tl.zeros((BYTES, 8), dtype=tl.int32)
    for b0 in range(0, NBYTES, BYTES):
        idx = (b0 + byte)[:, None] * 8 + bit[None, :]
        live = idx < R
        w = tl.load(e_row + idx, mask=live, other=0.0) + \
            tl.load(g_row + idx, mask=live, other=0.0)
        pos = (w >= 0.0) & live
        s_pos += tl.where(pos, w, 0.0)
        s_neg += tl.where(pos, 0.0, w)
        n_pos += pos.to(tl.int32)
    count = tl.sum(tl.sum(n_pos, axis=1), axis=0)
    mean_pos = tl.sum(tl.sum(s_pos, axis=1), axis=0) / \
        tl.maximum(count, 1).to(tl.float32)
    mean_neg = tl.sum(tl.sum(s_neg, axis=1), axis=0) / \
        tl.maximum(R - count, 1).to(tl.float32)
    tl.store(means_ptr + row * 2, mean_pos)
    tl.store(means_ptr + row * 2 + 1, mean_neg)
    out_row = err_ptr + row * R
    packed_row = packed_ptr + row * NBYTES
    for b0 in range(0, NBYTES, BYTES):
        idx = (b0 + byte)[:, None] * 8 + bit[None, :]
        live = idx < R
        w = tl.load(e_row + idx, mask=live, other=0.0) + \
            tl.load(g_row + idx, mask=live, other=0.0)
        pos = (w >= 0.0) & live
        tl.store(out_row + idx, w - tl.where(pos, mean_pos, mean_neg),
                 mask=live)
        bits = tl.sum(pos.to(tl.int32) << bit[None, :], axis=1)
        tl.store(packed_row + b0 + byte, bits.to(tl.uint8),
                 mask=(b0 + byte) < NBYTES)


def _kernel():
    """Import Triton and JIT-wrap the kernel body (once)."""
    global tl, _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language

        tl = triton.language
        _KERNEL = triton.jit(_onebit_ef_body)
    return _KERNEL


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"onebit_ef: {msg}")


class OnebitEf:
    """``onebit_ef(g, err, out_err=None) -> (packed, means, new_err)`` on
    CUDA tensors; ``out_err`` (may be ``err`` itself) receives the
    residual in place."""

    name = "onebit_ef"
    source = "src/repro_torch/kernels/onebit_ef/kernel.py"
    replaces = "src/repro/kernels/onebit_ef/kernel.py:40"
    bytes_per_chunk = 128

    def __init__(self):
        self.launches = 0

    def __call__(self, g: torch.Tensor, err: torch.Tensor,
                 out_err: torch.Tensor | None = None):
        _need(g.is_cuda, "g must be a CUDA tensor")
        _need(g.dtype == torch.float32 and g.ndim == 2 and g.is_contiguous(),
              f"g must be contiguous (M, R) float32, got {g.dtype} "
              f"{tuple(g.shape)}")
        m, r = g.shape
        _need(m >= 1 and 1 <= r < 2 ** 31, f"shape {(m, r)} out of range")
        for what, t in (("err", err), ("out_err", out_err)):
            if t is not None:
                _need(t.device == g.device and t.dtype == torch.float32
                      and tuple(t.shape) == (m, r) and t.is_contiguous(),
                      f"{what} must be contiguous float32 {(m, r)} on "
                      f"{g.device}")
        _need(err is not None, "err is required")
        kernel = _kernel()
        nbytes = (r + 7) // 8
        with torch.cuda.device(g.device):
            new_err = out_err if out_err is not None else torch.empty_like(g)
            packed = torch.empty((m, nbytes), dtype=torch.uint8,
                                 device=g.device)
            means = torch.empty((m, 2), dtype=torch.float32, device=g.device)
            kernel[(m,)](g, err, packed, means, new_err, r, nbytes,
                         BYTES=self.bytes_per_chunk, num_warps=4,
                         enable_fp_fusion=False)
        self.launches += 1
        return packed, means, new_err


onebit_ef = OnebitEf()
