"""Launchers of the deposit kernels (K2 and K3).

* ``topk_cr_deposit`` — CUDA C++ (``csrc/topk_cr_deposit.cu``), bound with
  ``ctypes``.
* ``onebit_cr_deposit`` — Triton, defined below.

Replaces ``src/repro/kernels/cr_reduce/kernel.py::onebit_cr_deposit``
(Pallas TPU).  What bounds it: device-memory bytes — per message it reads
the (M, R) sign map (1 byte per entry) and reads and writes the (M, R) f32
slot it lands in; the select and multiply-add are free beside them.
Design: each program owns one block of the M*R entries and loops over the
S messages in order (``acc += select(pos, m_pos, m_neg) * w``), so no two
programs touch the same word and no atomics are needed; the order of the
messages, which decides the rounding when two share a slot, is the
plain version's.  Launched with ``enable_fp_fusion=False``: Triton would
otherwise contract ``q * w + acc`` into one FMA and change the bits; and
with ``num_stages=1``, so that no load of a later message is hoisted above
the store of an earlier one to the same slot; and with a block barrier
after each message, because the warp that stores an entry need not be the
one that loads it for the next message (without it, a message sharing its
slot with an earlier one read stale entries now and then on the card, at
large sizes only).

Both wrappers check device, dtype, shape and contiguity, update ``acc`` in
place (the reference donates it), launch on the current stream and count
their launches in ``.launches``.  ``triton`` is imported inside the
launching function, so this module imports on machines without it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_VP, _LL = ctypes.c_void_p, ctypes.c_longlong


def _need(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_ring(name, acc, slots, weights, s):
    _need(acc.is_cuda, name, "acc must be a CUDA tensor")
    _need(acc.dtype == torch.float32 and acc.ndim == 3
          and acc.is_contiguous(), name,
          f"acc must be contiguous (cap, M, R) float32, got {acc.dtype} "
          f"{tuple(acc.shape)}")
    _need(slots.device == acc.device and slots.dtype == torch.int32
          and tuple(slots.shape) == (s,), name,
          f"slots must be ({s},) int32 on {acc.device}")
    _need(weights.device == acc.device and weights.dtype == torch.float32
          and tuple(weights.shape) == (s,), name,
          f"weights must be ({s},) float32 on {acc.device}")


class TopkCrDeposit:
    """``topk_cr_deposit(acc, vals, idx, slots, weights) -> acc``."""

    name = "topk_cr_deposit"
    source = "src/repro_torch/kernels/cr_reduce/csrc/topk_cr_deposit.cu"
    replaces = "src/repro/kernels/cr_reduce/kernel.py:92"

    def __init__(self):
        self.launches = 0

    def __call__(self, acc, vals, idx, slots, weights):
        s, m, k = vals.shape
        _check_ring(self.name, acc, slots, weights, s)
        cap, am, r = acc.shape
        _need(am == m, self.name, f"acc rows {am} != payload rows {m}")
        _need(vals.device == acc.device and vals.dtype == torch.float32
              and vals.is_contiguous(), self.name,
              "vals must be contiguous float32 on the ring's device")
        _need(idx.device == acc.device and idx.dtype == torch.int32
              and tuple(idx.shape) == (s, m, k) and idx.is_contiguous(),
              self.name, f"idx must be contiguous ({s}, {m}, {k}) int32")
        lib = _build.load("topk_cr_deposit")
        if not getattr(lib, "_typed", False):
            lib.topk_cr_deposit_launch.argtypes = [_VP] * 5 + [_LL] * 4 + [_VP]
            lib.topk_cr_deposit_launch.restype = ctypes.c_int
            lib._typed = True
        with torch.cuda.device(acc.device):
            stream = torch.cuda.current_stream(acc.device).cuda_stream
            rc = lib.topk_cr_deposit_launch(
                acc.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                slots.data_ptr(), weights.data_ptr(), s, m, r, k, stream)
        _build.check(rc, self.name)
        self.launches += 1
        return acc


# triton.language, bound at the first launch (the kernel body below names
# it as a module global, as Triton resolves names in the function's globals)
tl = None
_ONEBIT_KERNEL = None


def _onebit_deposit_body(acc_ptr, pos_ptr, means_ptr, slots_ptr, w_ptr, S, M,
                         R, MR, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    live = offs < MR
    mean_off = (offs // R) * 2
    pos_row = pos_ptr
    means_row = means_ptr
    for s in range(0, S):
        slot = tl.load(slots_ptr + s).to(tl.int64)
        wt = tl.load(w_ptr + s)
        p = tl.load(pos_row + offs, mask=live, other=0)
        m_pos = tl.load(means_row + mean_off, mask=live, other=0.0)
        m_neg = tl.load(means_row + mean_off + 1, mask=live, other=0.0)
        q = tl.where(p != 0, m_pos, m_neg)
        a_ptr = acc_ptr + slot * MR + offs
        a = tl.load(a_ptr, mask=live, other=0.0)
        tl.store(a_ptr, a + q * wt, mask=live)
        # the store may run in another register layout than the next
        # message's load (the byte-wide sign map sets the layout of the
        # sum), so another warp may store what this one loads next: the
        # barrier makes every store of message s visible to message s + 1
        tl.debug_barrier()
        pos_row += MR
        means_row += M * 2


def _onebit_kernel():
    """Import Triton and JIT-wrap the kernel body (once)."""
    global tl, _ONEBIT_KERNEL
    if _ONEBIT_KERNEL is None:
        import triton
        import triton.language

        tl = triton.language
        _ONEBIT_KERNEL = triton.jit(_onebit_deposit_body)
    return _ONEBIT_KERNEL


class OnebitCrDeposit:
    """``onebit_cr_deposit(acc, pos, means, slots, weights) -> acc``."""

    name = "onebit_cr_deposit"
    source = "src/repro_torch/kernels/cr_reduce/kernel.py"
    replaces = "src/repro/kernels/cr_reduce/kernel.py:134"
    block = 1024

    def __init__(self):
        self.launches = 0

    def __call__(self, acc, pos, means, slots, weights):
        s, m, r = pos.shape
        _check_ring(self.name, acc, slots, weights, s)
        _need(tuple(acc.shape[1:]) == (m, r), self.name,
              f"acc slot shape {tuple(acc.shape[1:])} != pos rows {(m, r)}")
        _need(pos.device == acc.device and pos.dtype == torch.bool
              and pos.is_contiguous(), self.name,
              "pos must be contiguous bool on the ring's device")
        _need(means.device == acc.device and means.dtype == torch.float32
              and tuple(means.shape) == (s, m, 2) and means.is_contiguous(),
              self.name, f"means must be contiguous ({s}, {m}, 2) float32")
        kernel = _onebit_kernel()
        mr = m * r
        grid = ((mr + self.block - 1) // self.block,)
        with torch.cuda.device(acc.device):
            kernel[grid](acc, pos.view(torch.uint8), means, slots, weights,
                         s, m, r, mr, BLOCK=self.block, num_warps=4,
                         num_stages=1, enable_fp_fusion=False)
        self.launches += 1
        return acc


topk_cr_deposit = TopkCrDeposit()
onebit_cr_deposit = OnebitCrDeposit()
