"""Launchers of the reduce kernels (K4, K5) and the deposit kernels (K2,
K3).

* ``topk_cr_reduce`` (K4) — CUDA C++ (``csrc/topk_cr_reduce.cu``), bound
  with ``ctypes``: a run pass over the indices, then one block per row
  segment adds every message's picks there in shared memory and writes the
  segment once (the segment route, for payloads in K1's order); a payload
  in another order takes the atomic route, chosen on the device.
* ``onebit_cr_reduce`` (K5) — Triton, defined below.
* ``topk_cr_deposit`` (K2) — CUDA C++ (``csrc/topk_cr_deposit.cu``).
* ``onebit_cr_deposit`` (K3) — Triton, defined below.

``onebit_cr_reduce`` replaces ``src/repro/kernels/cr_reduce/kernel.py::
onebit_cr_reduce`` (Pallas TPU).  What bounds it: device-memory bytes —
per entry it reads S sign bytes, and per row and message two means, and
writes one f32; the select and multiply-add are free beside them.
Design: each program owns one block of the M*R entries, keeps the sum in
registers from a zero start, loops over the S messages in order (``acc =
acc + select(pos, m_pos, m_neg) * w``) and stores once, so no two programs
touch the same word and the rounding is the plain version's.  Launched
with ``enable_fp_fusion=False``, so that no FMA changes the bits.  Each
program writes only its own words, once, so it needs none of K3's
per-message barriers.

``onebit_cr_deposit`` replaces ``…/kernel.py::onebit_cr_deposit``.  What
bounds it: device-memory bytes — per message it reads the (M, R) sign map
(1 byte per entry) and reads and writes the (M, R) f32 slot it lands in.
Design: as K5, but the sum lives in the ring: each program loops over the
S messages in order (``acc += select(pos, m_pos, m_neg) * w``), so no two
programs touch the same word and no atomics are needed; the order of the
messages, which decides the rounding when two share a slot, is the plain
version's.  Launched with ``enable_fp_fusion=False``, and with
``num_stages=1``, so that no load of a later message is hoisted above the
store of an earlier one to the same slot; and with a block barrier after
each message, because the warp that stores an entry need not be the one
that loads it for the next message (without it, a message sharing its
slot with an earlier one read stale entries now and then on the card, at
large sizes only).

Every wrapper checks device, dtype, shape and contiguity, launches on the
current stream and counts its calls in ``.launches``; the reduces allocate
their output, the deposits update ``acc`` in place (the reference donates
it).  ``triton`` is imported inside the launching function, so this module
imports on machines without it.
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


class TopkCrReduce:
    """``topk_cr_reduce(vals, idx, weights, r) -> (M, R) f32``: vals (S, M,
    k) bf16 or f32, idx (S, M, k) int32, weights (S,) f32, all on one card.
    Indices must lie in [0, r); a top-k message's are unique within a row,
    which makes the result bitwise the plain version's.  With duplicates
    inside one message the sum is still right, but the order of its adds,
    and so its rounding, is not fixed.  With S = 0 or k = 0 the output is
    the zero fill alone.  Each call allocates its scratch (the route flag,
    the runs and the segment crossings: about 8 bytes a payload row per
    8,192 entries of R); :meth:`last_route` reads the last call's route."""

    name = "topk_cr_reduce"
    source = "src/repro_torch/kernels/cr_reduce/csrc/topk_cr_reduce.cu"
    replaces = "src/repro/kernels/cr_reduce/kernel.py:50"

    def __init__(self):
        self.launches = 0
        self._scratch = None

    def __call__(self, vals, idx, weights, r: int):
        name = self.name
        _need(vals.is_cuda, name, "vals must be a CUDA tensor")
        _need(vals.dtype in (torch.float32, torch.bfloat16) and vals.ndim == 3
              and vals.is_contiguous(), name,
              f"vals must be contiguous (S, M, k) float32 or bfloat16, got "
              f"{vals.dtype} {tuple(vals.shape)}")
        s, m, k = vals.shape
        _need(idx.device == vals.device and idx.dtype == torch.int32
              and tuple(idx.shape) == (s, m, k) and idx.is_contiguous(),
              name, f"idx must be contiguous ({s}, {m}, {k}) int32")
        _need(weights.device == vals.device
              and weights.dtype == torch.float32
              and tuple(weights.shape) == (s,), name,
              f"weights must be ({s},) float32 on {vals.device}")
        _need(0 <= r < 2 ** 31 and (k <= r or s == 0), name,
              f"r={r} must be in [0, 2^31) and at least k={k}")
        out = torch.empty((m, r), dtype=torch.float32, device=vals.device)
        lib = _build.load("topk_cr_reduce")
        if not getattr(lib, "_typed", False):
            lib.topk_cr_reduce_launch.argtypes = [_VP, _VP, ctypes.c_int,
                                                  _VP, _VP, _VP] + [_LL] * 4 \
                + [_VP]
            lib.topk_cr_reduce_launch.restype = ctypes.c_int
            lib.topk_cr_reduce_scratch_words.argtypes = [_LL] * 3
            lib.topk_cr_reduce_scratch_words.restype = _LL
            lib._typed = True
        scratch = torch.empty(lib.topk_cr_reduce_scratch_words(s, m, r),
                              dtype=torch.int32, device=vals.device)
        with torch.cuda.device(vals.device):
            stream = torch.cuda.current_stream(vals.device).cuda_stream
            rc = lib.topk_cr_reduce_launch(
                out.data_ptr(), vals.data_ptr(),
                int(vals.dtype == torch.bfloat16), idx.data_ptr(),
                weights.data_ptr(), scratch.data_ptr(), s, m, r, k, stream)
        _build.check(rc, name)
        self._scratch = scratch
        self.launches += 1
        return out

    def last_route(self) -> str:
        """``"segment"`` or ``"atomic"``: the route the last call took,
        read back from its scratch (a host sync: for checks, never on the
        path)."""
        return "atomic" if int(self._scratch[0]) else "segment"

    def release_scratch(self) -> None:
        """Drop the last call's scratch, kept for :meth:`last_route`."""
        self._scratch = None


# triton.language, bound at the first launch (the kernel body below names
# it as a module global, as Triton resolves names in the function's globals)
tl = None
_ONEBIT_KERNEL = None
_ONEBIT_REDUCE_KERNEL = None


def _onebit_reduce_body(out_ptr, pos_ptr, means_ptr, w_ptr, S, M, R, MR,
                        BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    live = offs < MR
    mean_off = (offs // R) * 2
    pos_row = pos_ptr
    means_row = means_ptr
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for s in range(0, S):
        wt = tl.load(w_ptr + s)
        p = tl.load(pos_row + offs, mask=live, other=0)
        m_pos = tl.load(means_row + mean_off, mask=live, other=0.0)
        m_neg = tl.load(means_row + mean_off + 1, mask=live, other=0.0)
        acc = acc + tl.where(p != 0, m_pos, m_neg) * wt
        pos_row += MR
        means_row += M * 2
    tl.store(out_ptr + offs, acc, mask=live)


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


def _triton_kernels():
    """Import Triton and JIT-wrap the kernel bodies (once); -> (deposit,
    reduce)."""
    global tl, _ONEBIT_KERNEL, _ONEBIT_REDUCE_KERNEL
    if _ONEBIT_KERNEL is None:
        import triton
        import triton.language

        tl = triton.language
        _ONEBIT_KERNEL = triton.jit(_onebit_deposit_body)
        _ONEBIT_REDUCE_KERNEL = triton.jit(_onebit_reduce_body)
    return _ONEBIT_KERNEL, _ONEBIT_REDUCE_KERNEL


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
        kernel = _triton_kernels()[0]
        mr = m * r
        grid = ((mr + self.block - 1) // self.block,)
        with torch.cuda.device(acc.device):
            kernel[grid](acc, pos.view(torch.uint8), means, slots, weights,
                         s, m, r, mr, BLOCK=self.block, num_warps=4,
                         num_stages=1, enable_fp_fusion=False)
        self.launches += 1
        return acc


class OnebitCrReduce:
    """``onebit_cr_reduce(pos, means, weights) -> (M, R) f32``: pos (S, M,
    R) bool, means (S, M, 2) f32, weights (S,) f32, all on one card."""

    name = "onebit_cr_reduce"
    source = "src/repro_torch/kernels/cr_reduce/kernel.py"
    replaces = "src/repro/kernels/cr_reduce/kernel.py:177"
    block = 1024

    def __init__(self):
        self.launches = 0

    def __call__(self, pos, means, weights):
        name = self.name
        _need(pos.is_cuda, name, "pos must be a CUDA tensor")
        _need(pos.dtype == torch.bool and pos.ndim == 3
              and pos.is_contiguous(), name,
              f"pos must be contiguous (S, M, R) bool, got {pos.dtype} "
              f"{tuple(pos.shape)}")
        s, m, r = pos.shape
        _need(means.device == pos.device and means.dtype == torch.float32
              and tuple(means.shape) == (s, m, 2) and means.is_contiguous(),
              name, f"means must be contiguous ({s}, {m}, 2) float32")
        _need(weights.device == pos.device and weights.dtype == torch.float32
              and tuple(weights.shape) == (s,), name,
              f"weights must be ({s},) float32 on {pos.device}")
        out = torch.empty((m, r), dtype=torch.float32, device=pos.device)
        mr = m * r
        if mr:
            kernel = _triton_kernels()[1]
            grid = ((mr + self.block - 1) // self.block,)
            with torch.cuda.device(pos.device):
                kernel[grid](out, pos.view(torch.uint8), means, weights, s, m,
                             r, mr, BLOCK=self.block, num_warps=4,
                             enable_fp_fusion=False)
        self.launches += 1
        return out


topk_cr_reduce = TopkCrReduce()
onebit_cr_reduce = OnebitCrReduce()
topk_cr_deposit = TopkCrDeposit()
onebit_cr_deposit = OnebitCrDeposit()
