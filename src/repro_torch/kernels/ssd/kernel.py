"""Launcher of the CUDA chunked SSD scan kernel (``csrc/ssd_chunked.cu``,
K10).

The wrapper checks device, dtype, shape and contiguity, allocates ``y``,
the final state and the workspace of the chunk states with
``torch.empty``, launches the kernel's three passes (chunk states, the
scan over chunks, outputs) on the current stream, raises on a non-zero
launch error and counts each call once in ``.launches``.

Under autograd (grad mode on and an input that requires grad, as in
zamba2 training) the call goes through :class:`_SsdFunction`: its forward
launches the kernel on the inputs exactly as the no-grad call does, and
keeps those inputs, not ``y``; its backward recomputes the plain version
of the same function, ``ref.ssd_plain``, under ``torch.enable_grad()`` and
returns ``torch.autograd.grad`` of ``(y, state)`` with the incoming
gradients.  The backward has no kernel by design: the JAX package has no
backward kernel for the scan either and differentiates its plain chunked
form.  A failed build or launch in the forward raises; it never gives way
to the plain forward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd.ref import CHUNK, chunk_len, ssd_plain

_VP, _LL = ctypes.c_void_p, ctypes.c_longlong
MAX_DIM = 128          # hd, N and the chunk


def _lib():
    lib = _build.load("ssd_chunked")
    if not getattr(lib, "_typed", False):
        lib.ssd_chunked_launch.argtypes = ([_VP] * 9 + [_LL] * 6
                                           + [ctypes.c_int, _VP])
        lib.ssd_chunked_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _pad16(v: int) -> int:
    return (v + 15) // 16 * 16


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_chunked: {msg}")


class SsdChunked:
    """``ssd_chunked(xh, a, bmat, cmat, *, chunk=128) -> (y, state)`` on
    CUDA tensors: xh (B, T, H, hd), a (B, T, H) float32, bmat and cmat
    (B, T, N) in xh's dtype (bfloat16 or float32), all contiguous; T a
    multiple of ``min(chunk, T)``; hd, N and the chunk at most 128.
    Returns y (B, T, H, hd) in xh's dtype and the final state (B, H, hd,
    N) float32, from a zero initial state."""

    name = "ssd_chunked"
    source = "src/repro_torch/kernels/ssd/csrc/ssd_chunked.cu"
    replaces = "src/repro/kernels/ssd/kernel.py:66"

    def __init__(self):
        self.launches = 0

    def __call__(self, xh, a, bmat, cmat, *, chunk: int = CHUNK):
        _need(xh.is_cuda, "xh must be a CUDA tensor")
        _need(xh.ndim == 4, f"xh must be (B, T, H, hd), got "
              f"{tuple(xh.shape)}")
        b, t, h, hd = xh.shape
        dev = xh.device
        _need(xh.dtype in (torch.bfloat16, torch.float32),
              f"dtype {xh.dtype} is neither bfloat16 nor float32")
        _need(bmat.ndim == 3 and tuple(bmat.shape[:2]) == (b, t),
              f"bmat {tuple(bmat.shape)} is not (B, T, N)")
        n = bmat.shape[2]
        c = chunk_len(t, chunk)
        _need(1 <= hd <= MAX_DIM and 1 <= n <= MAX_DIM and c <= MAX_DIM,
              f"hd={hd}, N={n}, chunk={c}: each must be at most {MAX_DIM}")
        _need(1 <= b <= 65535 and 1 <= h <= 65535,
              f"B={b}, H={h} out of range")
        _need(tuple(a.shape) == (b, t, h), f"a {tuple(a.shape)} is not "
              f"({b}, {t}, {h})")
        _need(tuple(cmat.shape) == tuple(bmat.shape),
              f"cmat {tuple(cmat.shape)} != bmat {tuple(bmat.shape)}")
        _need(a.dtype == torch.float32, f"a must be float32, got {a.dtype}")
        for what, v in (("xh", xh), ("a", a), ("bmat", bmat),
                        ("cmat", cmat)):
            _need(v.device == dev and v.is_contiguous(),
                  f"{what} must be contiguous on {dev}")
            if what != "a":
                _need(v.dtype == xh.dtype, f"{what} must be {xh.dtype}")
        if torch.is_grad_enabled() and any(
                v.requires_grad for v in (xh, a, bmat, cmat)):
            return _SsdFunction.apply(self, c, xh, a, bmat, cmat)
        return self._launch(xh, a, bmat, cmat, c)

    def _launch(self, xh, a, bmat, cmat, c: int):
        b, t, h, hd = xh.shape
        n = bmat.shape[2]
        dev = xh.device
        lib = _lib()
        with torch.cuda.device(dev):
            y = torch.empty_like(xh)
            state = torch.empty((b, h, hd, n), dtype=torch.float32,
                                device=dev)
            # the workspace, hd and N padded to 16: each chunk's state D
            # (f32 inputs: then the state the chunk starts from), exp(cum)
            # at each chunk's end and, for bf16 inputs, the starting states
            # in 3 bf16 parts
            nc, hdp, np_ = t // c, _pad16(hd), _pad16(n)
            bf16 = xh.dtype == torch.bfloat16
            ws = torch.empty((b, h, nc, hdp, np_), dtype=torch.float32,
                             device=dev)
            el = torch.empty((b, h, nc), dtype=torch.float32, device=dev)
            sp = torch.empty((b, h, nc, 3, hdp, np_) if bf16 else (0,),
                             dtype=torch.bfloat16, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.ssd_chunked_launch(
                xh.data_ptr(), a.data_ptr(), bmat.data_ptr(),
                cmat.data_ptr(), y.data_ptr(), state.data_ptr(),
                ws.data_ptr(), el.data_ptr(), sp.data_ptr() if bf16 else None,
                b, t, h, hd, n, c, int(bf16), stream)
        _build.check(rc, self.name)
        self.launches += 1
        return y, state


class _SsdFunction(torch.autograd.Function):
    """K10 forward, ``ssd_plain`` recomputed and differentiated backward."""

    @staticmethod
    def forward(ctx, kernel, chunk, xh, a, bmat, cmat):
        ctx.chunk = chunk
        ctx.save_for_backward(xh, a, bmat, cmat)
        ctx.set_materialize_grads(False)
        return kernel._launch(xh, a, bmat, cmat, chunk)

    @staticmethod
    def backward(ctx, g_y, g_state):
        need = ctx.needs_input_grad[2:]
        used = [(i, g) for i, g in enumerate((g_y, g_state)) if g is not None]
        if not used:
            return (None,) * 6
        with torch.enable_grad():
            ins = [v.detach().requires_grad_(r)
                   for v, r in zip(ctx.saved_tensors, need)]
            outs = ssd_plain(*ins, chunk=ctx.chunk)
            wrt = [v for v in ins if v.requires_grad]
            got = iter(torch.autograd.grad(
                [outs[i] for i, _ in used], wrt, [g for _, g in used],
                allow_unused=True, materialize_grads=True))
        return (None, None, *(next(got).to(v.dtype).contiguous() if r
                              else None for v, r in zip(ins, need)))


ssd_chunked = SsdChunked()
