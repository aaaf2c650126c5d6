"""Launchers of the CUDA simulator-step kernels (``csrc/sim_step.cu``):
``delivery_step`` (K6) and ``sync_step`` (K7).

Both are batched over a leading case axis B.  ``a`` is (d, d), shared by
every case, or (G, d, d) with ``x_star`` (G, d): case b then uses entry
``b // (B // G)`` (G = B: one problem per case; G < B: consecutive groups
of cases share one problem, as ``simulate_grid`` orders them).

The wrappers check device, dtype, shape and contiguity, allocate the
outputs with ``torch.empty``, launch on the current stream, raise on a
non-zero launch error and count their launches in ``.launches``.
``delivery_step`` keeps one zeroed ticket counter per case and device
across launches (each launch leaves it zeroed), so its launches on one
device must be ordered: one stream at a time.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_VP, _LL = ctypes.c_void_p, ctypes.c_longlong
MAX_WORKERS = 64


def _lib():
    lib = _build.load("sim_step")
    if not getattr(lib, "_typed", False):
        lib.sim_delivery_partial_floats.argtypes = [_LL, _LL, _LL]
        lib.sim_delivery_partial_floats.restype = _LL
        lib.sim_delivery_launch.argtypes = [_VP] * 13 + [_LL] * 4 + [_VP]
        lib.sim_delivery_launch.restype = ctypes.c_int
        lib.sim_sync_launch.argtypes = [_VP] * 6 + [_LL] * 3 + [_VP]
        lib.sim_sync_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _need(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check(name, t, shape, what, device):
    _need(t.device == device and t.dtype == torch.float32
          and tuple(t.shape) == tuple(shape) and t.is_contiguous(), name,
          f"{what} must be contiguous float32 {tuple(shape)} on {device}, "
          f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _problem_group(name, a, x_star, b, d, device):
    """-> cases per problem entry, after checking ``a`` and ``x_star``."""
    if a.ndim == 2:
        _check(name, a, (d, d), "a", device)
        _check(name, x_star, (d,), "x_star", device)
        return b
    g = a.shape[0]
    _need(g >= 1 and b % g == 0, name, f"{g} problems do not divide {b} cases")
    _check(name, a, (g, d, d), "a", device)
    _check(name, x_star, (g, d), "x_star", device)
    return b // g


class DeliveryStep:
    """``delivery_step(v, x, a, x_star, noise, u, defer=None)
    -> (x', v', defer' or None, sq)`` on CUDA tensors: v, noise, defer
    (B, p, d); x (B, d); u (B, 1 + p, p), or (B, 1 + 2p, p) with defer;
    ``sq`` (B, p) is ``sum((x' - v'_i)^2)`` per worker."""

    name = "delivery_step"
    source = "src/repro_torch/kernels/sim_step/csrc/sim_step.cu"
    replaces = "src/repro/kernels/sim_step/kernel.py:73"

    def __init__(self):
        self.launches = 0
        self._tickets: dict = {}

    def _ticket(self, device, b):
        """A zeroed counter per case, kept across launches (each launch
        leaves it zeroed)."""
        t = self._tickets.get(device)
        if t is None or t.numel() < b:
            t = torch.zeros(max(b, 64), dtype=torch.int32, device=device)
            self._tickets[device] = t
        return t

    def __call__(self, v, x, a, x_star, noise, u, defer=None):
        name = self.name
        _need(v.is_cuda, name, "v must be a CUDA tensor")
        _need(v.ndim == 3, name, f"v must be (B, p, d), got {tuple(v.shape)}")
        b, p, d = v.shape
        dev = v.device
        _need(1 <= p <= MAX_WORKERS, name,
              f"p={p} workers outside [1, {MAX_WORKERS}]")
        _need(1 <= b <= 65535 and d >= 1, name, f"B={b}, d={d} out of range")
        m = 1 + 2 * p if defer is not None else 1 + p
        for what, t, shape in (("v", v, (b, p, d)), ("x", x, (b, d)),
                               ("noise", noise, (b, p, d)),
                               ("u", u, (b, m, p))):
            _check(name, t, shape, what, dev)
        if defer is not None:
            _check(name, defer, (b, p, d), "defer", dev)
        group = _problem_group(name, a, x_star, b, d, dev)
        lib = _lib()
        with torch.cuda.device(dev):
            x_out = torch.empty_like(x)
            v_out = torch.empty_like(v)
            defer_out = torch.empty_like(v) if defer is not None else None
            sq = torch.empty((b, p), dtype=torch.float32, device=dev)
            partial = torch.empty(
                int(lib.sim_delivery_partial_floats(b, p, d)),
                dtype=torch.float32, device=dev)
            ticket = self._ticket(dev, b)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.sim_delivery_launch(
                v.data_ptr(), x.data_ptr(), a.data_ptr(), x_star.data_ptr(),
                noise.data_ptr(), u.data_ptr(),
                defer.data_ptr() if defer is not None else None,
                x_out.data_ptr(), v_out.data_ptr(),
                defer_out.data_ptr() if defer_out is not None else None,
                partial.data_ptr(), sq.data_ptr(), ticket.data_ptr(), b, p, d,
                group, stream)
        _build.check(rc, name)
        self.launches += 1
        return x_out, v_out, defer_out, sq


class SyncStep:
    """``sync_step(x, a, x_star, nsum, c) -> x'`` on CUDA tensors: x, nsum
    (B, d); c (B,) the per-case gradient weight."""

    name = "sync_step"
    source = "src/repro_torch/kernels/sim_step/csrc/sim_step.cu"
    replaces = "src/repro/kernels/sim_step/kernel.py:120"

    def __init__(self):
        self.launches = 0

    def __call__(self, x, a, x_star, nsum, c):
        name = self.name
        _need(x.is_cuda, name, "x must be a CUDA tensor")
        _need(x.ndim == 2, name, f"x must be (B, d), got {tuple(x.shape)}")
        b, d = x.shape
        dev = x.device
        _need(1 <= b <= 65535 and d >= 1, name, f"B={b}, d={d} out of range")
        for what, t, shape in (("x", x, (b, d)), ("nsum", nsum, (b, d)),
                               ("c", c, (b,))):
            _check(name, t, shape, what, dev)
        group = _problem_group(name, a, x_star, b, d, dev)
        lib = _lib()
        with torch.cuda.device(dev):
            x_out = torch.empty_like(x)
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.sim_sync_launch(x.data_ptr(), a.data_ptr(),
                                     x_star.data_ptr(), nsum.data_ptr(),
                                     c.data_ptr(), x_out.data_ptr(), b, d,
                                     group, stream)
        _build.check(rc, name)
        self.launches += 1
        return x_out


delivery_step = DeliveryStep()
sync_step = SyncStep()
