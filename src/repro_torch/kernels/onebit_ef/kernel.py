"""Launcher of the CUDA onebit_ef kernel (K8, ``csrc/onebit_ef.cu``).

Replaces ``src/repro/kernels/onebit_ef/kernel.py::onebit_ef`` (Pallas TPU).
Computes, per row of ``w = err + g`` (M, R): the sign classes ``w >= 0``,
their means (Eq. 30, counts clamped at 1), the sign map packed LSB first
into ``ceil(R / 8)`` bytes (pad bits zero) and the residual ``w - Q(w)``.
Any M and any R: the reference's ``R % 8 == 0`` requirement does not
carry over.

What bounds it: device-memory bytes, 12 an entry and one per 8 entries of
signs.  At the simulator's sizes one launch moves under half a
microsecond of bytes, so the launch and its dependent memory round trips
bound it, and the kernel reads each row once (the source says how).
:func:`plan` picks the route from the shape alone: a warp a row up to
``WARP_ROW_MAX`` entries, else a thread-block cluster a row (a plain
block where one CTA a row fills the card better).

The wrapper checks device, dtype, shape and contiguity, allocates the
outputs, launches on the current stream, raises on a non-zero launch error
and counts its launches in ``onebit_ef.launches``.  The library is built
at first use (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_VP, _LL = ctypes.c_void_p, ctypes.c_longlong
# the layout constants of csrc/onebit_ef.cu, checked against the library
WARP_ROW_MAX = 2048       # entries: a row up to here takes one warp
ROWS_PER_BLOCK_MAX = 8    # warp rows: rows (warps) a block, at most
CLUSTER_THREADS_MIN = 64  # cluster rows: threads a CTA, at least
CLUSTER_THREADS_MAX = 256  # and at most
CLUSTER_UNITS_MAX = 8     # units of 8 entries a thread holds a pass
CLUSTER_MAX = 8           # CTAs a cluster, the portable limit
SMS = 132                 # the H100's SMs
CLUSTER_CAPACITY = (CLUSTER_MAX * CLUSTER_THREADS_MAX * CLUSTER_UNITS_MAX
                    * 8)
"""Entries a cluster holds in registers; a longer row loops over passes."""


@functools.lru_cache(maxsize=None)
def plan(m: int, r: int):
    """-> ``(route, cluster, threads, units, passes)`` for an (m, r) call;
    it depends on the shape alone, so a row's summation order never
    depends on the card.

    Warp rows (r <= WARP_ROW_MAX): ``("warp", 0, 32 W, U, 1)``, U (a power
    of two) units a lane, W rows a block, doubled from 1 (up to
    ROWS_PER_BLOCK_MAX) while the blocks would still number SMS or more.

    Cluster rows: the cluster size C doubles from 1 (up to CLUSTER_MAX)
    while 2 C m <= SMS (one CTA an SM) and either 8 m <= SMS (few rows:
    spreading a row pays for the cluster barrier) or a thread of C CTAs of
    CLUSTER_THREADS_MAX would hold more than two units.  The threads T
    double from CLUSTER_THREADS_MIN (up to CLUSTER_THREADS_MAX) until C T
    units cover the row, then the units U from 1 (up to
    CLUSTER_UNITS_MAX); passes loop over what remains."""
    nb = -(-r // 8)
    if r <= WARP_ROW_MAX:
        units = 1
        while units * 32 < nb:
            units *= 2
        rows = 1
        while rows < ROWS_PER_BLOCK_MAX and -(-m // (2 * rows)) >= SMS:
            rows *= 2
        return "warp", 0, 32 * rows, units, 1
    c = 1
    while (c < CLUSTER_MAX and 2 * c * m <= SMS
           and (8 * m <= SMS or nb > 2 * c * CLUSTER_THREADS_MAX)):
        c *= 2
    t = CLUSTER_THREADS_MIN
    while t < CLUSTER_THREADS_MAX and c * t < nb:
        t *= 2
    u = 1
    while u < CLUSTER_UNITS_MAX and c * t * u < nb:
        u *= 2
    return "cluster", c, t, u, -(-nb // (c * t * u))


_CONSTANTS = (WARP_ROW_MAX, ROWS_PER_BLOCK_MAX, CLUSTER_THREADS_MIN,
              CLUSTER_THREADS_MAX, CLUSTER_UNITS_MAX, CLUSTER_MAX)


def _lib():
    lib = _build.load("onebit_ef")
    if not getattr(lib, "_typed", False):
        lib.onebit_ef_constants.argtypes = [_VP]
        lib.onebit_ef_constants.restype = None
        got = (ctypes.c_longlong * len(_CONSTANTS))()
        lib.onebit_ef_constants(got)
        if tuple(got) != _CONSTANTS:
            raise RuntimeError(f"onebit_ef: library constants {tuple(got)} "
                               f"!= the wrapper's {_CONSTANTS}")
        lib.onebit_ef_launch.argtypes = [_VP] * 5 + [_LL] * 5 + [_VP]
        lib.onebit_ef_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"onebit_ef: {msg}")


class OnebitEf:
    """``onebit_ef(g, err, out_err=None) -> (packed, means, new_err)`` on
    CUDA tensors; ``out_err`` (may be ``err`` itself) receives the
    residual in place."""

    name = "onebit_ef"
    source = "src/repro_torch/kernels/onebit_ef/csrc/onebit_ef.cu"
    replaces = "src/repro/kernels/onebit_ef/kernel.py:40"

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
        _, cluster, threads, units, _ = plan(m, r)
        lib = _lib()
        with torch.cuda.device(g.device):
            new_err = out_err if out_err is not None else torch.empty_like(g)
            packed = torch.empty((m, (r + 7) // 8), dtype=torch.uint8,
                                 device=g.device)
            means = torch.empty((m, 2), dtype=torch.float32, device=g.device)
            stream = torch.cuda.current_stream(g.device).cuda_stream
            rc = lib.onebit_ef_launch(
                g.data_ptr(), err.data_ptr(), packed.data_ptr(),
                means.data_ptr(), new_err.data_ptr(), m, r, cluster, threads,
                units, stream)
        _build.check(rc, self.name)
        self.launches += 1
        return packed, means, new_err


onebit_ef = OnebitEf()
