"""Build and load the port's CUDA C++ kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
into its own shared library for ``sm_90a``, then loaded with ``ctypes``.
Libraries are built at first use from the sources in the checkout, into
``kernels/_build/`` (ignored by git), and named by a hash of the source and
the flags, so an edited source is never served a stale library.
:func:`build_all` starts one ``nvcc`` per source at once and waits for all.
:class:`Tickets` keeps the zeroed counters the fused reductions share.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every CUDA C++ source of the port, by library name
SOURCES = {
    "topk_ef": KERNELS_DIR / "topk_ef" / "csrc" / "topk_ef.cu",
    "topk_cr_deposit": KERNELS_DIR / "cr_reduce" / "csrc" /
    "topk_cr_deposit.cu",
    "topk_cr_reduce": KERNELS_DIR / "cr_reduce" / "csrc" /
    "topk_cr_reduce.cu",
    "sim_step": KERNELS_DIR / "sim_step" / "csrc" / "sim_step.cu",
    "swa_decode": KERNELS_DIR / "swa_attention" / "csrc" / "swa_decode.cu",
    "ssd_chunked": KERNELS_DIR / "ssd" / "csrc" / "ssd_chunked.cu",
    "onebit_ef": KERNELS_DIR / "onebit_ef" / "csrc" / "onebit_ef.cu",
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine with the card")


def lib_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every missing library in parallel; returns ``{name: ptxas
    report}`` for the ones built now.  Raises with the compiler's output
    when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


class Tickets:
    """Zeroed integer ticket counters, per device, kept across launches: the
    last block of a group finds itself by one, and each launch leaves the
    counters it used zeroed.  So the launches of one wrapper on one device
    must be ordered: one stream at a time."""

    def __init__(self):
        self._tickets: dict = {}

    def __call__(self, device, n: int):
        """At least ``n`` zeroed int32 counters on ``device``."""
        t = self._tickets.get(device)
        if t is None or t.numel() < n:
            t = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
            self._tickets[device] = t
        return t


def check(rc: int, what: str) -> None:
    """Raise when a launcher returned a non-zero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
