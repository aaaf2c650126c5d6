"""Device kernels of a profiled step by what launched them, first match
by substring of the kernel's name: the port's compression kernels by their
CUDA function names, then the library's matrix products, copies and casts,
and the elementwise and reduction passes (the grouping of ``PERF.md``'s
profiles)."""
from __future__ import annotations

GROUPS = (
    ("K1", ("topk_ef_hist", "topk_ef_cand", "topk_ef_digit",
            "topk_ef_place")),
    ("K2", ("deposit_kernel",)),
    ("K3", ("onebit_deposit",)),
    ("K4", ("topk_reduce_",)),
    ("K5", ("onebit_reduce",)),
    ("matmul", ("nvjet", "gemm", "gemv", "xmma", "cutlass", "cublas",
                "sm90_", "sm80_")),
    ("copy / cast", ("copy", "Memcpy", "Memset")),
    ("elementwise / reduce", ("elementwise", "reduce", "softmax", "index")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def group_seconds(ops) -> dict:
    """Device seconds by group of ``(name, start us, dur us)`` ops."""
    out = {}
    for name, _, dur in ops:
        g = group_of(name)
        out[g] = out.get(g, 0.0) + dur * 1e-6
    return out
