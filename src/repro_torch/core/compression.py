"""Lossy gradient compression operators (paper §4.1(d), Appendix B.7),
counterpart of ``repro.core.compression``.

Every operator ``Q`` satisfies the contraction property (Eq. 25):

    ||Q(w) - w||^2 <= gamma * ||w||^2,   0 <= gamma < 1

which is what the elastic-consistency bound for error-feedback methods needs
(Lemma 18: B = sqrt((2-gamma)*gamma/(1-gamma)^3) * M).

``ef_compress`` implements one error-feedback round of Algorithm 6:
w = eps + u;  payload = Q(w);  eps' = w - Q(w).  ``ef_compress_rows`` runs
one round per row through the port's kernels: top-k through ``topk_ef``
(K1), one-bit through ``onebit_ef`` (K8), any row length.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


# ---------------------------------------------------------------------------
# Top-K sparsification (Strom'15 / Aji-Heafield'17 style)
# ---------------------------------------------------------------------------

def topk_compress(w: torch.Tensor, k: int):
    """Magnitude top-k of a flat vector: ``(values, indices)``.  A stable
    descending sort puts equal magnitudes in index order, so the lowest
    index wins a tie, as ``lax.top_k`` does."""
    flat = w.reshape(-1)
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return flat[idx], idx


def topk_decompress(values, idx, n: int):
    out = torch.zeros((n,), dtype=values.dtype, device=values.device)
    return out.index_copy_(0, idx, values)


def topk_q(w: torch.Tensor, k: int) -> torch.Tensor:
    """Dense Q(w) for theory checks."""
    vals, idx = topk_compress(w, k)
    return topk_decompress(vals, idx, w.numel()).reshape(w.shape)


def topk_gamma(n: int, k: int) -> float:
    """TopK satisfies (25) with gamma = (n-k)/n."""
    return (n - k) / n


# ---------------------------------------------------------------------------
# One-bit quantization (Seide et al.'14, Eq. 30)
# ---------------------------------------------------------------------------

def _class_means(flat32: torch.Tensor, pos: torch.Tensor):
    n_pos = torch.clamp(pos.sum(), min=1)
    n_neg = torch.clamp((~pos).sum(), min=1)
    zero = torch.zeros((), dtype=flat32.dtype, device=flat32.device)
    mean_pos = torch.where(pos, flat32, zero).sum() / n_pos
    mean_neg = torch.where(pos, zero, flat32).sum() / n_neg
    return mean_pos, mean_neg


def onebit_q(w: torch.Tensor) -> torch.Tensor:
    """[Q(w)]_i = mean of w over the sign class of i."""
    flat = w.reshape(-1).float()
    pos = flat >= 0
    mean_pos, mean_neg = _class_means(flat, pos)
    return torch.where(pos, mean_pos, mean_neg).reshape(w.shape).to(w.dtype)


def onebit_compress(w: torch.Tensor):
    """Wire format: (sign bitmap packed LSB first into uint8, mean_pos,
    mean_neg)."""
    flat = w.reshape(-1)
    pos = flat >= 0
    pad = (-flat.numel()) % 8
    bits = torch.nn.functional.pad(pos, (0, pad)).reshape(-1, 8)
    weights = 2 ** torch.arange(8, dtype=torch.int32, device=w.device)
    packed = (bits.to(torch.int32) * weights).sum(-1).to(torch.uint8)
    mean_pos, mean_neg = _class_means(flat.float(), pos)
    return packed, mean_pos, mean_neg


def onebit_decompress(packed, mean_pos, mean_neg, n: int,
                      dtype=torch.float32):
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, None] >> shifts) & 1
    pos = bits.reshape(-1)[:n].bool()
    return torch.where(pos, mean_pos, mean_neg).to(dtype)


def onebit_gamma(n: int) -> float:
    """One-bit quantization satisfies (25) with gamma = 1 - 1/d in the worst
    case (paper App. B.7)."""
    return 1.0 - 1.0 / n


# ---------------------------------------------------------------------------
# QSGD-style unbiased random quantization (Alistarh et al.'17)
# ---------------------------------------------------------------------------

def qsgd_q(w: torch.Tensor, gen: torch.Generator,
           levels: int = 4) -> torch.Tensor:
    """Stochastic uniform quantization to ``levels`` levels of |w|/||w||,
    with the uniform draws from ``gen``.  Unbiased: E[Q(w)] = w."""
    flat = w.reshape(-1).float()
    norm = torch.linalg.vector_norm(flat) + 1e-30
    scaled = flat.abs() / norm * levels
    lower = torch.floor(scaled)
    prob = scaled - lower
    rnd = torch.rand(flat.shape, generator=gen, device=flat.device)
    q = (lower + (rnd < prob)) / levels
    return (torch.sign(flat) * q * norm).reshape(w.shape).to(w.dtype)


# ---------------------------------------------------------------------------
# Error feedback (Algorithm 6)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Compressor:
    """Dense-form compressor with its contraction constant.

    ``kind``/``ratio`` let batched callers (the simulator engine) route the
    row-wise EF round through the kernels instead of the dense ``q``;
    ``kind="custom"`` always takes the dense path.
    """

    q: Callable[[torch.Tensor], torch.Tensor]
    gamma: Callable[[int], float]
    name: str
    kind: str = "custom"          # topk | onebit | custom
    ratio: float = 0.0            # topk only


def topk_compressor(ratio: float) -> Compressor:
    def q(w):
        k = max(1, int(round(w.numel() * ratio)))
        return topk_q(w, k)

    return Compressor(q, lambda n: topk_gamma(n, max(1, int(round(n * ratio)))),
                      f"topk{ratio}", kind="topk", ratio=ratio)


def onebit_compressor() -> Compressor:
    return Compressor(onebit_q, onebit_gamma, "onebit", kind="onebit")


def ef_compress(comp: Compressor, update: torch.Tensor, err: torch.Tensor):
    """One error-feedback round (Alg 6 lines 2-4).

    update: alpha * gradient;  err: accumulated residual.
    Returns (payload Q(w), new_err)."""
    w = err + update
    payload = comp.q(w)
    return payload, w - payload


def ef_compress_rows(comp: Compressor, updates: torch.Tensor,
                     errs: torch.Tensor):
    """Batched error-feedback round: one row per worker.

    updates/errs: (M, d) — each row is an independent Alg-6 round (row-local
    selection == per-worker global selection, since each worker is one
    row).  Top-k rows go to the ``topk_ef`` kernel (K1) and one-bit rows to
    ``onebit_ef`` (K8), any d; a CPU tensor takes their plain versions.
    Returns (payloads (M, d), new_errs (M, d)) with payload = Q(w) = w -
    new_err, w = err + upd.
    """
    upd = updates.float()
    w = errs + upd
    if comp.kind == "topk":
        from repro_torch.kernels.topk_ef.ops import compress_rows
        _, _, new_errs = compress_rows(upd, errs, comp.ratio)
        return w - new_errs, new_errs
    if comp.kind == "onebit":
        from repro_torch.kernels.onebit_ef.ops import compress_rows
        _, _, new_errs = compress_rows(upd, errs)
        return w - new_errs, new_errs
    payloads = torch.stack([comp.q(row) for row in w])
    return payloads, w - payloads
