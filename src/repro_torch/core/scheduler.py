"""Row-space geometry and local EF compression of one leaf (counterpart of
the per-leaf helpers of ``repro.core.scheduler``).

A leaf is viewed as (M, R) rows: M = product of the ``model``-sharded dims
(kept local), R = the rest (compressed).  With a ``model`` axis of size 1
every spec is all-``None``, so M = 1 and the single row is the whole
stacked leaf — the shape the port's kernels are built for.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cr_reduce import ops as CR


def _split_model_dims(spec, ndim: int):
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    model = [i for i, s in enumerate(spec) if s is not None]
    other = [i for i in range(ndim) if i not in model]
    return model, other


def _to_rows(g: torch.Tensor, spec):
    """Leaf -> (M, R) rows (a view when no dim is model-sharded)."""
    model, other = _split_model_dims(spec, g.ndim)
    perm = model + other
    gt = g.permute(perm)
    m = 1
    for i in model:
        m *= g.shape[i]
    return gt.reshape(m, -1), perm, tuple(gt.shape)


def _from_rows(rows: torch.Tensor, perm, tshape):
    inv = [0] * len(perm)
    for i, p_ in enumerate(perm):
        inv[p_] = i
    return rows.reshape(tshape).permute(inv)


def leaf_rows_geometry(shape, spec):
    """``(m, r, perm, tshape)`` of the (M, R) layout :func:`_to_rows`
    gives a leaf of ``shape``."""
    model, other = _split_model_dims(spec, len(shape))
    perm = model + other
    tshape = tuple(shape[i] for i in perm)
    m = 1
    for i in model:
        m *= shape[i]
    size = 1
    for s in shape:
        size *= s
    r = size // m if m else 0
    return m, r, perm, tshape


def ef_compress_leaf(g, err, spec, method: str, topk_ratio: float = 1 / 64):
    """One local compression round of a leaf, densified: returns
    ``(payload, new_err)`` with ``payload = Q(err + g)`` in the leaf's
    shape and ``new_err = (err + g) - payload``.  ``err=None`` compresses
    without error feedback (a zero residual)."""
    if err is None:
        err = torch.zeros_like(g, dtype=torch.float32)
    w = err + g.float()
    if w.numel() == 0:
        return w, w
    rows, perm, tshape = _to_rows(w, spec)
    if method == "topk":
        vals, idx, _ = CR.topk_compress_rows(rows, None, topk_ratio)
        q = torch.zeros_like(rows).scatter_add_(1, idx.long(), vals)
    elif method == "onebit":
        pos, means, _ = CR.onebit_compress_rows(rows, None)
        q = torch.where(pos, means[:, 0:1], means[:, 1:2])
    else:
        raise ValueError(f"unknown compressor {method!r}")
    payload = _from_rows(q, perm, tshape)
    return payload, w - payload


def ef_compress_leaf_compact(g, err, spec, method: str,
                             topk_ratio: float = 1 / 64):
    """One local compression round kept in *wire form*.

    Returns ``(payload, new_err)``: ``{"vals" (M, k) f32, "idx" (M, k)
    i32}`` for top-k or ``{"pos" (M, R) bool, "means" (M, 2) f32}`` for
    one-bit, and the residual in the leaf's shape.  ``err=None`` means no
    error feedback; otherwise the residual is written into ``err``, which
    is returned (when the rows are a view of ``err``, as at M = 1, the
    compressor writes it there directly).  Densified, the payload equals
    :func:`ef_compress_leaf`'s bit for bit.
    """
    m, r, perm, tshape = leaf_rows_geometry(tuple(g.shape), spec)
    if g.numel() == 0:
        if method == "topk":
            payload = {"vals": g.new_zeros((m, 0), dtype=torch.float32),
                       "idx": g.new_zeros((m, 0), dtype=torch.int32)}
        else:
            payload = {"pos": g.new_zeros((m, r), dtype=torch.bool),
                       "means": g.new_zeros((m, 2), dtype=torch.float32)}
        return payload, (err if err is not None else g.float())
    rows_g, _, _ = _to_rows(g, spec)
    rows_e = _to_rows(err, spec)[0] if err is not None else None
    out = rows_e if (rows_e is not None
                     and rows_e.data_ptr() == err.data_ptr()
                     and rows_e.is_contiguous()) else None
    if method == "topk":
        vals, idx, err_rows = CR.topk_compress_rows(rows_g, rows_e,
                                                    topk_ratio, out_err=out)
        payload = {"vals": vals, "idx": idx}
    elif method == "onebit":
        pos, means, err_rows = CR.onebit_compress_rows(rows_g, rows_e,
                                                       out_err=out)
        payload = {"pos": pos, "means": means}
    else:
        raise ValueError(f"unknown compressor {method!r}")
    if err is None:
        return payload, _from_rows(err_rows, perm, tshape)
    if err_rows is not out:
        err.copy_(_from_rows(err_rows, perm, tshape))
    return payload, err
