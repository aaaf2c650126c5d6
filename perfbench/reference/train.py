"""The plain reference's first training steps, and the readings that the
comparison takes from them.

Both training strategies of the benchmark, from the paper's algorithms:

* ``async`` — bounded-staleness SGD: every step every worker takes the
  gradient of its contiguous rows at the current parameters, compresses
  ``residual + gradient`` to its ``k = round(R * ratio)`` entries of
  largest magnitude (the rest stays in its error-feedback residual), and
  sends it with the delay ``tau(t, w)`` of the oblivious adversary's table
  (drawn as ``np.random.default_rng(seed).integers(0, tau_max + 1,
  (horizon, workers))``); step ``t`` applies the mean over workers of every
  message that lands at ``t``.
* ``topk_ef`` — the same compression, every message applied at once, its
  values crossing the wire in bfloat16.

The applied gradient goes through heavy-ball momentum, ``mu = 0.9 mu + g``
and ``p -= lr mu``.  Each leaf is compressed whole (one row).

:func:`readings` returns what the comparison reads: each step's loss (the
mean over workers), each leaf's norm of the momentum after each step and
the first step that applied a message (``first``: 0 but where the delays
hold every message of step 0 back), each leaf's norm of the parameters'
change over the steps, and each leaf's norm of the first step's raw
gradient (which leaves count).  ``quant``, ``half_batch``,
``drop_exchange`` and ``keep_slot`` make the control and three faults: a
lower precision, half of each step's rows left out, every worker's
message but worker 0's lost, and (``async``) a delay ring whose slot is
not cleared after its take, so that what a step sends with delay 0 is
applied again a turn of the ring (``tau_max + 1`` steps) later.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import weights
from perfbench.reference import model


def tau_table(seed: int, horizon: int, workers: int, tau_max: int,
              schedule: str) -> np.ndarray:
    if schedule != "uniform":
        raise ValueError(f"the reference draws the uniform schedule only, "
                         f"not {schedule!r}")
    return np.random.default_rng(seed).integers(0, tau_max + 1,
                                                size=(horizon, workers))


def _topk(w: torch.Tensor, ratio: float):
    """(idx, vals) of the k entries of largest magnitude of flat ``w``."""
    k = max(1, int(round(w.numel() * ratio)))
    idx = torch.topk(w.abs(), k, sorted=False).indices
    return idx, w[idx]


def readings(dm: dict, traffic: dict, seed: int, batches: list, device, *,
             quant=model.bf16, half_batch: bool = False,
             drop_exchange: bool = False, keep_slot: bool = False) -> dict:
    """Run ``len(batches)`` steps from the seed's weights; ``batches`` are
    ``{"tokens", "labels"}`` (B, S) integer tensors on ``device``."""
    shapes = model.leaf_shapes(dm)
    paths = list(shapes)
    p = dict(zip(paths, weights.make(paths, list(shapes.values()), seed,
                                     device, dm["d_model"])))
    for x in p.values():
        x.requires_grad_(True)
    n = traffic["workers"]
    ratio, lr, beta = traffic["topk_ratio"], traffic["lr"], \
        traffic["momentum"]
    is_async = traffic["sync"] == "async"
    if traffic["sync"] not in ("async", "topk_ef"):
        raise ValueError(f"the reference runs async and topk_ef, not "
                         f"{traffic['sync']!r}")
    if keep_slot and not is_async:
        raise ValueError("keep_slot is a fault of the async delay ring")
    if is_async:
        taus = tau_table(seed, traffic["horizon"], n, traffic["tau_max"],
                         traffic["schedule"])
    ef = traffic["error_feedback"]
    mu = {q: torch.zeros_like(x, requires_grad=False) for q, x in p.items()}
    err = {q: [torch.zeros(x.numel(), device=device) for _ in range(n)]
           for q, x in p.items()} if ef else None
    pending: dict = {}            # landing step -> [(path, idx, vals)]
    out = {"losses": [], "mu_steps": [], "first": None, "change": None,
           "grad0": None}
    for t, batch in enumerate(batches):
        rows = batch["tokens"].shape[0]
        keep = rows // 2 if half_batch else rows
        b = keep // n
        losses, grad0 = [], {q: 0.0 for q in paths}
        for w in range(n):
            tok = batch["tokens"][w * b:(w + 1) * b].long()
            lab = batch["labels"][w * b:(w + 1) * b].long()
            loss = model.loss(p, dm, tok, lab, quant)
            loss.backward()
            losses.append(loss.detach().float())
            land = t + int(np.clip(taus[t, w], 0, traffic["tau_max"])) \
                if is_async else t
            for q, x in p.items():
                g = x.grad.reshape(-1)
                x.grad = None
                if t == 0:
                    grad0[q] = max(grad0[q], float(torch.linalg.vector_norm(g)))
                work = err[q][w] + g if ef else g
                del g
                idx, vals = _topk(work, ratio)
                if ef:
                    work[idx] = 0.0
                    err[q][w] = work
                del work
                if not is_async:
                    vals = vals.to(torch.bfloat16).float()
                if drop_exchange and w > 0:
                    continue
                pending.setdefault(land, []).append((q, idx, vals))
                if keep_slot and land == t:
                    pending.setdefault(t + traffic["tau_max"] + 1,
                                       []).append((q, idx, vals))
        applied = {q: torch.zeros(x.numel(), device=device)
                   for q, x in p.items()}
        landing = pending.pop(t, [])
        if landing and out["first"] is None:
            out["first"] = t
        for q, idx, vals in landing:
            applied[q].index_add_(0, idx, vals)
        with torch.no_grad():
            for q, x in p.items():
                g = applied.pop(q).mul_(np.float32(1.0) / np.float32(n))
                mu[q].mul_(beta).add_(g.reshape(x.shape))
                x.add_(mu[q] * -lr)
        out["losses"].append(float(torch.stack(losses).mean()))
        out["mu_steps"].append([float(torch.linalg.vector_norm(mu[q]))
                                for q in paths])
        if t == 0:
            out["grad0"] = [grad0[q] for q in paths]
    with torch.no_grad():
        out["change"] = [
            float(torch.linalg.vector_norm(
                p[q] - weights.leaf(q, shapes[q], i, seed, device,
                                    dm["d_model"])))
            for i, q in enumerate(paths)]
    out["paths"] = paths
    if out["first"] is None:
        out["first"] = len(batches) - 1
    return out
