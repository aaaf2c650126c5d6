"""The least bytes the compression kernels move, counted as the kernel
table of ``PERF.md`` counts them: each input read once and each output
written once, over the (M, R) rows of a leaf with ``k = round(R * ratio)``
entries kept a row and ``S`` messages (workers) a call.

* K1 (compress: residual + gradient -> top-k and the new residual):
  reads the gradient and, with error feedback, the residual (4 B an entry
  each), writes the residual (4 B) and the kept values and indices (8 B a
  kept entry).
* K2 (deposit S messages into a delay ring): reads each message's values
  and indices (8 B a kept entry) and reads and writes each slot entry it
  adds to (8 B), taken as one entry a kept entry: messages that land in
  one slot at one index would touch it once, so this counts at most that
  overlap too much.
* K4 (reduce S messages into one dense row): reads each message's values
  (``val_bytes``: 2 for the bfloat16 wire) and indices (4 B), writes the
  dense row (4 B an entry).
"""
from __future__ import annotations


def topk_k(r: int, ratio: float) -> int:
    return max(1, int(round(r * ratio)))


def k1_bytes(m: int, r: int, k: int, error_feedback: bool = True) -> int:
    return (12 if error_feedback else 8) * m * r + 8 * m * k


def k2_bytes(s: int, m: int, k: int) -> int:
    return 8 * s * m * k + 8 * s * m * k


def k4_bytes(s: int, m: int, r: int, k: int, val_bytes: int = 2) -> int:
    return 4 * m * r + s * m * k * (val_bytes + 4)


def step_bytes(leaf_sizes, traffic: dict) -> dict:
    """Bytes a step of a cell moves through K1, K2 and K4: one K1 call a
    worker and leaf, one K2 (async) or K4 (topk_ef) call a leaf, each leaf
    one row."""
    s, ratio = traffic["workers"], traffic["topk_ratio"]
    ef = traffic.get("error_feedback", True)
    out = {"K1": 0, "K2": 0, "K4": 0}
    for r in leaf_sizes:
        k = topk_k(r, ratio)
        out["K1"] += s * k1_bytes(1, r, k, ef)
        if traffic["sync"] == "async":
            out["K2"] += k2_bytes(s, 1, k)
        else:
            out["K4"] += k4_bytes(s, 1, r, k)
    return out
