"""Model FLOPs of one training step, from the shapes alone.

Every matrix product the model needs, at 2 operations a multiply-add,
forward once and backward twice (3x): the attention's projections, the
scores ``QK^T`` and ``PV`` (the causal half of the square, or the whole
square with ``causal=False``), the MLP or the routed experts (only the
``experts_per_token`` a token is sent to, whatever the capacity buffers
hold), the router, and the LM head (tied or not).  The embedding lookup
counts 0, and nothing recomputed counts.
"""
from __future__ import annotations


def matmul_params_per_token(dm: dict) -> int:
    """Multiply-adds a token needs in the products with weights."""
    d, h, k, hd = dm["d_model"], dm["n_heads"], dm["n_kv_heads"], \
        dm["head_dim"]
    attn = d * h * hd + 2 * d * k * hd + h * hd * d
    if dm["n_experts"]:
        ffn = dm["experts_per_token"] * 3 * d * dm["expert_d_ff"] \
            + d * dm["n_experts"]
    else:
        ffn = 3 * d * dm["d_ff"]
    return dm["n_layers"] * (attn + ffn) + d * dm["vocab_size"]


def attention_flops(dm: dict, batch: int, seq: int,
                    causal: bool = True) -> float:
    """Forward FLOPs of ``QK^T`` and ``PV`` over every layer."""
    pairs = seq * seq / 2 if causal else seq * seq
    return 2 * 2 * batch * pairs * dm["n_heads"] * dm["head_dim"] \
        * dm["n_layers"]


def step_flops(dm: dict, batch: int, seq: int, causal: bool = True) -> float:
    """Model FLOPs of one training step over ``batch`` x ``seq`` tokens."""
    tokens = batch * seq
    return 3 * (2 * tokens * matmul_params_per_token(dm)
                + attention_flops(dm, batch, seq, causal))
