"""The benchmark's FLOP and byte arithmetic against hand counts."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import arch  # noqa: E402
from perfbench.counts import flops, kernel_bytes as kb  # noqa: E402


def test_qwen3_step_flops():
    dm = arch.dims(arch.load_config("qwen3-1.7b"))
    assert flops.step_flops(dm, 4, 256) == pytest.approx(1.0662e13,
                                                          rel=1e-3)
    # with attention's whole square, the dry run's count of the step
    full = flops.step_flops(dm, 4, 256, causal=False)
    assert full == pytest.approx(10_750_840_012_800, rel=1e-3)
    assert full == 10_750_840_012_800


def test_mixtral_step_flops_by_hand():
    dm = arch.dims(arch.load_config("mixtral-8x7b-l1"))
    d, ff, v, t = 4096, 14336, 32000, 8 * 256
    attn = d * 4096 + 2 * d * 1024 + 4096 * d
    per_token = attn + 2 * 3 * d * ff + d * 8 + d * v
    scores = 2 * 2 * 8 * (256 * 256 / 2) * 32 * 128
    assert flops.step_flops(dm, 8, 256) == 3 * (2 * t * per_token + scores)


def test_k1_bytes_one_leaf():
    r = 28 * 2048 * 6144                     # qwen3 layers/mlp/w_gate
    k = kb.topk_k(r, 1 / 16)
    assert k == 22_020_096
    # reads gradient and residual, writes residual, values and indices
    assert kb.k1_bytes(1, r, k) == 4 * r + 4 * r + 4 * r + 4 * k + 4 * k
    assert kb.k1_bytes(1, r, k) == 4_404_019_200  # PERF.md: 1.315 ms bound
    assert kb.k1_bytes(1, r, k, error_feedback=False) == 8 * r + 8 * k


def test_k2_k4_bytes_one_leaf():
    r = 28 * 2048 * 6144
    k = kb.topk_k(r, 1 / 16)
    # two messages' values and indices, and each target read and written
    assert kb.k2_bytes(2, 1, k) == 2 * k * 8 + 2 * k * 8
    # bf16 values and int32 indices of two messages, the dense row written
    assert kb.k4_bytes(2, 1, r, k) == 4 * r + 2 * k * 2 + 2 * k * 4
    assert kb.k4_bytes(2, 1, r, k) / 3.35e12 * 1e3 == pytest.approx(
        0.4996, abs=1e-4)


def test_step_bytes_sum_over_leaves():
    tr = {"workers": 2, "topk_ratio": 1 / 16, "sync": "async"}
    out = kb.step_bytes([32, 4096], tr)
    assert out["K1"] == 2 * (kb.k1_bytes(1, 32, 2) + kb.k1_bytes(1, 4096,
                                                                 256))
    assert out["K2"] == kb.k2_bytes(2, 1, 2) + kb.k2_bytes(2, 1, 256)
    assert out["K4"] == 0
    sync = kb.step_bytes([4096], dict(tr, sync="topk_ef"))
    assert sync["K2"] == 0 and sync["K4"] == kb.k4_bytes(2, 1, 4096, 256)
