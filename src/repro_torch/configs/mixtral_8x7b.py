"""mixtral-8x7b — MoE decoder with sliding-window attention.

[arXiv:2401.04088] 32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336,
vocab=32000, MoE 8 experts / top-2, SWA window 4096.
"""
from repro_torch.configs.base import BLOCK_ATTN, ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    block_type=BLOCK_ATTN,
    rope_theta=1e6,
    source="arXiv:2401.04088",
)
