"""grok-1-314b — 314B-parameter MoE decoder.

[hf:xai-org/grok-1] 64L, d_model=6144, 48 heads (GQA kv=8), d_ff=32768,
vocab=131072, MoE with 8 experts / top-2 routing.
"""
from repro_torch.configs.base import BLOCK_ATTN, ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    experts_per_token=2,
    block_type=BLOCK_ATTN,
    rope_theta=1e4,
    source="hf:xai-org/grok-1",
)
