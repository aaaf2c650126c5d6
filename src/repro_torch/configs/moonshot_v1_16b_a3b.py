"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) — fine-grained MoE.

[hf:moonshotai/Moonlight-16B-A3B] 48L, d_model=2048, 16 heads (GQA kv=16),
per-expert d_ff=1408, vocab=163840, MoE 64 experts / top-6.
"""
from repro_torch.configs.base import BLOCK_ATTN, ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    n_experts=64,
    experts_per_token=6,
    moe_d_ff=1408,
    block_type=BLOCK_ATTN,
    rope_theta=5e4,
    source="hf:moonshotai/Moonlight-16B-A3B",
)
