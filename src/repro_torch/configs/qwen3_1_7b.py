"""qwen3-1.7b — dense decoder with QK-norm.

[hf:Qwen/Qwen3-8B family card] 28L, d_model=2048, 16 heads (GQA kv=8),
head_dim=128, d_ff=6144, vocab=151936, qk_norm.
"""
from repro_torch.configs.base import BLOCK_ATTN, ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    block_type=BLOCK_ATTN,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
)
