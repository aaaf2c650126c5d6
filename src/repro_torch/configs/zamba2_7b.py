"""zamba2-7b — hybrid Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242] 81L, d_model=3584, 32 heads (GQA kv=32) in the shared
attention block, d_ff=14336, vocab=32000, ssm_state=64; 64 SSM heads of
112 (d_inner 7168).  The single shared transformer block is applied
before every 6th Mamba2 layer (weights shared, one KV cache per
invocation).
"""
from repro_torch.configs.base import BLOCK_MAMBA2, ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_heads=64,
    ssm_expand=2,
    conv_width=4,
    shared_attn_every=6,
    block_type=BLOCK_MAMBA2,
    source="arXiv:2411.15242",
)
