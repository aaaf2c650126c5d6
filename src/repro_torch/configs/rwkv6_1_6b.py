"""rwkv6-1.6b (Finch) — attention-free RNN with data-dependent decay.

[arXiv:2404.05892] 24L, d_model=2048, attn-free, d_ff=7168 (channel-mix),
vocab=65536. WKV6 state: 32 heads x 64x64 per layer.
"""
from repro_torch.configs.base import BLOCK_RWKV6, ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=0,          # attention-free
    n_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    ssm_state=64,       # per-head k/v dim of the WKV state
    ssm_heads=32,       # d_model / 64
    block_type=BLOCK_RWKV6,
    source="arXiv:2404.05892",
)
