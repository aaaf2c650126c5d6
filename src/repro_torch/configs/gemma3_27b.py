"""gemma3-27b — dense decoder, 5:1 local:global attention, 128k context.

[hf:google/gemma-3 family card] 62L, d_model=5376, 32 heads (GQA kv=16),
d_ff=21504, vocab=262144. Local layers use SWA(1024); every 6th layer is
global. qk_norm per gemma3.
"""
from repro_torch.configs.base import BLOCK_ATTN, ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    qk_norm=True,
    sliding_window=1024,
    global_every=6,       # 5 local : 1 global
    tie_embeddings=True,
    block_type=BLOCK_ATTN,
    rope_theta=1e6,
    source="hf:google/gemma-3-1b-pt",
)
