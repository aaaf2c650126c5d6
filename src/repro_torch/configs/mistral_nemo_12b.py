"""mistral-nemo-12b — dense decoder, 128k context.

[hf:mistralai/Mistral-Nemo-Base-2407] 40L, d_model=5120, 32 heads (GQA kv=8),
head_dim=128, d_ff=14336, vocab=131072.  The first config whose
n_heads x head_dim (4096) differs from d_model.
"""
from repro_torch.configs.base import BLOCK_ATTN, ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    block_type=BLOCK_ATTN,
    rope_theta=1e6,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)
