"""internvl2-2b — InternViT vision encoder + InternLM2 language model.

[arXiv:2404.16821] LM backbone: 24L, d_model=2048, 16 heads (GQA kv=8),
d_ff=8192, vocab=92553. The InternViT encoder + MLP projector are a stub:
the batch carries 256 precomputed patch embeddings (``patch_embeds``), which
take the place of the first 256 token embeddings.
"""
from repro_torch.configs.base import BLOCK_ATTN, FRONTEND_VISION, ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    block_type=BLOCK_ATTN,
    frontend=FRONTEND_VISION,
    n_prefix_embeds=256,
    rope_theta=1e6,
    source="arXiv:2404.16821",
)
