"""musicgen-large — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284] 48L, d_model=2048, 32 heads (GQA kv=32), d_ff=8192,
vocab=2048 (per-codebook). The EnCodec conv codec frontend is a stub: the
batch carries precomputed frame embeddings (``frame_embeds``, the sum of the
4 codebook embeddings, delay pattern applied upstream) in place of the token
embeddings.
"""
from repro_torch.configs.base import BLOCK_ATTN, FRONTEND_AUDIO, ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    block_type=BLOCK_ATTN,
    frontend=FRONTEND_AUDIO,
    n_codebooks=4,
    rope_theta=1e4,
    source="arXiv:2306.05284",
)
