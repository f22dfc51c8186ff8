"""internvl2-1b [vlm]: InternViT frontend (a stub: precomputed patch
embeddings) and an InternLM2 / qwen2-style LM backbone (copy of
`repro.configs.internvl2_1b`).

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655
[arXiv:2404.16821; hf].  256 visual patches per image; head_dim = 64,
G = 7.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151655, qkv_bias=True,
    n_patches=256, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, qkv_bias=True, n_patches=8, dtype="float32",
)
