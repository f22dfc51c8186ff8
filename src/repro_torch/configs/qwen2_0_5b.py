"""qwen2-0.5b [dense]: GQA with QKV bias (copy of
`repro.configs.qwen2_0_5b`).

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936
[arXiv:2407.10671; hf].  head_dim = 896 / 14 = 64, G = 7 query heads
per kv head.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151936, qkv_bias=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, qkv_bias=True, dtype="float32",
)
