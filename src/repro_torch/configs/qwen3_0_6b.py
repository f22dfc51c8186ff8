"""qwen3-0.6b [dense]: qk_norm, GQA (copy of `repro.configs.qwen3_0_6b`).

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.  No `d_head`
is set, so head_dim = 1024 / 16 = 64 (the published model uses 128);
the port follows the reference config.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=3072, vocab=151936, qk_norm=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, qk_norm=True, dtype="float32",
)
