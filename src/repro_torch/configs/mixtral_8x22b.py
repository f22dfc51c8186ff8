"""mixtral-8x22b [moe]: 8 experts top-2, sliding-window attention (copy
of `repro.configs.mixtral_8x22b`).

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768
[arXiv:2401.04088; hf].  SWA window 4096 -> sub-quadratic decode with a
rolling KV cache.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768,
    n_experts=8, experts_per_token=2,
    sliding_window=4096, rope_theta=1e6, remat="full",
)

SMOKE = ModelConfig(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=256,
    n_experts=4, experts_per_token=2, sliding_window=8, dtype="float32",
)
