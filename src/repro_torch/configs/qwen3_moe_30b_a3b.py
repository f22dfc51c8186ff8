"""qwen3-moe-30b-a3b [moe]: 128 experts, top-8 (copy of
`repro.configs.qwen3_moe_30b_a3b`).

48L d_model=2048 32H (GQA kv=4) d_ff=768 (per expert) vocab=151936
[hf:Qwen/Qwen3-30B-A3B; hf].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab=151936, qk_norm=True,
    n_experts=128, experts_per_token=8,
    rope_theta=1e6, remat="full",
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=48, vocab=256, qk_norm=True,
    n_experts=8, experts_per_token=2, dtype="float32",
)
