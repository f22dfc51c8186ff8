"""zamba2-7b [hybrid]: Mamba2 backbone with one shared attention block
(copy of `repro.configs.zamba2_7b`).

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64
[arXiv:2411.15242; unverified].  The shared attention block (Zamba2's
weight-shared transformer block) is applied after every 6 Mamba2 layers.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
    shared_attn_period=6,
    remat="full",
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256,
    ssm_state=16, ssm_expand=2, ssm_headdim=32, ssm_chunk=8,
    shared_attn_period=2, dtype="float32",
)
