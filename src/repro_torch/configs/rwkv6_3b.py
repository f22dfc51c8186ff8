"""rwkv6-3b [ssm]: Finch, attention-free with a data-dependent decay
(copy of `repro.configs.rwkv6_3b`).

32L d_model=2560 d_ff=8960 vocab=65536 [arXiv:2404.05892; hf].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm", rwkv=True,
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536,
    remat="full",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm", rwkv=True,
    n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
    d_ff=192, vocab=256, dtype="float32",
)
