"""stablelm-12b [dense] (copy of `repro.configs.stablelm_12b`).

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352
[hf:stabilityai/stablelm-2-1_6b; hf].  head_dim = 5120 / 32 = 160;
RMSNorm and full rotary, as the reference builds every dense model.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab=100352,
    remat="full",
)

SMOKE = ModelConfig(
    name="stablelm-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, dtype="float32",
)
