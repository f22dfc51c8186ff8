"""gemma3-27b [dense]: 5:1 local:global attention (copy of
`repro.configs.gemma3_27b`).

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144
[hf:google/gemma-3-1b-pt; unverified].  Every 6th layer is global
full attention; local layers use a 1024-token sliding window.  No
`d_head` is set, so head_dim = 5376 / 32 = 168, and there is no
qk-norm; the port follows the reference config.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_ff=21504, vocab=262144,
    local_global_period=6, local_window=1024,
    rope_theta=1e6, remat="full",
)

SMOKE = ModelConfig(
    name="gemma3-smoke", family="dense",
    n_layers=7, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256,
    local_global_period=3, local_window=8, dtype="float32",
)
