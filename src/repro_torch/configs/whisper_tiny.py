"""whisper-tiny [audio]: encoder-decoder (copy of
`repro.configs.whisper_tiny`); the conv frontend is a stub: the encoder
takes precomputed frame embeddings.

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 [arXiv:2212.04356;
unverified].  Encoder source length 1500 frames; head_dim = 384 / 6 =
64, G = 1.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865,
    encoder_layers=4, encoder_seq=1500,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256,
    encoder_layers=2, encoder_seq=16, dtype="float32",
)
