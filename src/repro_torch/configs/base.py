"""Model configuration schema (a copy of `repro.configs.base` cut to
the fields the dense serving path reads; other families' fields come
with their slices, and `family` lets the model reject them until then).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """How the VP technique is applied to the model's matmuls.

    mode:
      none - float baseline
      vp   - per-element VP weights stored as packed words
    (`fxp` and `vp_block` are modes of the reference that this port does
    not serve yet.)
    """
    mode: str = "none"
    M: int = 7
    E: int = 2
    W: int = 12                      # FXP proxy grid width
    quantize_kv_cache: bool = False  # packed VP KV cache

    def __post_init__(self):
        if self.mode not in ("none", "vp"):
            raise ValueError(f"unsupported quant mode {self.mode!r}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None
    dtype: str = "bfloat16"
    quant: QuantConfig = QuantConfig()

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads
