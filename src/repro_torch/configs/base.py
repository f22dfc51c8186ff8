"""Model configuration schema (a copy of `repro.configs.base` cut to
the fields the dense serving and training paths read; other families'
fields come with their slices, and `family` lets the model reject them
until then).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """How the VP technique is applied to the model's matmuls.

    mode:
      none     - float baseline
      fxp      - int8 fixed-point weights (the FXP baseline)
      vp       - per-element VP weights stored as packed words
      vp_block - block VP: int8 significands with one exponent index per
                 `block` weights along the contraction, and activations
                 block-quantized on the fly, through the int8
                 `block_vp_matmul` kernel

    qat_mode: how float master weights train under mode vp or vp_block
    (both per element; "fake": fake-quant STE in the float graph;
    "packed": quantize to packed words and run the serving kernel
    forward and the packed-word backward kernels,
    `kernels.ops.vp_qat_matmul`).
    """
    mode: str = "none"
    M: int = 7
    E: int = 2
    W: int = 12                      # FXP proxy grid width
    block: int = 256                 # vp_block index granularity
    quantize_kv_cache: bool = False  # VP-quantized KV cache
    kv_layout: str = "packed"        # its storage: "packed" words (read by
                                     # the decode-attention kernel) or
                                     # "planes" (int8 significands and
                                     # bit-packed indices, dequantized
                                     # whole before plain attention)
    qat_mode: str = "fake"

    def __post_init__(self):
        if self.mode not in ("none", "fxp", "vp", "vp_block"):
            raise ValueError(f"unsupported quant mode {self.mode!r}")
        if self.kv_layout not in ("packed", "planes"):
            raise ValueError(f"unsupported KV layout {self.kv_layout!r}")
        if self.qat_mode not in ("fake", "packed"):
            raise ValueError(f"unsupported qat mode {self.qat_mode!r}")


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
    loss_chunk: int = 1024           # chunked cross-entropy seq block

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads
