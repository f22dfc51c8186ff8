"""Model configuration schema (a copy of `repro.configs.base` cut to
the fields the dense, MoE, SSM and hybrid serving and training paths
read; the encoder-decoder and VLM fields come with their slice, and
`family` lets the model reject them until then).
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
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    # Attention pattern
    sliding_window: Optional[int] = None      # SWA on every layer
    local_global_period: int = 0              # gemma3: every Nth layer global
    local_window: int = 1024                  # local-attention window
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    # RWKV6
    rwkv: bool = False
    # Hybrid (zamba2): one SHARED attention block applied every N ssm layers
    shared_attn_period: int = 0
    dtype: str = "bfloat16"
    quant: QuantConfig = QuantConfig()
    remat: str = "none"              # none | full | dots (act checkpointing)
    loss_chunk: int = 1024           # chunked cross-entropy seq block

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim
