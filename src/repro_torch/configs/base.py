"""Model configuration schema (a copy of `repro.configs.base` cut to
the fields the port's serving and training paths read: every family,
dense, MoE, SSM, hybrid, encoder-decoder and VLM, and `QuantConfig.
tp_axis` for the sharded forward; the reference's GSPMD hints are not
ported).
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
    tp_axis: Optional[str] = None    # set only by the sharded forward
                                     # (`parallel.shard_ops.tp_quant`):
                                     # the mesh dim whose ranks hold the
                                     # weights' output-column shards

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
    # Encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0
    # VLM
    n_patches: int = 0
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

    def param_count(self) -> int:
        """Approximate parameter count, the reference's formula
        (`repro.configs.base.ModelConfig.param_count`): attention and MLP
        (or experts, or the SSM projections) per layer, norms, embedding
        and lm_head, the hybrid's shared block once, and an encoder's
        layers and the decoder's cross attention."""
        d, dff, v = self.d_model, self.d_ff, self.vocab
        hd, nh, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * hd * nh + 2 * d * hd * nkv + hd * nh * d
        mlp = 3 * d * dff
        if self.n_experts:
            mlp = self.n_experts * 3 * d * dff + d * self.n_experts
        ssm = 0
        if self.family in ("ssm", "hybrid") and not self.rwkv:
            di, ns, nh_s = self.d_inner, self.ssm_state, self.ssm_nheads
            ssm = d * (2 * di + 2 * ns + nh_s) + di * d + di
        if self.rwkv:
            ssm = 6 * d * d + 2 * d * dff + d * dff
        per_layer = 2 * d
        if self.family == "ssm":
            per_layer += ssm + (2 * d * dff + d * dff if self.rwkv else 0)
            if self.rwkv:
                per_layer = 2 * d + ssm
        elif self.family == "hybrid":
            per_layer += ssm
        else:
            per_layer += attn + mlp
        total = self.n_layers * per_layer + 2 * v * d + d
        if self.family == "hybrid" and self.shared_attn_period:
            total += attn + 3 * d * dff
        if self.encoder_layers:
            total += self.encoder_layers * (attn + mlp + 2 * d)
            total += self.n_layers * (attn + 2 * d)
        return int(total)
