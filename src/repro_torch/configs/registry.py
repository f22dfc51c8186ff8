"""Architecture registry of the port: the dense, MoE, SSM, hybrid,
encoder-decoder and VLM configs of the reference, each family it serves.

`get_config` returns the full-width config (the card's target);
`get_smoke_config` the reduced one the CPU tests use.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .base import ModelConfig, QuantConfig
from . import (gemma3_27b, internvl2_1b, mixtral_8x22b, qwen2_0_5b,
               qwen3_0_6b, qwen3_moe_30b_a3b, rwkv6_3b, stablelm_12b,
               whisper_tiny, zamba2_7b)

_MODULES = {
    "qwen2-0.5b": qwen2_0_5b,
    "qwen3-0.6b": qwen3_0_6b,
    "stablelm-12b": stablelm_12b,
    "gemma3-27b": gemma3_27b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "mixtral-8x22b": mixtral_8x22b,
    "rwkv6-3b": rwkv6_3b,
    "zamba2-7b": zamba2_7b,
    "whisper-tiny": whisper_tiny,
    "internvl2-1b": internvl2_1b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, quant: Optional[QuantConfig] = None) -> ModelConfig:
    cfg = _MODULES[name].CONFIG
    if quant is not None:
        cfg = dataclasses.replace(cfg, quant=quant)
    return cfg


def get_smoke_config(name: str, quant: Optional[QuantConfig] = None
                     ) -> ModelConfig:
    cfg = _MODULES[name].SMOKE
    if quant is not None:
        cfg = dataclasses.replace(cfg, quant=quant)
    return cfg
