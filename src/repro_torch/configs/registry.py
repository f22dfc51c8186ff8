"""Architecture registry of the port: the configs it serves so far.

`get_config` returns the full-width config (the card's target);
`get_smoke_config` the reduced one the CPU tests use.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .base import ModelConfig, QuantConfig
from . import qwen3_0_6b

_MODULES = {
    "qwen3-0.6b": qwen3_0_6b,
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
