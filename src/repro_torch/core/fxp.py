"""Two's-complement fixed-point quantization (port of `repro.core.fxp`)."""
from __future__ import annotations

import torch

from .formats import FXPFormat


def fxp_quantize(x: torch.Tensor, fmt: FXPFormat) -> torch.Tensor:
    """Quantize real `x` to the raw integer FXP grid (saturating).

    Rounds half to even (`torch.round`, like `jnp.round` in the
    reference), then clips to the W-bit range; returns int32.
    """
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    raw = torch.round(x.to(dtype) * (2.0 ** fmt.F))
    raw = torch.clamp(raw, fmt.raw_min, fmt.raw_max)
    return raw.to(torch.int32)


def fxp_to_float(raw: torch.Tensor, fmt: FXPFormat,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Real value of raw FXP integers (an exact power-of-two scale)."""
    return raw.to(dtype) * (2.0 ** (-fmt.F))


def fxp_saturate(raw: torch.Tensor, fmt: FXPFormat) -> torch.Tensor:
    """Clip raw integers into the W-bit two's-complement range."""
    return torch.clamp(raw, fmt.raw_min, fmt.raw_max).to(torch.int32)


def fxp_quantize_value(x: torch.Tensor, fmt: FXPFormat) -> torch.Tensor:
    """Quantize-dequantize: nearest representable FXP real value (f32)."""
    return fxp_to_float(fxp_quantize(x, fmt), fmt)
