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
