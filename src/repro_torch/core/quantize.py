"""Tensor-level VP fake quantization (port of `vp_fake_quant` of
`repro.core.quantize`)."""
from __future__ import annotations

import torch

from .convert import fxp2vp, vp_to_float
from .formats import FXPFormat, VPFormat
from .fxp import fxp_quantize


def vp_fake_quant(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat
                  ) -> torch.Tensor:
    """Quantize-dequantize in x's dtype: FXP rounds to nearest (half to
    even), then the FXP2VP bit window truncates the dropped LSBs, exactly
    like the hardware."""
    m, i = fxp2vp(fxp_quantize(x, fxp), fxp, vp)
    return vp_to_float(m, i, vp, x.dtype)
