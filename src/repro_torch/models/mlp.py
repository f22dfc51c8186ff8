"""Feed-forward block: SwiGLU (port of `repro.models.mlp.swiglu`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import QuantConfig
from .layers import qdot


def swiglu(x: torch.Tensor, params, q: QuantConfig,
           train: bool = False) -> torch.Tensor:
    """params: w_gate (d, ff), w_up (d, ff), w_down (ff, d); `train`
    makes every projection a QAT `qdot`."""
    g = qdot(x, params["w_gate"], q, train)
    u = qdot(x, params["w_up"], q, train)
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return qdot(h, params["w_down"], q, train)
