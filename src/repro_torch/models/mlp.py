"""Feed-forward block: SwiGLU (port of `repro.models.mlp.swiglu`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import QuantConfig
from .layers import block_activation, qdot


def swiglu(x: torch.Tensor, params, q: QuantConfig,
           train: bool = False) -> torch.Tensor:
    """params: w_gate (d, ff), w_up (d, ff), w_down (ff, d); `train`
    makes every projection a QAT `qdot`."""
    xq = block_activation(x, (params["w_gate"], params["w_up"]), q)
    g = qdot(x, params["w_gate"], q, train, xq)
    u = qdot(x, params["w_up"], q, train, xq)
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return qdot(h, params["w_down"], q, train)
