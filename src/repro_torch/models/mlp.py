"""Feed-forward blocks: SwiGLU (the LM default) and GELU (whisper-style);
port of `repro.models.mlp`."""
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


def gelu_mlp(x: torch.Tensor, params, q: QuantConfig,
             train: bool = False) -> torch.Tensor:
    """params: w_in (d, ff), b_in (ff,), w_out (ff, d), b_out (d,).  The
    GELU is `jax.nn.gelu`'s default, the tanh approximation, in f32; the
    biases are added in x's dtype."""
    h = qdot(x, params["w_in"], q, train) + params["b_in"].to(x.dtype)
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return qdot(h, params["w_out"], q, train) + params["b_out"].to(x.dtype)
