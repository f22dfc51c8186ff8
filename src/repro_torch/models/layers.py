"""Quantization-aware building blocks (port of `repro.models.layers`).

Every weight matmul goes through `qdot`:

  none  x @ W
  vp    ops.vp_dequant_matmul(x, W_packed) * scale: one packed VP word
        per weight, consumed directly by the kernel (unpack and pow2
        scale on chip, no float weight matrix in device memory).

Training (`train=True`) keeps float master weights and, under mode vp,
fine-tunes them into the serving format (QAT): `qat_mode="packed"` runs
`ops.vp_qat_matmul` (quant and serving kernels forward, the packed-word
`vp_matmul_dx` kernel backward), `qat_mode="fake"` the fake-quant STE in
the float graph.

The reference's `fxp`, `vp_block` and two-plane layouts wait for a later
slice.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core.formats import FXPFormat, default_vp_format
from repro_torch.core.packing import dequant_words
from repro_torch.core.quantize import vp_fake_quant_ste
from repro_torch.kernels import ops


def canonical_formats(q: QuantConfig):
    """FXP(W, W-1) and its default VP(M, E) format: VP(7,[11,9,8,6])
    on FXP(12,11) for the defaults."""
    fxp = FXPFormat(q.W, q.W - 1)
    return fxp, default_vp_format(fxp, q.M, q.E)


def _pow2_scale(w: torch.Tensor) -> torch.Tensor:
    """Smallest power of two >= max|w|, computed in w's dtype like the
    reference; an all-zero tensor gets 1.0."""
    amax = w.abs().max()
    s = torch.exp2(torch.ceil(torch.log2(torch.clamp(amax, min=1e-30))))
    return torch.where(amax > 0, s, torch.ones_like(s))


def quantize_weight(w: torch.Tensor, q: QuantConfig) -> Any:
    """Float weight (d_in, d_out) -> its serving form.

    mode none: the float tensor; mode vp: {"w_packed", "scale"} with the
    words of w / scale (exported by the quant kernel on the card).
    """
    if q.mode == "none":
        return w
    fxp, vp = canonical_formats(q)
    s = _pow2_scale(w)
    wn = (w / s).to(torch.float32)
    return {"w_packed": ops.vp_quant(wn, fxp, vp, packed=True),
            "scale": s.to(torch.float32)}


def qdot(x: torch.Tensor, wq: Any, q: QuantConfig,
         train: bool = False) -> torch.Tensor:
    """x (..., d_in) @ W (d_in, d_out) under the quantization mode.

    `wq` is a float tensor (training, or mode none) or the dict that
    `quantize_weight` exports (serving).  With `train` and mode vp a
    float master weight is quantized on the fly (QAT, module docstring);
    its pow2 scale carries no gradient and commutes exactly with the
    contraction.
    """
    dtype = x.dtype
    if not isinstance(wq, dict):
        w = wq
        if train and q.mode == "vp":
            fxp, vp = canonical_formats(q)
            s = _pow2_scale(w.detach())
            if q.qat_mode == "packed" and w.ndim == 2:
                lead = x.shape[:-1]
                x2 = x.reshape(-1, x.shape[-1]).to(dtype)
                out = ops.vp_qat_matmul(x2, w / s, fxp, vp)
                out = out.to(dtype) * s.to(dtype)
                return out.reshape(*lead, -1)
            w = vp_fake_quant_ste(w / s, fxp, vp) * s
        return x @ w.to(dtype)
    _, vp = canonical_formats(q)
    lead = x.shape[:-1]
    out = ops.vp_dequant_matmul(x.reshape(-1, x.shape[-1]), wq["w_packed"],
                                vp, out_dtype=dtype)
    out = out * wq["scale"].to(dtype)
    return out.reshape(*lead, -1)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.to(torch.float32))).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4):
    """Rotary embedding: x (..., S, H, dh), positions (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_lookup(tokens: torch.Tensor, table: Any, q: QuantConfig,
                 train: bool = False):
    """Token embedding.  A packed table gathers the packed rows first and
    dequantizes only those (f32, like the reference).  A float table is
    gathered as it is, in training too (`train` is accepted for the
    reference's signature; the embedding is not fake-quantized)."""
    if isinstance(table, dict):
        _, vp = canonical_formats(q)
        rows = table["w_packed"][tokens]
        return dequant_words(rows, vp, torch.float32) * table["scale"]
    return table[tokens]


def weight_bytes(params: Dict[str, Any]) -> int:
    """Bytes of every tensor in a parameter tree."""
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(weight_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(weight_bytes(v) for v in params)
    return 0
