"""Tensor-level VP quantization (port of `vp_fake_quant`,
`vp_fake_quant_ste`, the packed-word tensor codec and the block-VP
quantizer of `repro.core.quantize`)."""
from __future__ import annotations

from typing import Tuple

import torch

from .convert import _shift, fxp2vp, vp_to_float
from .formats import FXPFormat, VPFormat
from .fxp import fxp_quantize
from .packing import dequant_words, pack_vp
from .vp_tensor import significand_dtype


def vp_fake_quant(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat
                  ) -> torch.Tensor:
    """Quantize-dequantize in x's dtype: FXP rounds to nearest (half to
    even), then the FXP2VP bit window truncates the dropped LSBs, exactly
    like the hardware."""
    m, i = fxp2vp(fxp_quantize(x, fxp), fxp, vp)
    return vp_to_float(m, i, vp, x.dtype)


class _STE(torch.autograd.Function):
    """Forward the quantized y; backward identity onto x, or, with
    bounds, identity inside [lo, hi] and zero outside."""

    @staticmethod
    def forward(ctx, x, y, lo, hi):
        if lo is not None:
            ctx.save_for_backward(x)
            ctx.bounds = (lo, hi)
        return y

    @staticmethod
    def backward(ctx, g):
        if not ctx.saved_tensors:
            return g, None, None, None
        (x,) = ctx.saved_tensors
        lo, hi = (torch.tensor(b, dtype=x.dtype) for b in ctx.bounds)
        inside = (x >= lo.to(x.device)) & (x <= hi.to(x.device))
        return torch.where(inside, g, torch.zeros_like(g)), None, None, None


def vp_fake_quant_ste(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat,
                      clip_grad: bool = False) -> torch.Tensor:
    """QAT straight-through estimator around `vp_fake_quant`.

    ``clip_grad=False`` passes the gradient everywhere (the classic STE);
    ``clip_grad=True`` zeroes it where x lies outside the FXP(W, F)
    envelope [fxp.min, fxp.max] (bounds taken in x's dtype), where the
    quantizer's Jacobian really is 0.
    """
    y = vp_fake_quant(x.detach(), fxp, vp)
    if clip_grad:
        return _STE.apply(x, y, fxp.min, fxp.max)
    return _STE.apply(x, y, None, None)


def pow2_scale(w: torch.Tensor) -> torch.Tensor:
    """Smallest power of two >= max|w| as a 0-d tensor of w's dtype, each
    step (log2, ceil, exp2) taken in that dtype like the reference's
    `_pow2_scale`; an all-zero tensor gets 1.0."""
    amax = w.abs().max()
    s = torch.exp2(torch.ceil(torch.log2(torch.clamp(amax, min=1e-30))))
    return torch.where(amax > 0, s, torch.ones_like(s))


def vp_pack_tensor(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real tensor (any rank, any float dtype) -> (packed words, f32
    scale).

    The memory codec of VP-packed gradient compression
    (`train.compression`) and packed optimizer moments
    (`optim.optimizer`): a per-tensor power-of-two scale (exact: it only
    shifts exponents) brings max|x| into (-1, 1], then real -> FXP(W, F)
    -> VP(M, f) -> `core.packing` words.  An all-zero tensor gets scale
    1.0.  Plain tensor code, as in the reference (no kernel).
    """
    xf = x.to(torch.float32)
    scale = pow2_scale(xf)
    m, i = fxp2vp(fxp_quantize(xf / scale, fxp), fxp, vp)
    return pack_vp(m, i, vp), scale


def vp_unpack_tensor(w: torch.Tensor, scale: torch.Tensor, vp: VPFormat,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Invert `vp_pack_tensor`: (words, scale) -> real tensor."""
    return dequant_words(w, vp, dtype) * scale.to(dtype)


def block_vp_quantize(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat,
                      block: int, axis: int = -1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize with ONE exponent index per `block` contiguous elements
    along `axis` (block VP, the VP analogue of block floating point).

    The block's index is the largest per-element FXP2VP index in it (the
    option of its largest magnitude), so every element of the block fits
    at that fractional length; each element is then re-shifted at the
    block's f and clipped to the significand range.  Returns
    (significands of `significand_dtype(vp.M)` shaped like x, uint8
    indices with `axis` reduced by `block`).  Plain tensor code, as in
    the reference (no kernel).
    """
    axis = axis % x.ndim
    n = x.shape[axis]
    if n % block:
        raise ValueError(f"axis size {n} not divisible by block {block}")
    raw = fxp_quantize(x, fxp)
    _, i_elt = fxp2vp(raw, fxp, vp)
    shp = list(x.shape)
    shp[axis:axis + 1] = [n // block, block]
    i_blk = i_elt.reshape(shp).amax(dim=axis + 1)
    i_full = torch.repeat_interleave(i_blk, block, dim=axis)
    m = torch.zeros_like(raw)
    for k in range(vp.K):
        m = torch.where(i_full == k, _shift(raw, fxp.F - vp.f[k]), m)
    m = torch.clamp(m, vp.raw_min, vp.raw_max)
    return m.to(significand_dtype(vp.M)), i_blk.to(torch.uint8)


def block_vp_dequantize(m: torch.Tensor, i_blk: torch.Tensor, vp: VPFormat,
                        block: int, axis: int = -1,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Invert `block_vp_quantize`: m * 2^-f of each element's block."""
    axis = axis % m.ndim
    scales = torch.tensor([2.0 ** (-fk) for fk in vp.f], dtype=dtype,
                          device=m.device)
    s = torch.repeat_interleave(scales[i_blk.long()], block, dim=axis)
    return m.to(dtype) * s
