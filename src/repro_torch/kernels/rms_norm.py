"""Wrapper of the RMSNorm kernel (csrc/rms_norm.cu).

No Pallas kernel stands behind it: the reference's `models/layers.py:
rms_norm` is plain jnp, which XLA fuses into one kernel.  On the card
PyTorch's ops take about nine launches for it, and their mean changes
its summation order with the number of rows, so a decode row's bits
would depend on its bucket.  The kernel is one launch, one warp a row,
in an order set by the row's width alone.  The plain version is
`ref.rms_norm_ref`; dispatch and the backward live in `ops.rms_norm`.
"""
from __future__ import annotations

import torch

from . import build

RN_WARPS = 8   # rows of a block (csrc/rms_norm.cu)


def rms_norm_cuda(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """x (..., D) -> x * rsqrt(mean(x^2) + eps) * (1 + gamma) in f32, in
    x's dtype; gamma's shape is x's trailing shape ((D,), or (H, N) over
    (..., H, N))."""
    xc = build.dtype_code(x.dtype, "x")
    gc = build.dtype_code(gamma.dtype, "gamma")
    if not 0 < gamma.ndim <= x.ndim or tuple(
            x.shape[x.ndim - gamma.ndim:]) != tuple(gamma.shape):
        raise ValueError(f"gamma {tuple(gamma.shape)} is not the trailing "
                         f"shape of x {tuple(x.shape)}")
    if not (x.is_cuda and gamma.device == x.device):
        raise ValueError("rms_norm kernel takes CUDA tensors on one device")
    D = x.shape[-1]
    x, gamma = x.contiguous(), gamma.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    lib = build.library("rms_norm")
    with torch.cuda.device(x.device):
        err = lib.rms_norm_launch(
            x.data_ptr(), xc, gamma.data_ptr(), gc, out.data_ptr(), rows, D,
            gamma.numel() // D, eps, -(-rows // RN_WARPS),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "rms_norm")
    build.LAUNCHES["rms_norm"] += 1
    return out
