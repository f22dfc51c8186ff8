"""Wrapper of the serving matmul kernel (csrc/vp_dequant_matmul.cu).

Replaces `repro/kernels/vp_dequant_matmul.py:vp_dequant_matmul_pallas`.
The plain version is `ref.vp_dequant_matmul_ref`; dispatch lives in
`ops.vp_dequant_matmul`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.formats import VPFormat
from repro_torch.core.packing import storage_dtype
from . import build


def vp_dequant_matmul_cuda(x: torch.Tensor, w: torch.Tensor, w_fmt: VPFormat,
                           out_dtype: torch.dtype) -> torch.Tensor:
    """x (M, K) f32/bf16 @ dequant(w (K, N) packed) -> (M, N) out_dtype."""
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("vp_dequant_matmul kernel takes CUDA tensors on "
                         "one device")
    if w.dtype != storage_dtype(w_fmt):
        raise ValueError(f"packed words of {w_fmt} are "
                         f"{storage_dtype(w_fmt)}, got {w.dtype}")
    M, K = x.shape
    N = w.shape[1]
    xc = build.dtype_code(x.dtype, "x")
    oc = build.dtype_code(out_dtype, "out_dtype")
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = build.library("vp_dequant_matmul")
    fmt = build.vp_fmt_struct(w_fmt)
    with torch.cuda.device(x.device):
        err = lib.vp_dequant_matmul_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N, xc,
            w.element_size(), oc, ctypes.byref(fmt),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "vp_dequant_matmul")
    build.LAUNCHES["vp_dequant_matmul"] += 1
    return out
