"""Wrappers of the backward matmul kernels (csrc/vp_bwd_matmul.cu).

`vp_matmul_dx_cuda` replaces `repro/kernels/vp_bwd_matmul.py:
vp_matmul_dx_pallas` and `vp_matmul_dw_cuda` replaces
`vp_matmul_dw_pallas`.  The plain versions are `ref.vp_matmul_dx_ref` /
`ref.vp_matmul_dw_ref`; dispatch lives in `ops.vp_matmul_dx` and
`ops.vp_matmul_dw`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.formats import VPFormat
from repro_torch.core.packing import storage_dtype
from . import build


def _launch(name: str, words: torch.Tensor, g: torch.Tensor, fmt: VPFormat,
            out_shape, out_dtype: torch.dtype, first, second, M: int, K: int,
            N: int) -> torch.Tensor:
    if not (g.is_cuda and words.device == g.device):
        raise ValueError(f"{name} kernel takes CUDA tensors on one device")
    if words.dtype != storage_dtype(fmt):
        raise ValueError(f"packed words of {fmt} are {storage_dtype(fmt)}, "
                         f"got {words.dtype}")
    gc = build.dtype_code(g.dtype, "g")
    oc = build.dtype_code(out_dtype, "out_dtype")
    out = torch.empty(out_shape, dtype=out_dtype, device=g.device)
    if out.numel() == 0:
        return out
    lib = build.library("vp_bwd_matmul")
    f = build.vp_fmt_struct(fmt)
    with torch.cuda.device(g.device):
        err = getattr(lib, f"{name}_launch")(
            first.data_ptr(), second.data_ptr(), out.data_ptr(), M, K, N, gc,
            words.element_size(), oc, ctypes.byref(f),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, name)
    build.LAUNCHES[name] += 1
    return out


def vp_matmul_dx_cuda(g: torch.Tensor, w: torch.Tensor, w_fmt: VPFormat,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """g (M, N) f32/bf16 @ dequant(w (K, N) packed)^T -> (M, K) out_dtype."""
    M, N = g.shape
    K = w.shape[0]
    g, w = g.contiguous(), w.contiguous()
    return _launch("vp_matmul_dx", w, g, w_fmt, (M, K), out_dtype, g, w,
                   M, K, N)


def vp_matmul_dw_cuda(a: torch.Tensor, g: torch.Tensor, a_fmt: VPFormat,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """dequant(a (M, K) packed)^T @ g (M, N) f32/bf16 -> (K, N) out_dtype."""
    M, K = a.shape
    N = g.shape[1]
    a, g = a.contiguous(), g.contiguous()
    return _launch("vp_matmul_dw", a, g, a_fmt, (K, N), out_dtype, a, g,
                   M, K, N)
