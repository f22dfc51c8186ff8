"""Wrappers of the quantize kernels (csrc/vp_quant.cu).

Replace `repro/kernels/vp_quant.py:vp_quant_packed_pallas` and
`vp_quant_pallas`.  The plain versions are `ref.vp_quant_packed_ref` and
`ref.vp_quant_ref`; dispatch lives in `ops.vp_quant`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.formats import FXPFormat, VPFormat
from repro_torch.core.packing import storage_dtype
from repro_torch.core.vp_tensor import significand_dtype
from . import build


def _check_input(x: torch.Tensor, what: str) -> torch.Tensor:
    if not x.is_cuda or x.dtype != torch.float32:
        raise ValueError(f"{what} kernel takes a CUDA f32 tensor, "
                         f"got {x.dtype} on {x.device}")
    return x.contiguous()


def vp_quant_packed_cuda(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat
                         ) -> torch.Tensor:
    """f32 CUDA tensor (any shape) -> packed VP words of the same shape."""
    x = _check_input(x, "vp_quant_packed")
    w = torch.empty(x.shape, dtype=storage_dtype(vp), device=x.device)
    if x.numel() == 0:
        return w
    lib = build.library("vp_quant")
    fmt = build.quant_fmt_struct(fxp, vp)
    with torch.cuda.device(x.device):
        err = lib.vp_quant_packed_launch(
            x.data_ptr(), w.data_ptr(), x.numel(), w.element_size(),
            ctypes.byref(fmt), torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "vp_quant_packed")
    build.LAUNCHES["vp_quant_packed"] += 1
    return w


def vp_quant_planes_cuda(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 CUDA tensor (any shape) -> (significand plane of
    `significand_dtype(vp.M)`, uint8 index plane), both of x's shape."""
    x = _check_input(x, "vp_quant_planes")
    m = torch.empty(x.shape, dtype=significand_dtype(vp.M), device=x.device)
    i = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.numel() == 0:
        return m, i
    lib = build.library("vp_quant")
    fmt = build.quant_fmt_struct(fxp, vp)
    with torch.cuda.device(x.device):
        err = lib.vp_quant_planes_launch(
            x.data_ptr(), m.data_ptr(), m.element_size(), i.data_ptr(),
            x.numel(), ctypes.byref(fmt),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "vp_quant_planes")
    build.LAUNCHES["vp_quant_planes"] += 1
    return m, i
