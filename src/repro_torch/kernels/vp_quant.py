"""Wrapper of the packed quantize kernel (csrc/vp_quant.cu).

Replaces `repro/kernels/vp_quant.py:vp_quant_packed_pallas`.  The plain
version is `ref.vp_quant_packed_ref`; dispatch lives in `ops.vp_quant`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.formats import FXPFormat, VPFormat
from repro_torch.core.packing import storage_dtype
from . import build


def vp_quant_packed_cuda(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat
                         ) -> torch.Tensor:
    """f32 CUDA tensor (any shape) -> packed VP words of the same shape."""
    if not x.is_cuda or x.dtype != torch.float32:
        raise ValueError(f"vp_quant_packed kernel takes a CUDA f32 tensor, "
                         f"got {x.dtype} on {x.device}")
    x = x.contiguous()
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
