"""Wrappers of the dequant kernels (csrc/vp_dequant.cu).

`vp_dequant_planes_cuda` replaces `repro/kernels/vp_dequant.py:
vp_dequant_pallas` and `vp_dequant_packed_cuda` replaces
`vp_dequant_packed_pallas`.  The plain versions are `ref.vp_dequant_ref`
and `ref.vp_dequant_packed_ref`; dispatch lives in `ops.vp_dequant`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.formats import VPFormat
from repro_torch.core.packing import storage_dtype
from . import build


def vp_dequant_planes_cuda(m: torch.Tensor, i: torch.Tensor, vp: VPFormat,
                           dtype: torch.dtype) -> torch.Tensor:
    """(significand, uint8 index) planes of one shape -> reals in dtype."""
    if not (m.is_cuda and i.device == m.device):
        raise ValueError("vp_dequant_planes kernel takes CUDA tensors on one "
                         "device")
    if m.shape != i.shape or i.dtype != torch.uint8:
        raise ValueError(f"planes must share a shape with a uint8 index, got "
                         f"{tuple(m.shape)} {m.dtype} and {tuple(i.shape)} "
                         f"{i.dtype}")
    if m.dtype != torch.int8:
        raise ValueError(f"the kernel takes int8 significands, got {m.dtype}")
    oc = build.dtype_code(dtype, "dtype")
    m, i = m.contiguous(), i.contiguous()
    out = torch.empty(m.shape, dtype=dtype, device=m.device)
    if m.numel() == 0:
        return out
    lib = build.library("vp_dequant")
    fmt = build.vp_fmt_struct(vp)
    with torch.cuda.device(m.device):
        err = lib.vp_dequant_planes_launch(
            m.data_ptr(), i.data_ptr(), out.data_ptr(),
            m.numel(), oc, ctypes.byref(fmt),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "vp_dequant_planes")
    build.LAUNCHES["vp_dequant_planes"] += 1
    return out


def vp_dequant_packed_cuda(w: torch.Tensor, vp: VPFormat,
                           dtype: torch.dtype) -> torch.Tensor:
    """Packed VP words (any shape) -> reals in dtype."""
    if not w.is_cuda:
        raise ValueError("vp_dequant_packed kernel takes a CUDA tensor")
    if w.dtype != storage_dtype(vp):
        raise ValueError(f"packed words of {vp} are {storage_dtype(vp)}, "
                         f"got {w.dtype}")
    if w.dtype not in (torch.int8, torch.int16):
        raise ValueError(f"the kernel takes int8 or int16 words, got {w.dtype}")
    oc = build.dtype_code(dtype, "dtype")
    w = w.contiguous()
    out = torch.empty(w.shape, dtype=dtype, device=w.device)
    if w.numel() == 0:
        return out
    lib = build.library("vp_dequant")
    fmt = build.vp_fmt_struct(vp)
    with torch.cuda.device(w.device):
        err = lib.vp_dequant_packed_launch(
            w.data_ptr(), w.element_size(), out.data_ptr(), w.numel(), oc,
            ctypes.byref(fmt), torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "vp_dequant_packed")
    build.LAUNCHES["vp_dequant_packed"] += 1
    return out
