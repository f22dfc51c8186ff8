"""Wrapper of the block-VP matmul kernel (csrc/vp_block_matmul.cu).

Replaces `repro/kernels/vp_block_matmul.py:block_vp_matmul_pallas`.  The
plain version is `ref.block_vp_matmul_ref`; dispatch and the int32
accumulator contract live in `ops.block_vp_matmul`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.formats import VPFormat
from . import build


def block_vp_matmul_cuda(a_m: torch.Tensor, a_i: torch.Tensor,
                         b_m: torch.Tensor, b_i: torch.Tensor,
                         a_fmt: VPFormat, b_fmt: VPFormat, bk: int,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """a_m (M, K) int8 with a_i (M, K/bk) uint8, b_m (K, N) int8 with b_i
    (K/bk, N) uint8 -> (M, N) out_dtype."""
    tensors = (a_m, a_i, b_m, b_i)
    if not all(t.is_cuda and t.device == a_m.device for t in tensors):
        raise ValueError("block_vp_matmul kernel takes CUDA tensors on one "
                         "device")
    if a_m.dtype != torch.int8 or b_m.dtype != torch.int8:
        raise ValueError(f"block_vp_matmul kernel takes int8 significands, "
                         f"got {a_m.dtype} and {b_m.dtype}")
    if a_i.dtype != torch.uint8 or b_i.dtype != torch.uint8:
        raise ValueError(f"block_vp_matmul kernel takes uint8 indices, got "
                         f"{a_i.dtype} and {b_i.dtype}")
    M, K = a_m.shape
    N = b_m.shape[1]
    oc = build.dtype_code(out_dtype, "out_dtype")
    a_m, a_i, b_m, b_i = (t.contiguous() for t in tensors)
    out = torch.empty((M, N), dtype=out_dtype, device=a_m.device)
    if M == 0 or N == 0:
        return out
    lib = build.library("vp_block_matmul")
    fa, fb = build.vp_fmt_struct(a_fmt), build.vp_fmt_struct(b_fmt)
    with torch.cuda.device(a_m.device):
        err = lib.block_vp_matmul_launch(
            a_m.data_ptr(), a_i.data_ptr(), b_m.data_ptr(), b_i.data_ptr(),
            out.data_ptr(), M, K, N, bk, oc, ctypes.byref(fa),
            ctypes.byref(fb), torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "block_vp_matmul")
    build.LAUNCHES["block_vp_matmul"] += 1
    return out
