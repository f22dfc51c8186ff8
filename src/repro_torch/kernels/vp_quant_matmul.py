"""Wrapper of the fused quantize + matmul kernel (csrc/vp_quant_matmul.cu).

Replaces `repro/kernels/vp_quant_matmul.py:vp_quant_matmul_batched_pallas`
and, as its G = 1 launch, `vp_quant_matmul_pallas`.  The plain versions
are `ref.vp_quant_matmul_batched_ref` / `ref.vp_quant_matmul_ref`;
dispatch lives in `ops.vp_quant_matmul` and `ops.vp_quant_matmul_batched`.
It runs the bodies of `vp_matmul.py` and its own batch body, picked by
`qmm_body`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.formats import FXPFormat, VPFormat
from . import build
from .vp_matmul import (BATCH_LUT_MAX, BODY_CODES, BODY_COUNTER,
                        check_body, mask_args, qmm_body)
from .vp_quant import table_ok


def batch_converts(fxp: FXPFormat) -> bool:
    """Whether the batch body converts an operand on this FXP grid in
    O(1): a value table of the grid, which has at most BATCH_LUT_MAX
    values.  (The index table alone measured slower for W's 4096-value
    grid, PERF.md §6 row 11.)"""
    return fxp.raw_max - fxp.raw_min + 1 <= BATCH_LUT_MAX


def vp_quant_matmul_cuda(a: torch.Tensor, b: torch.Tensor,
                         a_fxp: FXPFormat, a_vp: VPFormat,
                         b_fxp: FXPFormat, b_vp: VPFormat,
                         a_act: Optional[torch.Tensor] = None,
                         b_act: Optional[torch.Tensor] = None,
                         tiles: Tuple[int, int, int] = (0, 0, 0),
                         body: Optional[str] = None) -> torch.Tensor:
    """f32 (G, M, K) x f32 (G, K, N) on CUDA -> (G, M, N) f32, both
    operands VP-quantized in the kernel; masks as in `vp_matmul_cuda`.
    The body is `qmm_body`'s, or `body` ("warp", "tile" or "batch")
    where a caller measures one."""
    check_body(body)
    if not (a.is_cuda and b.device == a.device):
        raise ValueError("vp_quant_matmul kernel takes CUDA tensors on one "
                         "device")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"vp_quant_matmul kernel takes f32 operands, got "
                         f"{a.dtype} and {b.dtype}")
    a, b = a.contiguous(), b.contiguous()
    G, M, K = a.shape
    N = b.shape[2]
    out = torch.empty((G, M, N), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    if body is None:
        body = qmm_body(G, M, K, N,
                        a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0,
                        batch_converts(a_fxp) and batch_converts(b_fxp))
    _flags, (pa, pb, bm, bk, bn) = mask_args(a_act, b_act, tiles, a.device)
    lib = build.library("vp_quant_matmul")
    qa = build.quant_fmt_struct(a_fxp, a_vp, out.device)
    qb = build.quant_fmt_struct(b_fxp, b_vp, out.device)
    with torch.cuda.device(a.device):
        err = lib.vp_quant_matmul_launch(
            a.data_ptr(), ctypes.byref(qa), b.data_ptr(), ctypes.byref(qb),
            out.data_ptr(), pa, pb, G, M, K, N, bm, bk, bn,
            BODY_CODES[body], int(table_ok(a_fxp, a_vp)),
            int(table_ok(b_fxp, b_vp)),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, f"vp_quant_matmul ({body} body)")
    build.LAUNCHES["vp_quant_matmul"] += 1
    build.LAUNCHES[BODY_COUNTER[body]] += 1
    return out
