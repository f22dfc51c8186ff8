"""Wrapper of the VP x VP matmul kernel (csrc/vp_matmul.cu).

Replaces `repro/kernels/vp_matmul.py:vp_matmul_batched_pallas` and, as
its G = 1 launch, `vp_matmul_pallas`.  The plain versions are
`ref.vp_matmul_batched_ref` / `ref.vp_matmul_ref` and their packed
twins; dispatch lives in `ops.vp_matmul` and `ops.vp_matmul_batched`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.formats import VPFormat
from repro_torch.core.packing import storage_dtype
from repro_torch.core.vp_tensor import significand_dtype
from . import build


def _operand(x_m: torch.Tensor, x_i: Optional[torch.Tensor], fmt: VPFormat,
             device: torch.device, what: str):
    """Checked, contiguous (m, i) of one operand; i is None for words."""
    if x_m.device != device or (x_i is not None and x_i.device != device):
        raise ValueError("vp_matmul kernel takes CUDA tensors on one device")
    if x_i is None:
        if x_m.dtype != storage_dtype(fmt):
            raise ValueError(f"{what}: packed words of {fmt} are "
                             f"{storage_dtype(fmt)}, got {x_m.dtype}")
        return x_m.contiguous(), None
    if x_m.dtype != significand_dtype(fmt.M) or x_i.dtype != torch.uint8:
        raise ValueError(f"{what}: planes of {fmt} are "
                         f"({significand_dtype(fmt.M)}, uint8), got "
                         f"({x_m.dtype}, {x_i.dtype})")
    if x_i.shape != x_m.shape:
        raise ValueError(f"{what}: plane shapes differ")
    return x_m.contiguous(), x_i.contiguous()


def mask_args(a_act, b_act, tiles, device):
    """Launcher arguments of optional CSPADE flags: (the int32 contiguous
    flag tensors, to keep alive over the launch, and (a_act pointer,
    b_act pointer, bm, bk, bn)); nulls and zeros without masks."""
    if a_act is None:
        return (), (None, None, 0, 0, 0)
    if a_act.device != device or b_act.device != device:
        raise ValueError("CSPADE masks must lie on the operands' device")
    flags = (a_act.to(torch.int32).contiguous(),
             b_act.to(torch.int32).contiguous())
    return flags, (flags[0].data_ptr(), flags[1].data_ptr(), *tiles)


def vp_matmul_cuda(a_m: torch.Tensor, a_i: Optional[torch.Tensor],
                   b_m: torch.Tensor, b_i: Optional[torch.Tensor],
                   a_fmt: VPFormat, b_fmt: VPFormat,
                   a_act: Optional[torch.Tensor] = None,
                   b_act: Optional[torch.Tensor] = None,
                   tiles: Tuple[int, int, int] = (0, 0, 0)) -> torch.Tensor:
    """(G, M, K) x (G, K, N) VP operands on CUDA -> (G, M, N) f32.

    Each operand is planes (m, uint8 i) or packed words (m, None).  With
    CSPADE flags a_act (G, M/bm, K/bk) / b_act (G, K/bk, N/bn), `tiles`
    is their grid (bm, bk, bn); shapes are checked by `ops`.
    """
    if not a_m.is_cuda:
        raise ValueError("vp_matmul kernel takes CUDA tensors")
    dev = a_m.device
    a_m, a_i = _operand(a_m, a_i, a_fmt, dev, "a")
    b_m, b_i = _operand(b_m, b_i, b_fmt, dev, "b")
    G, M, K = a_m.shape
    N = b_m.shape[2]
    out = torch.empty((G, M, N), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    _flags, (pa, pb, bm, bk, bn) = mask_args(a_act, b_act, tiles, dev)
    lib = build.library("vp_matmul")
    fa, fb = build.vp_fmt_struct(a_fmt), build.vp_fmt_struct(b_fmt)
    with torch.cuda.device(dev):
        err = lib.vp_matmul_launch(
            a_m.data_ptr(), None if a_i is None else a_i.data_ptr(),
            a_m.element_size(), ctypes.byref(fa),
            b_m.data_ptr(), None if b_i is None else b_i.data_ptr(),
            b_m.element_size(), ctypes.byref(fb), out.data_ptr(), pa, pb,
            G, M, K, N, bm, bk, bn, torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "vp_matmul")
    build.LAUNCHES["vp_matmul"] += 1
    return out
