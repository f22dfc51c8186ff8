"""Wrappers of the backward matmul kernels (csrc/vp_bwd_matmul.cu).

`vp_matmul_dx_cuda` replaces `repro/kernels/vp_bwd_matmul.py:
vp_matmul_dx_pallas` and `vp_matmul_dw_cuda` replaces
`vp_matmul_dw_pallas`.  The plain versions are `ref.vp_matmul_dx_ref` /
`ref.vp_matmul_dw_ref`; dispatch lives in `ops.vp_matmul_dx` and
`ops.vp_matmul_dw`.

Each product has two CUDA bodies, and `bwd_body` alone picks one, from
the format and g's dtype, before the launch: the tensor-core body
(`wgmma` on bf16 tiles dequantized in shared memory) where the
dequantized words are exact in bf16, else the CUDA-core body.  A failed
build or launch of either raises; neither stands in for the other.
`plan_tiles` sizes the tensor-core body's grid.  `build.LAUNCHES` counts
every launch under the op's name, and also the CUDA-core body's under
`vp_bwd_cuda_core` and the split reduction's under
`vp_bwd_splitk_reduce`.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core.formats import VPFormat
from repro_torch.core.packing import storage_dtype
from . import build

# bf16 has an 8-bit significand: a dequantized word m * 2^-f is exact in
# bf16 when |m| <= 2^(M-1) <= 256.
TC_MAX_M = 9
TC_BM, TC_BN, TC_BK = 128, 64, 64  # output tile, contraction slice


def bwd_body(g_dtype: torch.dtype, fmt: VPFormat) -> str:
    """The body that computes dx / dw for g of `g_dtype` against words of
    `fmt`: "tensor_core" when every dequantized word is exact in bf16
    (`fmt.M <= TC_MAX_M`; an f32 g is then split into three bf16 terms),
    else "cuda_core" (f32 FMAs)."""
    build.dtype_code(g_dtype, "g")
    return "tensor_core" if fmt.M <= TC_MAX_M else "cuda_core"


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Grid of the tensor-core body for out (R, C) over contraction S:
    128 x 64 output tiles, the contraction cut into `split` runs of
    `kb_per` 64-deep slices (split > 1: f32 partials, then an ordered
    sum)."""
    split: int
    kb_per: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_tiles(R: int, C: int, S: int, num_sms: int) -> TilePlan:
    """Split the contraction into the most runs whose grid still fits one
    wave of `num_sms` blocks (a block's shared memory fills its SM), and
    at most one run per slice."""
    tiles = _cdiv(R, TC_BM) * _cdiv(C, TC_BN)
    nkb = max(1, _cdiv(S, TC_BK))
    split = min(nkb, max(1, num_sms // tiles))
    kb_per = _cdiv(nkb, split)
    return TilePlan(_cdiv(nkb, kb_per), kb_per)


def _launch(name: str, words: torch.Tensor, g: torch.Tensor, fmt: VPFormat,
            out_dtype: torch.dtype, first, second, M: int, K: int,
            N: int) -> torch.Tensor:
    if not (g.is_cuda and words.device == g.device):
        raise ValueError(f"{name} kernel takes CUDA tensors on one device")
    if words.dtype != storage_dtype(fmt):
        raise ValueError(f"packed words of {fmt} are {storage_dtype(fmt)}, "
                         f"got {words.dtype}")
    gc = build.dtype_code(g.dtype, "g")
    oc = build.dtype_code(out_dtype, "out_dtype")
    R, C, S = (M, K, N) if name == "vp_matmul_dx" else (K, N, M)
    out = torch.empty((R, C), dtype=out_dtype, device=g.device)
    if out.numel() == 0:
        return out
    lib = build.library("vp_bwd_matmul")
    f = build.vp_fmt_struct(fmt, out.device)
    body = bwd_body(g.dtype, fmt)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        if body == "tensor_core":
            plan = plan_tiles(R, C, S, torch.cuda.get_device_properties(
                g.device).multi_processor_count)
            ws = (torch.empty((plan.split, R, C), dtype=torch.float32,
                              device=g.device) if plan.split > 1 else None)
            err = getattr(lib, f"{name}_tc_launch")(
                first.data_ptr(), second.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), M, K, N, gc,
                words.element_size(), oc, plan.split, plan.kb_per,
                ctypes.byref(f), stream)
        else:
            err = getattr(lib, f"{name}_cc_launch")(
                first.data_ptr(), second.data_ptr(), out.data_ptr(), M, K,
                N, gc, words.element_size(), oc, ctypes.byref(f), stream)
    build.check(lib, err, name)
    build.LAUNCHES[name] += 1
    if body == "cuda_core":
        build.LAUNCHES["vp_bwd_cuda_core"] += 1
    elif plan.split > 1:
        build.LAUNCHES["vp_bwd_splitk_reduce"] += 1
    return out


def vp_matmul_dx_cuda(g: torch.Tensor, w: torch.Tensor, w_fmt: VPFormat,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """g (M, N) f32/bf16 @ dequant(w (K, N) packed)^T -> (M, K) out_dtype."""
    M, N = g.shape
    K = w.shape[0]
    g, w = g.contiguous(), w.contiguous()
    return _launch("vp_matmul_dx", w, g, w_fmt, out_dtype, g, w, M, K, N)


def vp_matmul_dw_cuda(a: torch.Tensor, g: torch.Tensor, a_fmt: VPFormat,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """dequant(a (M, K) packed)^T @ g (M, N) f32/bf16 -> (K, N) out_dtype."""
    M, K = a.shape
    N = g.shape[1]
    a, g = a.contiguous(), g.contiguous()
    return _launch("vp_matmul_dw", a, g, a_fmt, out_dtype, a, g, M, K, N)
