"""Wrapper of the serving matmul kernels (csrc/vp_dequant_matmul.cu).

Replaces `repro/kernels/vp_dequant_matmul.py:vp_dequant_matmul_pallas`.
The plain version is `ref.vp_dequant_matmul_ref`; dispatch lives in
`ops.vp_dequant_matmul`.

Three CUDA bodies, and `fwd_body` alone picks one, from M, x's dtype and
the format, before the launch: the skinny body (byte-bound, split-K) for
small M, the tensor-core body (`wgmma` on words dequantized into bf16 in
shared memory, `vp_bwd_matmul`'s body in its forward role) for large M
where the dequantized words are exact in bf16, else the CUDA-core body.
A failed build or launch raises; no body stands in for another.
`plan_skinny` sizes the skinny body's grid, `vp_bwd_matmul.plan_tiles`
the tensor-core body's.  `build.LAUNCHES` counts every launch under
`vp_dequant_matmul`, and also each body's under `vp_dqmm_skinny`,
`vp_dqmm_tc` or `vp_dqmm_cuda_core`, and the tensor-core body's split
reduction under `vp_dqmm_splitk_reduce` (the skinny body sums its splits
inside its own launch, across a thread-block cluster).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.formats import VPFormat
from repro_torch.core.packing import storage_dtype
from . import build
from .vp_bwd_matmul import TC_MAX_M, _cdiv, plan_tiles

# Largest M the skinny body takes, from row 2's M sweep in chip_smoke.py
# (PERF.md §6): against the tensor-core body where the words are exact in
# bf16 (it wins from M = 8), against the CUDA-core body otherwise.
SKINNY_MAX_M = 4
SKINNY_MAX_M_WIDE = 64
SK_COLS = 64        # output columns per skinny block
SK_KL = 32          # k lanes per skinny block: a split's k rows come in 32s
SK_MTS = (1, 2, 4, 8, 16)   # rows of x per skinny block
SK_WAVES = 2        # skinny blocks per SM that the split aims at
SK_MAX_SPLIT = 8    # the blocks of a split form one cluster (portable size)

BODY_COUNTER = {"skinny": "vp_dqmm_skinny", "tensor_core": "vp_dqmm_tc",
                "cuda_core": "vp_dqmm_cuda_core"}


def fwd_body(M: int, x_dtype: torch.dtype, fmt: VPFormat) -> str:
    """The body that computes x (M, K) of `x_dtype` @ dequant(words of
    `fmt`).  Where every dequantized word is exact in bf16 (`fmt.M <=
    TC_MAX_M`): "skinny" for M <= SKINNY_MAX_M, else "tensor_core" (an
    f32 x is split into three bf16 terms).  Otherwise "skinny" for M <=
    SKINNY_MAX_M_WIDE, else "cuda_core"."""
    build.dtype_code(x_dtype, "x")
    exact = fmt.M <= TC_MAX_M
    if M <= (SKINNY_MAX_M if exact else SKINNY_MAX_M_WIDE):
        return "skinny"
    return "tensor_core" if exact else "cuda_core"


@dataclasses.dataclass(frozen=True)
class SkinnyPlan:
    """Grid of the skinny body for out (M, N) over K: `groups` column
    groups of 64 x `m_chunks` row chunks of `mt` x `split` runs of
    `k_per` k rows (the runs of a group form one cluster and sum in split
    order)."""
    mt: int
    m_chunks: int
    groups: int
    split: int
    k_per: int


@functools.lru_cache(maxsize=1024)
def plan_skinny(M: int, K: int, N: int, num_sms: int) -> SkinnyPlan:
    """Split K (in runs of whole 32-row units, at most SK_MAX_SPLIT) into
    the fewest runs that give SK_WAVES blocks per SM, where the column
    groups alone give fewer."""
    mt = next(t for t in SK_MTS if t >= min(M, SK_MTS[-1]))
    m_chunks, groups = _cdiv(M, mt), _cdiv(N, SK_COLS)
    units = max(1, _cdiv(K, SK_KL))
    split = min(units, SK_MAX_SPLIT,
                max(1, _cdiv(SK_WAVES * num_sms, groups * m_chunks)))
    k_per = _cdiv(units, split) * SK_KL
    return SkinnyPlan(mt, m_chunks, groups, max(1, _cdiv(K, k_per)), k_per)


def vp_dequant_matmul_cuda(x: torch.Tensor, w: torch.Tensor, w_fmt: VPFormat,
                           out_dtype: torch.dtype,
                           body: Optional[str] = None) -> torch.Tensor:
    """x (M, K) f32/bf16 @ dequant(w (K, N) packed) -> (M, N) out_dtype,
    on `fwd_body`'s body, or on `body` where a caller measures one."""
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("vp_dequant_matmul kernel takes CUDA tensors on "
                         "one device")
    if w.dtype != storage_dtype(w_fmt):
        raise ValueError(f"packed words of {w_fmt} are "
                         f"{storage_dtype(w_fmt)}, got {w.dtype}")
    M, K = x.shape
    if w.ndim != 2 or w.shape[0] != K:
        raise ValueError(f"x {tuple(x.shape)} and words {tuple(w.shape)} "
                         "do not contract")
    N = w.shape[1]
    xc = build.dtype_code(x.dtype, "x")
    oc = build.dtype_code(out_dtype, "out_dtype")
    if body is None:
        body = fwd_body(M, x.dtype, w_fmt)
    elif body not in BODY_COUNTER:
        raise ValueError(f"unknown body {body!r}")
    if body == "tensor_core" and w_fmt.M > TC_MAX_M:
        raise ValueError(f"{w_fmt}: words not exact in bf16 (M > "
                         f"{TC_MAX_M}); no tensor-core body")
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = build.library("vp_dequant_matmul")
    f = build.vp_fmt_struct(w_fmt, out.device)
    reduced = False
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        num_sms = torch.cuda.get_device_properties(
            x.device).multi_processor_count
        if body == "skinny":
            sp = plan_skinny(M, K, N, num_sms)
            err = lib.vp_dqmm_skinny_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N, xc,
                w.element_size(), oc, sp.mt, sp.split, sp.k_per,
                ctypes.byref(f), stream)
        elif body == "tensor_core":
            tp = plan_tiles(M, N, K, num_sms)
            ws = (torch.empty((tp.split, M, N), dtype=torch.float32,
                              device=x.device) if tp.split > 1 else None)
            err = lib.vp_dqmm_tc_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), M, K, N, xc,
                w.element_size(), oc, tp.split, tp.kb_per, ctypes.byref(f),
                stream)
            reduced = tp.split > 1
        else:
            err = lib.vp_dqmm_cc_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N, xc,
                w.element_size(), oc, ctypes.byref(f), stream)
    build.check(lib, err, f"vp_dequant_matmul ({body} body)")
    build.LAUNCHES["vp_dequant_matmul"] += 1
    build.LAUNCHES[BODY_COUNTER[body]] += 1
    if reduced:
        build.LAUNCHES["vp_dqmm_splitk_reduce"] += 1
    return out
