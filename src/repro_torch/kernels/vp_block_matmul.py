"""Wrapper of the block-VP matmul kernels (csrc/vp_block_matmul.cu).

Replaces `repro/kernels/vp_block_matmul.py:block_vp_matmul_pallas`.  The
plain version is `ref.block_vp_matmul_ref`; dispatch and the int32
accumulator contract live in `ops.block_vp_matmul`.

Four CUDA bodies, and `block_body` alone picks one, from (M, K, N, bk),
the significands' width and the operands' alignment, before the launch:
for int8 significands the skinny body (byte-bound, the k-tiles split
across tile groups of a block and the blocks of a cluster) for small M,
the tensor-core body (s8 `wgmma`) above, both for bk = 256 and N a
multiple of 16, the dp4a body for anything else; for int16 significands
(M 9-16, `significand_dtype`) the int16 body (int32 multiply-adds on
the CUDA cores) at any bk.  A failed build or
launch raises; no body stands in for another.  `plan_skinny` sizes the
skinny body's grid.  `build.LAUNCHES` counts every launch under
`block_vp_matmul`, and also each body's under `vp_bmm_skinny`,
`vp_bmm_tc`, `vp_bmm_dp4a` or `vp_bmm_i16`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.formats import VPFormat
from repro_torch.core.vp_tensor import SIGNIFICAND_DTYPES
from . import build

BK = 256            # the k-tile the skinny and tensor-core bodies take
# Largest M the skinny body takes, from the M sweep in chip_smoke.py
# (PERF.md §6, row 12): above it the tensor-core body is faster.
SKINNY_MAX_M = 8
SK_COLS = 32        # output columns per skinny block
SK_MTS = (1, 2, 4, 8)   # rows of x per skinny block
SK_WAVES = 4        # column blocks per SM below which the tiles split
SK_MAX_SPLIT = 8    # the blocks of a split form one cluster (portable size)
SK_TERMS = 8        # k-tiles a block that keeps terms may hold

BODY_COUNTER = {"skinny": "vp_bmm_skinny", "tensor_core": "vp_bmm_tc",
                "dp4a": "vp_bmm_dp4a", "int16": "vp_bmm_i16"}
# Significand planes (`SIGNIFICAND_DTYPES`): int8 (M <= 8) on the first
# three bodies, int16 (M 9-16) on the int16 body.


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def block_body(M: int, K: int, N: int, bk: int, aligned: bool = True,
               m_bytes: int = 1) -> str:
    """The body that computes a (M, K) @ b (K, N) with index block `bk`
    over significands of `m_bytes` bytes: "int16" for int16; for int8
    "skinny" for M <= SKINNY_MAX_M and "tensor_core" above, where bk is
    BK, N a multiple of 16 and the operands 16-byte aligned (`aligned`);
    else "dp4a"."""
    if m_bytes == 2:
        return "int16"
    if bk != BK or K % BK or N % 16 or not aligned:
        return "dp4a"
    return "skinny" if M <= SKINNY_MAX_M else "tensor_core"


@dataclasses.dataclass(frozen=True)
class SkinnyPlan:
    """Grid of the skinny body for out (M, N) over nk k-tiles: `groups`
    column groups of 32 x `m_chunks` row chunks of `mt` x `split` thread
    blocks (one cluster) of `tile_groups` tile groups each; the split x
    tile_groups runs of whole k-tiles are added in tile order."""
    mt: int
    m_chunks: int
    groups: int
    split: int
    tile_groups: int = 1


@functools.lru_cache(maxsize=1024)
def plan_skinny(M: int, K: int, N: int, num_sms: int) -> SkinnyPlan:
    """Where the column groups alone give fewer than SK_WAVES blocks per
    SM, split the k-tiles into runs: `tile_groups` of a block (4, or 2 for
    8 rows, which would spill at 4) and `split` blocks of a cluster, a
    tile per run (two for 8 rows), at most SK_MAX_SPLIT blocks and no
    more runs than tiles; a block holding more than SK_TERMS tiles takes
    none of this (the M sweep of chip_smoke.py chose these)."""
    mt = next(t for t in SK_MTS if t >= min(M, SK_MTS[-1]))
    m_chunks, groups = _cdiv(M, mt), _cdiv(N, SK_COLS)
    nk = K // BK
    if groups * m_chunks >= SK_WAVES * num_sms or nk == 1:
        return SkinnyPlan(mt, m_chunks, groups, 1)
    tg = next(g for g in (4, 2, 1) if g <= min(4 if mt <= 4 else 2, nk))
    per_run = 1 if mt <= 4 else 2
    split = max(1, min(SK_MAX_SPLIT, _cdiv(nk, tg * per_run), nk // tg))
    if _cdiv(nk, split) > SK_TERMS:
        return SkinnyPlan(mt, m_chunks, groups, 1)
    return SkinnyPlan(mt, m_chunks, groups, split, tg)


@functools.lru_cache(maxsize=None)
def _num_sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def significand_width(a_dtype: torch.dtype, b_dtype: torch.dtype) -> int:
    """Bytes of the significands the kernel multiplies: 1 (int8, the
    first three bodies) or 2 (int16, the int16 body), the same for both
    operands (`significand_dtype` of one format).  Raises for other
    planes: the host-side check of `block_vp_matmul_cuda`."""
    if a_dtype != b_dtype or a_dtype not in SIGNIFICAND_DTYPES:
        raise ValueError(f"block_vp_matmul kernel takes int8 or int16 "
                         f"significands of one width, got {a_dtype} and "
                         f"{b_dtype}")
    return a_dtype.itemsize


def block_vp_matmul_cuda(a_m: torch.Tensor, a_i: torch.Tensor,
                         b_m: torch.Tensor, b_i: torch.Tensor,
                         a_fmt: VPFormat, b_fmt: VPFormat, bk: int,
                         out_dtype: torch.dtype,
                         body: Optional[str] = None) -> torch.Tensor:
    """a_m (M, K) int8 or int16 with a_i (M, K/bk) uint8, b_m (K, N)
    int8 or int16 with b_i (K/bk, N) uint8 -> (M, N) out_dtype, on
    `block_body`'s body, or on `body` where a caller measures one."""
    tensors = (a_m, a_i, b_m, b_i)
    if not all(t.is_cuda and t.device == a_m.device for t in tensors):
        raise ValueError("block_vp_matmul kernel takes CUDA tensors on one "
                         "device")
    mb = significand_width(a_m.dtype, b_m.dtype)
    if a_i.dtype != torch.uint8 or b_i.dtype != torch.uint8:
        raise ValueError(f"block_vp_matmul kernel takes uint8 indices, got "
                         f"{a_i.dtype} and {b_i.dtype}")
    M, K = a_m.shape
    N = b_m.shape[1]
    oc = build.dtype_code(out_dtype, "out_dtype")
    a_m, a_i, b_m, b_i = (t.contiguous() for t in tensors)
    aligned = a_m.data_ptr() % 16 == 0 and b_m.data_ptr() % 16 == 0
    planned = block_body(M, K, N, bk, aligned, mb)
    if body is None:
        body = planned
    elif body not in BODY_COUNTER:
        raise ValueError(f"unknown body {body!r}")
    elif (body == "int16") != (planned == "int16") or (
            body not in ("dp4a", "int16") and planned == "dp4a"):
        raise ValueError(f"the {body} body does not take {a_m.dtype} "
                         f"significands at bk {bk}, N {N}")
    out = torch.empty((M, N), dtype=out_dtype, device=a_m.device)
    if M == 0 or N == 0:
        return out
    lib = build.library("vp_block_matmul")
    fa = build.vp_fmt_struct(a_fmt, out.device)
    fb = build.vp_fmt_struct(b_fmt, out.device)
    args = (a_m.data_ptr(), a_i.data_ptr(), b_m.data_ptr(), b_i.data_ptr(),
            out.data_ptr(), M, K, N)
    with torch.cuda.device(a_m.device):
        stream = torch.cuda.current_stream().cuda_stream
        if body == "skinny":
            sp = plan_skinny(M, K, N, _num_sms(a_m.device.index))
            err = lib.block_vp_matmul_skinny_launch(
                *args, oc, sp.mt, sp.tile_groups, sp.split,
                ctypes.byref(fa),
                ctypes.byref(fb), stream)
        elif body == "tensor_core":
            err = lib.block_vp_matmul_tc_launch(
                *args, oc, ctypes.byref(fa), ctypes.byref(fb), stream)
        elif body == "dp4a":
            err = lib.block_vp_matmul_dp4a_launch(
                *args, bk, oc, ctypes.byref(fa), ctypes.byref(fb), stream)
        else:
            err = lib.block_vp_matmul_i16_launch(
                *args, bk, oc, ctypes.byref(fa), ctypes.byref(fb), stream)
    build.check(lib, err, f"block_vp_matmul ({body} body)")
    build.LAUNCHES["block_vp_matmul"] += 1
    build.LAUNCHES[BODY_COUNTER[body]] += 1
    return out
