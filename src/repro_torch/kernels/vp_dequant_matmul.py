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
the tensor-core body's.  The skinny body's split of K, (split, k_per),
comes from a caller (`plan=`), else on the card from the measured plan
cache (`autotune.tuned`, read inside `plan_skinny`'s memo and keyed on
(K, N) and the format: the split fixes the order of a row's sums, so one
split serves every M and a row's bits do not depend on the rows beside
it), else from the heuristic.  A launch on a shard of the output columns
(inside a `mesh_scope` of spec "N") takes the unsharded launch's split
on either body (`shard_skinny`, `shard_tiles`).
`build.LAUNCHES` counts every launch under `vp_dequant_matmul`, and also
each body's under `vp_dqmm_skinny`,
`vp_dqmm_tc` or `vp_dqmm_cuda_core`, and the tensor-core body's split
reduction under `vp_dqmm_splitk_reduce` (the skinny body sums its splits
inside its own launch, across a thread-block cluster).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.core.formats import VPFormat
from repro_torch.core.packing import storage_dtype
from . import autotune, build
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
SKINNY_KERNEL = "vp_dqmm_skinny"   # the plan cache's name for the body


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


@autotune.memoised_planner
@functools.lru_cache(maxsize=1024)
def plan_skinny(M: int, K: int, N: int, num_sms: int,
                split_k: Optional[Tuple[int, int]] = None,
                fmt: Optional[VPFormat] = None,
                device: Optional[int] = None) -> SkinnyPlan:
    """The grid for out (M, N) over K: `mt` the snug power of two of M
    (at most 16), then K in `split_k` = (split, k_per) runs; where it is
    None, the plan cache's split for words (K, N) of `fmt` on CUDA device
    `device` (an index; an entry that is not a split of K is ignored),
    else the heuristic's: the fewest runs of whole 32-row units, at most
    SK_MAX_SPLIT, that give SK_WAVES blocks per SM where the column
    groups alone give fewer.  `mt` leaves a row's sums as they are; the
    split fixes their order.  Memoised; `autotune.record` and
    `clear_cache` drop the memo."""
    mt = next(t for t in SK_MTS if t >= min(M, SK_MTS[-1]))
    m_chunks, groups = _cdiv(M, mt), _cdiv(N, SK_COLS)
    if split_k is None and device is not None:
        split_k = autotune.tuned(SKINNY_KERNEL, (K, N), (fmt,), device)
        if split_k is not None and not valid_split(K, split_k):
            split_k = None
    if split_k is None:
        units = max(1, _cdiv(K, SK_KL))
        split = min(units, SK_MAX_SPLIT,
                    max(1, _cdiv(SK_WAVES * num_sms, groups * m_chunks)))
        k_per = _cdiv(units, split) * SK_KL
        split_k = (max(1, _cdiv(K, k_per)), k_per)
    return SkinnyPlan(mt, m_chunks, groups, *split_k)


def shard_skinny(M: int, K: int, N: int, num_sms: int,
                 plan: Optional[Tuple[int, int]] = None,
                 fmt: Optional[VPFormat] = None,
                 device: Optional[int] = None) -> SkinnyPlan:
    """The skinny grid of a launch at out (M, N): `plan_skinny`'s, except
    that inside a `mesh_scope` cutting N (a shard of the output columns)
    a launch with no `plan` takes the (split, k_per) of the unsharded
    launch (`autotune.unsharded`; the plan cache read under that shape's
    key), so a shard sums each column in the unsharded order."""
    full = autotune.unsharded("N", N)
    if plan is None and full != N:
        p = plan_skinny(M, K, full, num_sms, None, fmt, device)
        plan = (p.split, p.k_per)
    return plan_skinny(M, K, N, num_sms, plan, fmt, device)


def shard_tiles(M: int, K: int, N: int, num_sms: int):
    """The tensor-core body's plan (`vp_bwd_matmul.plan_tiles`) for out
    (M, N) over K, at the unsharded N inside a `mesh_scope` cutting the
    output columns: the split of K is the unsharded launch's."""
    return plan_tiles(M, autotune.unsharded("N", N), K, num_sms)


def valid_split(K: int, split_k) -> bool:
    """Whether (split, k_per) covers K in `split` non-empty runs of one
    cluster (the C entry's conditions)."""
    if len(split_k) != 2:
        return False
    split, k_per = split_k
    return (1 <= split <= SK_MAX_SPLIT and k_per >= 1
            and split * k_per >= K > (split - 1) * k_per)


def skinny_candidates(K: int, N: int, num_sms: int) -> List[Tuple[int, int]]:
    """The splits of K a tuning run times: the heuristic's first, then
    every split of whole 32-row units into 1..SK_MAX_SPLIT runs."""
    h = plan_skinny(1, K, N, num_sms)
    out = [(h.split, h.k_per)]
    units = max(1, _cdiv(K, SK_KL))
    for s in range(1, SK_MAX_SPLIT + 1):
        k_per = _cdiv(units, s) * SK_KL
        c = (_cdiv(K, k_per), k_per)
        if c not in out:
            out.append(c)
    return out


def vp_dequant_matmul_cuda(x: torch.Tensor, w: torch.Tensor, w_fmt: VPFormat,
                           out_dtype: torch.dtype,
                           body: Optional[str] = None,
                           plan: Optional[Tuple[int, int]] = None
                           ) -> torch.Tensor:
    """x (M, K) f32/bf16 @ dequant(w (K, N) packed) -> (M, N) out_dtype,
    on `fwd_body`'s body, or on `body` where a caller measures one; the
    skinny body at the (split, k_per) `plan` where a caller gives one."""
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
    if plan is not None and (body != "skinny" or not valid_split(K, plan)):
        raise ValueError(f"plan {plan} is not a split of K {K} for the "
                         f"skinny body (on the {body} body)")
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
            sp = shard_skinny(M, K, N, num_sms, plan, w_fmt,
                              x.device.index)
            err = lib.vp_dqmm_skinny_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N, xc,
                w.element_size(), oc, sp.mt, sp.split, sp.k_per,
                ctypes.byref(f), stream)
        elif body == "tensor_core":
            tp = shard_tiles(M, K, N, num_sms)
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
