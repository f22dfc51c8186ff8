"""Wrappers of the attention kernels (csrc/vp_attention.cu).

Replace `repro/kernels/vp_attention.py:vp_decode_attention_pallas` and
`flash_prefill_pallas`.  The plain versions are
`ref.vp_decode_attention_ref` and `ref.flash_prefill_ref`; dispatch and
the reshapes live in `ops.py`.  Both kernels take q unscaled, in its own
dtype, and apply dh**-0.5 as the plain path does.

Decode has one body, split over the cache span: `plan_decode` fixes the
split (blocks of a cluster, warps of a block, lanes per position) from
the shapes of one row alone, not the batch, so a row's bits do not
depend on the rows decoded beside it (the serving engine's buckets), and
`decode_runs` lists the positions each run reads.  A lane loads 16
bytes of a row, or 8 at int8 rows of dh = 8 mod 16, or 32 at int32 rows
past dh 128 (`lane_bytes`), and
query rows past its registers (`DEC_MAX_G`) split over slices of a grid
axis; neither changes a row's sums.
Prefill has two, and `flash_body` alone picks one from q's dtype and the
head dim before the launch: the tensor-core body (`mma.sync`) for bf16
at the head dims it is built for (`TC_DHS`: multiples of 16 up to 128,
and stablelm's 160 and gemma3's 168), the CUDA-core body otherwise.  A
failed build or launch raises; no body stands in for another.
`build.LAUNCHES` counts every launch under `vp_decode_attention` /
`flash_prefill`, and also each body's under `vp_dec_split`, `flash_tc`
or `flash_cuda_core`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.core.formats import VPFormat
from repro_torch.core.packing import storage_dtype
from . import build

DEC_MAX_WARPS = 8     # runs (warps) per block
DEC_MAX_CLUSTER = 8   # blocks per cluster (portable size)
DEC_BLOCKS = 128      # blocks the split aims at: ~one per SM
DEC_WARPS = 2048      # warps the split aims at on long caches: 16 per SM
DEC_MIN_STEPS = 2     # warp steps a run is given before runs are added
DEC_MAX_G = {16: 4, 8: 8, 4: 8}   # query rows a block, by words a lane
DEC_MAX_G_WIDE = 4    # ... on 32-byte lanes (8 int32 words)

# Head dims of the tensor-core prefill body's instances (csrc/
# vp_attention.cu:tc_dh): multiples of 16 up to 128, then 160 and 168,
# whose 84 output f32 a thread still fit its registers.
TC_DHS = frozenset(range(16, 129, 16)) | {160, 168}
BODY_COUNTER = {"tensor_core": "flash_tc", "cuda_core": "flash_cuda_core"}
_BODY_CODE = {"tensor_core": 0, "cuda_core": 1}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Grid of the split decode body: per (batch, kv head) a cluster of
    `cluster` blocks of `warps` warps, one run of the span per warp, in
    split order (block, then warp); `lpp` lanes hold one position's dh
    words, `lane_bytes` of them each, so a warp step covers 32 / lpp
    positions; the G query rows in `slices` slices of `rows(G)` rows, one
    block each (the last may hold fewer)."""
    cluster: int
    warps: int
    lpp: int
    lane_bytes: int = 16
    slices: int = 1

    def rows(self, G: int) -> int:
        """Query rows per slice."""
        return _cdiv(G, self.slices)

    @property
    def runs(self) -> int:
        return self.cluster * self.warps

    @property
    def step(self) -> int:
        return 32 // self.lpp


@functools.lru_cache(maxsize=1024)
def plan_decode(KV: int, smax: int, G: int, dh: int,
                w_bytes: int = 2) -> DecodePlan:
    """The split for one row of q (KV, G, dh) over a cache of smax
    positions of `w_bytes` words.  Runs of at least DEC_MIN_STEPS warp
    steps, as many as the buffer holds up to DEC_WARPS warps per row; at
    least DEC_BLOCKS / KV blocks per cluster where the buffer allows, at
    most DEC_MAX_CLUSTER.  The batch does not enter: the runs fix the
    order of the sums, and a row gives the same bits in every batch.

    A lane holds 16 bytes of a row (nw words), or 8 where int8 rows are
    only 8-byte aligned (dh = 8 mod 16: gemma3's dh 168), or 32 where
    int32 rows pass 32 lanes of 4 words (dh above 128: stablelm's 160,
    gemma3's 168).  G above DEC_MAX_G[nw] (DEC_MAX_G_WIDE on 32-byte
    lanes; the registers of a lane: qwen2's G = 7 at 16 int8 words)
    splits into slices of that many rows; the runs do not depend on G,
    so a row's bits are the same in every slicing.  Raises for shapes
    the body does not take: dh not a multiple of nw or past 32 * nw,
    G < 1."""
    if w_bytes not in (1, 2, 4):
        raise ValueError(f"packed words of {w_bytes} bytes")
    lane_bytes = (8 if w_bytes == 1 and dh % 16
                  else 32 if w_bytes == 4 and dh > 128 else 16)
    nw = lane_bytes // w_bytes
    if dh % nw or not 1 <= dh <= 32 * nw or G < 1:
        raise ValueError(
            f"the decode body takes dh a multiple of {nw} up to {32 * nw} "
            f"and G >= 1 at {w_bytes}-byte words; got dh {dh}, G {G}")
    max_g = DEC_MAX_G_WIDE if lane_bytes == 32 else DEC_MAX_G[nw]
    slices = _cdiv(G, max_g)
    lpp = 1 << (dh // nw - 1).bit_length()
    step = 32 // lpp
    cap = max(1, _cdiv(smax, DEC_MIN_STEPS * step))   # runs the buffer fills
    want = min(cap, max(1, _cdiv(DEC_WARPS, KV)))
    cluster = min(DEC_MAX_CLUSTER, cap,
                  max(_cdiv(DEC_BLOCKS, KV), _cdiv(want, DEC_MAX_WARPS)))
    warps = min(DEC_MAX_WARPS, max(1, _cdiv(want, cluster)))
    return DecodePlan(cluster, warps, lpp, lane_bytes, slices)


def decode_runs(plan: DecodePlan, length: int, smax: int,
                window: Optional[int], rolling: bool
                ) -> List[Tuple[int, int]]:
    """[lo, hi) of every run, in split order, as the kernel computes them:
    the valid span of a query of valid length `length` (the plain
    version's mask) cut into runs of the same whole number of warp steps,
    the last ones empty."""
    lo, hi = 0, length
    if rolling:
        hi = min(length, smax)
    elif window:
        lo = max(length - window, 0)
    hi = min(hi, smax)
    per = _cdiv(_cdiv(max(hi - lo, 0), plan.runs), plan.step) * plan.step
    out = []
    for r in range(plan.runs):
        r_lo = min(lo + r * per, hi)
        out.append((r_lo, min(r_lo + per, hi)))
    return out


def vp_decode_attention_cuda(q, k_w, v_w, k_s, v_s, lengths, fmt: VPFormat,
                             window: Optional[int], rolling: bool,
                             scale: float):
    """q (B, KV, G, dh) f32 or bf16, not scaled (the kernel multiplies it
    by `scale` in f32); k_w / v_w (B, Smax, KV, dh) packed words; k_s /
    v_s (B, Smax) f32; lengths (B,) -> (B, KV, G, dh) in q's dtype."""
    B, KV, G, dh = q.shape
    smax = k_w.shape[1]
    if not all(t.is_cuda and t.device == q.device
               for t in (q, k_w, v_w, k_s, v_s, lengths)):
        raise ValueError("vp_decode_attention kernel takes CUDA tensors on "
                         "one device")
    if k_w.shape != (B, smax, KV, dh) or v_w.shape != k_w.shape:
        raise ValueError(f"cache shape {tuple(k_w.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if k_w.dtype != storage_dtype(fmt) or v_w.dtype != k_w.dtype:
        raise ValueError(f"packed words of {fmt} are {storage_dtype(fmt)}")
    if lengths.shape != (B,) or k_s.numel() != B * smax or \
            v_s.numel() != B * smax:
        raise ValueError(f"lengths {tuple(lengths.shape)} / scales "
                         f"{tuple(k_s.shape)} do not match the cache "
                         f"{tuple(k_w.shape)}")
    q_bf16 = build.dtype_code(q.dtype, "q")
    plan = plan_decode(KV, smax, G, dh, k_w.element_size())
    q, k_w, v_w = q.contiguous(), k_w.contiguous(), v_w.contiguous()
    align = min(plan.lane_bytes, 16)
    if k_w.data_ptr() % align or v_w.data_ptr() % align:
        raise ValueError(f"vp_decode_attention kernel reads {align}-byte "
                         f"aligned caches")
    k_s = k_s.reshape(B, smax).to(torch.float32).contiguous()
    v_s = v_s.reshape(B, smax).to(torch.float32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.library("vp_attention")
    f = build.vp_fmt_struct(fmt, q.device)
    with torch.cuda.device(q.device):
        err = lib.vp_decode_attention_launch(
            q.data_ptr(), k_w.data_ptr(), v_w.data_ptr(), k_s.data_ptr(),
            v_s.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, KV, G, dh, smax, int(window or 0), int(rolling),
            k_w.element_size(), q_bf16, plan.cluster, plan.warps, plan.lpp,
            plan.lane_bytes, plan.rows(G), scale, ctypes.byref(f),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "vp_decode_attention")
    build.LAUNCHES["vp_decode_attention"] += 1
    build.LAUNCHES["vp_dec_split"] += 1
    return out


def flash_body(dtype: torch.dtype, dh: int) -> str:
    """The prefill body for q, k, v of `dtype` with head dim dh:
    "tensor_core" for bf16 with dh in TC_DHS (multiples of 16 up to 128,
    160, 168), else "cuda_core" (f32 keeps f32 products: a bf16 product
    would not hold the f32 tolerance)."""
    build.dtype_code(dtype, "q")
    if dtype == torch.bfloat16 and dh in TC_DHS:
        return "tensor_core"
    return "cuda_core"


def flash_prefill_cuda(q, k, v, causal: bool, window: Optional[int],
                       scale: float, body: Optional[str] = None):
    """q (B, Sq, H, dh) not scaled (the kernel multiplies it by `scale`,
    dh**-0.5 rounded to q's dtype, rounding the product to q's dtype), k
    / v (B, Sk, KV, dh), all f32 or all bf16 -> (B, Sq, H, dh) in q's
    dtype, on `flash_body`'s body, or on `body` where a caller measures
    one."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_prefill kernel takes CUDA tensors on one "
                         "device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_prefill kernel takes q, k, v of one dtype")
    if H % KV or v.shape != k.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"bad GQA shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    code = build.dtype_code(q.dtype, "q")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if body is None:
        body = flash_body(q.dtype, dh)
    elif body not in BODY_COUNTER:
        raise ValueError(f"unknown body {body!r}")
    elif body == "tensor_core" and flash_body(q.dtype, dh) != body:
        raise ValueError(f"the tensor-core body takes bf16 with dh in "
                         f"{sorted(TC_DHS)}; got {q.dtype}, dh {dh}")
    if body == "tensor_core" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the tensor-core prefill body reads 16-byte "
                         "aligned q, k, v")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.library("vp_attention")
    with torch.cuda.device(q.device):
        err = lib.flash_prefill_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, KV, dh, int(causal), int(window or 0), code,
            _BODY_CODE[body], scale, torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "flash_prefill")
    build.LAUNCHES["flash_prefill"] += 1
    build.LAUNCHES[BODY_COUNTER[body]] += 1
    return out
