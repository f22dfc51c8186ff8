"""Wrappers of the quantize kernels (csrc/vp_quant.cu).

Replace `repro/kernels/vp_quant.py:vp_quant_packed_pallas` and
`vp_quant_pallas`.  The plain versions are `ref.vp_quant_packed_ref`,
`ref.vp_quant_scaled_ref` and `ref.vp_quant_ref`; dispatch lives in
`ops.vp_quant` and `ops.vp_quant_scaled`.

The packed and the planes kernels each have two bodies, picked by
`packed_body` from the format alone: the table body, which takes the
Fig. 3 cascade's exponent index in O(1) from `index_table`, for every
format whose index is a function of the raw value's bit length
(`table_ok`: every format a path of the repo uses), and the select chain
for the rest.  `plan_packed` sizes both kernels' grid from the element
count; `plan_kv` the KV mode's (one warp per row).  `build.LAUNCHES`
counts every packed launch under `vp_quant_packed` and each body under
`BODY_COUNTER`, every planes launch under `vp_quant_planes` and each
body under `PLANES_COUNTER`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.formats import FXPFormat, VPFormat
from repro_torch.core.packing import storage_dtype
from repro_torch.core.vp_tensor import significand_dtype
from . import build

IDX_TAB = build.VP_IDX_TAB   # bit lengths 0..32
PACKED_VEC = 8               # elements of one thread step
PACKED_THREADS = 256         # threads of a block of the packed bodies...
PACKED_SMALL_THREADS = 64    # ... and below one full wave of them
KV_THREADS = 256             # the KV mode: 8 rows (warps) a block
SMS = 132                    # the H100 SXM's SMs: the grid's yardstick

BODY_COUNTER = {"table": "vp_qp_table", "chain": "vp_qp_chain",
                "kv": "vp_qp_kv"}
PLANES_COUNTER = {"table": "vp_qpl_table", "chain": "vp_qpl_chain"}
PLANES_CODES = {"table": 0, "chain": 1}   # csrc/vp_quant.cu (2: first design)


def _shifts(fxp: FXPFormat, vp: VPFormat):
    return [fxp.F - f for f in vp.f]


def table_ok(fxp: FXPFormat, vp: VPFormat) -> bool:
    """Whether the cascade's index is a function of the bit length of
    raw ^ (raw >> 31): every shift s_k = F - f_k is a right shift, or a
    left shift with -(M - 1) <= s_k that cannot wrap int32 (W - 1 - s_k
    <= 31)."""
    return all(s >= 0 or (s >= -(vp.M - 1) and fxp.W - 1 - s <= 31)
               for s in _shifts(fxp, vp))


def index_table(fxp: FXPFormat, vp: VPFormat) -> Tuple[int, ...]:
    """tab[L], L = 0..32: the exponent index the Fig. 3 cascade gives
    every raw FXP integer whose bit length bitlen(raw ^ (raw >> 31)) is L
    (`core.convert.fxp2vp`'s i).

    The cascade takes the first option k whose shifted value raw >> s_k
    fits M signed bits, else the last.  A right shift is a floor, so
    option k fits iff -2^(M-1+s_k) <= raw < 2^(M-1+s_k), that is iff
    L <= M - 1 + s_k; so does a left shift that cannot wrap, where
    s_k >= -(M - 1).  Raises ValueError for a format outside those
    conditions (`table_ok`), which keeps the select chain.
    """
    if not table_ok(fxp, vp):
        raise ValueError(f"{vp} on {fxp}: a shift of {_shifts(fxp, vp)} "
                         "makes the index depend on more than the bit "
                         "length (left shift past -(M - 1) or into int32's "
                         "sign); use the select chain")
    shifts = _shifts(fxp, vp)
    return tuple(next((k for k, s in enumerate(shifts) if L <= vp.M - 1 + s),
                      vp.K - 1) for L in range(IDX_TAB))


def packed_body(fxp: FXPFormat, vp: VPFormat) -> str:
    """The packed and planes kernels' body for a format: "table" or
    "chain"."""
    return "table" if table_ok(fxp, vp) else "chain"


def plan_packed(n: int, sms: int = SMS) -> Tuple[int, int]:
    """(blocks, threads) of the packed and planes bodies for n elements:
    grid-stride steps of 8 elements per thread (n // 8 of them, then a
    tail of n % 8 elements), in 256-thread blocks (thousands of blocks at
    the export and QAT shapes), or 64-thread blocks where fewer than one
    full wave of 256-thread blocks would run (decode and MIMO shapes: one
    wave of small blocks), at most 16 blocks per SM (a grid-stride loop
    takes the rest)."""
    steps = max(1, -(-n // PACKED_VEC))
    threads = (PACKED_THREADS if steps >= sms * PACKED_THREADS
               else PACKED_SMALL_THREADS)
    return min(-(-steps // threads), 16 * sms), threads


def plan_kv(rows: int) -> Tuple[int, int]:
    """(blocks, threads) of the KV mode: one warp per row, up to 8 rows a
    block."""
    threads = min(KV_THREADS, 32 * rows)
    return -(-rows // (threads // 32)), threads


def _check_input(x: torch.Tensor, what: str) -> torch.Tensor:
    if not x.is_cuda or x.dtype != torch.float32:
        raise ValueError(f"{what} kernel takes a CUDA f32 tensor, "
                         f"got {x.dtype} on {x.device}")
    return x.contiguous()


def vp_quant_packed_cuda(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat,
                         body: Optional[str] = None) -> torch.Tensor:
    """f32 CUDA tensor (any shape) -> packed VP words of the same shape.
    `body` forces "table" or "chain" (comparisons only)."""
    x = _check_input(x, "vp_quant_packed")
    w = torch.empty(x.shape, dtype=storage_dtype(vp), device=x.device)
    if x.numel() == 0:
        return w
    body = body or packed_body(fxp, vp)
    if body == "table" and not table_ok(fxp, vp):
        raise ValueError(f"{vp} on {fxp} has no index table")
    blocks, threads = plan_packed(x.numel(), torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    lib = build.library("vp_quant")
    fmt = build.quant_fmt_struct(fxp, vp, x.device)
    with torch.cuda.device(x.device):
        err = lib.vp_quant_packed_launch(
            x.data_ptr(), w.data_ptr(), x.numel(), w.element_size(),
            ctypes.byref(fmt), int(body == "table"), blocks, threads,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "vp_quant_packed")
    build.LAUNCHES["vp_quant_packed"] += 1
    build.LAUNCHES[BODY_COUNTER[body]] += 1
    return w


def vp_quant_scaled_cuda(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat,
                         group_dims: int = 2
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 or bf16 CUDA tensor -> (packed words of x's shape, f32 scales
    of shape x.shape[:-group_dims] + (1,) * group_dims): each group of
    the last `group_dims` dims divided by its pow2 scale, in one launch
    (the KV mode)."""
    if not x.is_cuda or x.ndim < group_dims:
        raise ValueError(f"vp_quant_scaled kernel takes a CUDA tensor of "
                         f"rank >= {group_dims}, got {tuple(x.shape)} on "
                         f"{x.device}")
    xc = build.dtype_code(x.dtype, "x")
    x = x.contiguous()
    lead = x.shape[:x.ndim - group_dims]
    w = torch.empty(x.shape, dtype=storage_dtype(vp), device=x.device)
    s = torch.empty(*lead, *(1,) * group_dims, dtype=torch.float32,
                    device=x.device)
    rows = s.numel()
    g = x.numel() // rows if rows else 0
    if x.numel() == 0:
        return w, s
    if rows >= 2 ** 31 or g >= 2 ** 31:
        raise ValueError(f"vp_quant_scaled: {rows} groups of {g} elements "
                         "exceed the kernel's int32 extents")
    blocks, threads = plan_kv(rows)
    lib = build.library("vp_quant")
    fmt = build.quant_fmt_struct(fxp, vp, x.device)
    with torch.cuda.device(x.device):
        err = lib.vp_quant_packed_kv_launch(
            x.data_ptr(), w.data_ptr(), s.data_ptr(), rows, g, xc,
            w.element_size(), ctypes.byref(fmt), int(table_ok(fxp, vp)),
            blocks, threads, torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "vp_quant_packed (KV mode)")
    build.LAUNCHES["vp_quant_packed"] += 1
    build.LAUNCHES[BODY_COUNTER["kv"]] += 1
    return w, s


def vp_quant_planes_cuda(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 CUDA tensor (any shape) -> (significand plane of
    `significand_dtype(vp.M)`, uint8 index plane), both of x's shape, on
    the body `packed_body` picks."""
    x = _check_input(x, "vp_quant_planes")
    m = torch.empty(x.shape, dtype=significand_dtype(vp.M), device=x.device)
    i = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.numel() == 0:
        return m, i
    body = packed_body(fxp, vp)
    blocks, threads = plan_packed(x.numel(), torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    lib = build.library("vp_quant")
    fmt = build.quant_fmt_struct(fxp, vp, x.device)
    with torch.cuda.device(x.device):
        err = lib.vp_quant_planes_launch(
            x.data_ptr(), m.data_ptr(), m.element_size(), i.data_ptr(),
            x.numel(), ctypes.byref(fmt), PLANES_CODES[body], blocks,
            threads, torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "vp_quant_planes")
    build.LAUNCHES["vp_quant_planes"] += 1
    build.LAUNCHES[PLANES_COUNTER[body]] += 1
    return m, i
