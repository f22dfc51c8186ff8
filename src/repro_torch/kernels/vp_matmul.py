"""Wrapper of the VP x VP matmul kernel (csrc/vp_matmul.cu).

Replaces `repro/kernels/vp_matmul.py:vp_matmul_batched_pallas` and, as
its G = 1 launch, `vp_matmul_pallas`.  The plain versions are
`ref.vp_matmul_batched_ref` / `ref.vp_matmul_ref` and their packed
twins; dispatch lives in `ops.vp_matmul` and `ops.vp_matmul_batched`.

Three CUDA bodies (csrc/vp_common.cuh), and a planner picks one from the
shape, the layout and the pointers before the launch: the warp body (one
warp per 32 outputs) for many small products, the tile body (a 64 x 64
output tile per block, 4 x 4 outputs per thread) for large ones
(`mm_body`), and the batch body (a persistent grid, one warp per
product, operands read in 16-byte chunks and converted once in O(1))
for many small products that fit it (`batch_fits`).  `vmm_body` sends
`vp_matmul`'s batched launches there in the layouts its launcher takes
(`BATCH_LAYOUTS`: the MIMO engine's int16 x int8 words and int8 planes)
with 16-byte aligned planes; the fused kernel (`vp_quant_matmul.py`)
has its own loader, and `qmm_body` sends its batched launches there.
All run each output's sum in the same order, so the choice never
changes a bit of the result.  A failed build or launch raises; no body
stands in for another.  `build.LAUNCHES` counts every launch under
`vp_matmul` (or `vp_quant_matmul`) and also under its body's counter,
`vp_mm_warp`, `vp_mm_tile` or `vp_mm_batch`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.formats import VPFormat
from repro_torch.core.packing import storage_dtype
from repro_torch.core.vp_tensor import significand_dtype
from . import build

# The tile body takes launches of at most TILE_MAX_G products: in the
# sweep of both bodies in chip_smoke.py (PERF.md §6) it wins every G = 1
# shape, M = 16 to 2048 by N = 2 to 256, and the warp body wins the
# batched ones (G = 1024 and 8192 of (16, 64) x (64, 2)).
TILE_MAX_G = 1
BODY_CODES = {"warp": 0, "tile": 1, "batch": 2}   # VPMMBody of vp_common.cuh
BODY_COUNTER = {"warp": "vp_mm_warp", "tile": "vp_mm_tile",
                "batch": "vp_mm_batch"}
# The batch body (csrc/vp_common.cuh, VP_MB_*): a product's M x N outputs
# on one warp's lanes, at most BATCH_A elements of A and BATCH_B of B in
# whole 16-byte chunks (at most one chunk of B, plus its index chunk, per
# lane), the converted A rows and B columns ((M + N)(K + 4) floats) in
# one warp's area; and the largest FXP grid the fused kernel's loader
# tabulates by value.
BATCH_OUT = 32
BATCH_A = 1024
BATCH_B = 128
BATCH_WARP_FLOATS = 1280
BATCH_LUT_MAX = 4096
CHUNK_BYTES = 16
F32_CHUNK = CHUNK_BYTES // 4            # the fused kernel's f32 elements
# vp_matmul's operand layouts, (kind, element bytes): packed words or
# (significand, uint8 index) planes.  The batch body's launcher takes an
# A and B pair in these layouts only (csrc/vp_matmul.cu).
BATCH_LAYOUTS = frozenset({(("words", 2), ("words", 1)),
                           (("planes", 1), ("planes", 1))})


def mm_body(G: int, M: int, K: int, N: int) -> str:
    """The body that computes (G, M, K) x (G, K, N): "tile" for one large
    product (G <= TILE_MAX_G), "warp" for many small ones.  M, K and N do
    not enter: the sweep found no G = 1 shape where the warp body wins."""
    del M, K, N
    return "tile" if G <= TILE_MAX_G else "warp"


def batch_fits(M: int, K: int, N: int, a_chunk: int = F32_CHUNK,
               b_chunk: int = F32_CHUNK) -> bool:
    """Whether the batch body takes products of (M, K) x (K, N) whose
    operands come a_chunk / b_chunk elements to a 16-byte chunk: every row
    of A is whole chunks, and so is each product's B."""
    return (M * N <= BATCH_OUT and K % 4 == 0 and K % a_chunk == 0
            and K * N % b_chunk == 0 and M * K <= BATCH_A
            and K * N <= BATCH_B and (M + N) * (K + 4) <= BATCH_WARP_FLOATS)


def qmm_body(G: int, M: int, K: int, N: int, aligned: bool = True,
             tables: bool = True) -> str:
    """The fused kernel's body for (G, M, K) x (G, K, N): "batch" for a
    batched launch (`mm_body` says "warp") whose products fit the batch
    body, with 16-byte aligned operands whose formats it converts in
    O(1) (`tables`: `vp_quant_matmul.batch_converts`); else `mm_body`'s."""
    body = mm_body(G, M, K, N)
    if body == "warp" and aligned and tables and batch_fits(M, K, N):
        return "batch"
    return body


def layout_of(x_m: torch.Tensor, x_i: Optional[torch.Tensor]):
    """An operand's layout: ("words", bytes) or ("planes", bytes)."""
    return ("words" if x_i is None else "planes", x_m.element_size())


def vmm_body(G: int, M: int, K: int, N: int, layout, aligned: bool) -> str:
    """`vp_matmul`'s body for (G, M, K) x (G, K, N) in `layout` (an (A, B)
    pair of `layout_of`): "batch" for a batched launch (`mm_body` says
    "warp") in one of BATCH_LAYOUTS whose products fit the batch body,
    every plane 16-byte aligned (`aligned`); else `mm_body`'s."""
    body = mm_body(G, M, K, N)
    if (body == "warp" and aligned and layout in BATCH_LAYOUTS
            and batch_fits(M, K, N, *(CHUNK_BYTES // nb for _, nb in layout))):
        return "batch"
    return body


def check_body(body: Optional[str]) -> None:
    """Raise unless `body` is None (the planner's) or a body's name."""
    if body is not None and body not in BODY_CODES:
        raise ValueError(f"unknown body {body!r}; one of "
                         f"{sorted(BODY_CODES)}")


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
                   tiles: Tuple[int, int, int] = (0, 0, 0),
                   body: Optional[str] = None) -> torch.Tensor:
    """(G, M, K) x (G, K, N) VP operands on CUDA -> (G, M, N) f32.

    Each operand is planes (m, uint8 i) or packed words (m, None).  With
    CSPADE flags a_act (G, M/bm, K/bk) / b_act (G, K/bk, N/bn), `tiles`
    is their grid (bm, bk, bn); shapes are checked by `ops`.  The body is
    `vmm_body`'s, or `body` where a caller measures one (a launch that
    the body refuses raises).
    """
    check_body(body)
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
    if body is None:
        planes = [p for p in (a_m, a_i, b_m, b_i) if p is not None]
        body = vmm_body(G, M, K, N, (layout_of(a_m, a_i), layout_of(b_m, b_i)),
                        all(p.data_ptr() % CHUNK_BYTES == 0 for p in planes))
    _flags, (pa, pb, bm, bk, bn) = mask_args(a_act, b_act, tiles, dev)
    lib = build.library("vp_matmul")
    fa, fb = build.vp_fmt_struct(a_fmt, dev), build.vp_fmt_struct(b_fmt, dev)
    with torch.cuda.device(dev):
        err = lib.vp_matmul_launch(
            a_m.data_ptr(), None if a_i is None else a_i.data_ptr(),
            a_m.element_size(), ctypes.byref(fa),
            b_m.data_ptr(), None if b_i is None else b_i.data_ptr(),
            b_m.element_size(), ctypes.byref(fb), out.data_ptr(), pa, pb,
            G, M, K, N, bm, bk, bn, BODY_CODES[body],
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, f"vp_matmul ({body} body)")
    build.LAUNCHES["vp_matmul"] += 1
    build.LAUNCHES[BODY_COUNTER[body]] += 1
    return out
