"""Wrapper of the block-VP quantizer kernels (csrc/vp_block_quant.cu).

Replaces what the JAX package leaves to XLA (no Pallas kernel):
`repro/core/quantize.py:164 block_vp_quantize` of x / `_pow2_scale(x)`
(`repro/models/layers.py:223-224`, and `:85-86` at a weight's export).
The plain version is `ref.block_vp_quant_ref`; dispatch lives in
`ops.block_vp_quant`.

`plan` alone picks, from the shape, the block and the axis, one of four
bodies and their grid:
  * "small": axis -1 and at most SMALL_MAX elements (decode activations):
    one launch of one CUDA block up to SMALL_ONE_BLOCK elements, else of
    a thread-block cluster of SMALL_CLUSTER blocks (or fewer where the
    tensor has fewer index blocks);
  * "coop": a tensor whose blocks all fit on the card at once, COOP_PER_SM
    per SM (prefill activations, the layer weights' export): one
    cooperative launch with a grid-wide barrier;
  * "two_pass": the rest (the `lm_head` export): an amax pass, then the
    quantize pass;
  * "general": every block that divides the axis and that the three
    above do not take (`fast_block`: axis -1 blocks that are not a
    multiple of VEC or above THREADS * V * VEC elements, axis 0 blocks
    that are not a multiple of TILE_TY or above TILE_TY * TILE_ROWS
    rows): an amax pass, then a body that reads x twice.
The first three read x once into registers.  `plan` raises only for a
block that does not divide the axis (or a body forced where it cannot
run).

`build.LAUNCHES` counts every call under `vp_block_quant`, each body
under `BODY_COUNTER`, and the amax pass (two-pass and general bodies)
under `vp_block_amax`.  The
coop body's barrier and the amax pass share one pair of words per
device, which each launch leaves as it found them: two of these
launches must not run at once on one device (the path runs on one
stream).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.formats import FXPFormat, VPFormat
from repro_torch.core.vp_tensor import SIGNIFICAND_DTYPES, significand_dtype
from . import build
from .vp_quant import SMS, table_ok

SMALL_MAX = 16384      # elements of the small body
SMALL_THREADS = 1024   # most threads of a small-body block
SMALL_ONE_BLOCK = 4096  # the small body in one block up to this many
SMALL_CLUSTER = 8      # elements, else in a cluster of 8 (PERF.md)
THREADS = 256          # threads of a coop or two-pass block...
V = 8                  # ... each holding up to 8 vectors (axis -1)
VEC = 4                # elements of a vector
TILE_COLS = 64         # axis 0: columns of a tile (block rows each)
TILE_TY = 32           # axis 0: threads down a tile
TILE_ROWS = 8          # axis 0: most rows of a thread
COOP_PER_SM = 2        # coop blocks on one SM (the kernels' launch bounds)
COOP_SPREAD = 2        # coop blocks per SM the planner aims for
AMAX_BLOCKS = 1024     # most CUDA blocks of the amax pass
AMAX_PER_BLOCK = 2048  # elements per CUDA block of the amax pass
GENERAL_SMALL = 64     # general body, axis 0: blocks of at most this many
GENERAL_TY = (8, 32)   # rows take 8 threads down a tile, larger ones 32
GENERAL_PER_SM = 16    # general body, axis -1: most CUDA blocks per SM

BODIES = ("small", "coop", "two_pass", "general")   # launcher codes 0-3
BODY_COUNTER = {"small": "vp_bq_small", "coop": "vp_bq_coop",
                "two_pass": "vp_bq_two_pass", "general": "vp_bq_general"}

_BARRIERS: Dict[int, torch.Tensor] = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of the quantizer: `grid` CUDA blocks of `threads` (the
    small body's grid is one cluster); along the rows `chunk` elements
    (whole index blocks) per CUDA block in `nv` vectors of 4 per thread
    (the general body: neither), along the columns on the general body
    `nv` threads down a tile (`general_tile`); the amax pass's
    `amax_blocks` (two-pass and general bodies, else 0)."""
    body: str
    grid: int
    threads: int
    nv: int = 1
    chunk: int = 0
    amax_blocks: int = 0


def plan_amax(n: int) -> int:
    """CUDA blocks of the amax pass for a tensor of n elements."""
    return min(AMAX_BLOCKS, -(-n // AMAX_PER_BLOCK))


def _rows(block: int, per_cta: int, threads: int):
    """(chunk, nv) for CUDA blocks of `per_cta` index blocks."""
    chunk = per_cta * block
    return chunk, -(-chunk // (VEC * threads))


def fast_block(block: int, axis: int) -> bool:
    """Whether the small, coop and two-pass bodies take this block."""
    if axis % 2 == 0:
        return block % TILE_TY == 0 and block <= TILE_TY * TILE_ROWS
    return block % VEC == 0 and block <= THREADS * V * VEC


def general_tile(block: int) -> Tuple[int, int]:
    """(threads down, columns across) a tile of the general body along
    the columns: 8 columns per thread, all THREADS threads."""
    ty = GENERAL_TY[block > GENERAL_SMALL]
    return ty, THREADS // ty * 8


def _general(R: int, C: int, block: int, axis: int, sms: int) -> Plan:
    """The general body: along the columns one CUDA block per tile of
    `block` rows x `general_tile` columns (its threads down the tile as
    `nv`); along the rows warps whose groups of g lanes take an index
    block each, in a grid-stride loop."""
    n = R * C
    if axis == 0:
        ty, width = general_tile(block)
        return Plan("general", R // block * -(-C // width), THREADS, nv=ty,
                    amax_blocks=plan_amax(n))
    g = min(32, 1 << (block - 1).bit_length())
    per_cta = THREADS // 32 * (32 // g)
    grid = min(-(-(n // block) // per_cta), GENERAL_PER_SM * sms)
    return Plan("general", grid, THREADS, amax_blocks=plan_amax(n))


def plan(R: int, C: int, block: int, axis: int, sms: int = SMS,
         cluster: Optional[int] = None, body: Optional[str] = None) -> Plan:
    """The body and grid for x (R, C) quantized in blocks of `block`
    along `axis`, from shapes alone.  `body` and `cluster` force a body
    where it can run this tensor and the small body's cluster
    (comparisons only).  Raises ValueError for a block that does not
    divide the axis, or a forced body that cannot run the tensor."""
    axis %= 2
    n = R * C
    if block < 1 or (R, C)[axis] % block:
        raise ValueError(f"block {block} does not divide axis {axis} of "
                         f"{(R, C)}")
    if body == "general" or (body is None and not fast_block(block, axis)):
        return _general(R, C, block, axis, sms)
    if not fast_block(block, axis):
        raise ValueError(f"body {body!r} cannot take axis-{axis} block "
                         f"{block}: only the general body does")
    if cluster is None:
        cluster = 1 if n <= SMALL_ONE_BLOCK else SMALL_CLUSTER
    if axis == 0:
        tiles = R // block * -(-C // TILE_COLS)
        pick = body or ("coop" if tiles <= COOP_PER_SM * sms else "two_pass")
        if pick == "small" or (pick == "coop"
                               and tiles > COOP_PER_SM * sms):
            raise ValueError(f"body {pick!r} cannot take {tiles} tiles")
        return Plan(pick, tiles, THREADS,
                    amax_blocks=plan_amax(n) if pick == "two_pass" else 0)
    nb = n // block
    pick = body or ("small" if n <= SMALL_MAX else None)
    if pick == "small":
        if n > SMALL_MAX or not 1 <= cluster <= 8:
            raise ValueError(f"the small body takes at most {SMALL_MAX} "
                             f"elements in a cluster of 1-8 blocks")
        per = -(-nb // cluster)
        grid = -(-nb // per)
        threads = min(SMALL_THREADS, 32 * -(-per * block // (32 * VEC)))
        chunk, nv = _rows(block, per, threads)
        return Plan("small", grid, threads, nv, chunk)
    # Spread the tensor over COOP_SPREAD blocks per SM where it can.
    nv = min(V, max(-(-n // (COOP_SPREAD * sms * THREADS * VEC)),
                    -(-block // (THREADS * VEC))))
    per = max(1, THREADS * nv * VEC // block)
    chunk, nv = _rows(block, per, THREADS)
    grid = -(-nb // per)
    if pick is None:
        pick = "coop" if grid <= COOP_PER_SM * sms else "two_pass"
    if pick == "coop" and grid > COOP_PER_SM * sms:
        raise ValueError(f"body 'coop' cannot take {grid} blocks")
    if pick == "two_pass":
        per = max(1, THREADS * V * VEC // block)
        chunk, nv = _rows(block, per, THREADS)
        return Plan("two_pass", -(-nb // per), THREADS, nv, chunk,
                    amax_blocks=plan_amax(n))
    return Plan("coop", grid, THREADS, nv, chunk)


def significand_planes(vp: VPFormat) -> torch.dtype:
    """The significand plane the kernel writes for `vp`
    (`significand_dtype(vp.M)`); raises for a width it does not store:
    the host-side check of `block_vp_quant_cuda`."""
    mdt = significand_dtype(vp.M)
    if mdt not in SIGNIFICAND_DTYPES:
        raise ValueError(f"{vp}: the kernel stores int8 or int16 "
                         f"significands, not {mdt}")
    return mdt


def _barrier(device: torch.device) -> torch.Tensor:
    """[arrivals, generation] of the device's grid-wide barrier and amax
    pass, zeroed once."""
    c = _BARRIERS.get(device.index)
    if c is None:
        c = _BARRIERS[device.index] = torch.zeros(2, dtype=torch.int32,
                                                  device=device)
    return c


def block_vp_quant_cuda(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat,
                        block: int, axis: int, bf16_math: bool,
                        body: Optional[str] = None,
                        cluster: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (R, C) f32 or bf16 on the card -> (m (R, C) of
    `significand_dtype(vp.M)` (int8, or int16 for M 9-16), i uint8 with
    `axis` reduced by `block`, s 0-d f32): x / s block-VP quantized, s
    the pow2 scale; `bf16_math` (a bf16 x) rounds s and x / s to bf16.
    `body` and `cluster` force a body and the small body's cluster
    (comparisons only)."""
    if not x.is_cuda or x.ndim != 2:
        raise ValueError(f"vp_block_quant kernel takes a 2-D CUDA tensor, "
                         f"got {tuple(x.shape)} on {x.device}")
    xc = build.dtype_code(x.dtype, "x")
    if bf16_math and x.dtype != torch.bfloat16:
        raise ValueError("bf16 math takes a bf16 x")
    mdt = significand_planes(vp)
    axis = axis % 2
    R, C = x.shape
    if block < 1 or (R, C)[axis] % block:
        raise ValueError(f"axis size {(R, C)[axis]} not divisible by block "
                         f"{block}")
    x = x.contiguous()
    dev = x.device
    m = torch.empty((R, C), dtype=mdt, device=dev)
    i = torch.empty((R // block, C) if axis == 0 else (R, C // block),
                    dtype=torch.uint8, device=dev)
    s = torch.empty((), dtype=torch.float32, device=dev)
    if x.numel() == 0:
        return m, i, s.fill_(1.0)
    pl = plan(R, C, block, axis,
              torch.cuda.get_device_properties(dev).multi_processor_count,
              cluster, body)
    part = torch.empty(max(pl.grid, pl.amax_blocks), dtype=torch.float32,
                       device=dev)
    lib = build.library("vp_block_quant")
    q = build.quant_fmt_struct(fxp, vp, dev)
    with torch.cuda.device(dev):
        err = lib.vp_block_quant_launch(
            x.data_ptr(), m.data_ptr(), i.data_ptr(), s.data_ptr(),
            part.data_ptr(), _barrier(dev).data_ptr(), R, C, block,
            int(axis == 0), xc, int(bf16_math),
            BODIES.index(pl.body),
            pl.grid, pl.threads, pl.nv, pl.chunk, pl.amax_blocks,
            int(table_ok(fxp, vp)), m.element_size(), ctypes.byref(q),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "vp_block_quant")
    build.LAUNCHES["vp_block_quant"] += 1
    build.LAUNCHES[BODY_COUNTER[pl.body]] += 1
    if pl.amax_blocks:
        build.LAUNCHES["vp_block_amax"] += 1
    return m, i, s


def block_amax_cuda(x: torch.Tensor, bf16_math: bool) -> torch.Tensor:
    """The two-pass body's amax pass alone on x (R, C): its scale as a
    0-d f32 (chip_smoke.py times it; not counted, not on a path)."""
    x = x.contiguous()
    s = torch.empty((), dtype=torch.float32, device=x.device)
    blocks = plan_amax(x.numel())
    part = torch.empty(blocks, dtype=torch.float32, device=x.device)
    lib = build.library("vp_block_quant")
    with torch.cuda.device(x.device):
        err = lib.vp_block_amax_launch(
            x.data_ptr(), s.data_ptr(), part.data_ptr(),
            _barrier(x.device).data_ptr(), x.shape[0], x.shape[1],
            build.dtype_code(x.dtype, "x"), int(bf16_math), blocks,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "vp_block_amax")
    return s
