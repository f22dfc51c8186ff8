"""Wrapper of the block-VP quantizer kernels (csrc/vp_block_quant.cu).

Replaces what the JAX package leaves to XLA (no Pallas kernel):
`repro/core/quantize.py:164 block_vp_quantize` of x / `_pow2_scale(x)`
(`repro/models/layers.py:223-224`, and `:85-86` at a weight's export).
The plain version is `ref.block_vp_quant_ref`; dispatch lives in
`ops.block_vp_quant`.

`plan_amax` alone decides, before the launch, whether the quantize
pass's CUDA blocks each take the amax of the whole tensor themselves,
in one launch (at most FUSED_MAX elements: decode activations), or an
amax pass runs first (two launches).
`build.LAUNCHES` counts every call under `vp_block_quant` and the amax
pass under `vp_block_amax`.  The amax pass finds its last block by a
counter, one per device, that the kernel leaves at zero: two amax
passes must not run at once on one device (the path runs on one
stream).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.core.formats import FXPFormat, VPFormat
from . import build

FUSED_MAX = 16384      # elements quantized in one launch
AMAX_BLOCKS = 1024     # most CUDA blocks of the amax pass
AMAX_PER_BLOCK = 2048  # elements per CUDA block of the amax pass

_COUNTERS: Dict[int, torch.Tensor] = {}


def plan_amax(n: int) -> int:
    """CUDA blocks of the amax pass for a tensor of n elements: 0 where
    the quantize pass takes the amax itself."""
    if n <= FUSED_MAX:
        return 0
    return min(AMAX_BLOCKS, -(-n // AMAX_PER_BLOCK))


def _counter(device: torch.device) -> torch.Tensor:
    c = _COUNTERS.get(device.index)
    if c is None:
        c = _COUNTERS[device.index] = torch.zeros(1, dtype=torch.int32,
                                                  device=device)
    return c


def block_vp_quant_cuda(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat,
                        block: int, axis: int, bf16_math: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (R, C) f32 or bf16 on the card -> (m (R, C) int8, i uint8 with
    `axis` reduced by `block`, s 0-d f32): x / s block-VP quantized, s
    the pow2 scale; `bf16_math` (a bf16 x) rounds s and x / s to bf16."""
    if not x.is_cuda or x.ndim != 2:
        raise ValueError(f"vp_block_quant kernel takes a 2-D CUDA tensor, "
                         f"got {tuple(x.shape)} on {x.device}")
    xc = build.dtype_code(x.dtype, "x")
    if bf16_math and x.dtype != torch.bfloat16:
        raise ValueError("bf16 math takes a bf16 x")
    if vp.raw_min < -128 or vp.raw_max > 127:
        raise ValueError(f"{vp}: the kernel stores int8 significands")
    axis = axis % 2
    R, C = x.shape
    if (R, C)[axis] % block:
        raise ValueError(f"axis size {(R, C)[axis]} not divisible by block "
                         f"{block}")
    x = x.contiguous()
    dev = x.device
    m = torch.empty((R, C), dtype=torch.int8, device=dev)
    i = torch.empty((R // block, C) if axis == 0 else (R, C // block),
                    dtype=torch.uint8, device=dev)
    s = torch.empty((), dtype=torch.float32, device=dev)
    if x.numel() == 0:
        return m, i, s.fill_(1.0)
    blocks = plan_amax(x.numel())
    part = torch.empty(max(blocks, 1), dtype=torch.float32, device=dev)
    lib = build.library("vp_block_quant")
    q = build.quant_fmt_struct(fxp, vp)
    with torch.cuda.device(dev):
        err = lib.vp_block_quant_launch(
            x.data_ptr(), m.data_ptr(), i.data_ptr(), s.data_ptr(),
            part.data_ptr(), _counter(dev).data_ptr(), R, C, block,
            int(axis == 0), xc, int(bf16_math), blocks, ctypes.byref(q),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "vp_block_quant")
    build.LAUNCHES["vp_block_quant"] += 1
    if blocks:
        build.LAUNCHES["vp_block_amax"] += 1
    return m, i, s
