"""Fail-fast kernel contracts at op entry (port of the checks of
`repro.analysis.contracts` that the quantize ops, `ops.block_vp_matmul`
and `ops.vp_dequant` run).

A CUDA int32 accumulator or the quantize cascade's int32 shift wraps
silently, and a dequant scale outside the f32 normal range degrades
silently, so these raise `VPContractError`
with the analyzer's explanation where the reference raises, on every
device.  Each check is cached on its hashable arguments.
"""
from __future__ import annotations

import functools
from typing import Union

from repro_torch.core.formats import FXPFormat, VPFormat
from . import bitwidth

Format = Union[FXPFormat, VPFormat]


class VPContractError(ValueError):
    """A statically provable violation of a kernel's contract."""


@functools.lru_cache(maxsize=None)
def require_format_serviceable(fmt: Format, what: str = "kernel op") -> bool:
    """Packed fields fit the storage word and every 2^-f_i scale is an
    f32 normal (any op that dequantizes `fmt`)."""
    if isinstance(fmt, VPFormat):
        problems = (bitwidth.check_pack_fields(fmt)
                    + bitwidth.check_scale_exponents(fmt))
        if problems:
            raise VPContractError(f"static contract violation in {what}:\n  "
                                  + "\n  ".join(problems))
    return True


@functools.lru_cache(maxsize=None)
def require_quant_safe(fxp: FXPFormat, vp: VPFormat,
                       what: str = "vp_quant") -> bool:
    """No int32 shift wraparound inside the Fig. 3 cascade's range tests,
    and the dequant-side contract of `vp` (quantize ops emit words or
    planes that something will dequantize)."""
    require_format_serviceable(vp, what)
    problems = bitwidth.check_quantize_shifts(fxp, vp)
    if problems:
        raise VPContractError(f"static contract violation in {what}:\n  "
                              + "\n  ".join(problems))
    return True


@functools.lru_cache(maxsize=None)
def require_int_accum_safe(a: Format, b: Format, depth: int,
                           what: str = "block_vp_matmul") -> bool:
    """A `depth`-term raw-significand dot product cannot wrap the integer
    accumulator.  For the block-VP kernel `depth` is the k-tile: each
    tile's int32 sum is rescaled to f32 before the next tile."""
    proof = bitwidth.analyze_matmul(a, b, depth)
    if proof.wraps:
        raise VPContractError(
            f"static contract violation in {what}:\n{proof.explain()}")
    return True

