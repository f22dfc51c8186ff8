"""Packed VP words (port of `repro.core.packing`).

Word layout: ``w = (m << E) | i`` in two's complement, one int8 word when
M + E <= 8, int16 up to 16, else int32.  Unpacking is ``m = w >> E``
(arithmetic) and ``i = w & (K - 1)``.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .formats import VPFormat

# Widest format served by the whole-word dequant table (4096 entries).
WORD_LUT_MAX_BITS = 12


def storage_dtype(fmt: VPFormat) -> torch.dtype:
    """The packed-word dtype for a format: int8 / int16 / int32."""
    return {8: torch.int8, 16: torch.int16, 32: torch.int32}[
        fmt.storage_bits]


def pack_vp(m: torch.Tensor, i: torch.Tensor, fmt: VPFormat) -> torch.Tensor:
    """(significand, index) -> packed words in `storage_dtype(fmt)`.

    The low E bits of ``m << E`` are zero, so ``m * 2^E + i`` is the same
    word without shifting a negative value.
    """
    w = m.to(torch.int32) * (1 << fmt.E) + i.to(torch.int32)
    return w.to(storage_dtype(fmt))


def unpack_vp(w: torch.Tensor, fmt: VPFormat
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed words -> (int32 significand, int32 index)."""
    wi = w.to(torch.int32)
    return wi >> fmt.E, wi & (fmt.K - 1)


@functools.lru_cache(maxsize=None)
def _dequant_lut_np(fmt: VPFormat) -> np.ndarray:
    """Offline table: packed-word low bits -> real value, 2^(M+E) entries.

    Every entry m * 2^-f_i is exact in f32, so the table dequant equals
    the shift/mask/scale path bit for bit.
    """
    bits = fmt.M + fmt.E
    if bits > WORD_LUT_MAX_BITS:
        raise ValueError(f"{fmt} is too wide for the word table")
    idx = np.arange(1 << bits)
    m = (idx >> fmt.E).astype(np.int64)
    m = np.where(m >= (1 << (fmt.M - 1)), m - (1 << fmt.M), m)
    i = idx & (fmt.K - 1)
    return (m * (2.0 ** (-np.asarray(fmt.f, np.float64))[i])).astype(
        np.float32)


def dequant_words(w: torch.Tensor, fmt: VPFormat,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Packed words -> real values: one table gather for formats up to
    12 information bits in f32, else unpack and scale (both exact)."""
    bits = fmt.M + fmt.E
    if bits <= WORD_LUT_MAX_BITS and dtype == torch.float32:
        lut = torch.as_tensor(_dequant_lut_np(fmt), device=w.device)
        u = w.to(torch.int32) & ((1 << bits) - 1)
        return lut[u.long()]
    m, i = unpack_vp(w, fmt)
    scales = torch.tensor([2.0 ** (-fk) for fk in fmt.f], dtype=dtype,
                          device=w.device)
    return m.to(dtype) * scales[i.long()]
