"""FXP -> VP conversion (port of `repro.core.convert.fxp2vp`).

For each exponent option k the FXP raw value is shifted by
s_k = F - f_k; the first k whose shifted value fits in M signed bits
wins (the paper's Fig. 3 leading-one detector).  When no option fits,
the significand saturates at the last (coarsest) option.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from .formats import FXPFormat, VPFormat


def _shift(v: torch.Tensor, s: int) -> torch.Tensor:
    """Arithmetic shift of int32 `v`: right by s >= 0, left by -s."""
    if s >= 0:
        return v >> min(s, 31)
    # Multiply in int64 and wrap to int32, like the reference's int32
    # left shift (a shift by 32 or more gives 0), without shifting a
    # negative value.
    return (v.to(torch.int64) * (1 << min(-s, 32))).to(torch.int32)


def fxp2vp(raw: torch.Tensor, fxp: FXPFormat, vp: VPFormat
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw FXP(W,F) int32 values -> (int32 significand, int32 index)."""
    raw = raw.to(torch.int32)
    lo, hi = vp.raw_min, vp.raw_max
    m_sel = torch.zeros_like(raw)
    i_sel = torch.zeros_like(raw)
    valid_any = torch.zeros(raw.shape, dtype=torch.bool, device=raw.device)
    for k in range(vp.K):
        m_k = _shift(raw, fxp.F - vp.f[k])
        valid_k = (m_k >= lo) & (m_k <= hi)
        take = valid_k & ~valid_any
        m_sel = torch.where(take, m_k, m_sel)
        i_sel = torch.where(take, k, i_sel)
        valid_any = valid_any | valid_k
    m_last = torch.clamp(_shift(raw, fxp.F - vp.f[-1]), lo, hi)
    m = torch.where(valid_any, m_sel, m_last).to(torch.int32)
    i = torch.where(valid_any, i_sel, vp.K - 1).to(torch.int32)
    return m, i


@functools.lru_cache(maxsize=None)
def scale_table(vp: VPFormat, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """2^(-f_k) for every option k of `vp`, made once per dtype and
    device: a CUDA graph can read it, where a copy from the host would
    not capture."""
    return torch.tensor([2.0 ** (-fk) for fk in vp.f], dtype=dtype,
                        device=device)


def vp_to_float(m: torch.Tensor, i: torch.Tensor, vp: VPFormat,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Exact real value of VP numbers: m * 2^(-f_i) (eq. 1)."""
    return m.to(dtype) * scale_table(vp, dtype, m.device)[i.long()]
