"""VP arithmetic (port of `repro.core.vp_math`; paper Sec. II-B).

A VP multiplier is a plain FXP multiplier on the significands; the
product's exponent index is the CONCATENATION of the operand indices, and
the product's exponent list is the pairwise sum f_a + f_b built offline
(`formats.product_format`).  No exponent is added per product: VP2FXP
consumes the concatenated index directly.
"""
from __future__ import annotations

import torch

from .convert import vp2fxp
from .formats import FXPFormat, VPFormat, product_format


def vp_mul(m_a, i_a, a_fmt: VPFormat, m_b, i_b, b_fmt: VPFormat):
    """Elementwise VP x VP -> (m_p, i_p, p_fmt): the significand product
    in int32 (exact for M_a + M_b - 1 <= 31), the concatenated index
    (i_a << E_b) | i_b, and the offline product format."""
    m_p = torch.as_tensor(m_a).to(torch.int32) * \
        torch.as_tensor(m_b).to(torch.int32)
    i_p = (torch.as_tensor(i_a).to(torch.int32) << b_fmt.E) | \
        torch.as_tensor(i_b).to(torch.int32)
    return m_p, i_p, product_format(a_fmt, b_fmt)


def vp_mul_to_fxp(m_a, i_a, a_fmt: VPFormat, m_b, i_b, b_fmt: VPFormat,
                  out_fmt: FXPFormat) -> torch.Tensor:
    """VP x VP -> raw FXP product, as in the paper's SP-CM (Fig. 10): each
    multiplier is followed by a VP2FXP converter, so every addition
    downstream runs in plain FXP."""
    m_p, i_p, p_fmt = vp_mul(m_a, i_a, a_fmt, m_b, i_b, b_fmt)
    return vp2fxp(m_p, i_p, p_fmt, out_fmt)


def product_scale_lut(a_fmt: VPFormat, b_fmt: VPFormat,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The 2^(E_a + E_b) product scales 2^-(f_a[ia] + f_b[ib]), indexed by
    the concatenated exponent index: the only per-product exponent work
    is one lookup in this table."""
    p = product_format(a_fmt, b_fmt)
    return torch.tensor([2.0 ** (-fv) for fv in p.f], dtype=dtype)
