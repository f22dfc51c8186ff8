"""CSPADE sparsity-adaptive thresholding (paper Sec. IV-A; port of
`repro.mimo.cspade`).

A partial product is muted when the magnitudes of BOTH operands fall
below predetermined thresholds; beamspace W and y are approximately
sparse, so most partial products qualify.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def muting_mask(w_plane: torch.Tensor, y_plane: torch.Tensor,
                thresh_w: float, thresh_y: float) -> torch.Tensor:
    """Per-partial-product muting of real planes w (..., U, B) and y
    (..., B): bool (..., U, B), True = muted."""
    quiet_w = w_plane.abs() < thresh_w
    quiet_y = (y_plane.abs() < thresh_y)[..., None, :]
    return quiet_w & quiet_y


def muting_rate(w: torch.Tensor, y: torch.Tensor, thresh_w: float,
                thresh_y: float) -> float:
    """Average muting rate over the 4 real multipliers of each complex
    multiplier: (wr,yr), (wr,yi), (wi,yr), (wi,yi)."""
    rates = [muting_mask(wp, yp, thresh_w, thresh_y).float().mean()
             for wp in (w.real, w.imag) for yp in (y.real, y.imag)]
    return float(torch.stack(rates).mean())


def calibrate_thresholds(w: torch.Tensor, y: torch.Tensor,
                         target_rate: float = 0.5, tol: float = 0.02,
                         iters: int = 24) -> Tuple[float, float]:
    """Thresholds as a common quantile of |w| and |y| planes hitting a
    target muting rate (bisection over the quantile; numpy quantiles,
    as in the reference)."""
    def planes(x):
        x = x.detach().cpu()
        return np.abs(np.stack([x.real.numpy(), x.imag.numpy()])).ravel()

    wabs, yabs = planes(w), planes(y)
    lo, hi = 0.0, 1.0
    for _ in range(iters):
        q = 0.5 * (lo + hi)
        tw, ty = float(np.quantile(wabs, q)), float(np.quantile(yabs, q))
        r = muting_rate(w, y, tw, ty)
        if abs(r - target_rate) < tol:
            break
        if r < target_rate:
            lo = q
        else:
            hi = q
    return tw, ty
