"""Monte-Carlo VP parameter selection (port of `repro.core.param_search`;
paper Sec. II-D).

"The optimal parameters are determined for each signal individually using
Monte-Carlo simulations to ensure that the precision loss is negligible for
the target application.  In general, we set max(f) = F ... and min(f) such
that W - F = M - min(f)."

Given samples of a signal (already in, or quantized to, a reference
FXP(W, F) grid), we search:

  * the exponent list `f` for fixed (M, E): endpoints pinned by the Sec. II-D
    rules, interior entries chosen by exhaustive/greedy MSE minimization over
    the samples;
  * the smallest significand width M meeting an NMSE target.

Samples are a numpy array (put on `device`) or a tensor (on its own
device).  Each candidate's error goes through `ops.vp_quant` (planes) and
`ops.vp_dequant`: on the card their CUDA kernels, on the CPU their plain
versions.  The samples are quantized as f32 in a zero-padded (rows, 64)
tile (a zero quantizes to zero) and the error sums run in f64 over the
true count; every VP value is exact in f32, so the reference's
`vp_to_float(..., float64)` (f32 when JAX's x64 is off) gives the same
values.  The sums run in another order than numpy's, so an NMSE agrees
with the reference's to ~1e-15 relative.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import ops
from .formats import FXPFormat, VPFormat

Samples = Union[np.ndarray, torch.Tensor]
TILE = 64   # columns of the quantize / dequantize tile


@dataclasses.dataclass(frozen=True)
class _Prepared:
    """Samples on their device: f64 values (n,) and the f32 tile."""
    x64: torch.Tensor
    tile: torch.Tensor
    den: float


def _prepare(samples: Samples, device) -> _Prepared:
    if isinstance(samples, torch.Tensor):
        x64 = samples.detach().reshape(-1).to(torch.float64)
    else:
        dev = torch.device("cuda" if device is None else device)
        x64 = torch.from_numpy(np.asarray(samples, np.float64).ravel()).to(dev)
    n = x64.numel()
    tile = torch.zeros(max(1, -(-n // TILE)) * TILE, dtype=torch.float32,
                       device=x64.device)
    tile[:n] = x64.to(torch.float32)
    den = float(torch.sum(x64 * x64)) / max(n, 1) + 1e-300
    return _Prepared(x64, tile.reshape(-1, TILE), den)


def _nmse(p: _Prepared, fxp: FXPFormat, vp: VPFormat) -> float:
    m, i = ops.vp_quant(p.tile, fxp, vp)
    xq = ops.vp_dequant(m, i, vp, torch.float32).reshape(-1)[:p.x64.numel()]
    d = xq.to(torch.float64) - p.x64
    return float(torch.sum(d * d)) / max(p.x64.numel(), 1) / p.den


def vp_nmse(samples: Samples, fxp: FXPFormat, vp: VPFormat,
            device=None) -> float:
    """NMSE of representing `samples` in VP(M, f) via the FXP(W,F) grid."""
    return _nmse(_prepare(samples, device), fxp, vp)


def candidate_lists(fxp: FXPFormat, M: int, E: int) -> Sequence[Tuple[int, ...]]:
    """All descending exponent lists with Sec. II-D endpoint rules."""
    K = 1 << E
    top = fxp.F                    # max(f) = F
    bot = M - (fxp.W - fxp.F)      # W - F = M - min(f)
    if bot > top:
        raise ValueError(f"infeasible: M={M} too large for {fxp} (bot {bot} > top {top})")
    if K == 1:
        return [(top,)]
    if K == 2:
        return [(top, bot)]
    interior = list(range(bot + 1, top))
    lists = []
    for combo in itertools.combinations(interior, K - 2):
        lists.append(tuple(sorted((top, bot) + combo, reverse=True)))
    return lists


def search_exponent_list(
    samples: Samples,
    fxp: FXPFormat,
    M: int,
    E: int,
    max_exhaustive: int = 20000,
    seed: int = 0,
    device=None,
) -> Tuple[VPFormat, float]:
    """Best exponent list for fixed (M, E) by MSE over the samples.

    Exhaustive when the candidate count is small; otherwise greedy forward
    selection (add the interior entry that most reduces MSE, K-2 times),
    each partial list padded to a power of two by repeating its last
    entry.  Ties go to the first candidate in order.  Returns (format,
    nmse).
    """
    cands = candidate_lists(fxp, M, E)
    p = _prepare(samples, device)
    if len(cands) <= max_exhaustive:
        best, best_err = None, math.inf
        for f in cands:
            err = _nmse(p, fxp, VPFormat(M, f))
            if err < best_err:
                best, best_err = f, err
        return VPFormat(M, best), best_err
    # Greedy forward selection.
    K = 1 << E
    top, bot = fxp.F, M - (fxp.W - fxp.F)
    chosen = [top, bot]
    pool = [v for v in range(bot + 1, top)]
    while len(chosen) < K:
        best_v, best_err = None, math.inf
        for v in pool:
            f = tuple(sorted(chosen + [v], reverse=True))
            if len(f) & (len(f) - 1):
                f = f + (f[-1],) * (2 ** math.ceil(math.log2(len(f))) - len(f))
                f = tuple(sorted(f, reverse=True))
            err = _nmse(p, fxp, VPFormat(M, f))
            if err < best_err:
                best_v, best_err = v, err
        chosen.append(best_v)
        pool.remove(best_v)
    f = tuple(sorted(chosen, reverse=True))
    return VPFormat(M, f), _nmse(p, fxp, VPFormat(M, f))


def search_min_M(
    samples: Samples,
    fxp: FXPFormat,
    E: int,
    nmse_target: float,
    M_range: Tuple[int, int] = (4, 16),
    device=None,
) -> Optional[Tuple[VPFormat, float]]:
    """Smallest M whose best exponent list meets `nmse_target`."""
    p = samples if isinstance(samples, torch.Tensor) else \
        _prepare(samples, device).x64
    for M in range(M_range[0], M_range[1] + 1):
        try:
            fmt, err = search_exponent_list(p, fxp, M, E)
        except ValueError:
            continue
        if err <= nmse_target:
            return fmt, err
    return None
