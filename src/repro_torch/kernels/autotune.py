"""Shape-clamped default tiling (port of the heuristic of
`repro.kernels.autotune`).

Only the heuristic is ported; the persisted, measured cache waits for a
later slice.  The heuristic is semantics, not tuning: the CSPADE paths
of `mimo.mvm_engine` build their tile-activity masks on its grid.
"""
from __future__ import annotations

from typing import Tuple

Blocks = Tuple[int, int, int]

_BASE: Blocks = (256, 256, 256)


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def heuristic_blocks(M: int, K: int, N: int, base: Blocks = _BASE) -> Blocks:
    """Each axis: `min(base, next_pow2(dim))`, so a dimension smaller
    than the base block gets one power-of-two tile covering it."""
    return (
        min(base[0], _pow2_at_least(max(M, 1))),
        min(base[1], _pow2_at_least(max(K, 1))),
        min(base[2], _pow2_at_least(max(N, 1))),
    )
