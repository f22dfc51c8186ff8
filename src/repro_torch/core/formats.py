"""Number-format descriptors for FXP and VP numbers (copy of
`repro.core.formats`).

  FXP(W, F): W-bit two's-complement fixed point with F fractional bits.
  VP(M, f):  M-bit two's-complement significand `m` plus an E-bit exponent
             index `i` into the descending exponent list `f`.
             Value: x = m * 2**(-f_i).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FXPFormat:
    """FXP(W, F): W-bit two's complement, F fractional bits."""

    W: int
    F: int

    def __post_init__(self):
        if self.W < 2:
            raise ValueError(f"FXP width must be >= 2, got W={self.W}")

    @property
    def raw_min(self) -> int:
        return -(1 << (self.W - 1))

    @property
    def raw_max(self) -> int:
        return (1 << (self.W - 1)) - 1

    @property
    def scale(self) -> float:
        return 2.0 ** (-self.F)

    @property
    def min(self) -> float:
        return self.raw_min * self.scale

    @property
    def max(self) -> float:
        return self.raw_max * self.scale

    def __repr__(self) -> str:
        return f"FXP({self.W},{self.F})"


@dataclasses.dataclass(frozen=True)
class VPFormat:
    """VP(M, f): M-bit significand + index into exponent list `f`.

    `f` is sorted descending; K = |f| must be a power of two.
    """

    M: int
    f: Tuple[int, ...]

    def __post_init__(self):
        f = tuple(int(v) for v in self.f)
        object.__setattr__(self, "f", f)
        if self.M < 2:
            raise ValueError(f"VP significand must be >= 2 bits, got M={self.M}")
        if len(f) < 1 or (len(f) & (len(f) - 1)) != 0:
            raise ValueError(f"|f| must be a power of two, got {len(f)}")
        if any(f[k] < f[k + 1] for k in range(len(f) - 1)):
            raise ValueError(f"exponent list must be sorted descending, got {f}")

    @property
    def K(self) -> int:
        """Number of exponent options, 2**E."""
        return len(self.f)

    @property
    def E(self) -> int:
        """Exponent-index bitwidth."""
        return int(math.log2(len(self.f)))

    @property
    def raw_min(self) -> int:
        return -(1 << (self.M - 1))

    @property
    def raw_max(self) -> int:
        return (1 << (self.M - 1)) - 1

    @property
    def storage_bits(self) -> int:
        """Bits per element in the packed word layout (`core.packing`):
        M + E information bits rounded up to 8, 16 or 32."""
        bits = self.M + self.E
        for width in (8, 16, 32):
            if bits <= width:
                return width
        raise ValueError(f"M + E = {bits} exceeds the widest packed word")

    def __repr__(self) -> str:
        return f"VP({self.M},{list(self.f)})"


@functools.lru_cache(maxsize=None)
def default_vp_format(fxp: FXPFormat, M: int, E: int) -> VPFormat:
    """Default parameter rule of Sec. II-D.

    Cached: every `qdot` and KV write asks for its format, and the rule's
    repair walk is quadratic in K (3.6 ms a call at E 7).

    max(f) = F and W - F = M - min(f), with the remaining 2^E - 2 entries
    spread as evenly as possible in between.  `round` is Python's
    (half to even), exactly as in the reference.
    """
    K = 1 << E
    top, bot = fxp.F, M - (fxp.W - fxp.F)
    if K == 1:
        return VPFormat(M, (top,))
    step = (top - bot) / (K - 1)
    f = sorted({int(round(top - k * step)) for k in range(K)}, reverse=True)
    # Rounding may collide entries; repair by walking down.
    while len(f) < K:
        for v in range(top, bot - (K - len(f)) - 1, -1):
            if v not in f:
                f.append(v)
                break
        else:
            f.append(f[-1] - 1)
        f = sorted(set(f), reverse=True)
    return VPFormat(M, tuple(f[:K]))


def product_format(a: VPFormat, b: VPFormat) -> VPFormat:
    """Exponent list and significand width of a VP x VP product (Sec.
    II-B): the pairwise sums f_a + f_b in index-concatenation order
    ((i_a << E_b) | i_b), built offline; M records the multiplier's width
    M_a + M_b - 1 (the one product (-2^(Ma-1)) * (-2^(Mb-1)) needs one
    bit more, and `vp_math.vp_mul` keeps it exact in int32).  The list is
    sorted only within each i_a block, and only VP2FXP consumes it, so
    the descending check is bypassed by direct construction, as in the
    reference."""
    fmt = object.__new__(VPFormat)
    object.__setattr__(fmt, "M", a.M + b.M - 1)
    object.__setattr__(fmt, "f", tuple(fa + fb for fa in a.f for fb in b.f))
    return fmt
