"""Bitwidth and overflow proofs over VP and FXP formats (port of the
parts of `repro.analysis.bitwidth` that the op contracts use).

Every quantized element is an integer significand in a known interval
times a power-of-two scale, so the growth of a K-deep dot product of
significands is provable from the formats alone:

  * one product m_a * m_b lies in the product of the two significand
    intervals (M_a + M_b signed bits: min * min needs the last one);
  * K products sum to at most K times that magnitude;
  * the int32 accumulator of the block-VP path wraps once that sum
    exceeds 2^31 - 1.
"""
from __future__ import annotations

import dataclasses
from typing import List, Union

from repro_torch.core.formats import FXPFormat, VPFormat

Format = Union[FXPFormat, VPFormat]

INT32_MAX = (1 << 31) - 1
# f32 biased exponents of normals lie in [1, 254].
F32_MIN_BIASED_EXP = 1
F32_MAX_BIASED_EXP = 254


@dataclasses.dataclass(frozen=True)
class Interval:
    """Closed integer interval [lo, hi]."""

    lo: int
    hi: int

    @property
    def mag(self) -> int:
        return max(abs(self.lo), abs(self.hi))

    @property
    def signed_bits(self) -> int:
        """Bits of the smallest two's-complement type holding [lo, hi]."""
        b = 1
        while self.lo < -(1 << (b - 1)) or self.hi > (1 << (b - 1)) - 1:
            b += 1
        return b

    def mul(self, other: "Interval") -> "Interval":
        c = (self.lo * other.lo, self.lo * other.hi,
             self.hi * other.lo, self.hi * other.hi)
        return Interval(min(c), max(c))

    def scale(self, k: int) -> "Interval":
        """Interval of a k-term sum of values from this interval."""
        if k < 0:
            raise ValueError(f"negative accumulation depth K={k}")
        return Interval(self.lo * k, self.hi * k)

    def __repr__(self) -> str:
        return f"[{self.lo}, {self.hi}]"


def significand_interval(fmt: Format) -> Interval:
    return Interval(fmt.raw_min, fmt.raw_max)


def product_interval(a: Format, b: Format) -> Interval:
    """Interval of one raw significand product m_a * m_b."""
    return significand_interval(a).mul(significand_interval(b))


def max_safe_k(a: Format, b: Format) -> int:
    """Largest depth K whose raw significand sum cannot wrap an int32
    accumulator.  0: not even one product is safe."""
    return INT32_MAX // product_interval(a, b).mag


@dataclasses.dataclass(frozen=True)
class MatmulProof:
    """The int32 certificate for one (format pair, depth)."""

    a: Format
    b: Format
    K: int
    sum_interval: Interval
    max_safe_k: int
    wraps: bool        # K > max_safe_k

    def explain(self) -> str:
        head = (f"{self.a!r} x {self.b!r} @ K={self.K} into int32: "
                f"{'UNSAFE' if self.wraps else 'SAFE'}")
        lines = [head,
                 f"  - raw significand sum over K={self.K} in "
                 f"{self.sum_interval} ({self.sum_interval.signed_bits} bits)",
                 f"  - horizon: K <= {self.max_safe_k}"]
        if self.wraps:
            lines.append(f"  - K={self.K} OVERFLOWS int32: "
                         "two's-complement wraparound, silently wrong results")
        return "\n".join(lines)


def analyze_matmul(a: Format, b: Format, K: int) -> MatmulProof:
    """Prove or refute that a K-deep dot product of a x b significands
    cannot wrap an int32 accumulator."""
    k_max = max_safe_k(a, b)
    return MatmulProof(a=a, b=b, K=K,
                       sum_interval=product_interval(a, b).scale(K),
                       max_safe_k=k_max, wraps=K > k_max)


def check_pack_fields(fmt: VPFormat) -> List[str]:
    """Violations of the packed-word layout (empty: it cannot truncate)."""
    try:
        storage = fmt.storage_bits
    except ValueError as e:
        return [f"{fmt!r}: {e}"]
    problems = []
    if fmt.M + fmt.E > storage:
        problems.append(f"{fmt!r}: M + E = {fmt.M + fmt.E} bits exceed the "
                        f"{storage}-bit packed word")
    if fmt.K > (1 << fmt.E):
        problems.append(f"{fmt!r}: {fmt.K} exponent options exceed the "
                        f"E={fmt.E}-bit index field")
    return problems


def check_scale_exponents(fmt: VPFormat) -> List[str]:
    """Violations of "every scale 2^-f_i is an f32 normal" (empty: safe)."""
    problems = []
    for fv in fmt.f:
        biased = 127 - fv
        if not F32_MIN_BIASED_EXP <= biased <= F32_MAX_BIASED_EXP:
            problems.append(
                f"{fmt!r}: scale 2^-{fv} has biased f32 exponent "
                f"{biased}, outside the normal range "
                f"[{F32_MIN_BIASED_EXP}, {F32_MAX_BIASED_EXP}] — the "
                f"dequant scale degenerates to "
                f"{'zero/denormal' if biased < 1 else 'inf'}")
    return problems


def check_quantize_shifts(fxp: FXPFormat, vp: VPFormat) -> List[str]:
    """Violations of "the Fig. 3 cascade's shifts cannot wrap int32"
    (empty: safe).

    For exponent option k the cascade computes m_k = raw << (f_k - F)
    when f_k > F; raw carries up to W signed bits, so the shifted value
    needs W + f_k - F bits, and an int32 left shift wraps beyond 32: the
    range test then sees a wrapped value and can select a corrupt
    (m, i).
    """
    problems: List[str] = []
    raw_bits = significand_interval(fxp).signed_bits
    for fv in vp.f:
        s = fxp.F - fv
        if s < 0 and raw_bits + (-s) > 32:
            problems.append(
                f"{fxp!r} -> {vp!r}: option f={fv} left-shifts the "
                f"{raw_bits}-bit raw value by {-s} bits "
                f"({raw_bits - s} > 32) — int32 shift wraparound inside "
                f"the quantize cascade's range test")
    return problems
