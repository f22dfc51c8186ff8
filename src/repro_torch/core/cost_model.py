"""Gate-level area/power model for the paper's VLSI comparisons (copy of
`repro.core.cost_model`: the same float operations in the same order, so
every number is bit for bit the reference's).

The paper reports post-layout 22nm numbers (Fig. 11, Sec. V): B-VP saves ~20%
area and 10-14% power vs B-FXP, B-FXP is ~25% larger than A-FXP, and a
custom-FLP CMAC array is ~3.4x the area of the VP CMAC array.  Silicon
cannot be re-measured here; this module reproduces the comparisons with a
transparent unit-gate model (standard GE accounting: NAND2 = 1 GE).

Only RATIOS between designs are meaningful; the single multiplier constant
is shared by all designs, so ratios are calibration-free.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from .formats import FXPFormat, VPFormat, product_format

# Unit-gate costs (GE), standard cell-library accounting.
FA = 5.0          # full adder
HA = 3.0          # half adder
AND = 1.0
XNOR = 2.0
MUX_BIT = 2.0     # 2:1 mux per bit (AOI-based datapath mux)
FF = 4.5          # flip-flop per bit
INV = 0.5


def adder_area(W: int) -> float:
    """Ripple/compact CLA adder, W bits."""
    return FA * W


def multiplier_area(Wa: int, Wb: int) -> float:
    """Signed (Baugh-Wooley) array multiplier Wa x Wb.

    PP generation Wa*Wb AND gates + reduction tree ~ (Wa*Wb - Wa - Wb) FAs
    + final (Wa+Wb)-bit adder.
    """
    pp = AND * Wa * Wb
    red = FA * max(Wa * Wb - Wa - Wb, 0)
    final = adder_area(Wa + Wb)
    return pp + red + final


def mux_area(W: int, K: int) -> float:
    """K-way W-bit select.

    The converter muxes select among SHIFTED copies of one word, so they
    synthesize as a log2(K)-stage barrel structure (not a flat K-1 mux
    chain); datapath compilers exploit this.
    """
    if K <= 1:
        return 0.0
    return MUX_BIT * W * math.ceil(math.log2(K))


def eq_check_area(bits: int) -> float:
    """All-equal detector over `bits` bits: (bits-1) XNORs + AND tree."""
    if bits <= 1:
        return 0.0
    return XNOR * (bits - 1) + AND * (bits - 2 if bits > 2 else 0)


def lod_area(K: int) -> float:
    """Leading-one detector over K check bits -> log2(K)-bit index."""
    return 3.0 * K


def fxp2vp_area(fxp: FXPFormat, vp: VPFormat) -> float:
    """Fig. 3: K MSB-equality checks + LOD + K-way M-bit significand mux."""
    total = 0.0
    for fk in vp.f:
        s_k = fxp.F - fk
        win = fxp.W - (vp.M + s_k - 1)  # bits [W-1 : M+s_k-1]
        total += eq_check_area(max(win, 0))
    total += lod_area(vp.K)
    total += mux_area(vp.M, vp.K)
    return total


def vp2fxp_area(vp: VPFormat, fxp: FXPFormat) -> float:
    """Fig. 5: shifts are wiring; K-way W-bit mux dominates."""
    return mux_area(fxp.W, vp.K)


def barrel_shifter_area(W: int) -> float:
    return MUX_BIT * W * max(math.ceil(math.log2(max(W, 2))), 1)


def flp_mult_area(Wm: int, We: int) -> float:
    """Custom (non-IEEE, no denormals/NaN) FLP multiplier.

    Beyond the significand multiplier: exponent add + bias, 1-bit
    normalization, and round-to-nearest with guard/sticky (sticky OR-tree
    over Wm low product bits + incrementer + overflow exponent fixup).
    Literature half-precision-class FLP multipliers land near 2.5-3x the
    bare significand multiplier; this composition reproduces that.
    """
    g = 3  # guard/round/sticky datapath widening
    return (
        multiplier_area(Wm, Wm)
        + 2 * adder_area(We)               # exponent add + bias/overflow fixup
        + mux_area(Wm + g, 2)              # 1-bit normalize shift
        + AND * Wm                         # sticky OR tree
        + adder_area(Wm + 1)               # rounding incrementer
        + FF * (Wm + We)                   # 1 GHz pipeline stage
    )


def flp_adder_area(Wm: int, We: int) -> float:
    """Custom FLP adder: the component that makes FLP MACs expensive.

    Swap + alignment barrel + effective-subtract negate + wide (guarded)
    add + leading-zero anticipation + normalization barrel + round + exp
    update, plus a pipeline stage to make timing at 1 GHz.  Unit-gate
    totals reproduce published ~1.2-1.5 kGE half-precision-class adders.
    """
    g = 3
    Wd = Wm + g
    return (
        adder_area(We)                     # exponent difference
        + mux_area(2 * Wd, 2)              # operand swap
        + barrel_shifter_area(Wd)          # alignment shifter
        + AND * Wm                         # sticky collection
        + XNOR * Wd + adder_area(Wd)       # effective-subtract negate (XOR+cin)
        + adder_area(Wd + 1)               # significand add
        + 6.0 * Wd                         # leading-zero anticipator
        + barrel_shifter_area(Wd)          # normalization shifter
        + adder_area(Wm + 1)               # round incrementer
        + 2 * adder_area(We)               # exponent update / clamp
        + FF * (Wm + We + g)               # 1 GHz pipeline stage
    )


# ---------------------------------------------------------------------------
# Design specs (Table I) and hierarchical areas
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MVMSpec:
    """One equalizer design: U DOTP units x B complex multipliers."""

    name: str
    B: int
    U: int
    # FXP formats of the two operand streams (post-quantization).
    y_fxp: FXPFormat
    w_fxp: FXPFormat
    # VP formats (None => pure-FXP design).
    y_vp: Optional[VPFormat] = None
    w_vp: Optional[VPFormat] = None
    cspade: bool = False

    @property
    def is_vp(self) -> bool:
        return self.y_vp is not None


def _rm_operands(spec: MVMSpec) -> Tuple[int, int]:
    """Real-multiplier operand widths."""
    if spec.is_vp:
        return spec.y_vp.M, spec.w_vp.M
    return spec.y_fxp.W, spec.w_fxp.W


def _product_fxp(spec: MVMSpec) -> FXPFormat:
    """FXP format carried into the adder tree."""
    if spec.is_vp:
        p = product_format(spec.y_vp, spec.w_vp)
        # Integer bits to hold the largest product, fraction = max(f_p).
        frac = max(p.f)
        max_val = (2 ** (p.M - 1)) * 2.0 ** (-min(p.f))
        int_bits = max(1, math.ceil(math.log2(max_val + 1)))
        return FXPFormat(int_bits + frac + 1, frac)
    return FXPFormat(spec.y_fxp.W + spec.w_fxp.W,
                     spec.y_fxp.F + spec.w_fxp.F)


def cm_area(spec: MVMSpec) -> Dict[str, float]:
    """Complex multiplier (Fig. 10): 4 RMs + 2 adders (+ VP2FXP, CSPADE)."""
    wa, wb = _rm_operands(spec)
    prod = _product_fxp(spec)
    rm = 4 * multiplier_area(wa, wb)
    add = 2 * adder_area(prod.W + 1)
    conv = 4 * vp2fxp_area(product_format(spec.y_vp, spec.w_vp), prod) if spec.is_vp else 0.0
    cspade = 0.0
    if spec.cspade:
        # Threshold comparators on |re|+|im| of both operands + muting gates.
        cspade = 2 * adder_area(max(spec.y_fxp.W, spec.w_fxp.W)) + 4 * AND * (wa + wb)
    return {"rm": rm, "cm_add": add, "conv": conv, "cspade": cspade}


def dotp_area(spec: MVMSpec) -> Dict[str, float]:
    """One dot-product unit: B CMs + pipelined complex adder tree."""
    acc = _product_fxp(spec).W + math.ceil(math.log2(spec.B))
    parts = {k: spec.B * v for k, v in cm_area(spec).items()}
    # (B-1) complex adders = 2(B-1) real adders + pipeline FFs every 2 levels.
    parts["tree_add"] = 2 * (spec.B - 1) * adder_area(acc)
    levels = math.ceil(math.log2(spec.B))
    parts["pipe_ff"] = 2 * acc * spec.B * FF * (levels // 2) / 2
    # Weight-register file: B complex weights per DOTP.
    parts["w_reg"] = 2 * spec.B * spec.w_fxp.W * FF
    return parts


def mvm_area(spec: MVMSpec) -> Dict[str, float]:
    """Full MVM engine: U DOTPs + input FXP2VP converters (VP design)."""
    parts = {k: spec.U * v for k, v in dotp_area(spec).items()}
    if spec.is_vp:
        # One FXP2VP pair (y-path + W-path) per real/imag input port (Fig 9c).
        per_port = fxp2vp_area(spec.y_fxp, spec.y_vp) + fxp2vp_area(spec.w_fxp, spec.w_vp)
        parts["conv"] = parts.get("conv", 0.0) + 2 * spec.B * per_port
    return parts


def total(parts: Dict[str, float]) -> float:
    return sum(parts.values())


# ---------------------------------------------------------------------------
# Power: P ~ area x activity, with CSPADE muting on the multipliers
# ---------------------------------------------------------------------------

# Relative switching-activity priors per component class.  Multiplier
# glitching is high per active cycle, but registers/clock switch every
# cycle; these priors are shared by ALL designs (ratios calibration-free).
ACTIVITY = {
    "rm": 0.55,
    "cm_add": 0.55,
    "conv": 0.45,
    "cspade": 0.9,
    "tree_add": 0.6,
    "pipe_ff": 1.0,
    "w_reg": 0.12,     # weights reload only once per coherence block
}


def mvm_power(spec: MVMSpec, muting_rate: float = 0.0,
              power_savings: bool = True) -> Dict[str, float]:
    """Relative dynamic power per component.

    `muting_rate`: fraction of partial products muted by CSPADE (measured
    from channel stimuli); only multipliers (and their product adders/
    converters) see the activity reduction, matching Sec. V-A.
    """
    parts = mvm_area(spec)
    out = {}
    for k, a in parts.items():
        act = ACTIVITY.get(k, 0.5)
        if k in ("rm", "cm_add", "conv") and spec.cspade and power_savings:
            act *= (1.0 - muting_rate)
        out[k] = a * act
    # Clock-tree/network power: switches every cycle regardless of data
    # activity, proportional to the sequential area it drives.
    out["clock"] = 0.6 * (parts.get("pipe_ff", 0.0) + parts.get("w_reg", 0.0))
    return out


# ---------------------------------------------------------------------------
# Sec. V-B: CMAC array, VP vs custom FLP
# ---------------------------------------------------------------------------

def vp_cmac_array_area(spec: MVMSpec) -> float:
    """U CSPADE CMACs: 1 CM + complex accumulator each (+ input converters)."""
    acc = _product_fxp(spec).W + math.ceil(math.log2(spec.B))
    cm = total(cm_area(spec))
    per_cmac = cm + 2 * adder_area(acc) + 2 * acc * FF
    conv_in = 2 * (fxp2vp_area(spec.y_fxp, spec.y_vp)
                   + fxp2vp_area(spec.w_fxp, spec.w_vp)) if spec.is_vp else 0.0
    return spec.U * per_cmac + conv_in


def flp_cmac_array_area(U: int, Wm: int = 10, We: int = 4) -> float:
    """Custom FLP(1 sign + 9-bit mantissa + 4-bit exp) CMAC array (Sec. V-B).

    Wm includes the sign+mantissa significand datapath width (1+9).
    Complex MAC: 4 FLP mults + 2 FLP adds (cross terms) + 2 FLP accumulators.
    """
    cm = 4 * flp_mult_area(Wm, We) + 2 * flp_adder_area(Wm + 1, We)
    acc = 2 * flp_adder_area(Wm + 3, We) + 2 * (Wm + We) * FF
    return U * (cm + acc)


# ---------------------------------------------------------------------------
# The paper's three designs (Table I)
# ---------------------------------------------------------------------------

def paper_designs(B: int = 64, U: int = 8) -> Dict[str, MVMSpec]:
    return {
        "A-FXP": MVMSpec(
            "A-FXP", B, U,
            y_fxp=FXPFormat(7, 1), w_fxp=FXPFormat(11, 10), cspade=False),
        "B-FXP": MVMSpec(
            "B-FXP", B, U,
            y_fxp=FXPFormat(9, 1), w_fxp=FXPFormat(12, 11), cspade=True),
        "B-VP": MVMSpec(
            "B-VP", B, U,
            y_fxp=FXPFormat(9, 1), w_fxp=FXPFormat(12, 11),
            y_vp=VPFormat(7, (1, -1)), w_vp=VPFormat(7, (11, 9, 7, 6)),
            cspade=True),
    }
