"""The three MVM equalizer designs (paper Sec. IV, Table I; port of
`repro.mimo.equalizer`).

  A-FXP: antenna domain, FXP operands  ybar:(7,1)   Wbar:(11,10)
  B-FXP: beamspace,      FXP operands  y:(9,1)      W:(12,11)
  B-VP:  beamspace,      VP operands   y:VP(7,[1,-1]) W:VP(7,[11,9,7,6])

Signals are mapped onto the hardware formats by a static AGC gain per
stream (calibrated once over an ensemble), then quantized re/im
separately.  Quantization is the only error source: `equalize_quantized`
is the fake-quant model of the designs, `mvm_engine` the kernel path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.formats import FXPFormat, VPFormat
from repro_torch.core.fxp import fxp_quantize_value
from repro_torch.core.quantize import vp_fake_quant


@dataclasses.dataclass(frozen=True)
class EqualizerSpec:
    name: str
    beamspace: bool
    y_fxp: FXPFormat
    w_fxp: FXPFormat
    y_vp: Optional[VPFormat] = None
    w_vp: Optional[VPFormat] = None
    # Static AGC gains (set by `calibrate`).
    y_gain: float = 1.0
    w_gain: float = 1.0

    @property
    def is_vp(self) -> bool:
        return self.y_vp is not None


def table1_specs() -> Tuple[EqualizerSpec, EqualizerSpec, EqualizerSpec]:
    return (
        EqualizerSpec("A-FXP", False, FXPFormat(7, 1), FXPFormat(11, 10)),
        EqualizerSpec("B-FXP", True, FXPFormat(9, 1), FXPFormat(12, 11)),
        EqualizerSpec("B-VP", True, FXPFormat(9, 1), FXPFormat(12, 11),
                      VPFormat(7, (1, -1)), VPFormat(7, (11, 9, 7, 6))),
    )


def abs_max(x: torch.Tensor) -> float:
    """Largest |re| or |im| of a complex tensor, as a Python float."""
    return max(float(x.real.abs().max()), float(x.imag.abs().max()))


def f32(v: float, device=None) -> torch.Tensor:
    """A gain as an f32 scalar tensor.  The reference multiplies its f32
    planes by gains cast to f32; multiplying by the f64 Python float
    instead puts some operands on the other side of a rounding tie."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def calibrate(spec: EqualizerSpec, w_samples: torch.Tensor,
              y_samples: torch.Tensor, headroom: float = 0.98
              ) -> EqualizerSpec:
    """Fix the AGC gains so the calibration ensemble fills the FXP ranges."""
    def gain(x, fmt: FXPFormat):
        return headroom * fmt.max / max(abs_max(x), 1e-30)

    return dataclasses.replace(spec, y_gain=gain(y_samples, spec.y_fxp),
                               w_gain=gain(w_samples, spec.w_fxp))


def _quant_plane(x, spec_fxp: FXPFormat, spec_vp: Optional[VPFormat]):
    if spec_vp is None:
        return fxp_quantize_value(x, spec_fxp)
    return vp_fake_quant(x, spec_fxp, spec_vp)


def quantize_inputs(spec: EqualizerSpec, w: torch.Tensor, y: torch.Tensor):
    """Quantize equalizer inputs onto the design's formats (re/im planes).

    Returns (wq, yq) back in physical units (gains divided out), so that
    s_hat = wq @ yq estimates the unscaled symbols directly.
    """
    def q(x, gain, fxp, vp):
        g = f32(gain, x.device)
        xr = _quant_plane(x.real * g, fxp, vp)
        xi = _quant_plane(x.imag * g, fxp, vp)
        return torch.complex(xr, xi) / gain

    return (q(w, spec.w_gain, spec.w_fxp, spec.w_vp),
            q(y, spec.y_gain, spec.y_fxp, spec.y_vp))


def equalize_quantized(spec: EqualizerSpec, w: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
    """One equalization s_hat = W y with quantized inputs (the designs'
    numerical model; w (..., U, B), y (..., B) complex, in the domain the
    spec expects)."""
    wq, yq = quantize_inputs(spec, w, y)
    return torch.einsum("...ub,...b->...u", wq, yq)
