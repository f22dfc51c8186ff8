"""Monte-Carlo NMSE / BER harness (paper Sec. III-A and V; port of
`repro.mimo.sim`).

  * Fig. 7: spiky beamspace PDFs (kurtosis / dynamic-range stats);
  * Fig. 8: NMSE vs operand bitwidth, antenna vs beamspace (~1.2-bit gap);
  * Table I: BER of the three quantized designs vs float LMMSE.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.formats import FXPFormat
from repro_torch.core.fxp import fxp_quantize_value
from repro_torch.models.model import resolve_device
from .beamspace import to_beamspace
from .channel import (
    ChannelConfig, awgn_draws, awgn_from_draws, channel_draws,
    channels_from_draws,
)
from .equalizer import EqualizerSpec, abs_max, calibrate, equalize_quantized
from .lmmse import equalize, lmmse_matrix

# ---------------------------------------------------------------------------
# 16-QAM (gray-coded, Es = 1)
# ---------------------------------------------------------------------------

# Gray code for levels [-3, -1, 1, 3] -> bit pairs (00, 01, 11, 10).
_GRAY = (0, 1, 3, 2)


def _sqrt10(device) -> torch.Tensor:
    return torch.sqrt(torch.tensor(10.0, dtype=torch.float32, device=device))


def _bits(idx_i: torch.Tensor, idx_q: torch.Tensor) -> torch.Tensor:
    gray = torch.tensor(_GRAY, device=idx_i.device)
    bi, bq = gray[idx_i.long()], gray[idx_q.long()]
    return torch.stack([(bi >> 1) & 1, bi & 1, (bq >> 1) & 1, bq & 1],
                       dim=-1).to(torch.uint8)


def qam16_draws(gen: torch.Generator, shape: Tuple[int, ...]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Level indices in [0, 4) of the in-phase and quadrature parts."""
    def draw():
        return torch.randint(0, 4, tuple(shape), generator=gen,
                             device=gen.device)
    return draw(), draw()


def qam16_from_draws(idx_i: torch.Tensor, idx_q: torch.Tensor):
    """16-QAM symbols (complex64) and their bit labels (shape + (4,))."""
    levels = torch.tensor([-3.0, -1.0, 1.0, 3.0],
                          device=idx_i.device) / _sqrt10(idx_i.device)
    sym = torch.complex(levels[idx_i.long()], levels[idx_q.long()])
    return sym, _bits(idx_i, idx_q)


def qam16_mod(gen: torch.Generator, shape: Tuple[int, ...]):
    """Random 16-QAM symbols + their bit labels."""
    return qam16_from_draws(*qam16_draws(gen, shape))


def qam16_demod_hard(s: torch.Tensor) -> torch.Tensor:
    """Hard-decision demodulation -> bit labels (shape + (4,))."""
    bounds = torch.tensor([-2.0, 0.0, 2.0],
                          device=s.device) / _sqrt10(s.device)

    def level_idx(x):
        return torch.clamp(torch.searchsorted(bounds, x.contiguous()), 0, 3)

    return _bits(level_idx(s.real), level_idx(s.imag))


# ---------------------------------------------------------------------------
# Ensemble generation (channels, receive vectors, LMMSE matrices)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Ensemble:
    h_ant: torch.Tensor   # (n, B, U) antenna-domain channels
    h_beam: torch.Tensor  # (n, B, U)
    w_ant: torch.Tensor   # (n, U, B) LMMSE matrices
    w_beam: torch.Tensor  # (n, U, B)
    y_ant: torch.Tensor   # (n, B) received vectors (one per channel)
    y_beam: torch.Tensor  # (n, B)
    s: torch.Tensor       # (n, U) transmitted symbols
    bits: torch.Tensor    # (n, U, 4)
    n0: float


def ensemble_draws(gen: torch.Generator, cfg: ChannelConfig, n: int
                   ) -> Dict[str, Any]:
    """The random numbers of `make_ensemble`: channel draws, 16-QAM level
    indices and noise normals."""
    return {"channel": channel_draws(gen, cfg, n),
            "qam": qam16_draws(gen, (n, cfg.U)),
            "noise": awgn_draws(gen, (n, cfg.B))}


def ensemble_from_draws(cfg: ChannelConfig, draws: Mapping[str, Any],
                        snr_db: float) -> Ensemble:
    """Paper Sec. III-A: one 16-QAM receive vector per channel.  Per-stream
    SNR with E[|h|^2] ~ 1 per antenna and Es = 1: N0 = 10^(-SNR/10)."""
    h = channels_from_draws(cfg, **draws["channel"])
    n0 = float(10.0 ** (-snr_db / 10.0))
    s, bits = qam16_from_draws(*draws["qam"])
    noise = awgn_from_draws(draws["noise"], n0)
    y = torch.einsum("nbu,nu->nb", h, s) + noise
    hb = to_beamspace(h, axis=-2)
    yb = to_beamspace(y, axis=-1)
    return Ensemble(h, hb, lmmse_matrix(h, n0), lmmse_matrix(hb, n0), y, yb,
                    s, bits, n0)


def make_ensemble(gen: torch.Generator, cfg: ChannelConfig, n: int,
                  snr_db: float) -> Ensemble:
    """n channels, one 16-QAM receive vector each, on gen's device."""
    return ensemble_from_draws(cfg, ensemble_draws(gen, cfg, n), snr_db)


def ensemble_from_numpy(arrays: Mapping[str, Any], device="cuda"
                        ) -> Ensemble:
    """An `Ensemble` from numpy arrays keyed by field name (the
    reference's ensemble carried across), plus the float `n0`."""
    dev = resolve_device(device)
    fields = {f.name: arrays[f.name] for f in dataclasses.fields(Ensemble)}
    n0 = float(fields.pop("n0"))
    return Ensemble(**{k: torch.from_numpy(np.array(v)).to(dev)
                       for k, v in fields.items()}, n0=n0)


# ---------------------------------------------------------------------------
# Fig. 7: distribution statistics (spikiness of beamspace signals)
# ---------------------------------------------------------------------------

def pdf_stats(x: torch.Tensor) -> Dict[str, float]:
    """Kurtosis & peak-to-average stats of the real part (paper Fig. 7)."""
    v = x.real.detach().cpu().numpy().ravel()
    v = v / (v.std() + 1e-30)
    return {
        "kurtosis": float(np.mean(v**4) - 3.0),
        "papr_db": float(10 * np.log10(np.max(v**2) / np.mean(v**2))),
        "frac_below_0p1sigma": float(np.mean(np.abs(v) < 0.1)),
    }


# ---------------------------------------------------------------------------
# Fig. 8: NMSE vs bitwidth
# ---------------------------------------------------------------------------

def _global_unit_scale(x: torch.Tensor) -> float:
    """Single scalar putting re/im of the whole ensemble into (-1, 1)."""
    return (1.0 - 1e-6) / max(abs_max(x), 1e-30)


def _scale(x: torch.Tensor, g: float) -> torch.Tensor:
    """complex64 x times a real gain, re and im in f32 as the reference's
    complex-by-real product gives them."""
    gf = torch.tensor(g, dtype=torch.float32, device=x.device)
    return torch.complex(x.real * gf, x.imag * gf)


def nmse_vs_bitwidth(ens: Ensemble, widths: Sequence[int] = range(6, 11)
                     ) -> Dict[str, Dict[int, float]]:
    """Quantize FXP(W, W-1)-normalized inputs, NMSE of the dot product
    (eq. 4).  Only the inputs are quantized; the multiply runs in float,
    as in the paper."""
    out = {"antenna": {}, "beamspace": {}}
    for domain, (w, y) in {"antenna": (ens.w_ant, ens.y_ant),
                           "beamspace": (ens.w_beam, ens.y_beam)}.items():
        wn = _scale(w, _global_unit_scale(w))
        yn = _scale(y, _global_unit_scale(y))
        ref = torch.einsum("nub,nb->nu", wn, yn)
        den = float(torch.mean(ref.abs() ** 2))
        for W in widths:
            fmt = FXPFormat(W, W - 1)

            def q(x):
                return torch.complex(fxp_quantize_value(x.real, fmt),
                                     fxp_quantize_value(x.imag, fmt))

            est = torch.einsum("nub,nb->nu", q(wn), q(yn))
            num = float(torch.mean((est - ref).abs() ** 2))
            out[domain][int(W)] = num / den
    return out


def bitwidth_gap(nmse: Dict[str, Dict[int, float]]) -> float:
    """Horizontal gap (bits) between the antenna and beamspace NMSE
    curves, averaged over the antenna curve's levels (paper: ~1.2)."""
    wa = sorted(nmse["antenna"])
    la = np.log10([nmse["antenna"][w] for w in wa])
    lb = np.log10([nmse["beamspace"][w] for w in wa])
    gaps = []
    for i, w in enumerate(wa):
        target = la[i]
        j = np.searchsorted(-lb, -target)  # lb is decreasing
        if j == 0 or j >= len(wa):
            continue
        frac = (lb[j - 1] - target) / (lb[j - 1] - lb[j] + 1e-30)
        w_beam = wa[j - 1] + frac * (wa[j] - wa[j - 1])
        gaps.append(w_beam - w)
    return float(np.mean(gaps)) if gaps else float("nan")


# ---------------------------------------------------------------------------
# BER: Table I validation
# ---------------------------------------------------------------------------

def bit_error_rate(s_hat: torch.Tensor, bits: torch.Tensor) -> float:
    """Hard-decision BER of estimates against the sent bit labels."""
    return float((qam16_demod_hard(s_hat) != bits).float().mean())


def ber_float(ens: Ensemble, beamspace: bool) -> float:
    w, y = (ens.w_beam, ens.y_beam) if beamspace else (ens.w_ant, ens.y_ant)
    return bit_error_rate(equalize(w, y), ens.bits)


def ber_quantized(ens: Ensemble, spec: EqualizerSpec) -> float:
    w, y = ((ens.w_beam, ens.y_beam) if spec.beamspace
            else (ens.w_ant, ens.y_ant))
    return bit_error_rate(equalize_quantized(spec, w, y), ens.bits)


def calibrate_specs(specs, ens: Ensemble):
    """Calibrate AGC gains of each design on the ensemble."""
    out = []
    for spec in specs:
        w, y = ((ens.w_beam, ens.y_beam) if spec.beamspace
                else (ens.w_ant, ens.y_ant))
        out.append(calibrate(spec, w, y))
    return out


# ---------------------------------------------------------------------------
# Golden statistics
# ---------------------------------------------------------------------------

def golden_stats(seed: int = 0, n: int = 128, snr_db: float = 20.0,
                 device="cuda") -> Dict[str, float]:
    """Scalar summary of the Fig. 7 / Fig. 8 reproduction on one
    ensemble drawn from a torch generator seeded with `seed` (not the
    reference's draws: hold it against the reference on a carried-across
    ensemble, through `pdf_stats` and `nmse_vs_bitwidth`)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    ens = make_ensemble(gen, ChannelConfig(), n, snr_db)
    nm = nmse_vs_bitwidth(ens, widths=(6, 8, 10))
    return {
        "kurtosis_y_beam": pdf_stats(ens.y_beam)["kurtosis"],
        "kurtosis_w_beam": pdf_stats(ens.w_beam)["kurtosis"],
        "kurtosis_y_ant": pdf_stats(ens.y_ant)["kurtosis"],
        "nmse_ant_w6": nm["antenna"][6],
        "nmse_ant_w10": nm["antenna"][10],
        "nmse_beam_w6": nm["beamspace"][6],
        "nmse_beam_w10": nm["beamspace"][10],
        "bit_gap": bitwidth_gap(nm),
    }

