"""Wideband OFDM equalization on the batched VP kernel (port of
`repro.mimo.ofdm`).

A wideband system runs the narrowband LMMSE MVM on every OFDM
subcarrier: S independent (U, B) x (B,) products per channel use.

  * `generate_wideband_channels`: a tapped-delay-line extension of the
    LoS generator (L taps, exponential power-delay profile, DFT across
    taps gives the per-subcarrier responses H[s]);
  * `make_wideband_ensemble`: per-subcarrier 16-QAM symbols, AWGN,
    beamspace transform and LMMSE matrices, leading axis S;
  * `WidebandCalibrator`: per-subcarrier AGC gains, cached;
  * `equalize_wideband`: every (subcarrier, realization) MVM folded into
    the leading batch axis of one batched kernel launch ("flat"), or a
    loop over subcarriers ("vmap", the same numbers).  The gains ride
    outside the quantizer, so both give the same estimates.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.formats import VPFormat
from repro_torch.models.model import resolve_device
from .beamspace import to_beamspace
from .channel import ChannelConfig, awgn, generate_channels
from .equalizer import EqualizerSpec, calibrate
from .lmmse import lmmse_matrix
from .mvm_engine import (
    batched_complex_mvm, combine_products, stack_complex_operands,
)
from .sim import bit_error_rate, qam16_mod


@dataclasses.dataclass(frozen=True)
class OFDMConfig:
    """Wideband dimensioning: S subcarriers over an L-tap delay channel."""

    n_subcarriers: int = 16
    n_taps: int = 4             # delay taps (frequency selectivity)
    tap_decay: float = 1.5      # exponential power-delay-profile constant

    @property
    def S(self) -> int:
        return self.n_subcarriers


def wideband_channels_from_taps(taps: torch.Tensor, ofdm: OFDMConfig
                                ) -> torch.Tensor:
    """Per-subcarrier channels (S, n, B, U) complex64 from L independent
    narrowband draws `taps` (L, n, B, U): weight by the power-delay
    profile, then H[s] = sum_l h_l exp(-2 pi j s l / S)."""
    L, S = ofdm.n_taps, ofdm.S
    dev = taps.device
    pdp = torch.exp(-torch.arange(L, device=dev) / ofdm.tap_decay)
    pdp = pdp / pdp.sum()                                  # unit total power
    taps = taps * torch.sqrt(pdp)[:, None, None, None]
    k = (torch.arange(S, device=dev)[:, None]
         * torch.arange(L, device=dev)[None, :]).to(torch.float32)
    # The reference's complex64 phase: f32(-2 pi) * s * l, then / S.
    ang = torch.tensor(-2 * math.pi, dtype=torch.float32) * k / S
    phase = torch.polar(torch.ones_like(ang), ang)         # (S, L)
    return torch.einsum("sl,lnbu->snbu", phase, taps)


def generate_wideband_channels(gen: torch.Generator, cfg: ChannelConfig,
                               ofdm: OFDMConfig, n: int) -> torch.Tensor:
    """(S, n, B, U) complex64: each tap an independent draw of the LoS
    geometry, power normalized so E[|H|^2] per antenna matches the
    narrowband generator."""
    taps = torch.stack([generate_channels(gen, cfg, n)
                        for _ in range(ofdm.n_taps)])
    return wideband_channels_from_taps(taps, ofdm)


@dataclasses.dataclass
class WidebandEnsemble:
    """Per-subcarrier ensembles; every tensor carries a leading S axis."""

    h_beam: torch.Tensor   # (S, n, B, U) beamspace channels
    w_beam: torch.Tensor   # (S, n, U, B) LMMSE matrices
    y_beam: torch.Tensor   # (S, n, B) received vectors
    s: torch.Tensor        # (S, n, U) transmitted symbols
    bits: torch.Tensor     # (S, n, U, 4)
    n0: float

    @property
    def S(self) -> int:
        return self.h_beam.shape[0]


def make_wideband_ensemble(gen: torch.Generator, cfg: ChannelConfig,
                           ofdm: OFDMConfig, n: int, snr_db: float
                           ) -> WidebandEnsemble:
    """S-subcarrier extension of `sim.make_ensemble` (beamspace)."""
    h = generate_wideband_channels(gen, cfg, ofdm, n)      # (S, n, B, U)
    n0 = float(10.0 ** (-snr_db / 10.0))
    s, bits = qam16_mod(gen, (ofdm.S, n, cfg.U))
    noise = awgn(gen, (ofdm.S, n, cfg.B), n0)
    y = torch.einsum("snbu,snu->snb", h, s) + noise
    hb = to_beamspace(h, axis=-2)
    yb = to_beamspace(y, axis=-1)
    return WidebandEnsemble(hb, lmmse_matrix(hb, n0), yb, s, bits, n0)


def wideband_ensemble_from_numpy(arrays: Mapping[str, Any], device="cuda"
                                 ) -> WidebandEnsemble:
    """A `WidebandEnsemble` from numpy arrays keyed by field name (the
    reference's ensemble carried across), plus the float `n0`."""
    dev = resolve_device(device)
    fields = {f.name: arrays[f.name]
              for f in dataclasses.fields(WidebandEnsemble)}
    n0 = float(fields.pop("n0"))
    return WidebandEnsemble(**{k: torch.from_numpy(np.array(v)).to(dev)
                               for k, v in fields.items()}, n0=n0)


class WidebandCalibrator:
    """Cached per-subcarrier AGC calibration.

    Gains depend only on a subcarrier's signal statistics, so they are
    computed once per subcarrier and reused across frames; the key holds
    a fingerprint of the operands, so a new ensemble recalibrates.
    """

    def __init__(self, base_spec: EqualizerSpec):
        if not base_spec.is_vp:
            raise ValueError("the wideband path is the B-VP design")
        self.base_spec = base_spec
        self._spec_cache: Dict[tuple, EqualizerSpec] = {}

    @staticmethod
    def _fingerprint(x: torch.Tensor) -> tuple:
        """Shape plus the first few values: a cheap content stamp."""
        head = x.reshape(-1)[:4].detach().cpu().numpy()
        return (tuple(x.shape), head.tobytes())

    def spec_for(self, s_idx: int, w_s: torch.Tensor, y_s: torch.Tensor
                 ) -> EqualizerSpec:
        """AGC-calibrated spec for one subcarrier (cached)."""
        key = (s_idx, self._fingerprint(w_s), self._fingerprint(y_s))
        if key not in self._spec_cache:
            self._spec_cache[key] = calibrate(self.base_spec, w_s, y_s)
        return self._spec_cache[key]

    def specs_for(self, ens: WidebandEnsemble) -> Sequence[EqualizerSpec]:
        return [self.spec_for(s, ens.w_beam[s], ens.y_beam[s])
                for s in range(ens.S)]

    def search_vp_format(self, s_idx: int, w_s, M: Optional[int] = None,
                         E: Optional[int] = None,
                         max_samples: int = 100_000) -> VPFormat:
        raise NotImplementedError(
            "the per-subcarrier exponent-list search needs "
            "core/param_search.py, not ported yet (ROADMAP queue 1, item 7)")

    @property
    def cache_sizes(self) -> Tuple[int, int]:
        return len(self._spec_cache), 0


def _stack_operands(specs: Sequence[EqualizerSpec], w, y):
    """Scale per subcarrier and stack into batched-kernel operands:
    a (S, n, 2U, B), b (S, n, B, 2) and the (S,) gain products."""
    gw = torch.tensor([sp.w_gain for sp in specs], dtype=torch.float32,
                      device=w.device)
    gy = torch.tensor([sp.y_gain for sp in specs], dtype=torch.float32,
                      device=w.device)
    a, b = stack_complex_operands(w, y, gw, gy)
    return a, b, gw * gy


def equalize_wideband(
    specs: Sequence[EqualizerSpec],
    w: torch.Tensor,            # (S, n, U, B) complex
    y: torch.Tensor,            # (S, n, B) complex
    how: str = "flat",
    fused: Optional[bool] = None,
    mesh=None,
    blocks: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """s_hat (S, n, U) through the batched VP kernel, the whole band.

    `specs` holds one AGC-calibrated B-VP spec per subcarrier, all with
    the same formats (only the gains differ).

    how="flat": fold (S, n) into one leading batch dim: one batched
        kernel launch of S * n programs.
    how="vmap": one batched launch per subcarrier (the same numbers).
    how="shard_map" (a device mesh over subcarriers) is not ported.
    """
    S, n, U, B = w.shape
    if len(specs) != S:
        raise ValueError(f"need one spec per subcarrier: {len(specs)} != {S}")
    fmts = (specs[0].w_fxp, specs[0].w_vp, specs[0].y_fxp, specs[0].y_vp)
    for sp in specs:
        if (sp.w_fxp, sp.w_vp, sp.y_fxp, sp.y_vp) != fmts:
            raise ValueError(
                "wideband batch requires one static format across the band "
                "(only AGC gains may vary per subcarrier)")

    a, b, g = _stack_operands(specs, w, y)
    if how == "flat":
        out = batched_complex_mvm(
            a.reshape(S * n, 2 * U, B), b.reshape(S * n, B, 2), *fmts,
            fused=fused, blocks=blocks).reshape(S, n, 2 * U, 2)
    elif how == "vmap":
        out = torch.stack([
            batched_complex_mvm(a[s], b[s], *fmts, fused=fused,
                                blocks=blocks) for s in range(S)])
    elif how == "shard_map":
        raise NotImplementedError(
            "how='shard_map' needs the distribution layer, not ported yet "
            "(ROADMAP queue 1, items 7 and 10)")
    else:
        raise ValueError(
            f"unknown how {how!r} (want 'flat', 'vmap' or 'shard_map')")
    return combine_products(out, g)


def wideband_nmse(s_hat: torch.Tensor, s_true: torch.Tensor) -> float:
    """Band-averaged NMSE of the equalized symbols."""
    num = float(torch.mean((s_hat - s_true).abs() ** 2))
    den = float(torch.mean(s_true.abs() ** 2))
    return num / den


def wideband_ber(s_hat: torch.Tensor, bits: torch.Tensor) -> float:
    """Hard-decision BER over the whole band."""
    return bit_error_rate(s_hat, bits)
