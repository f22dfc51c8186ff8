"""The paper's case study end to end (counterpart of
`examples/mimo_equalizer.py`): beamspace LMMSE equalization with the
three MVM designs (A-FXP / B-FXP / B-VP) on simulated LoS mmWave
channels, and the wideband OFDM extension.

    PYTHONPATH=src python -m repro_torch.launch.equalize --n 2000

Prints the Fig. 7 statistics, the Fig. 8 NMSE gap, the Table I BERs
(float, A-FXP and B-FXP through the fake-quant model, B-VP both through
the model and through the VP kernels), the CSPADE thresholds and muting
rate, and wideband NMSE/BER with the whole band in one batched kernel
launch.  Runs on the card by default and raises when CUDA is absent;
`--device cpu` runs the plain PyTorch versions of the kernels.  The
Fig. 11 cost-model block waits for `core/cost_model.py`.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

import torch

from repro_torch.mimo import cspade
from repro_torch.mimo.channel import ChannelConfig
from repro_torch.mimo.equalizer import table1_specs
from repro_torch.mimo.lmmse import equalize
from repro_torch.mimo.mvm_engine import equalize_vp_kernel
from repro_torch.mimo.ofdm import (
    OFDMConfig, WidebandCalibrator, equalize_wideband,
    make_wideband_ensemble, wideband_ber, wideband_nmse,
)
from repro_torch.mimo.sim import (
    ber_float, ber_quantized, bit_error_rate, bitwidth_gap, calibrate_specs,
    make_ensemble, nmse_vs_bitwidth, pdf_stats,
)
from repro_torch.models.model import resolve_device


def _generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=2000,
                    help="channel realizations per ensemble")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, metavar="FILE",
                    help="write the printed numbers to FILE")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = ChannelConfig()
    report = {"n": args.n, "device": str(dev)}

    print(f"=== LoS mmWave ensemble (B={cfg.B}, U={cfg.U}, 16-QAM, 20dB) "
          f"on {dev} ===")
    ens = make_ensemble(_generator(dev, 0), cfg, args.n, 20.0)
    report["fig7"] = {}
    for name, x in [("ybar", ens.y_ant), ("y", ens.y_beam),
                    ("Wbar", ens.w_ant), ("W", ens.w_beam)]:
        s = pdf_stats(x)
        report["fig7"][name] = s
        print(f"  {name:5s} kurtosis={s['kurtosis']:7.1f}  "
              f"papr={s['papr_db']:5.1f}dB")

    print("\n=== Fig. 8: NMSE vs bitwidth ===")
    nm = nmse_vs_bitwidth(ens)
    for w in sorted(nm["antenna"]):
        print(f"  W={w}: antenna={nm['antenna'][w]:.2e}  "
              f"beamspace={nm['beamspace'][w]:.2e}")
    gap = bitwidth_gap(nm)
    report.update(fig8=nm, bit_gap=gap)
    print(f"  beamspace needs {gap:.2f} extra bits (paper: ~1.2)")

    print("\n=== Table I BER validation (SNR 2 dB) ===")
    ens_lo = make_ensemble(_generator(dev, 7), cfg, args.n, 2.0)
    specs = calibrate_specs(table1_specs(), ens_lo)
    ber = {"float": ber_float(ens_lo, True)}
    print(f"  float LMMSE: {ber['float']:.4f}")
    for s in specs:
        ber[s.name] = ber_quantized(ens_lo, s)
        print(f"  {s.name:6s}: {ber[s.name]:.4f}  "
              f"(y={s.y_fxp}{'/' + str(s.y_vp) if s.y_vp else ''}, "
              f"W={s.w_fxp}{'/' + str(s.w_vp) if s.w_vp else ''})")
    bvp = specs[2]
    s_hat = equalize_vp_kernel(bvp, ens_lo.w_beam, ens_lo.y_beam)
    ber["B-VP kernel"] = bit_error_rate(s_hat, ens_lo.bits)
    report["ber"] = ber
    print(f"  B-VP through the VP kernels: {ber['B-VP kernel']:.4f}")

    print("\n=== CSPADE thresholds / muting ===")
    tw, ty = cspade.calibrate_thresholds(ens.w_beam, ens.y_beam, 0.5)
    rate = cspade.muting_rate(ens.w_beam, ens.y_beam, tw, ty)
    report["cspade"] = {"tau_w": tw, "tau_y": ty, "muting": rate}
    print(f"  calibrated thresholds: tau_W={tw:.4f} tau_y={ty:.4f} "
          f"-> muting={rate:.2f}")

    print("\n=== Wideband OFDM: batched VP kernel over the band ===")
    ofdm = OFDMConfig(n_subcarriers=16, n_taps=4)
    n_wb = max(16, args.n // 64)
    wens = make_wideband_ensemble(_generator(dev, 5), cfg, ofdm, n_wb, 20.0)
    cal = WidebandCalibrator(next(s for s in table1_specs()
                                  if s.name == "B-VP"))
    wspecs = cal.specs_for(wens)
    s_vp = equalize_wideband(wspecs, wens.w_beam, wens.y_beam, how="flat")
    s_fl = equalize(wens.w_beam, wens.y_beam)
    report["wideband"] = {
        "S": ofdm.S, "n": n_wb,
        "nmse_vp": wideband_nmse(s_vp, wens.s),
        "nmse_float": wideband_nmse(s_fl, wens.s),
        "ber_vp": wideband_ber(s_vp, wens.bits),
        "ber_float": wideband_ber(s_fl, wens.bits)}
    wb = report["wideband"]
    print(f"  S={ofdm.S} subcarriers x n={n_wb} realizations "
          f"-> one batched kernel call of {ofdm.S * n_wb} programs")
    print(f"  per-subcarrier AGC gains cached: {cal.cache_sizes[0]} entries "
          f"(w_gain spread {min(s.w_gain for s in wspecs):.3g}.."
          f"{max(s.w_gain for s in wspecs):.3g})")
    print(f"  NMSE  B-VP={wb['nmse_vp']:.2e}  float={wb['nmse_float']:.2e}")
    print(f"  BER   B-VP={wb['ber_vp']:.4f}  float={wb['ber_float']:.4f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
