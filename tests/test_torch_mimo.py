"""The port's MIMO equalization path against the JAX package.

The two packages' random streams differ, so the JAX side draws its own
random numbers (splitting its keys as `repro.mimo` does) and the port's
deterministic halves (`channels_from_draws`, ...) get the same draws; the
equalizers get the same numpy W, y and gains.  Tolerances: channels and
transforms 1e-5 (f32 sin/exp/sums in another order), the LMMSE solve
rtol 1e-4, equalized estimates rtol 1e-5 and atol 1e-5 * max|out| (f32
sums of exactly quantized operands in another order); symbols, bits,
gains and quantized values exactly.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.mimo import beamspace as jbeam
from repro.mimo import channel as jchannel
from repro.mimo import cspade as jcspade
from repro.mimo import equalizer as jeq
from repro.mimo import lmmse as jlmmse
from repro.mimo import mvm_engine as jengine
from repro.mimo import ofdm as jofdm
from repro.mimo import sim as jsim
from repro_torch.launch import equalize as cli
from repro_torch.mimo import beamspace, channel, cspade, equalizer, lmmse
from repro_torch.mimo import mvm_engine, ofdm, sim

JCFG, TCFG = jchannel.ChannelConfig(), channel.ChannelConfig()
ROOT = Path(__file__).resolve().parents[1]


def close(got, want, rtol=1e-5, atol_rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()))


def _jax_channel_draws(key, n):
    """The draws of `repro.mimo.channel.generate_channels`, split as it
    splits its key."""
    k_ang, k_cl, k_g, k_ph = jax.random.split(key, 4)
    c = JCFG
    return {
        "angle_deg": jax.random.uniform(k_ang, (n, c.U), minval=-c.sector_deg,
                                        maxval=c.sector_deg),
        "d_ang": jax.random.normal(k_cl, (n, c.U, c.n_clusters)),
        "g": jax.random.normal(k_g, (n, c.U, c.n_clusters, 2)),
        "phi": jax.random.uniform(k_ph, (n, c.U), maxval=2 * jnp.pi),
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _jax_ensemble_draws(key, n):
    """The draws of `repro.mimo.sim.make_ensemble`, split as it splits."""
    kh, ks, kn = jax.random.split(key, 3)
    ki, kq = jax.random.split(ks)
    return {"channel": _jax_channel_draws(kh, n),
            "qam": (jax.random.randint(ki, (n, 8), 0, 4),
                    jax.random.randint(kq, (n, 8), 0, 4)),
            "noise": jax.random.normal(kn, (n, 64, 2))}


@pytest.fixture(scope="module")
def ens():
    """One JAX ensemble (n = 8, 10 dB), the port's copy of it, and the
    JAX draws it was made from."""
    key = jax.random.PRNGKey(2)
    jens = jsim.make_ensemble(key, JCFG, 8, 10.0)
    fields = {f.name: np.asarray(getattr(jens, f.name))
              for f in dataclasses.fields(jens) if f.name != "n0"}
    return (jens, sim.ensemble_from_numpy(dict(fields, n0=jens.n0), "cpu"),
            _jax_ensemble_draws(key, 8))


@pytest.fixture(scope="module")
def specs(ens):
    """Table I specs calibrated by both packages on the same ensemble."""
    jens, tens, _ = ens
    jspecs = jsim.calibrate_specs(jeq.table1_specs(), jens)
    tspecs = sim.calibrate_specs(equalizer.table1_specs(), tens)
    for j, t in zip(jspecs, tspecs):
        assert (t.name, t.w_gain, t.y_gain) == (j.name, j.w_gain, j.y_gain)
    return {t.name: (j, t) for j, t in zip(jspecs, tspecs)}


def test_channels_and_noise_from_jax_draws(ens):
    jens, _, draws = ens
    got = channel.channels_from_draws(TCFG, **_to_torch(draws["channel"]))
    assert got.dtype == torch.complex64 and got.shape == (8, 64, 8)
    close(got.numpy(), jens.h_ant)
    kn = jax.random.split(jax.random.PRNGKey(2), 3)[2]
    got = channel.awgn_from_draws(_to_torch(draws["noise"]), jens.n0)
    close(got.numpy(), jchannel.awgn(kn, (8, 64), jens.n0), rtol=1e-6,
          atol_rel=0)


def test_dft_beamspace_and_lmmse():
    np.testing.assert_allclose(beamspace.dft_matrix(64).numpy(),
                               np.asarray(jbeam.dft_matrix(64)), atol=1e-6)
    rng = np.random.default_rng(0)
    h = (rng.normal(size=(5, 64, 8))
         + 1j * rng.normal(size=(5, 64, 8))).astype(np.complex64)
    th, jh = torch.from_numpy(h), jnp.asarray(h)
    hb = beamspace.to_beamspace(th, -2)
    close(hb.numpy(), jbeam.to_beamspace(jh, -2))
    close(beamspace.from_beamspace(hb, -2).numpy(), h, atol_rel=1e-5)
    close(beamspace.to_beamspace(th[:, :, 0], -1).numpy(),
          jbeam.to_beamspace(jh[:, :, 0], -1))
    w = lmmse.lmmse_matrix(th, 0.1)
    close(w.numpy(), jlmmse.lmmse_matrix(jh, 0.1), rtol=1e-4, atol_rel=1e-4)
    y = th[:, :, 0]
    close(lmmse.equalize(w, y).numpy(),
          jlmmse.equalize(jnp.asarray(w.numpy()), jnp.asarray(y.numpy())))


def test_qam16_from_jax_draws_and_demod():
    ki, kq = jax.random.split(jax.random.PRNGKey(5))
    shape = (50, 8)
    idx = (jax.random.randint(ki, shape, 0, 4),
           jax.random.randint(kq, shape, 0, 4))
    sym, bits = sim.qam16_from_draws(*_to_torch(idx))
    jsym, jbits = jsim.qam16_mod(jax.random.PRNGKey(5), shape)
    np.testing.assert_array_equal(sym.numpy(), np.asarray(jsym))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    # Hard decisions on noisy symbols and on the decision boundaries.
    rng = np.random.default_rng(1)
    b = np.float32(2 / np.sqrt(np.float32(10)))
    edges = np.array([-b, 0.0, b, -1.0, 1.0], np.float32)
    s = (np.asarray(jsym) + (rng.normal(size=shape)
                             + 1j * rng.normal(size=shape)) * 0.3)
    s = np.concatenate([s.ravel(), edges + 1j * edges[::-1]]).astype(
        np.complex64)
    np.testing.assert_array_equal(
        sim.qam16_demod_hard(torch.from_numpy(s)).numpy(),
        np.asarray(jsim.qam16_demod_hard(jnp.asarray(s))))


def test_ensemble_from_jax_draws(ens):
    want, _, draws = ens
    got = sim.ensemble_from_draws(TCFG, _to_torch(draws), 10.0)
    assert got.n0 == want.n0
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    for name in ("h_ant", "h_beam", "y_ant", "y_beam"):
        close(getattr(got, name).numpy(), getattr(want, name))
    for name in ("w_ant", "w_beam"):
        close(getattr(got, name).numpy(), getattr(want, name), rtol=1e-4,
              atol_rel=1e-4)


def test_nmse_vs_bitwidth_and_fig7_stats(ens):
    """The Fig. 7 / Fig. 8 numbers on one carried-across ensemble,
    against a live run of the reference (not its pinned GOLDEN)."""
    jens, tens, _ = ens
    got = sim.nmse_vs_bitwidth(tens)
    want = jsim.nmse_vs_bitwidth(jens)
    for dom in ("antenna", "beamspace"):
        assert sorted(got[dom]) == sorted(want[dom])
        for w in want[dom]:
            assert got[dom][w] == pytest.approx(want[dom][w], rel=1e-4)
    assert sim.bitwidth_gap(got) == pytest.approx(
        jsim.bitwidth_gap(want), rel=1e-3)
    for name in ("y_beam", "w_beam", "y_ant"):
        g, w = sim.pdf_stats(getattr(tens, name)), jsim.pdf_stats(
            getattr(jens, name))
        assert g == pytest.approx(w, rel=1e-6)


@pytest.mark.parametrize("name", ["A-FXP", "B-FXP", "B-VP"])
def test_equalize_quantized(ens, specs, name):
    jens, tens, _ = ens
    jspec, tspec = specs[name]
    dom = "beam" if tspec.beamspace else "ant"
    got = equalizer.equalize_quantized(tspec, getattr(tens, f"w_{dom}"),
                                       getattr(tens, f"y_{dom}"))
    want = jeq.equalize_quantized(jspec, getattr(jens, f"w_{dom}"),
                                  getattr(jens, f"y_{dom}"))
    close(got.numpy(), want)
    # The quantized planes agree exactly (before the gains are divided
    # back out by a complex division, which rounds differently).
    for x in ("w", "y"):
        tx, jx = getattr(tens, f"{x}_{dom}"), getattr(jens, f"{x}_{dom}")
        gain = getattr(tspec, f"{x}_gain")
        fxp, vp = getattr(tspec, f"{x}_fxp"), getattr(tspec, f"{x}_vp")
        jfxp, jvp = getattr(jspec, f"{x}_fxp"), getattr(jspec, f"{x}_vp")
        got_q = equalizer._quant_plane(tx.imag * equalizer.f32(gain), fxp, vp)
        want_q = jeq._quant_plane(jx.imag * gain, jfxp, jvp)
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    for g, w in zip(
            equalizer.quantize_inputs(tspec, getattr(tens, f"w_{dom}"),
                                      getattr(tens, f"y_{dom}")),
            jeq.quantize_inputs(jspec, getattr(jens, f"w_{dom}"),
                                getattr(jens, f"y_{dom}"))):
        close(g.numpy(), w)
    assert sim.ber_quantized(tens, tspec) == jsim.ber_quantized(jens, jspec)


ENGINE_CASES = {
    "batched-unfused": dict(mode="batched"),
    "batched-fused": dict(mode="batched", fused=True),
    "batched-cspade": dict(mode="batched", cspade_threshold_quantile=0.5),
    "masked-unfused": dict(mode="masked"),
    "masked-fused": dict(mode="masked", fused=True),
    "masked-cspade": dict(mode="masked", cspade_threshold_quantile=0.5),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_equalize_vp_kernel(ens, specs, case):
    jens, tens, _ = ens
    jspec, tspec = specs["B-VP"]
    kw = ENGINE_CASES[case]
    got = mvm_engine.equalize_vp_kernel(tspec, tens.w_beam, tens.y_beam,
                                        **kw)
    want = jengine.equalize_vp_kernel(jspec, jens.w_beam, jens.y_beam, **kw)
    assert got.dtype == torch.complex64
    close(got.numpy(), want)
    if "cspade" not in case:
        # Every mask-free path gives the fake-quant model's estimates.
        close(got.numpy(), jeq.equalize_quantized(jspec, jens.w_beam,
                                                  jens.y_beam))


def test_equalize_vp_kernel_interpret_and_masks(ens, specs):
    """One case through the reference's Pallas bodies, and the CSPADE
    masks of the batched path exactly as the reference builds them."""
    jens, tens, _ = ens
    jspec, tspec = specs["B-VP"]
    got = mvm_engine.equalize_vp_kernel(tspec, tens.w_beam[:3],
                                        tens.y_beam[:3], fused=True)
    want = jengine.equalize_vp_kernel(jspec, jens.w_beam[:3],
                                      jens.y_beam[:3], fused=True,
                                      interpret=True)
    close(got.numpy(), want)
    a, b = mvm_engine.stack_complex_operands(tens.w_beam, tens.y_beam,
                                             tspec.w_gain, tspec.y_gain)
    ja, jb = jengine.stack_complex_operands(jens.w_beam, jens.y_beam,
                                            jspec.w_gain, jspec.y_gain)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    ta = mvm_engine.quantile_linear(a.abs(), 0.5)
    assert ta.item() == float(jnp.quantile(jnp.abs(ja), 0.5))


WB_KEY, WB_N = 5, 8


@pytest.fixture(scope="module")
def wideband():
    """A JAX wideband ensemble (S = 4, n = 8) and the port's copy."""
    cfg = jofdm.OFDMConfig(n_subcarriers=4, n_taps=4)
    jw = jofdm.make_wideband_ensemble(jax.random.PRNGKey(WB_KEY), JCFG, cfg,
                                      WB_N, 20.0)
    fields = {f.name: np.asarray(getattr(jw, f.name))
              for f in dataclasses.fields(jw) if f.name != "n0"}
    return jw, ofdm.wideband_ensemble_from_numpy(dict(fields, n0=jw.n0),
                                                 "cpu")


@pytest.mark.parametrize("how", ["flat", "vmap"])
def test_equalize_wideband(wideband, how):
    jw, tw = wideband
    jspecs = jofdm.WidebandCalibrator(jeq.table1_specs()[2]).specs_for(jw)
    tcal = ofdm.WidebandCalibrator(equalizer.table1_specs()[2])
    tspecs = tcal.specs_for(tw)
    assert [(s.w_gain, s.y_gain) for s in tspecs] == [
        (s.w_gain, s.y_gain) for s in jspecs]
    assert tcal.cache_sizes[0] == tw.S
    got = ofdm.equalize_wideband(tspecs, tw.w_beam, tw.y_beam, how=how)
    want = jofdm.equalize_wideband(jspecs, jw.w_beam, jw.y_beam, how=how)
    assert got.shape == (4, 8, 8)
    close(got.numpy(), want)
    assert ofdm.wideband_nmse(got, tw.s) == pytest.approx(
        jofdm.wideband_nmse(want, jw.s), rel=1e-4)
    assert ofdm.wideband_ber(got, tw.bits) == jofdm.wideband_ber(
        want, jw.bits)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ofdm.equalize_wideband(tspecs, tw.w_beam, tw.y_beam, how="shard_map")


def test_wideband_channels_from_jax_taps(wideband):
    """The reference's taps (split as its ensemble splits its key) through
    the port's tapped-delay-line DFT and beamspace transform."""
    jw, _ = wideband
    kh = jax.random.split(jax.random.PRNGKey(WB_KEY), 3)[0]
    taps = jnp.stack([jchannel.generate_channels(k, JCFG, WB_N)
                      for k in jax.random.split(kh, 4)])
    h = ofdm.wideband_channels_from_taps(
        torch.from_numpy(np.array(taps)),
        ofdm.OFDMConfig(n_subcarriers=4, n_taps=4))
    close(beamspace.to_beamspace(h, -2).numpy(), jw.h_beam)


def test_cspade_thresholds_and_muting(ens):
    jens, tens, _ = ens
    got = cspade.calibrate_thresholds(tens.w_beam, tens.y_beam, 0.5)
    want = jcspade.calibrate_thresholds(jens.w_beam, jens.y_beam, 0.5)
    assert got == pytest.approx(want, rel=1e-6)
    assert cspade.muting_rate(tens.w_beam, tens.y_beam, *got) == \
        pytest.approx(float(jcspade.muting_rate(jens.w_beam, jens.y_beam,
                                                *want)), rel=1e-6)


def test_equalize_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "eq.json"
    report = cli.main(["--n", "16", "--device", "cpu", "--json", str(out)])
    text = capsys.readouterr().out
    for block in ("Fig. 8", "Table I", "B-VP through the VP kernels",
                  "CSPADE", "Wideband"):
        assert block in text
    assert json.loads(out.read_text())["n"] == 16
    ber = report["ber"]
    assert set(ber) == {"float", "A-FXP", "B-FXP", "B-VP", "B-VP kernel"}
    assert all(0.0 <= v <= 1.0 for v in ber.values())
    assert np.isfinite(report["wideband"]["nmse_vp"])


def test_mimo_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--n", "4"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sim.golden_stats(n=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sim.ensemble_from_numpy({"n0": 0.1}, "cuda")


def test_mimo_path_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.mimo.ofdm, repro_torch.launch.equalize; "
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
