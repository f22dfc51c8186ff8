"""The port's Sec. II-D parameter search (`repro_torch.core.param_search`)
and the per-subcarrier search of `WidebandCalibrator` against the JAX
package's, on the CPU (the plain quantize and dequantize).

Inputs are made once with numpy from a seed and fed to both packages.
Formats must be equal; an NMSE within 1e-12 relative (the port's f64 sums
run in another order than numpy's).  The greedy branch, forced with a
small `max_exhaustive`, scores lists padded with repeated exponents.
Where the reference raises (an infeasible M, or an exhaustive branch
with no candidate), the port raises the same exception type.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import formats as jfmt
from repro.core import param_search as jps
from repro.mimo import (ChannelConfig as JChannelConfig,
                        OFDMConfig as JOFDMConfig,
                        WidebandCalibrator as JWidebandCalibrator,
                        make_wideband_ensemble, table1_specs as jtable1)
from repro_torch.core import formats as tfmt
from repro_torch.core import param_search as tps
from repro_torch.mimo.equalizer import table1_specs as ttable1
from repro_torch.mimo.ofdm import WidebandCalibrator

RTOL = 1e-12
FXPS = ((12, 11), (9, 1))


@pytest.fixture(scope="module")
def samples():
    """Heavy-tailed samples in [-1, 1], as a beamspace W plane is, with
    exact zeros and the range's ends."""
    rng = np.random.default_rng(29)
    x = np.clip(rng.standard_t(3, 3000) * 0.08, -1.0, 1.0)
    x[:4] = (0.0, 1.0, -1.0, 2.0 ** -12)
    return x


def _run(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except (ValueError, TypeError) as e:
        return type(e)


def _same(got, want):
    if isinstance(want, type):
        assert got is want
        return
    assert repr(got[0]) == repr(want[0])
    assert abs(got[1] - want[1]) <= RTOL * abs(want[1])


@pytest.mark.parametrize("wf", FXPS, ids=lambda wf: f"FXP{wf}")
def test_candidate_lists_equal(wf):
    for M in range(2, 17):
        for E in range(0, 4):
            want = _run(jps.candidate_lists, jfmt.FXPFormat(*wf), M, E)
            got = _run(tps.candidate_lists, tfmt.FXPFormat(*wf), M, E)
            assert got == want if not isinstance(want, type) else got is want


@pytest.mark.parametrize("wf", FXPS, ids=lambda wf: f"FXP{wf}")
def test_vp_nmse_of_every_candidate(samples, wf):
    jf, tf = jfmt.FXPFormat(*wf), tfmt.FXPFormat(*wf)
    for M, E in ((4, 2), (7, 2), (8, 1), (5, 3)):
        for f in jps.candidate_lists(jf, M, E):
            want = jps.vp_nmse(samples, jf, jfmt.VPFormat(M, f))
            got = tps.vp_nmse(samples, tf, tfmt.VPFormat(M, f), device="cpu")
            assert abs(got - want) <= RTOL * abs(want), (M, f, got, want)


def test_vp_nmse_takes_a_tensor_on_its_device(samples):
    f = tfmt.FXPFormat(12, 11)
    vp = tfmt.VPFormat(7, (11, 9, 7, 6))
    assert tps.vp_nmse(torch.from_numpy(samples), f, vp) == \
        tps.vp_nmse(samples, f, vp, device="cpu")


@pytest.mark.parametrize("branch", ["exhaustive", "greedy"])
@pytest.mark.parametrize("wf", FXPS, ids=lambda wf: f"FXP{wf}")
@pytest.mark.parametrize("E", [1, 2, 3])
def test_search_exponent_list_equal(samples, wf, E, branch):
    kw = {"max_exhaustive": 0} if branch == "greedy" else {}
    for M in range(4, 13):
        want = _run(jps.search_exponent_list, samples, jfmt.FXPFormat(*wf),
                    M, E, **kw)
        got = _run(tps.search_exponent_list, samples, tfmt.FXPFormat(*wf),
                   M, E, device="cpu", **kw)
        _same(got, want)


def test_greedy_scores_lists_with_repeated_exponents(samples, monkeypatch):
    """The greedy branch at K = 4 scores 3-entry lists padded to 4 by
    repeating the last entry, through the same quantize / dequantize."""
    seen = []
    real = tps._nmse
    monkeypatch.setattr(tps, "_nmse",
                        lambda p, fxp, vp: seen.append(vp.f) or real(p, fxp,
                                                                     vp))
    tps.search_exponent_list(samples, tfmt.FXPFormat(12, 11), 7, 2,
                             max_exhaustive=0, device="cpu")
    assert any(len(set(f)) < len(f) for f in seen)


@pytest.mark.parametrize("E,target", [(1, 1e-4), (2, 1e-4), (2, 1e-2),
                                      (3, 1e-2), (2, 1e-12)])
def test_search_min_M_equal(samples, E, target):
    want = _run(jps.search_min_M, samples, jfmt.FXPFormat(12, 11), E, target)
    got = _run(tps.search_min_M, samples, tfmt.FXPFormat(12, 11), E, target,
               device="cpu")
    if want is None or isinstance(want, type):
        assert got is want
    else:
        _same(got, want)


@pytest.fixture(scope="module")
def wideband():
    """The reference's own wideband draw (tests/test_ofdm.py): 8
    subcarriers, 3 taps, n 16, PRNGKey(0)."""
    ens = make_wideband_ensemble(jax.random.PRNGKey(0), JChannelConfig(),
                                 JOFDMConfig(8, 3), 16, 20.0)
    return ens, np.asarray(ens.w_beam)


@pytest.mark.parametrize("M,E", [(None, None), (6, 2), (8, 2), (5, 3),
                                 (9, 1)])
def test_search_vp_format_per_subcarrier(wideband, M, E):
    ens, w_beam = wideband
    jcal = JWidebandCalibrator(next(s for s in jtable1() if s.name == "B-VP"))
    tcal = WidebandCalibrator(next(s for s in ttable1() if s.name == "B-VP"))
    for s in range(w_beam.shape[0]):
        want = jcal.search_vp_format(s, ens.w_beam[s], M=M, E=E)
        w_s = torch.from_numpy(w_beam[s].copy())
        got = tcal.search_vp_format(s, w_s, M=M, E=E)
        assert repr(got) == repr(want), s
        assert tcal.search_vp_format(s, w_s, M=M, E=E) is got
    assert tcal.cache_sizes == (0, w_beam.shape[0])
    assert jcal.cache_sizes == tcal.cache_sizes
