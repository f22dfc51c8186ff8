"""The port's gate-level cost model (`repro_torch.core.cost_model`) against
the JAX package's (`repro.core.cost_model`): every function bit for bit
(the same float operations in the same order) on the paper's designs and
on a sweep of (M, E, W) formats, the four Fig. 11 ratios of the
equalizer CLI equal to the reference example's, and the reference's own
checks (`tests/test_cost_model.py`) repeated on the port."""
import itertools

import pytest

from repro.core import cost_model as jcm
from repro.core import formats as jfmt
from repro_torch.core import cost_model as tcm
from repro_torch.core import formats as tfmt
from repro_torch.launch.equalize import fig11

SCALARS = {
    "adder_area": [(w,) for w in range(1, 40)],
    "multiplier_area": list(itertools.product(range(1, 17), range(1, 17))),
    "mux_area": list(itertools.product(range(1, 24), range(1, 130))),
    "eq_check_area": [(b,) for b in range(0, 40)],
    "lod_area": [(k,) for k in (1, 2, 4, 8, 16, 32, 64, 128)],
    "barrel_shifter_area": [(w,) for w in range(0, 40)],
    "flp_mult_area": list(itertools.product(range(2, 16), range(2, 9))),
    "flp_adder_area": list(itertools.product(range(2, 16), range(2, 9))),
    "flp_cmac_array_area": list(itertools.product((1, 4, 8, 16), range(4, 14),
                                                  range(3, 7))),
}


def _formats(pkg, W, F, M, E):
    fxp = pkg.FXPFormat(W, F)
    return fxp, pkg.default_vp_format(fxp, M, E)


def _sweep():
    """(W, F, M, E) of a W-plane format sweep that passes the Sec. II-D
    rule's feasibility (bot <= top)."""
    out = []
    for W in (9, 12, 16):
        for M in range(4, W + 1):
            for E in (1, 2, 3):
                if M - 1 <= W - 1:
                    out.append((W, W - 1, M, E))
    return out


def _specs(pkg, fmt_pkg):
    """MVMSpecs of both kinds over the sweep, B / U / CSPADE varied."""
    out = []
    for n, (W, F, M, E) in enumerate(_sweep()):
        w_fxp, w_vp = _formats(fmt_pkg, W, F, M, E)
        y_fxp = fmt_pkg.FXPFormat(9, 1)
        y_vp = fmt_pkg.VPFormat(7, (1, -1))
        B, U = ((16, 4), (64, 8), (32, 2))[n % 3]
        out.append(pkg.MVMSpec(f"vp{n}", B, U, y_fxp, w_fxp, y_vp, w_vp,
                               cspade=bool(n % 2)))
        out.append(pkg.MVMSpec(f"fxp{n}", B, U, y_fxp, w_fxp,
                               cspade=bool(n % 2)))
    return out


@pytest.mark.parametrize("name", sorted(SCALARS))
def test_unit_gate_functions_bit_for_bit(name):
    for args in SCALARS[name]:
        assert getattr(tcm, name)(*args) == getattr(jcm, name)(*args), args


def test_converter_areas_bit_for_bit():
    for W, F, M, E in _sweep():
        jf, jv = _formats(jfmt, W, F, M, E)
        tf, tv = _formats(tfmt, W, F, M, E)
        assert tcm.fxp2vp_area(tf, tv) == jcm.fxp2vp_area(jf, jv)
        assert tcm.vp2fxp_area(tv, tf) == jcm.vp2fxp_area(jv, jf)


def test_activity_and_paper_designs_equal():
    assert tcm.ACTIVITY == jcm.ACTIVITY
    for B, U in ((64, 8), (32, 4)):
        jd, td = jcm.paper_designs(B, U), tcm.paper_designs(B, U)
        assert list(jd) == list(td)
        for k in jd:
            assert repr(td[k]) == repr(jd[k])


@pytest.mark.parametrize("which", ["paper", "sweep"])
def test_hierarchical_areas_and_power_bit_for_bit(which):
    if which == "paper":
        pairs = [(tcm.paper_designs()[k], jcm.paper_designs()[k])
                 for k in jcm.paper_designs()]
    else:
        pairs = list(zip(_specs(tcm, tfmt), _specs(jcm, jfmt)))
    for t, j in pairs:
        for fn in ("cm_area", "dotp_area", "mvm_area"):
            assert getattr(tcm, fn)(t) == getattr(jcm, fn)(j), (fn, j.name)
        assert tcm.total(tcm.mvm_area(t)) == jcm.total(jcm.mvm_area(j))
        for mut, ps in itertools.product((0.0, 0.3, 0.5, 0.9), (True, False)):
            assert tcm.mvm_power(t, mut, ps) == jcm.mvm_power(j, mut, ps)
        if j.is_vp:
            assert tcm.vp_cmac_array_area(t) == jcm.vp_cmac_array_area(j)


def test_fig11_ratios_equal_to_the_reference_example():
    """The four ratios `examples/mimo_equalizer.py` prints, computed as it
    computes them, against the port's CLI block."""
    designs = jcm.paper_designs()
    tot = {k: jcm.total(jcm.mvm_area(s)) for k, s in designs.items()}
    p = {k: sum(jcm.mvm_power(s, muting_rate=0.5).values())
         for k, s in designs.items()}
    got = fig11()
    assert got["area_bfxp_afxp"] == tot["B-FXP"] / tot["A-FXP"]
    assert got["area_bvp_bfxp"] == tot["B-VP"] / tot["B-FXP"]
    assert got["power_bvp_bfxp"] == p["B-VP"] / p["B-FXP"]
    assert got["flp_vp_cmac"] == (jcm.flp_cmac_array_area(8)
                                  / jcm.vp_cmac_array_area(designs["B-VP"]))
    assert got["muting_rate"] == 0.5


# -- the reference's checks (tests/test_cost_model.py), on the port ----------

def test_area_ratios_match_paper_trends():
    designs = tcm.paper_designs()
    tot = {k: tcm.total(tcm.mvm_area(s)) for k, s in designs.items()}
    assert 1.2 < tot["B-FXP"] / tot["A-FXP"] < 1.5
    assert 0.70 < tot["B-VP"] / tot["B-FXP"] < 0.88


def test_rm_dominates_bfxp_area():
    areas = tcm.mvm_area(tcm.paper_designs()["B-FXP"])
    share = areas["rm"] / tcm.total(areas)
    assert 0.55 < share < 0.78


def test_power_savings_band():
    designs = tcm.paper_designs()
    for mut in (0.3, 0.5):
        p = {k: sum(tcm.mvm_power(s, muting_rate=mut).values())
             for k, s in designs.items()}
        r = p["B-VP"] / p["B-FXP"]
        assert 0.75 < r < 0.95, (mut, r)


def test_flp_much_larger_than_vp():
    designs = tcm.paper_designs()
    ratio = tcm.flp_cmac_array_area(8) / tcm.vp_cmac_array_area(
        designs["B-VP"])
    assert ratio > 2.0


def test_converter_cheaper_than_multiplier():
    y_fxp, y_vp = tfmt.FXPFormat(9, 1), tfmt.VPFormat(7, (1, -1))
    w_fxp, w_vp = tfmt.FXPFormat(12, 11), tfmt.VPFormat(7, (11, 9, 7, 6))
    rm_fxp = tcm.multiplier_area(9, 12)
    rm_vp = tcm.multiplier_area(7, 7)
    conv = (tcm.fxp2vp_area(y_fxp, y_vp) / 64
            + tcm.fxp2vp_area(w_fxp, w_vp) / 64
            + tcm.vp2fxp_area(tfmt.product_format(y_vp, w_vp),
                              tfmt.FXPFormat(20, 12)))
    assert rm_vp + conv < rm_fxp


def test_multiplier_area_monotone():
    assert tcm.multiplier_area(7, 7) < tcm.multiplier_area(9, 12)
    assert tcm.multiplier_area(9, 12) < tcm.multiplier_area(12, 12)
