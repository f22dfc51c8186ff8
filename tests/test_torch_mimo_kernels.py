"""The port's MIMO-path kernels (plain versions, CPU) against the JAX
package: its Pallas bodies in interpret mode and its reference oracles.

Quantized planes and CSPADE masks are compared bit for bit.  Matmul
outputs are f32 reductions in another order: rtol 1e-5 and atol 1e-5 *
max|out| (K = 64 is past the exact-f32 horizon of these formats).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FXPFormat as JFXP, VPFormat as JVP
from repro.kernels import autotune as jautotune
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.formats import FXPFormat as TFXP, VPFormat as TVP
from repro_torch.kernels import autotune as tautotune
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.mimo.mvm_engine import quantile_linear

# Table I B-VP formats: W = FXP(12,11)/VP(7,[11,9,7,6]) (int16 words),
# y = FXP(9,1)/VP(7,[1,-1]) (int8 words).
FORMATS = {"W": ((12, 11), (7, (11, 9, 7, 6))), "y": ((9, 1), (7, (1, -1)))}


def _fmts(name):
    (W, F), (M, f) = FORMATS[name]
    return JFXP(W, F), JVP(M, f), TFXP(W, F), TVP(M, f)


JWF, JWV, TWF, TWV = _fmts("W")
JYF, JYV, TYF, TYV = _fmts("y")


def assert_close(got, *wants):
    got = np.asarray(got)
    for want in wants:
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(
            got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def _quant_inputs(F: int, seed: int) -> np.ndarray:
    """Random values, exact ties (k + 0.5) 2^-F and saturating values."""
    rng = np.random.default_rng(seed)
    scale = 2.0 ** -F
    rand = rng.standard_t(2, 400) * 256 * scale
    ties = (rng.integers(-2048, 2048, 200) + 0.5) * scale
    big = rng.choice([-1, 1], 40) * rng.uniform(2048, 8192, 40) * scale
    x = np.concatenate([rand, ties, big, [0.0, -0.0]]).astype(np.float32)
    return np.resize(x, 41 * 16).reshape(41, 16)


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_vp_quant_planes_bit_exact(name):
    jf, jv, tf, tv = _fmts(name)
    x = _quant_inputs(tf.F, seed=len(name))
    m, i = tops.vp_quant(torch.from_numpy(x), tf, tv)
    assert (m.dtype, i.dtype) == (torch.int8, torch.uint8)
    for jm, ji in (jops.vp_quant(jnp.asarray(x), jf, jv, interpret=True),
                   jref.vp_quant_ref(jnp.asarray(x), jf, jv)):
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    # The packed words carry the same (m, i).
    w = tops.vp_quant(torch.from_numpy(x), tf, tv, packed=True)
    wm, wi = tops._unpack_pair(w, None, tv)
    assert torch.equal(wm, m) and torch.equal(wi, i)


def _operands(shape, seed):
    """a like AGC-scaled W rows, b like AGC-scaled y columns (as in
    tests/test_batched_parity.py)."""
    *lead, M, K, N = shape
    rng = np.random.default_rng(seed)
    a = (rng.standard_t(2, (*lead, M, K)).clip(-8, 8) * 0.01).astype(
        np.float32)
    b = rng.standard_t(2, (*lead, K, N)).clip(-8, 8).astype(np.float32)
    return a, b


def _masks(lead, M, K, N, tiles, seed):
    bm, bk, bn = tiles
    rng = np.random.default_rng(seed)
    a_act = rng.integers(0, 2, (*lead, M // bm, K // bk)).astype(np.int32)
    b_act = rng.integers(0, 2, (*lead, K // bk, N // bn)).astype(np.int32)
    return a_act, b_act


def _run_both(kind, batched, a, b, masks, tiles):
    """(port output, [JAX interpret output, JAX ref output])."""
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    a_act, b_act = masks if masks is not None else (None, None)
    kw_t = dict(a_act=t(a_act), b_act=t(b_act), blocks=tiles)
    if kind == "fused":
        top = tops.vp_quant_matmul_batched if batched else tops.vp_quant_matmul
        jop = jops.vp_quant_matmul_batched if batched else jops.vp_quant_matmul
        got = top(t(a), t(b), TWF, TWV, TYF, TYV, **kw_t)
        wants = [jop(j(a), j(b), JWF, JWV, JYF, JYV, a_act=j(a_act),
                     b_act=j(b_act), blocks=tiles, interpret=interp)
                 for interp in (True, None)]
        return got, wants
    top = tops.vp_matmul_batched if batched else tops.vp_matmul
    jop = jops.vp_matmul_batched if batched else jops.vp_matmul
    ta, tb = tops.vp_quant(t(a), TWF, TWV), tops.vp_quant(t(b), TYF, TYV)
    if kind in ("packed", "mixed"):
        ta = (tops.vp_quant(t(a), TWF, TWV, packed=True), None)
    if kind == "packed":
        tb = (tops.vp_quant(t(b), TYF, TYV, packed=True), None)
    got = top(*ta, *tb, TWV, TYV, **kw_t)
    wants = []
    for interp in (True, None):
        ja = jops.vp_quant(j(a), JWF, JWV, interpret=interp,
                           packed=kind != "planes")
        jb = jops.vp_quant(j(b), JYF, JYV, interpret=interp,
                           packed=kind == "packed")
        ja = (ja, None) if kind != "planes" else ja
        jb = (jb, None) if kind == "packed" else jb
        wants.append(jop(*ja, *jb, JWV, JYV, a_act=j(a_act), b_act=j(b_act),
                         blocks=tiles, interpret=interp))
    return got, wants


# (kind, masked): every layout without masks; planes, packed and fused
# with CSPADE masks.
KINDS = [("planes", False), ("planes", True), ("packed", False),
         ("packed", True), ("mixed", False), ("fused", False),
         ("fused", True)]
BATCHED_SHAPES = {(1, 16, 64, 2): (8, 32, 2), (5, 16, 64, 2): (16, 16, 1),
                  (3, 13, 50, 1): (13, 25, 1)}
SHAPES = {(16, 64, 2): (8, 16, 1), (13, 50, 1): (13, 10, 1),
          (48, 64, 24): (16, 32, 8)}


@pytest.mark.parametrize("kind,masked", KINDS,
                         ids=[f"{k}-{'masks' if m else 'nomask'}"
                              for k, m in KINDS])
@pytest.mark.parametrize("shape", sorted(BATCHED_SHAPES), ids=str)
def test_vp_matmul_batched_ops(shape, kind, masked):
    G, M, K, N = shape
    a, b = _operands(shape, seed=G * 100 + M)
    tiles = BATCHED_SHAPES[shape] if masked else None
    masks = _masks((G,), M, K, N, tiles, seed=K) if masked else None
    got, wants = _run_both(kind, True, a, b, masks, tiles)
    assert got.dtype == torch.float32
    assert_close(got.numpy(), *wants)
    if kind == "fused":
        # On the plain path the fused op is quantize then matmul, exactly.
        planes, _ = _run_both("planes", True, a, b, masks, tiles)
        np.testing.assert_array_equal(got.numpy(), planes.numpy())


@pytest.mark.parametrize("kind,masked", KINDS,
                         ids=[f"{k}-{'masks' if m else 'nomask'}"
                              for k, m in KINDS])
@pytest.mark.parametrize("shape", sorted(SHAPES), ids=str)
def test_vp_matmul_ops(shape, kind, masked):
    M, K, N = shape
    a, b = _operands(shape, seed=M + N)
    tiles = SHAPES[shape] if masked else None
    masks = _masks((), M, K, N, tiles, seed=K + 1) if masked else None
    got, wants = _run_both(kind, False, a, b, masks, tiles)
    assert_close(got.numpy(), *wants)


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "batched"])
def test_cspade_tile_masks_exact(batched):
    shape = (6, 16, 64, 2) if batched else (32, 64, 8)
    tiles = (8, 16, 1) if batched else (8, 16, 4)
    a, b = _operands(shape, seed=11)
    ta = np.float32(np.quantile(np.abs(a), 0.99))
    tb = np.float32(np.quantile(np.abs(b), 0.99))
    tfn = tref.cspade_tile_masks_batched if batched else tref.cspade_tile_masks
    jfn = jref.cspade_tile_masks_batched if batched else jref.cspade_tile_masks
    got = tfn(torch.from_numpy(a), torch.from_numpy(b), *tiles,
              torch.tensor(ta), torch.tensor(tb))
    want = jfn(jnp.asarray(a), jnp.asarray(b), *tiles, jnp.float32(ta),
               jnp.float32(tb))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert 0 < int(g.sum()) < g.numel()      # both kinds of tile occur


@pytest.mark.parametrize("n", [1, 2, 7, 33, 100, 1000, 2048])
def test_quantile_linear_equals_jnp_quantile(n):
    x = np.abs(np.random.default_rng(n).standard_t(2, n)).astype(np.float32)
    for q in (0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0):
        got = quantile_linear(torch.from_numpy(x), q)
        assert got.dtype == torch.float32
        assert got.item() == float(jnp.quantile(jnp.asarray(x), q)), (n, q)


def test_heuristic_blocks_exact():
    dims = [0, 1, 2, 3, 13, 16, 50, 64, 100, 255, 256, 257, 2048, 100000]
    for M in dims:
        for K in dims[::3]:
            for N in dims[::2]:
                assert (tautotune.heuristic_blocks(M, K, N)
                        == jautotune.heuristic_blocks(M, K, N)), (M, K, N)


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "batched"])
def test_mask_shape_errors(batched):
    """Unpaired masks, ragged shapes and off-grid masks raise the
    reference's ValueErrors."""
    lead = (2,) if batched else ()
    a, b = _operands((*lead, 16, 64, 2), seed=3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    top = tops.vp_quant_matmul_batched if batched else tops.vp_quant_matmul
    jop = jops.vp_quant_matmul_batched if batched else jops.vp_quant_matmul
    good = _masks(lead, 16, 64, 2, (8, 32, 2), seed=0)
    cases = [
        ("come in pairs", (good[0], None), (8, 32, 2)),
        ("tile-aligned", good, (6, 32, 2)),
        ("do not match", good, (16, 32, 2)),
    ]
    for match, (a_act, b_act), tiles in cases:
        with pytest.raises(ValueError, match=match):
            top(ta, tb, TWF, TWV, TYF, TYV,
                a_act=torch.from_numpy(a_act),
                b_act=None if b_act is None else torch.from_numpy(b_act),
                blocks=tiles)
        with pytest.raises(ValueError, match=match):
            jop(ja, jb, JWF, JWV, JYF, JYV, a_act=jnp.asarray(a_act),
                b_act=None if b_act is None else jnp.asarray(b_act),
                blocks=tiles)


def test_mimo_ops_dispatch_by_device():
    """CPU tensors take the plain versions; tensors on two devices and
    non-f32 outputs on the kernel path are refused."""
    a, b = _operands((16, 64, 2), seed=5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with tops.force_backend("ref"):
        out = tops.vp_quant_matmul(ta, tb, TWF, TWV, TYF, TYV)
    np.testing.assert_array_equal(
        out.numpy(), tops.vp_quant_matmul(ta, tb, TWF, TWV, TYF, TYV).numpy())
    assert not tops.uses_kernel(ta, tb)
    with pytest.raises(ValueError, match="several devices"):
        tops.vp_quant_matmul(ta, tb.to("meta"), TWF, TWV, TYF, TYV)
