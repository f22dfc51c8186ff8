"""The port's VP format core against the JAX package, bit for bit.

Inputs are made with numpy from a fixed seed and handed to both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import packing as jpacking
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import formats as tformats
from repro_torch.core import packing as tpacking
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# (M, E) -> int16 words for (7, 2), int8 words for (6, 2).
FORMATS = [(7, 2), (6, 2)]


def _formats(M, E, W=12):
    jf = jformats.FXPFormat(W, W - 1)
    tf = tformats.FXPFormat(W, W - 1)
    return (jf, jformats.default_vp_format(jf, M, E),
            tf, tformats.default_vp_format(tf, M, E))


def _inputs(fxp_F: int, seed: int = 0) -> np.ndarray:
    """Random values, exact ties (k + 0.5) 2^-F, and values past the
    saturation range, shaped (R, C) with a ragged width."""
    rng = np.random.default_rng(seed)
    rand = rng.normal(0.0, 0.3, 300)
    ks = rng.integers(-2048, 2048, 200)
    ties = (ks + 0.5) * 2.0 ** -fxp_F
    big = rng.choice([-1, 1], 40) * rng.uniform(1.0, 8.0, 40)
    edge = np.array([0.0, -0.0, 1.0, -1.0, 0.999, -0.9995, 2.0 ** -12,
                     -(2.0 ** -12), 0.5 * 2.0 ** -fxp_F,
                     1.5 * 2.0 ** -fxp_F, -2.5 * 2.0 ** -fxp_F])
    x = np.concatenate([rand, ties, big, edge]).astype(np.float32)
    x = np.resize(x, 37 * 15)
    return x.reshape(37, 15)


def test_default_vp_format_matches_reference():
    for W in range(4, 17):
        for F in range(0, W):
            for M in range(2, 9):
                for E in range(0, 4):
                    jf = jformats.default_vp_format(
                        jformats.FXPFormat(W, F), M, E)
                    tf = tformats.default_vp_format(
                        tformats.FXPFormat(W, F), M, E)
                    assert (tf.M, tf.f) == (jf.M, jf.f), (W, F, M, E)


@pytest.mark.parametrize("M,E", FORMATS)
def test_packed_quantize_bit_exact(M, E):
    jfxp, jvp, tfxp, tvp = _formats(M, E)
    assert tpacking.storage_dtype(tvp) == {7: torch.int16,
                                           6: torch.int8}[M]
    x = _inputs(tfxp.F, seed=M)
    want_ref = np.asarray(jref.vp_quant_packed_ref(jnp.asarray(x), jfxp, jvp))
    want_kernel = np.asarray(jops.vp_quant(
        jnp.asarray(x), jfxp, jvp, interpret=True, packed=True))
    got = tops.vp_quant(torch.from_numpy(x), tfxp, tvp, packed=True).numpy()
    assert got.dtype == want_ref.dtype
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_kernel)


def test_quantize_rounds_half_to_even():
    jfxp, jvp, tfxp, tvp = _formats(7, 2)
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5], np.float32) * 2.0 ** -tfxp.F
    got = tref.vp_quant_packed_ref(torch.from_numpy(x), tfxp, tvp)
    m, _ = tpacking.unpack_vp(got, tvp)
    assert m.tolist() == [0, 2, 2, 0, -2]


@pytest.mark.parametrize("M,E", FORMATS)
def test_dequant_words_bit_exact(M, E):
    jfxp, jvp, tfxp, tvp = _formats(M, E)
    rng = np.random.default_rng(M)
    bits = tvp.storage_bits
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1))
    w = rng.integers(lo, hi, (41, 9)).astype(
        np.int16 if bits == 16 else np.int8)
    want = np.asarray(jpacking.dequant_words(jnp.asarray(w), jvp))
    got = tpacking.dequant_words(torch.from_numpy(w), tvp).numpy()
    np.testing.assert_array_equal(got, want)
    # On words a quantizer can emit (M + E significant bits), the
    # unpack/scale path (non-f32 consumers) gives the same values.
    half = 1 << (M + E - 1)
    wv = rng.integers(-half, half, (41, 9)).astype(w.dtype)
    want = np.asarray(jpacking.dequant_words(jnp.asarray(wv), jvp))
    got64 = tpacking.dequant_words(torch.from_numpy(wv), tvp,
                                   torch.float64).numpy()
    np.testing.assert_array_equal(got64.astype(np.float32), want)
