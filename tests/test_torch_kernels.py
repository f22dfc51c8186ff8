"""Plain versions of the port's kernels against the JAX package: its
Pallas bodies in interpret mode and its reference oracles.

Float reductions are compared at rtol 1e-5 and atol 1e-5 * max|out|:
the reference's own Pallas body differs from its oracle by 2.9e-6 at
(33, 96, 24), so 1e-6 is out of reach for any summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as JQuantConfig
from repro.kernels import ops as jops
from repro.models.layers import canonical_formats as j_canonical
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.kernels import ops as tops
from repro_torch.models.layers import canonical_formats as t_canonical

JFXP, JVP = j_canonical(JQuantConfig(mode="vp"))
TFXP, TVP = t_canonical(TQuantConfig(mode="vp"))


def assert_close(got, *wants):
    for want in wants:
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(
            got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def _words(rng, shape):
    """Packed words of random weights in (-1, 1), int16."""
    x = rng.normal(0.0, 0.3, shape).clip(-0.99, 0.99).astype(np.float32)
    return tops.vp_quant(torch.from_numpy(x), TFXP, TVP, packed=True).numpy()


@pytest.mark.parametrize("mkn", [(4, 64, 128), (16, 64, 192), (33, 96, 24)])
def test_vp_dequant_matmul(mkn):
    M, K, N = mkn
    rng = np.random.default_rng(M * 1000 + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = _words(rng, (K, N))
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    got = tops.vp_dequant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                 TVP).numpy()
    assert_close(got, jops.vp_dequant_matmul(jx, jw, JVP),
                 jops.vp_dequant_matmul(jx, jw, JVP, interpret=True))


DECODE_CASES = {
    "full": dict(smax=24, lengths=[5, 17], window=None, rolling=False),
    "window": dict(smax=24, lengths=[5, 20], window=8, rolling=False),
    "rolling": dict(smax=16, lengths=[30, 12], window=16, rolling=True),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_vp_decode_attention(case):
    c = DECODE_CASES[case]
    B, H, KV, dh, smax = 2, 4, 2, 16, c["smax"]     # G = 2 (GQA)
    rng = np.random.default_rng(len(case))
    q = rng.normal(size=(B, 1, H, dh)).astype(np.float32)
    k_w = _words(rng, (B, smax, KV, dh))
    v_w = _words(rng, (B, smax, KV, dh))
    k_s = (2.0 ** rng.integers(-3, 3, (B, smax, 1, 1))).astype(np.float32)
    v_s = (2.0 ** rng.integers(-3, 3, (B, smax, 1, 1))).astype(np.float32)
    lengths = np.asarray(c["lengths"], np.int32)
    args = (q, k_w, v_w, k_s, v_s, lengths)
    kw = dict(window=c["window"], rolling=c["rolling"])
    got = tops.vp_decode_attention(
        *map(torch.from_numpy, args), TVP, **kw).numpy()
    jargs = tuple(map(jnp.asarray, args))
    assert_close(got, jops.vp_decode_attention(*jargs, JVP, **kw),
                 jops.vp_decode_attention(*jargs, JVP, interpret=True, **kw))


PREFILL_CASES = {
    "causal": dict(S=32, pattern="causal", window=None),
    "local": dict(S=32, pattern="local", window=8),
    "ragged": dict(S=37, pattern="causal", window=None),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_flash_prefill(case):
    c = PREFILL_CASES[case]
    B, H, KV, dh, S = 2, 4, 2, 16, c["S"]
    rng = np.random.default_rng(S + len(case))
    q = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, dh)).astype(np.float32)
    kw = dict(pattern=c["pattern"], window=c["window"])
    got = tops.flash_prefill(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    assert_close(got, jops.flash_prefill(jq, jk, jv, **kw),
                 jops.flash_prefill(jq, jk, jv, interpret=True, **kw))


def test_force_backend_and_device_dispatch():
    """CPU tensors take the plain versions; only "ref" can be forced."""
    x = torch.zeros((2, 3))
    w = torch.zeros((3, 4), dtype=torch.int16)
    with tops.force_backend("ref"):
        assert tops.vp_dequant_matmul(x, w, TVP).shape == (2, 4)
    with pytest.raises(ValueError):
        with tops.force_backend("cuda"):
            pass
    with pytest.raises(ValueError):
        tops.vp_dequant_matmul(x, w.to("meta"), TVP)
