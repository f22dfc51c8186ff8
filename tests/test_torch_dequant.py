"""`ops.vp_dequant` of the port against the JAX package: two-plane and
packed-word dequantization, f32 and bf16, and its argument and format
checks.

Inputs are made with numpy and fed to both packages; the JAX side runs
its oracle (ref backend) and its Pallas bodies (`interpret=True`).  Every
VP value m * 2^-f is exact in f32 and, for VP(7, ...) and VP(6, ...), in
bf16, so every comparison is bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.contracts import VPContractError as JContractError
from repro.core.formats import FXPFormat as JFXP
from repro.core.formats import VPFormat as JVPFormat
from repro.core.formats import default_vp_format as j_default_vp
from repro.kernels import ops as jops
from repro_torch.analysis.contracts import VPContractError
from repro_torch.core.formats import FXPFormat as TFXP
from repro_torch.core.formats import VPFormat as TVPFormat
from repro_torch.core.formats import default_vp_format as t_default_vp
from repro_torch.kernels import ops as tops

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
SHAPES = [(33, 70), (2, 5, 12)]


def _formats(M):
    """VP(M, E=2) on FXP(12, 11): int16 words for M = 7, int8 for M = 6."""
    return (j_default_vp(JFXP(12, 11), M, 2),
            t_default_vp(TFXP(12, 11), M, 2))


def _bits(x):
    """Exact f32 bit patterns of a torch or JAX result (bf16 widens
    exactly), so +0 and -0 differ too."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32).view(np.uint32)


def _words(rng, jvp, shape):
    """Packed words of every (m, i) pair the format holds, plus random
    ones, in the format's storage dtype."""
    m = rng.integers(jvp.raw_min, jvp.raw_max + 1, shape)
    i = rng.integers(0, jvp.K, shape)
    flat_m, flat_i = m.reshape(-1), i.reshape(-1)
    n = min(flat_m.size, (jvp.raw_max - jvp.raw_min + 1))
    flat_m[:n] = np.arange(jvp.raw_min, jvp.raw_min + n)
    flat_i[:n] = np.arange(n) % jvp.K
    words = m * (1 << jvp.E) + i
    dt = {8: np.int8, 16: np.int16, 32: np.int32}[jvp.storage_bits]
    return m.astype(np.int8), i.astype(np.uint8), words.astype(dt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("M", [7, 6])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_vp_dequant_bit_exact(shape, M, dtype):
    jvp, tvp = _formats(M)
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(M * 100 + len(shape))
    m, i, w = _words(rng, jvp, shape)
    got_planes = tops.vp_dequant(torch.from_numpy(m), torch.from_numpy(i),
                                 tvp, dtype=tdt)
    got_packed = tops.vp_dequant(torch.from_numpy(w), None, tvp, dtype=tdt)
    assert got_planes.dtype == got_packed.dtype == tdt
    assert tuple(got_planes.shape) == tuple(got_packed.shape) == shape
    jm, ji, jw = map(jnp.asarray, (m, i, w))
    want = _bits(jops.vp_dequant(jm, ji, jvp, jdt))
    for got in (got_planes, got_packed):
        np.testing.assert_array_equal(_bits(got), want)
    np.testing.assert_array_equal(
        _bits(jops.vp_dequant(jw, None, jvp, jdt)), want)
    if len(shape) == 2:
        for interp in (jops.vp_dequant(jm, ji, jvp, jdt, interpret=True),
                       jops.vp_dequant(jw, None, jvp, jdt, interpret=True)):
            np.testing.assert_array_equal(_bits(interp), want)


def test_vp_dequant_format_slot_type_error():
    """The format is the third argument: in the index slot, or missing,
    it raises TypeError in both packages."""
    jvp, tvp = _formats(7)
    _, _, w = _words(np.random.default_rng(0), jvp, (4, 4))
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    for call in (lambda: tops.vp_dequant(tw, tvp),
                 lambda: tops.vp_dequant(tw, None)):
        with pytest.raises(TypeError, match="THIRD argument"):
            call()
    for call in (lambda: jops.vp_dequant(jw, jvp),
                 lambda: jops.vp_dequant(jw, None)):
        with pytest.raises(TypeError):
            call()


@pytest.mark.parametrize("M,f", [(7, (11, 9, 8, 6)), (7, (130, 9)),
                                 (7, (-128, -130)), (12, (11, 9, 8, 6)),
                                 (5, (20, 10))])
def test_vp_dequant_contract_matches_reference(M, f):
    """A format whose scales leave the f32 normal range, or whose fields
    overflow the packed word, raises in the port exactly where the
    reference raises."""
    jvp, tvp = JVPFormat(M, f), TVPFormat(M, f)
    m = np.zeros((2, 3), np.int8)
    i = np.zeros((2, 3), np.uint8)
    try:
        jops.vp_dequant(jnp.asarray(m), jnp.asarray(i), jvp)
        ref_raises = False
    except JContractError:
        ref_raises = True
    if ref_raises:
        with pytest.raises(VPContractError):
            tops.vp_dequant(torch.from_numpy(m), torch.from_numpy(i), tvp)
    else:
        tops.vp_dequant(torch.from_numpy(m), torch.from_numpy(i), tvp)
