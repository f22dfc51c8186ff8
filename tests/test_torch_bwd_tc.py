"""The tensor-core body of `vp_matmul_dx` / `vp_matmul_dw` on the CPU: the
arithmetic it relies on, against the JAX package.

The body runs only on the card; these tests hold its plain statements:
  (a) every word of the port's formats dequantizes exactly into bf16
      (so `wgmma` on bf16 computes the reference's products), by the
      kernel's own decode (magic-number int -> float, scale table, high
      halves of the f32 bits), and `bwd_body` picks the tensor cores
      exactly where that holds (M <= 9);
  (b) the three-term bf16 split of an f32 g (a truncation) gives finite
      terms that sum back to g exactly, up to +-FLT_MAX;
  (c) the f32 path emulated (three bf16 products per 64-deep slice,
      summed in f32) agrees with the reference's oracles within 1e-5 of
      max|reference|, the kernel's own tolerance (F32_RTOL);
  (d) the tile planner fills the card or splits the contraction, and its
      grid covers every output element exactly once per contraction run.
Inputs are made with numpy from a seed.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.base import QuantConfig as JQuantConfig
from repro.core.formats import VPFormat as JVPFormat
from repro.kernels import ref as jref
from repro.mimo.equalizer import table1_specs as j_table1
from repro.models.layers import canonical_formats as j_canonical
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.core.formats import VPFormat
from repro_torch.core.packing import pack_vp, storage_dtype
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.vp_bwd_matmul import (
    TC_BK, TC_BM, TC_BN, TC_MAX_M, TilePlan, bwd_body, plan_tiles)
from repro_torch.mimo.equalizer import table1_specs as t_table1
from repro_torch.models.layers import canonical_formats as t_canonical

TFXP, TVP = t_canonical(TQuantConfig(mode="vp"))
JFXP, JVP = j_canonical(JQuantConfig(mode="vp"))
# Table I's B-VP formats: w VP(7,[11,9,7,6]) (int16), y VP(7,[1,-1]) (int8)
T_BVP, J_BVP = t_table1()[2], j_table1()[2]
FORMATS = {"canonical": (TVP, JVP), "table1_w": (T_BVP.w_vp, J_BVP.w_vp),
           "table1_y": (T_BVP.y_vp, J_BVP.y_vp)}
# (M tokens, K, N) of qwen3-0.6b's weights at batch 8 x seq 128, and the
# backward of ops.vp_quant_matmul at the MIMO shape (chip_smoke.py).
TRAIN_SHAPES = [(1024, 1024, 1024), (1024, 1024, 3072), (1024, 3072, 1024),
                (1024, 1024, 512)]
QMM_SHAPE = (2048, 64, 256)
# SMs of the H100 SXM (the card the port is measured on) and of the PCIe H100
SMS = {"h100_sxm": 132, "h100_pcie": 114}
SHAPES = [(8, 8, 8), (16, 24, 8), (16, 8, 24), (33, 40, 24), (70, 130, 200)]


def split_bf16(g: torch.Tensor):
    """f32 g -> (hi, mid, lo) bf16, each the high 16 bits of what the
    earlier terms left (a truncation): the tensor-core body's split of an
    f32 operand (csrc/vp_tc_mm.cuh: split8)."""
    r = g.to(torch.float32)
    terms = []
    for _ in range(3):
        t = (r.view(torch.int32) & -65536).view(torch.float32)
        terms.append(t.to(torch.bfloat16))   # exact: the low half is zero
        r = r - t
    return tuple(terms)


def tile_blocks(plan: TilePlan, R: int, C: int, S: int):
    """(output rows, output columns, contraction range) of every block of
    the plan's grid, by the kernel's index arithmetic (csrc/
    vp_bwd_matmul.cu: tc_body, tc_launch)."""
    nkb = -(-S // TC_BK)
    for z in range(plan.split):
        k0 = z * plan.kb_per * TC_BK
        k1 = min(nkb, (z + 1) * plan.kb_per) * TC_BK
        for by in range(-(-R // TC_BM)):
            for bx in range(-(-C // TC_BN)):
                yield (range(by * TC_BM, min(R, (by + 1) * TC_BM)),
                       range(bx * TC_BN, min(C, (bx + 1) * TC_BN)),
                       range(k0, min(S, k1)))


def all_words(fmt: VPFormat) -> torch.Tensor:
    """Every valid packed word of `fmt`: each significand with each index."""
    m = torch.arange(fmt.raw_min, fmt.raw_max + 1, dtype=torch.int32)
    m, i = torch.meshgrid(m, torch.arange(fmt.K, dtype=torch.int32),
                          indexing="ij")
    return pack_vp(m.reshape(-1), i.reshape(-1), fmt)


def kernel_decode_bf16(w: torch.Tensor, fmt: VPFormat) -> torch.Tensor:
    """The tensor-core body's word decode (csrc/vp_bwd_matmul.cu: WordDeq,
    pack_exact) in plain PyTorch: m = w >> E through the 1.5 * 2^23 magic
    number, times the 2^-f_i table, then the high 16 bits of the f32 as the
    bf16 (a truncation, which equals rounding only where the value is
    exact in bf16)."""
    w32 = w.to(torch.int32)
    m, i = w32 >> fmt.E, w32 & (fmt.K - 1)
    magic = (m + 0x4B400000).view(torch.float32) - 12582912.0
    tab = torch.tensor([2.0 ** -f for f in fmt.f], dtype=torch.float32)
    v = magic * tab[i.long()]
    hi = (v.view(torch.int32) >> 16) << 16
    return hi.view(torch.float32)


# -- (a) bf16 is exact for every word; the body choice -----------------------

@pytest.mark.parametrize("name", sorted(FORMATS))
def test_every_word_is_exact_in_bf16(name):
    """Each word's value: the kernel's bf16 decode == the f32 dequant ==
    the reference's dequant, for every valid word of the format."""
    tfmt, jfmt = FORMATS[name]
    assert tfmt.M <= TC_MAX_M
    w = all_words(tfmt)
    assert w.dtype == storage_dtype(tfmt)
    f32 = tref.vp_dequant_packed_ref(w, tfmt, torch.float32)
    bf16 = tref.vp_dequant_packed_ref(w, tfmt, torch.bfloat16)
    np.testing.assert_array_equal(bf16.float().numpy(), f32.numpy())
    np.testing.assert_array_equal(kernel_decode_bf16(w, tfmt).numpy(),
                                  f32.numpy())
    want = jref.vp_dequant_packed_ref(jnp.asarray(w.numpy()), jfmt)
    np.testing.assert_array_equal(f32.numpy(), np.asarray(want))


def test_ten_bit_significands_are_not_exact_in_bf16():
    """M = 10: some words need 9 significant bits, which bf16 rounds; the
    kernel's truncating decode would be wrong there too."""
    fmt = VPFormat(10, (12, 8))
    w = all_words(fmt)
    f32 = tref.vp_dequant_packed_ref(w, fmt, torch.float32)
    bf16 = tref.vp_dequant_packed_ref(w, fmt, torch.bfloat16).float()
    assert bool((bf16 != f32).any())
    assert bool((kernel_decode_bf16(w, fmt) != f32).any())


@pytest.mark.parametrize("M", range(2, 17))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_body_is_tensor_core_iff_significand_fits(M, dtype):
    fmt = VPFormat(M, (M + 4, M + 1))
    want = "tensor_core" if M <= 9 else "cuda_core"
    assert bwd_body(dtype, fmt) == want


def test_bwd_body_rejects_other_dtypes():
    with pytest.raises(ValueError):
        bwd_body(torch.float16, TVP)


def test_magic_number_int_to_float():
    """1.5 * 2^23 + m as f32 bits, minus 1.5 * 2^23, is m for |m| < 2^22
    (the kernel uses it for |m| <= 2^15)."""
    m = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32)
    got = (m + 0x4B400000).view(torch.float32) - 12582912.0
    np.testing.assert_array_equal(got.numpy(), m.numpy().astype(np.float32))


# -- (b) the three-term split ------------------------------------------------

# |g| in [2^-110, FLT_MAX]: the split is exact over the whole range
_NORMAL = st.tuples(st.integers(-110, 127), st.integers(0, 2 ** 23 - 1),
                    st.booleans())


@settings(max_examples=200, deadline=None)
@given(st.lists(_NORMAL, min_size=1, max_size=64))
def test_split_bf16_sums_back_exactly(parts):
    """hi + mid + lo == g for f32 g of exponent -110 to 127, any
    significand, either sign; each term is a finite bf16 and each partial
    sum is exact in f32."""
    bits = [(int(s) << 31) | ((e + 127) << 23) | frac for e, frac, s in parts]
    g = torch.tensor(np.array(bits, dtype=np.uint32).view(np.float32))
    hi, mid, lo = split_bf16(g)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert all(bool(torch.isfinite(t).all()) for t in (hi, mid, lo))
    total = hi.float() + mid.float() + lo.float()
    np.testing.assert_array_equal(total.numpy(), g.numpy())


def test_split_bf16_zeros_and_signs():
    fmax = float(np.finfo(np.float32).max)
    g = torch.tensor([0.0, -0.0, 1.0, -1.0, 3.0e38, -3.0e38, 1e-30,
                      -1e-30, 1.0 + 2.0 ** -23, fmax, -fmax, 3.4e38,
                      -3.4e38], dtype=torch.float32)
    hi, mid, lo = split_bf16(g)
    assert all(bool(torch.isfinite(t).all()) for t in (hi, mid, lo))
    total = hi.float() + mid.float() + lo.float()
    np.testing.assert_array_equal(total.numpy(), g.numpy())
    assert (torch.signbit(hi[:2]) == torch.signbit(g[:2])).all()


# -- (c) the f32 path emulated against the reference -------------------------

def _words(rng, shape, fxp, vp):
    x = rng.normal(0.0, 0.3, shape).clip(-0.99, 0.99).astype(np.float32)
    return tops.vp_quant(torch.from_numpy(x), fxp, vp, packed=True)


def tc_emulate(a_real: torch.Tensor, b_real: torch.Tensor,
               split: str) -> torch.Tensor:
    """(R, S) @ (S, C) as the tensor-core body sums an f32 g (operand
    `split`, "a" or "b") against dequantized words: per 64-deep slice, the
    three bf16 terms' exact products summed in f32 (a slice's partial),
    the partials summed in f32 in slice order."""
    R, S = a_real.shape
    acc = torch.zeros((R, b_real.shape[1]), dtype=torch.float32)
    for s0 in range(0, S, TC_BK):
        a_s, b_s = a_real[:, s0:s0 + TC_BK], b_real[s0:s0 + TC_BK]
        if split == "a":
            acc += sum(t.float() @ b_s for t in split_bf16(a_s))
        else:
            acc += sum(a_s @ t.float() for t in split_bf16(b_s))
    return acc


def assert_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("mkn", SHAPES)
def test_f32_split_path_dx(mkn):
    """dx = g @ dequant(w)^T with g split: within 1e-5 of max|ref|."""
    M, K, N = mkn
    rng = np.random.default_rng(M * 100 + K)
    g = rng.normal(size=(M, N)).astype(np.float32)
    w = _words(rng, (K, N), TFXP, TVP)
    w_real = tref.vp_dequant_packed_ref(w, TVP, torch.float32)
    # the words' side: a bf16 tile, exact; g's side: the three terms
    got = tc_emulate(torch.from_numpy(g), w_real.t().contiguous(),
                     "a").numpy()
    assert_close(got, jref.vp_matmul_dx_ref(jnp.asarray(g),
                                            jnp.asarray(w.numpy()), JVP))


@pytest.mark.parametrize("mkn", SHAPES)
def test_f32_split_path_dw(mkn):
    """dw = dequant(a)^T @ g with g split: within 1e-5 of max|ref|."""
    M, K, N = mkn
    rng = np.random.default_rng(M * 100 + N)
    a = _words(rng, (M, K), TFXP, TVP)
    g = rng.normal(size=(M, N)).astype(np.float32)
    a_real = tref.vp_dequant_packed_ref(a, TVP, torch.float32)
    got = tc_emulate(a_real.t().contiguous(), torch.from_numpy(g),
                     "b").numpy()
    assert_close(got, jref.vp_matmul_dw_ref(jnp.asarray(a.numpy()),
                                            jnp.asarray(g), JVP))


# -- (d) the tile planner -------------------------------------------------------

def _products(M, K, N):
    """(R, C, S) of dx and of dw for a (M, K, N) product."""
    return {"dx": (M, K, N), "dw": (K, N, M)}


@pytest.mark.parametrize("mkn", TRAIN_SHAPES + [QMM_SHAPE])
@pytest.mark.parametrize("card", SMS)
def test_plan_fills_the_card_and_covers_the_output(mkn, card):
    num_sms = SMS[card]
    for R, C, S in _products(*mkn).values():
        plan = plan_tiles(R, C, S, num_sms)
        blocks = list(tile_blocks(plan, R, C, S))
        tiles = len(blocks) // plan.split
        nkb = -(-S // TC_BK)
        assert plan.split == 1 or len(blocks) <= num_sms   # one wave
        # unsplit only where a second run would not fit beside the first
        assert plan.split > 1 or nkb == 1 or 2 * tiles > num_sms
        if num_sms == 132:
            assert len(blocks) >= 128 or plan.split > 1
        cover = np.zeros((R, C), dtype=np.int32)
        runs = {}
        for rows, cols, ks in blocks:
            assert len(rows) and len(cols) and len(ks)
            cover[rows.start:rows.stop, cols.start:cols.stop] += 1
            runs.setdefault((rows.start, cols.start), []).append(ks)
        assert (cover == plan.split).all()
        for ks in runs.values():      # the contraction runs partition [0, S)
            ks = sorted(ks, key=lambda r: r.start)
            assert ks[0].start == 0 and ks[-1].stop == S
            assert all(x.stop == y.start for x, y in zip(ks, ks[1:]))
            assert all(r.start % TC_BK == 0 for r in ks)


@pytest.mark.parametrize("R,C,S", list(itertools.product(
    (1, 64, 130, 1000), (1, 100, 1024), (1, 63, 3000))))
def test_plan_ragged_shapes(R, C, S):
    """Ragged shapes: every element once per run, tiles of TC_BM rows."""
    plan = plan_tiles(R, C, S, SMS["h100_sxm"])
    cover = np.zeros((R, C), dtype=np.int32)
    for rows, cols, ks in tile_blocks(plan, R, C, S):
        assert len(rows) <= TC_BM and len(cols) <= TC_BN
        cover[rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (cover == plan.split).all()


def test_jax_and_port_formats_match():
    """The formats the tests pair are the same on both sides."""
    for tfmt, jfmt in FORMATS.values():
        assert isinstance(jfmt, JVPFormat)
        assert (tfmt.M, tuple(tfmt.f)) == (jfmt.M, tuple(jfmt.f))
