"""The redesigned vp_block path on the CPU: the activation
block-quantizer op against the JAX package, and the plain statements of
the `block_vp_matmul` bodies.

  (a) `ops.block_vp_quant` is bit for bit the reference's
      `block_vp_quantize(x / _pow2_scale(x))` (significands, indices and
      scale) at axis -1 and 0, blocks 16, 64, 256 and 512 (on the card
      axis 0 at 16 and 512 takes the general body), on heavy-tailed data,
      an all-zero tensor, a zero block, values that saturate FXP and an
      amax just above 2^k;
  (b) `block_body` picks the skinny body at every decode shape and for
      `lm_head`, the tensor-core body for prefill, dp4a for the rest;
  (c) the skinny body's split plan cuts only at k-tile boundaries, into
      at most min(nk, 8) blocks of at most 4 tile groups, whose runs
      cover every tile once, in order;
  (d) mirrors of the skinny body's arithmetic (the 4 x 4 byte transpose
      into __dp4a layout, the reduce-scatter over a warp's k lanes, the
      per-tile terms summed in tile order across the split) against the
      JAX function on numpy-made operands: bit-identical in f32;
  (e) `qdot` in vp_block on the SMOKE config's weights equals the
      reference's.
Inputs are made with numpy and fed to both packages; the JAX side runs
as its own tests run it on the CPU (its ops dispatch to the oracles).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import quantize as jquant
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.core.quantize import block_vp_quantize
from repro_torch.kernels import ops as tops
from repro_torch.kernels.vp_block_matmul import (
    BK, SK_COLS, SK_MAX_SPLIT, SK_TERMS, SKINNY_MAX_M, block_body,
    plan_skinny)
from repro_torch.models import layers as tlayers
from repro_torch.models.weights import params_from_numpy

ARCH = "qwen3-0.6b"
JFXP, JVP = jlayers.canonical_formats(JQuantConfig(mode="vp_block"))
TFXP, TVP = tlayers.canonical_formats(TQuantConfig(mode="vp_block"))
SMS = 132   # the H100 SXM the port is measured on
# (M, K, N) of qwen3-0.6b's weight matmuls: decode at batch 4 (w_up /
# w_gate, w_down, q / o, k / v, lm_head), prefill at 4 x 128 tokens
DECODE = [(4, 1024, 3072), (4, 3072, 1024), (4, 1024, 1024), (4, 1024, 512),
          (4, 1024, 151936)]
PREFILL = [(512, 1024, 3072), (512, 3072, 1024), (512, 1024, 1024),
           (512, 1024, 512)]


# -- (a) the quantizer --------------------------------------------------------

def _data(case, shape, rng):
    x = (rng.standard_t(3, size=shape) * 0.7).astype(np.float32)
    if case == "zero":
        return np.zeros(shape, np.float32)
    if case == "zero_block":
        x.reshape(-1)[:256] = 0.0        # a whole block at either axis...
        if shape[0] > shape[1]:
            x[:256, 0] = 0.0             # ...along the rows for axis 0
    elif case == "saturate":
        x.reshape(-1)[::7] = 40.0        # past FXP(12, 11) after scaling
        x.reshape(-1)[3::7] = 2e-6       # below its grid
    elif case.startswith("above_2^"):
        # amax one ulp above 2^k: at k = 4 f32's log2 rounds to k (the
        # scale is 2^k, below amax), at the others it does not
        k = int(case.split("^")[1])
        x = x / np.abs(x).max() * np.float32(2.0 ** k)
        x.reshape(-1)[5] = np.float32(2.0 ** k) * np.float32(1 + 2.0 ** -23)
    return x


@pytest.mark.parametrize("case", ["heavy", "zero", "zero_block", "saturate",
                                  "above_2^-3", "above_2^2", "above_2^4"])
@pytest.mark.parametrize("block", [16, 64, 256, 512])
@pytest.mark.parametrize("axis", [-1, 0])
def test_block_vp_quant_matches_reference(axis, block, case):
    shape = (6, 512) if axis == -1 else (512, 24)
    x = _data(case, shape, np.random.default_rng(block + axis))
    js = jlayers._pow2_scale(jnp.asarray(x))
    jm, ji = jquant.block_vp_quantize(jnp.asarray(x) / js, JFXP, JVP, block,
                                      axis=axis)
    tm, ti, ts = tops.block_vp_quant(torch.from_numpy(x), TFXP, TVP, block,
                                     axis=axis)
    assert tm.dtype == torch.int8 and ti.dtype == torch.uint8
    assert ts.dtype == torch.float32 and ts.ndim == 0
    assert float(ts) == float(js)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_block_vp_quant_takes_math_dtype():
    """A bf16 x with f32 math (qdot's activations) is the f32 x's result;
    with its own math (a weight's export) the scale and the quotient are
    taken in bf16, as `quantize_weight` takes them."""
    x = np.random.default_rng(1).normal(size=(4, 256)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = tops.block_vp_quant(xb.float(), TFXP, TVP, 64)
    got = tops.block_vp_quant(xb, TFXP, TVP, 64, math_dtype=torch.float32)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    wb = xb.t().contiguous()              # (d_in, d_out), blocks on d_in
    m, i, s = tops.block_vp_quant(wb, TFXP, TVP, 64, axis=0)
    sb = tlayers.pow2_scale(wb)
    assert sb.dtype == torch.bfloat16 and float(s) == float(sb)
    wm, wi = block_vp_quantize((wb / sb).float(), TFXP, TVP, 64, axis=0)
    assert torch.equal(m, wm) and torch.equal(i, wi)


# -- (b) the body -------------------------------------------------------------

@pytest.mark.parametrize("mkn", DECODE + PREFILL, ids=str)
def test_block_body_on_the_main_path(mkn):
    """Decode and lm_head (M = 4) on the skinny body, prefill's layer
    weights (M = 512) on the tensor cores."""
    M, K, N = mkn
    assert block_body(M, K, N, BK) == ("skinny" if M <= SKINNY_MAX_M
                                       else "tensor_core")
    assert block_body(M, K, N, BK) == ("skinny" if M == 4 else "tensor_core")


@pytest.mark.parametrize("M,K,N,bk,aligned,want", [
    (4, 1024, 3072, 64, True, "dp4a"),        # bk other than 256
    (4, 256, 131, 256, True, "dp4a"),         # N % 16 != 0
    (512, 256, 131, 256, True, "dp4a"),
    (4, 1024, 3072, 256, False, "dp4a"),      # unaligned operands
    (SKINNY_MAX_M, 1024, 48, 256, True, "skinny"),
    (SKINNY_MAX_M + 1, 1024, 48, 256, True, "tensor_core"),
    (1, 256, 16, 256, True, "skinny")])
def test_block_body_edges(M, K, N, bk, aligned, want):
    assert block_body(M, K, N, bk, aligned) == want


# -- (c) the skinny split plan ------------------------------------------------

def split_tiles(nk, runs):
    """The k-tiles [lo, hi) of each run, as the skinny kernel takes them
    (csrc/vp_block_matmul.cu: run r = z G + g, of runs = split x G,
    holds [r nk / runs, (r + 1) nk / runs))."""
    return [(r * nk // runs, (r + 1) * nk // runs) for r in range(runs)]


@pytest.mark.parametrize("mkn", DECODE + [(1, 256, 64), (8, 8192, 1024),
                                          (3, 65536, 64), (7, 2048, 4096),
                                          (4, 768, 64), (8, 3072, 1024)],
                         ids=str)
def test_skinny_split_plan_cuts_at_tiles(mkn):
    M, K, N = mkn
    nk = K // BK
    p = plan_skinny(M, K, N, SMS)
    runs = p.split * p.tile_groups
    assert 1 <= p.split <= min(nk, SK_MAX_SPLIT)
    assert p.tile_groups in (1, 2, 4) and runs <= nk
    assert p.tile_groups < 4 or p.mt <= 4       # 8 rows x 4 groups spills
    spans = split_tiles(nk, runs)
    # consecutive runs of whole tiles that cover 0 .. nk once, in order
    assert spans[0][0] == 0 and spans[-1][1] == nk
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(hi > lo for lo, hi in spans)
    # a block's runs are consecutive: its tiles [z nk / split, ...)
    for z in range(p.split):
        block = spans[z * p.tile_groups:(z + 1) * p.tile_groups]
        assert block[0][0] == z * nk // p.split
        assert block[-1][1] == (z + 1) * nk // p.split
        if runs > 1:
            assert block[-1][1] - block[0][0] <= SK_TERMS
    assert p.mt >= min(M, 8) and p.mt * p.m_chunks >= M
    assert p.groups * SK_COLS >= N
    if (M, K, N) == (4, 3072, 1024):     # w_down: 3 blocks x 4 groups
        assert (p.groups, p.split, p.tile_groups) == (32, 3, 4)
    if (M, K, N) == (4, 1024, 3072):     # w_up: 4 groups, no cluster
        assert (p.split, p.tile_groups) == (1, 4)
    if (M, K, N) == (4, 1024, 151936):   # lm_head: no split at all
        assert (p.split, p.tile_groups) == (1, 1)


# -- (d) mirrors of the skinny body's arithmetic ------------------------------

def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 numpy arrays."""
    src = [(x >> (8 * k)) & 0xFF for k in range(4)] + \
          [(y >> (8 * k)) & 0xFF for k in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 0xF] << (8 * i)
    return out


def _transpose4(w0, w1, w2, w3):
    """csrc/vp_block_matmul.cu:transpose4."""
    t0, t1 = _byte_perm(w0, w1, 0x5140), _byte_perm(w0, w1, 0x7362)
    t2, t3 = _byte_perm(w2, w3, 0x5140), _byte_perm(w2, w3, 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def test_transpose4_is_a_byte_transpose():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 2 ** 32, size=(4, 1000), dtype=np.uint64)
    cols = _transpose4(*rows)
    for j in range(4):
        for r in range(4):
            np.testing.assert_array_equal((cols[j] >> (8 * r)) & 0xFF,
                                          (rows[r] >> (8 * j)) & 0xFF)


CT = SK_COLS // 16   # column threads of a skinny block: the low lane bits


def _reduce_scatter(s):
    """csrc/vp_block_matmul.cu:scatter over lane bits CT .. 16: s (32
    lanes, V) -> each lane's V CT / 32 sums and the index of its first."""
    s = s.copy()
    lanes = np.arange(32)
    V = s.shape[1]
    base = np.zeros(32, np.int64)
    o, cur = CT, V
    while o <= 16:
        up = (lanes & o) != 0
        h = cur // 2
        give = np.where(up[:, None], s[:, :h], s[:, h:cur])
        keep = np.where(up[:, None], s[:, h:cur], s[:, :h])
        s[:, :h] = keep + give[lanes ^ o]
        base += np.where(up, h, 0)
        o, cur = 2 * o, h
    return s[:, :cur], base


@pytest.mark.parametrize("mt", [1, 2, 4, 8])
def test_reduce_scatter_sums_each_value_once(mt):
    V, kl = mt * 16, 32 // CT
    s = np.random.default_rng(mt).integers(-2 ** 20, 2 ** 20, (32, V))
    got, base = _reduce_scatter(s)
    for ct in range(CT):                  # the k lanes of one column thread
        lanes = [ct + CT * q for q in range(kl)]
        want = s[lanes].sum(0)
        held = np.concatenate([base[ln] + np.arange(V // kl)
                               for ln in lanes])
        assert sorted(held) == list(range(V))
        for ln in lanes:
            np.testing.assert_array_equal(
                got[ln], want[base[ln]:base[ln] + V // kl])


def _skinny_mirror(a_m, a_i, b_m, b_i, runs):
    """The skinny body's arithmetic in numpy: per tile, each thread's
    (ct, L) words transposed into __dp4a layout and dotted with x's
    words; the 64 k lanes summed in int32; the tile's f32 term; the terms
    of every run added in tile order from +0."""
    M, K = a_m.shape
    N = b_m.shape[1]
    nk = K // BK
    lut = np.array([2.0 ** -f for f in TVP.f], np.float32)
    terms = np.zeros((nk, M, N), np.float32)
    for t in range(nk):
        isum = np.zeros((M, N), np.int64)
        for L in range(BK // 4):
            k0 = t * BK + 4 * L
            rows = b_m[k0:k0 + 4].view(np.uint8).astype(np.uint64)
            words = [(rows[r, 0::4] | rows[r, 1::4] << 8 | rows[r, 2::4] << 16
                      | rows[r, 3::4] << 24) for r in range(4)]
            cols = _transpose4(*words)       # cols[j][q]: column 4 q + j
            xw = a_m[:, k0:k0 + 4].astype(np.int64)
            for j in range(4):
                c = cols[j]
                wb = np.stack([((c >> (8 * r)) & 0xFF).astype(np.int64)
                               for r in range(4)], 1)
                wb = np.where(wb > 127, wb - 256, wb)   # signed bytes
                isum[:, j::4] += xw @ wb.T
        terms[t] = (isum.astype(np.float32) * lut[a_i[:, t]][:, None]
                    * lut[b_i[t]][None, :])
    out = np.zeros((M, N), np.float32)
    for lo, hi in split_tiles(nk, runs):
        for t in range(lo, hi):
            out = out + terms[t]
    return out


@pytest.mark.parametrize("mkn,runs", [((4, 1024, 64), 4), ((3, 3072, 32), 12),
                                      ((1, 512, 48), 1)], ids=str)
def test_skinny_mirror_bit_identical_to_reference(mkn, runs):
    M, K, N = mkn
    rng = np.random.default_rng(K + N)
    a_m = rng.integers(JVP.raw_min, JVP.raw_max + 1, (M, K)).astype(np.int8)
    b_m = rng.integers(JVP.raw_min, JVP.raw_max + 1, (K, N)).astype(np.int8)
    a_i = rng.integers(0, JVP.K, (M, K // BK)).astype(np.uint8)
    b_i = rng.integers(0, JVP.K, (K // BK, N)).astype(np.uint8)
    want = np.asarray(jref.block_vp_matmul_ref(
        *map(jnp.asarray, (a_m, a_i, b_m, b_i)), JVP, JVP, bk=BK))
    got = _skinny_mirror(a_m, a_i, b_m, b_i, runs)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# -- (e) qdot on the SMOKE config ---------------------------------------------

def test_qdot_vp_block_on_smoke_weights():
    """Every layer-0 weight of the SMOKE config, exported and applied by
    both packages (block 64: the config's widths), bit for bit."""
    jq = JQuantConfig(mode="vp_block", block=64)
    tq = TQuantConfig(mode="vp_block", block=64)
    jcfg = jregistry.get_smoke_config(ARCH, jq)
    tcfg = tregistry.get_smoke_config(ARCH, tq)
    jp = jmodel.init_params(jax.random.PRNGKey(3), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           "cpu")
    rng = np.random.default_rng(4)
    for part in ("attn", "mlp"):
        for name, w in tp["layers"][0][part].items():
            if w.ndim != 2:
                continue
            x = rng.normal(size=(2, 3, w.shape[0])).astype(np.float32)
            want = jlayers.qdot(jnp.asarray(x), jlayers.quantize_weight(
                jnp.asarray(w.numpy()), jq), jq)
            got = tlayers.qdot(torch.from_numpy(x),
                               tlayers.quantize_weight(w, tq), tq)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=name)
