"""The MIMO path's two quantize-on-load kernels as redesigned for the
card, on the CPU:

  (a) the planes kernel's grid (`plan_packed`): its grid-stride steps of
      8 elements, then a tail, cover every element once (mirrored), at
      ragged sizes and at the MIMO W panel's 102.4 M elements;
      `packed_body` picks the table body for both MIMO formats and the
      select chain for a format outside `table_ok`;
  (b) `qmm_body` sends the fused MIMO launches (G = 100,000 and the
      wideband 65,536 of (16, 64) x (64, 2)) to the batch body while
      `mm_body` keeps `vp_matmul`'s on the warp body; G = 1 goes to the
      tile body, and products that do not fit, unaligned operands and
      formats without an O(1) conversion to the warp body;
  (c) a numpy mirror of the batch body's per-element conversion (the
      4096-entry value table of W's FXP(12,11) grid, the 512-entry one of
      y's FXP(9,1), and the index table) equals the JAX package's
      `vp_quant_ref`, dequantized, on every raw value of both grids, on
      f32 ties, on +-0 and on values past the clip;
  (d) a mirror of the batch body's staging (each lane's loads land once
      in the warp's area) and of its sum (k in order from +0, the muted
      k-ranges skipped) against the JAX package's batched fused kernel,
      through its plain reference and in interpret mode, with and without
      CSPADE masks; and `ops.vp_quant_matmul_batched` against the same:
      rtol 1e-5, atol 1e-5 * max|out| (f32 sums in another order).
The bodies themselves run only on the card, where `chip_smoke.py` holds
them bit-identical to the warp body and to quantize -> `vp_matmul`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.formats import FXPFormat, VPFormat
from repro_torch.kernels import ops as tops
from repro_torch.kernels.vp_matmul import (
    BATCH_LUT_MAX, BATCH_WARP_FLOATS, batch_fits, mm_body, qmm_body)
from repro_torch.kernels.vp_quant import (
    PACKED_VEC, index_table, plan_packed, packed_body, table_ok)
from repro_torch.kernels.vp_quant_matmul import batch_converts
from test_torch_mimo_kernels import (
    JWF, JWV, JYF, JYV, TWF, TWV, TYF, TYV, _masks, _operands, assert_close)

SMS = 132   # the H100 SXM the port is measured on
MIMO = (16, 64, 2)


# -- (a) the planes kernel ----------------------------------------------------

def _visits(n, blocks, threads):
    """How often the planes bodies' loop (csrc/vp_quant.cu:quant_planes)
    touches each of n elements: thread t takes 8-element steps t, t +
    stride, ... below n // 8, then tail elements 8 (n // 8) + t, ..."""
    stride = blocks * threads
    nv = n // PACKED_VEC
    seen = np.zeros(n, np.int64)
    for t in range(stride):
        for g in range(t, nv, stride):
            seen[g * PACKED_VEC:(g + 1) * PACKED_VEC] += 1
        seen[nv * PACKED_VEC + t:n:stride] += 1
    return seen


@pytest.mark.parametrize("n", [1, 7, 8, 9, 1000, 8 * 64 * 132 + 5,
                               100_003])
def test_planes_grid_covers_each_element_once(n):
    blocks, threads = plan_packed(n, SMS)
    assert (_visits(n, blocks, threads) == 1).all()


def test_planes_grid_at_the_mimo_panel():
    n = 1_600_000 * 64
    blocks, threads = plan_packed(n, SMS)
    assert threads == 256 and blocks == 16 * SMS      # a grid-stride loop
    steps = -(-(n // PACKED_VEC) // (blocks * threads))
    assert steps * blocks * threads * PACKED_VEC >= n and n % PACKED_VEC == 0


@pytest.mark.parametrize("fxp,vp,body", [
    (TWF, TWV, "table"), (TYF, TYV, "table"),
    (FXPFormat(12, 2), VPFormat(7, (10, 2)), "chain")],
    ids=["W", "y", "chain"])
def test_planes_body_from_the_format(fxp, vp, body):
    assert packed_body(fxp, vp) == body
    assert table_ok(fxp, vp) == (body == "table")


# -- (b) the fused kernel's planner -------------------------------------------

@pytest.mark.parametrize("G", [100_000, 65_536, 1024, 2])
def test_mimo_launches_take_the_batch_body(G):
    assert qmm_body(G, *MIMO) == "batch"
    assert mm_body(G, *MIMO) == "warp"        # vp_matmul's batched launches


@pytest.mark.parametrize("shape,aligned,tables,want", [
    ((1, 2048, 64, 256), True, True, "tile"),     # the masked mode
    ((1, 16, 64, 2), True, True, "tile"),
    ((3, 13, 50, 1), True, True, "warp"),         # K % 4 != 0
    ((5, 16, 64, 4), True, True, "warp"),         # 64 outputs > 32 lanes
    ((5, 8, 32, 4), True, True, "batch"),
    ((5, 16, 128, 2), True, True, "warp"),        # M K > 1024
    ((5, 2, 64, 4), True, True, "warp"),          # K N > 128
    ((5, 16, 64, 2), False, True, "warp"),        # unaligned operands
    ((5, 16, 64, 2), True, False, "warp"),        # no O(1) conversion
], ids=str)
def test_qmm_body_routes_the_rest(shape, aligned, tables, want):
    assert qmm_body(*shape, aligned=aligned, tables=tables) == want


def test_batch_body_limits():
    M, K, N = MIMO
    assert batch_fits(M, K, N) and (M + N) * (K + 4) <= BATCH_WARP_FLOATS
    assert batch_converts(TWF) and batch_converts(TYF)
    # the value table needs only a grid of at most BATCH_LUT_MAX values
    # (built by the chain where the format has no index table); a 2^20-
    # value grid goes to the warp body, index table or not
    chain = (FXPFormat(12, 2), VPFormat(7, (10, 2)))
    assert not table_ok(*chain) and batch_converts(chain[0])
    wide = (FXPFormat(20, 2), VPFormat(8, (10, 2)))
    assert not table_ok(*wide) and not batch_converts(wide[0])
    assert not batch_converts(FXPFormat(13, 11))


# -- (c) the per-element conversion -------------------------------------------

def _bitlen(raw):
    key = raw ^ (raw >> 63)
    out = np.zeros(raw.shape, np.int64)
    nz = key > 0
    out[nz] = np.floor(np.log2(key[nz])).astype(np.int64) + 1
    return out


def _value_tab(raw, fxp, vp):
    """The index table's conversion of int64 raws (VPQuantLoad::lut_value
    after the FXP rounding): f32 m * 2^-f_i."""
    i = np.asarray(index_table(fxp, vp))[_bitlen(raw)]
    s = fxp.F - np.asarray(vp.f)[i]
    m = np.where(s >= 0, raw >> np.maximum(s, 0), raw << np.maximum(-s, 0))
    m = np.clip(m, vp.raw_min, vp.raw_max)
    return (m * 2.0 ** -np.asarray(vp.f, np.float64)[i]).astype(np.float32)


def _fxp_raw(x, fxp):
    """vp_fxp_raw: rintf(x * 2^F) clipped, in f32, as an int64."""
    with np.errstate(over="ignore"):              # inf past f32's range
        r = np.rint(x.astype(np.float32) * np.float32(2.0 ** fxp.F))
    return np.clip(r, fxp.raw_min, fxp.raw_max).astype(np.int64)


def _lut_value(x, fxp, vp):
    """The value table's conversion: the table of the grid built from the
    index table, looked up at the rounded raw (VPQuantLoad::lut_index)."""
    grid = np.arange(fxp.raw_min, fxp.raw_max + 1, dtype=np.int64)
    assert grid.size <= BATCH_LUT_MAX
    lut = _value_tab(grid, fxp, vp)
    return lut[_fxp_raw(x, fxp) - fxp.raw_min]


def _inputs(fxp):
    """Every raw value of the grid, ties between neighbours, +-0, and
    values past the clip (+-inf included)."""
    raw = np.arange(fxp.raw_min, fxp.raw_max + 1, dtype=np.float64)
    ties = (raw + 0.5) * 2.0 ** -fxp.F
    past = np.array([2.0, -2.0, 1e3, -1e3, 1e30, -1e30, np.inf, -np.inf]) \
        * 2.0 ** (fxp.W - 1 - fxp.F)
    return np.concatenate([raw * 2.0 ** -fxp.F, ties, [0.0, -0.0], past]
                          ).astype(np.float32)


@pytest.mark.parametrize("name", ["W", "y"])
@pytest.mark.parametrize("mode", ["lut", "tab"])
def test_conversion_mirror_matches_reference(name, mode):
    tf, tv, jf, jv = ((TWF, TWV, JWF, JWV) if name == "W"
                      else (TYF, TYV, JYF, JYV))
    x = _inputs(tf)
    jm, ji = jref.vp_quant_ref(jnp.asarray(x), jf, jv)
    want = (np.asarray(jm).astype(np.float64)
            * 2.0 ** -np.asarray(tv.f, np.float64)[np.asarray(ji)]
            ).astype(np.float32)
    got = (_lut_value(x, tf, tv) if mode == "lut"
           else _value_tab(_fxp_raw(x, tf), tf, tv))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# -- (d) the staging and the sum ----------------------------------------------

def _batch_mirror(a, b, a_act=None, b_act=None, tiles=None):
    """The batch body on numpy operands: each product's elements
    converted (value tables), staged as the lanes' offsets say, and each
    output summed in k order from +0 in f32, skipping muted k-ranges."""
    G, M, K = a.shape
    N = b.shape[2]
    kp, k4 = K + 4, K // 4
    av = _lut_value(a.reshape(-1), TWF, TWV).reshape(a.shape)
    bv = _lut_value(b.reshape(-1), TYF, TYV).reshape(b.shape)
    out = np.zeros((G, M, N), np.float32)
    for g in range(G):
        area = np.full(BATCH_WARP_FLOATS, np.nan, np.float32)
        fa, fb = av[g].reshape(-1), bv[g].reshape(-1)
        for lane in range(32):
            for j in range(8):                       # A: float4s
                v = lane + 32 * j
                if v < M * K // 4:
                    off = (v // k4) * kp + 4 * (v % k4)
                    assert np.isnan(area[off:off + 4]).all()
                    area[off:off + 4] = fa[4 * v:4 * v + 4]
            if 4 * lane < K * N:                     # B: four elements
                for t in range(4):
                    k, n = divmod(4 * lane + t, N)
                    assert np.isnan(area[(M + n) * kp + k])
                    area[(M + n) * kp + k] = fb[4 * lane + t]
        for m in range(M):
            assert (area[m * kp:m * kp + K] == av[g, m]).all()
        for n in range(N):
            assert (area[(M + n) * kp:(M + n) * kp + K] == bv[g, :, n]).all()
        for lane in range(M * N):
            m, n = divmod(lane, N)
            ar, bc = area[m * kp:], area[(M + n) * kp:]
            acc = np.float32(0.0)
            for k in range(K):
                if a_act is not None:
                    bm, bk, bn = tiles
                    if not (a_act[g, m // bm, k // bk]
                            | b_act[g, k // bk, n // bn]):
                        continue
                p = np.float64(ar[k]) * np.float64(bc[k])
                assert np.float32(p) == p            # fmaf == mul + add
                acc = np.float32(acc + np.float32(p))
            out[g, m, n] = acc
    return out


def _mimo_like(G, seed):
    a, b = _operands((G, *MIMO), seed)
    a[0, 0, :8] = (np.arange(8) + 0.5) * 2.0 ** -11       # ties
    a[0, 1, :2] = [3.0, -3.0]                              # past the clip
    b[0, :4, 0] = [0.25, -0.25, 300.0, -0.0]
    return a, b


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "masks"])
def test_batch_mirror_matches_reference(masked):
    G = 3
    a, b = _mimo_like(G, seed=11 + masked)
    tiles = (8, 16, 1) if masked else None
    masks = _masks((G,), *MIMO, tiles, seed=5) if masked else (None, None)
    got = _batch_mirror(a, b, *masks, tiles=tiles)
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    wants = [jops.vp_quant_matmul_batched(
        j(a), j(b), JWF, JWV, JYF, JYV, a_act=j(masks[0]),
        b_act=j(masks[1]), blocks=tiles, interpret=interp)
        for interp in (True, None)]
    assert_close(got, *wants)
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    port = tops.vp_quant_matmul_batched(
        t(a), t(b), TWF, TWV, TYF, TYV, a_act=t(masks[0]),
        b_act=t(masks[1]), blocks=tiles)
    assert port.dtype == torch.float32
    assert_close(port.numpy(), *wants)
    assert_close(port.numpy(), got)
