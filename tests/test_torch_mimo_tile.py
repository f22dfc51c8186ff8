"""The G = 1 VP x VP products on the tile body's shapes (CPU, plain
versions) against the JAX package, and the tile body's planner and index
arithmetic.

  (a) `mm_body` picks the tile body at the masked mode's and the
      qmm-grad check's (1, 2048, 64, 256) and at every G = 1 shape of
      the sweep that set it, the warp body at the batched MIMO shapes
      (above TILE_MAX_G).
  (b) `ops.vp_matmul` / `ops.vp_quant_matmul` at G = 1 on shapes where
      `mm_body` picks the tile body, ragged ones included, in packed,
      planes, mixed and fused, unmasked and with CSPADE grids that cut
      across a 64 x 64 tile: rtol 1e-5, atol 1e-5 * max|out| against the
      JAX package's interpret-mode kernel and its oracle; CSPADE masks
      at such a grid bit-exact.
  (c) Mirrors of csrc/vp_common.cuh's tile staging: the shares of a
      cluster cover each staged element once, the copies fill in the
      rest, a warp's A stores hit 32 banks, and each k's micro-tile
      reads take one wavefront per operand.

The body itself (bit-identical to the warp body) runs only on the card,
where `chip_smoke.py` holds it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels.vp_matmul import (
    TILE_MAX_G, mm_body, vp_matmul_cuda)
from repro_torch.kernels.vp_quant_matmul import vp_quant_matmul_cuda
from test_torch_mimo_kernels import (
    TWF, TWV, TYF, TYV, _masks, _operands, _run_both, assert_close)


@pytest.mark.parametrize("shape,want", [
    ((1, 2048, 64, 256), "tile"),       # masked mode at n = 256; qmm-grad
    ((100_000, 16, 64, 2), "warp"),     # the batched MVM
    ((65_536, 16, 64, 2), "warp"),      # the wideband band
    ((1, 16, 64, 2), "tile"),           # the sweep's G = 1 corners
    ((1, 2048, 64, 2), "tile"),
    ((1, 16, 64, 256), "tile"),
    ((1024, 16, 64, 2), "warp"),        # ... and its batched points
    ((8192, 16, 64, 2), "warp"),
    ((TILE_MAX_G, 200, 50, 72), "tile"),
    ((TILE_MAX_G + 1, 2048, 64, 256), "warp"),
], ids=str)
def test_mm_body(shape, want):
    assert mm_body(*shape) == want


def test_unknown_body_is_refused():
    a, b = torch.zeros((1, 64, 64)), torch.zeros((1, 64, 64))
    w = torch.zeros((1, 64, 64), dtype=torch.int16)
    with pytest.raises(ValueError, match="unknown body"):
        vp_matmul_cuda(w, None, w, None, TWV, TWV, body="wide")
    with pytest.raises(ValueError, match="unknown body"):
        vp_quant_matmul_cuda(a, b, TWF, TWV, TYF, TYV, body="wide")


# (M, K, N) -> a CSPADE grid that cuts across the 64 x 64 output tile
# and, with bn < 4, mixes loud and muted outputs inside a micro-tile.
TILE_SHAPES = {(256, 64, 64): (8, 16, 8), (200, 50, 72): (8, 10, 2)}
LAYOUTS = ["packed", "planes", "mixed", "fused"]


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "masks"])
@pytest.mark.parametrize("kind", LAYOUTS)
@pytest.mark.parametrize("shape", sorted(TILE_SHAPES), ids=str)
def test_vp_matmul_g1_on_tile_shapes(shape, kind, masked):
    M, K, N = shape
    assert mm_body(1, M, K, N) == "tile"
    a, b = _operands(shape, seed=M + K + N)
    tiles = TILE_SHAPES[shape] if masked else None
    masks = _masks((), M, K, N, tiles, seed=N) if masked else None
    got, wants = _run_both(kind, False, a, b, masks, tiles)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert_close(got.numpy(), *wants)
    if kind == "fused":
        # On the plain path the fused op is quantize then matmul, exactly.
        planes, _ = _run_both("planes", False, a, b, masks, tiles)
        np.testing.assert_array_equal(got.numpy(), planes.numpy())


def test_cspade_masks_across_the_tile_exact():
    M, K, N = 256, 64, 64
    a, b = _operands((M, K, N), seed=29)
    ta = np.float32(np.quantile(np.abs(a), 0.99))
    tb = np.float32(np.quantile(np.abs(b), 0.99))
    got = tref.cspade_tile_masks(torch.from_numpy(a), torch.from_numpy(b),
                                 *TILE_SHAPES[(M, K, N)], torch.tensor(ta),
                                 torch.tensor(tb))
    want = jref.cspade_tile_masks(jnp.asarray(a), jnp.asarray(b),
                                  *TILE_SHAPES[(M, K, N)], jnp.float32(ta),
                                  jnp.float32(tb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert 0 < int(g.sum()) < g.numel()
    # ... and the masked op on them agrees with the JAX package's.
    out, wants = _run_both("fused", False, a, b,
                           tuple(g.numpy() for g in got),
                           TILE_SHAPES[(M, K, N)])
    assert_close(out.numpy(), *wants)


# -- mirrors of the tile body's staging (csrc/vp_common.cuh) ----------------
BM = BN = KC = 64
MR, NR = 4, 4
THREADS = 512                       # staging; the first 256 compute
FMA_THREADS = BM // MR * (BN // NR)
CN = 2                              # the cluster pair along n
SHARE_A = BM // CN
AST, BST = BM + 4, BN + 4


def _slot_a(t, s, cx):
    e = t + s * THREADS
    q, lane = e >> 5, e & 31
    return (cx * SHARE_A + (q // (KC // 8)) * 4 + (lane >> 3),
            (q % (KC // 8)) * 8 + (lane & 7))


def _slot_b(t, s):
    e = t + s * THREADS
    return e // BN, e % BN


def _gather(t, cx):
    """The A offsets one thread copies from its partner (one float4)."""
    aq = SHARE_A // 4
    o = (t // aq) * AST + (1 - cx) * SHARE_A + (t % aq) * 4
    return [o + i for i in range(4)]


def test_tile_shares_and_copies_fill_each_tile_once():
    per_a, per_b = SHARE_A * KC // THREADS, KC * BN // THREADS
    assert per_a * THREADS == SHARE_A * KC and per_b * THREADS == KC * BN
    assert KC * SHARE_A // 4 == THREADS      # one float4 copied per thread
    want_a = sorted(c * AST + r for c in range(KC) for r in range(BM))
    want_b = sorted(k * BST + n for k in range(KC) for n in range(BN))
    staged_b = [kb * BST + n for t in range(THREADS) for s in range(per_b)
                for kb, n in [_slot_b(t, s)]]
    assert sorted(staged_b) == want_b
    for cx in range(CN):
        staged_a = [c * AST + r for t in range(THREADS) for s in range(per_a)
                    for r, c in [_slot_a(t, s, cx)]]
        copied_a = [o for t in range(THREADS) for o in _gather(t, cx)]
        assert sorted(staged_a + copied_a) == want_a
        # a block never copies over what it staged itself, and copies
        # exactly what its partner staged
        assert set(copied_a).isdisjoint(staged_a)
        assert set(copied_a) == {c * AST + r for t in range(THREADS)
                                 for s in range(per_a)
                                 for r, c in [_slot_a(t, s, 1 - cx)]}


def test_tile_staging_and_reads_are_free_of_bank_conflicts():
    for s in range(SHARE_A * KC // THREADS):
        for w in range(THREADS // 32):
            banks = {(c * AST + r) % 32 for lane in range(32)
                     for r, c in [_slot_a(w * 32 + lane, s, 0)]}
            assert len(banks) == 32
    # Micro-tile reads: a warp covers 4 x 8 micro-tiles, so per k its A
    # and B reads (16 bytes each) each fit one 128-byte row.
    wx = BN // NR // 8
    assert FMA_THREADS == 256
    for w in range(FMA_THREADS // 32):
        rows = {((w // wx) * 4 + lane // 8) * MR for lane in range(32)}
        cols = {((w % wx) * 8 + lane % 8) * NR for lane in range(32)}
        assert (max(rows) - min(rows) + MR) * 4 <= 128
        assert (max(cols) - min(cols) + NR) * 4 <= 128
