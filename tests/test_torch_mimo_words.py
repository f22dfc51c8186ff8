"""`vp_matmul`'s batched launches on the batch body, on the CPU:

  (a) `vmm_body` sends the MIMO engine's batched `vp_matmul` launches to
      the batch body: int16 W x int8 y words (the unfused default) and
      int8 planes (the CSPADE calls; CSPADE masks do not enter the plan),
      at G = 100,000 and at a small G.  It keeps G = 1 on the tile body,
      and products that do not fit, unaligned operands and the layouts
      the launcher does not take (int32 words, mixed words x planes, int16
      significands) on the warp body;
  (b) a numpy mirror of the batch body's staging
      (csrc/vp_common.cuh:vp_mb_slots and vp_mb_product): each 16-byte
      chunk of 4 (f32), 8 (int16 words) or 16 (int8 words, planes)
      elements lands once, at its slot in the warp's area, and the area
      then holds every A row and B column, for every fitting shape tried;
  (c) a mirror of the loaders' conversion (VPLoadWords::values,
      VPLoadPlanes::values: 16-byte chunks unpacked little-endian, the
      scale from the format's table) equals the JAX package's
      `ref.vp_dequant_ref` on every (m, i) pair and its unpack and
      `ref.vp_dequant_packed_ref` on every word of W's and y's formats;
  (d) the mirror's sum (k in order from +0, muted k-ranges skipped), and
      `ops.vp_matmul_batched` on the CPU, against the JAX package's
      `vp_matmul_batched_pallas` in interpret mode and its plain
      reference: packed and planes, with and without CSPADE masks, rtol
      1e-5 and atol 1e-5 * max|out| (f32 sums in another order).
The body itself runs only on the card, where `chip_smoke.py` holds it
bit-identical to the warp body and to the fused kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import unpack_vp as j_unpack_vp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.vp_matmul import (
    BATCH_LAYOUTS, BATCH_WARP_FLOATS, CHUNK_BYTES, batch_fits, vmm_body)
from test_torch_mimo_kernels import (
    JWF, JWV, JYF, JYV, TWF, TWV, TYF, TYV, _masks, _operands, assert_close)

MIMO = (16, 64, 2)
WORDS = (("words", 2), ("words", 1))     # W int16 x y int8 words
PLANES = (("planes", 1), ("planes", 1))  # int8 significands + uint8 index
A_MAX = 1024                             # VP_MB_A_MAX


# -- (a) the planner ----------------------------------------------------------

@pytest.mark.parametrize("G", [100_000, 5])
@pytest.mark.parametrize("layout", [WORDS, PLANES], ids=["words", "planes"])
def test_mimo_launches_take_the_batch_body(layout, G):
    assert layout in BATCH_LAYOUTS
    assert vmm_body(G, *MIMO, layout, aligned=True) == "batch"


@pytest.mark.parametrize("shape,layout,aligned,want", [
    ((1, *MIMO), WORDS, True, "tile"),            # G = 1: the tile body
    ((1, 2048, 64, 256), PLANES, True, "tile"),   # the masked mode
    ((5, *MIMO), WORDS, False, "warp"),           # unaligned operands
    ((5, *MIMO), PLANES, False, "warp"),
    ((5, *MIMO), (("words", 4), ("words", 1)), True, "warp"),   # int32
    ((5, *MIMO), (("words", 2), ("planes", 1)), True, "warp"),  # mixed
    ((5, *MIMO), (("planes", 2), ("planes", 1)), True, "warp"),  # int16 m
    ((5, *MIMO), (("words", 1), ("words", 1)), True, "warp"),   # int8 A
    ((5, 16, 128, 2), WORDS, True, "warp"),       # M K > 1024
    ((5, 16, 64, 4), PLANES, True, "warp"),       # 64 outputs > 32 lanes
    ((5, 16, 36, 2), WORDS, True, "warp"),        # K % 8: A rows not chunks
    ((5, 8, 24, 2), WORDS, True, "batch"),        # K % 8 == 0, K N % 16 == 0
    ((5, 8, 24, 2), PLANES, True, "warp"),        # K % 16 != 0
    ((5, 8, 32, 4), PLANES, True, "batch"),
    ((5, 8, 32, 3), PLANES, True, "batch"),       # B chunks cross columns
    ((5, 8, 20, 2), (("words", 1), ("words", 1)), True, "warp"),
], ids=str)
def test_vmm_body_routes_the_rest(shape, layout, aligned, want):
    assert vmm_body(*shape, layout, aligned) == want


def test_fused_limits_unchanged():
    """The fused kernel's f32 chunks keep the batch body's old limits."""
    assert batch_fits(*MIMO) and batch_fits(16, 36, 2)
    assert not batch_fits(16, 36, 2, 8, 16)      # int16 rows of 36 words


# -- (b) the staging ----------------------------------------------------------

def _slots(M, K, N, a_per, b_per):
    """vp_mb_slots for all 32 lanes: A chunk j of lane l at a[l][j] (-1:
    none), lane l's B chunk starting at (bk[l], bn[l]) (bk -1: none)."""
    kp = K + 4
    nca, ncb = M * K // a_per, K * N // b_per
    na = A_MAX // (32 * a_per)
    a = [[((v * a_per) // K) * kp + (v * a_per) % K if v < nca else -1
          for v in (lane + 32 * j for j in range(na))] for lane in range(32)]
    bk = [(lane * b_per) // N if lane < ncb else -1 for lane in range(32)]
    bn = [(lane * b_per) % N for lane in range(32)]
    return a, bk, bn


def _stage(av, bv, a_per, b_per):
    """One product's staging as the lanes do it: av (M, K) and bv (K, N)
    values, each chunk written at its slots (A: kPer / 4 float4s; B: down
    its columns, n then k); every area float written at most once."""
    M, K = av.shape
    N = bv.shape[1]
    kp = K + 4
    area = np.full(BATCH_WARP_FLOATS, np.nan, np.float32)
    fa, fb = av.reshape(-1), bv.reshape(-1)
    a, bk, bn = _slots(M, K, N, a_per, b_per)
    for lane in range(32):
        for j, off in enumerate(a[lane]):
            if off < 0:
                continue
            v = lane + 32 * j
            assert np.isnan(area[off:off + a_per]).all()
            area[off:off + a_per] = fa[v * a_per:(v + 1) * a_per]
        if bk[lane] < 0:
            continue
        k, n = bk[lane], bn[lane]
        for t in range(b_per):
            assert np.isnan(area[(M + n) * kp + k])
            area[(M + n) * kp + k] = fb[lane * b_per + t]
            n += 1
            if n == N:
                n, k = 0, k + 1
    return area


CHUNKS = {"f32": (4, 4), "words": (8, 16), "planes": (16, 16)}


@pytest.mark.parametrize("kind", sorted(CHUNKS))
def test_staging_lands_each_chunk_once(kind):
    a_per, b_per = CHUNKS[kind]
    rng = np.random.default_rng(a_per)
    tried = 0
    for M in (1, 2, 8, 16, 31, 32):
        for K in (4, 8, 16, 24, 32, 48, 64, 80):
            for N in (1, 2, 3, 4, 8):
                if not batch_fits(M, K, N, a_per, b_per):
                    continue
                av = rng.standard_normal((M, K)).astype(np.float32)
                bv = rng.standard_normal((K, N)).astype(np.float32)
                area = _stage(av, bv, a_per, b_per)
                kp = K + 4
                for m in range(M):
                    assert (area[m * kp:m * kp + K] == av[m]).all()
                for n in range(N):
                    assert (area[(M + n) * kp:(M + n) * kp + K]
                            == bv[:, n]).all()
                assert (~np.isnan(area)).sum() == M * K + K * N
                tried += 1
    assert tried >= 40


# -- (c) the conversion -------------------------------------------------------

def _stab(vp):
    """vp_scale_table: 2^-f_k for k < K, scale[0] past it (VP_MAX_K)."""
    s = np.full(16, np.float32(2.0 ** -vp.f[0]), np.float32)
    s[:vp.K] = [np.float32(2.0 ** -f) for f in vp.f]
    return s


def _lanes(plane):
    """A plane's bytes as the 32-bit lanes of its 16-byte chunks."""
    b = np.ascontiguousarray(plane).reshape(-1).view(np.uint8)
    assert b.size % CHUNK_BYTES == 0
    return b.view("<u4").reshape(-1, 4)


def _sext(x, t, nbytes):
    """Word t of the uint32 lanes x, sign-extended (VPLoadWords::word)."""
    bits = 8 * nbytes
    sh = 32 - bits
    return ((x << np.uint32(sh - bits * t)).view(np.int32)
            >> sh).astype(np.int64)


def _words_values(w, vp):
    """VPLoadWords::values over every chunk: (float)(w >> E) * stab[w &
    (K - 1)], in the chunk's order."""
    nb = w.dtype.itemsize
    x, stab = _lanes(w), _stab(vp)
    out = np.empty((x.shape[0], 4, 4 // nb), np.float32)
    for t in range(4 // nb):
        wv = _sext(x, t, nb)
        out[:, :, t] = (wv >> vp.E).astype(np.float32) * stab[wv & (vp.K - 1)]
    return out.reshape(w.shape)


def _planes_values(m, i, vp):
    """VPLoadPlanes::values: (float)m * stab[i < 16 ? i : 0]."""
    xm, xi, stab = _lanes(m), _lanes(i), _stab(vp)
    out = np.empty((xm.shape[0], 4, 4), np.float32)
    for t in range(4):
        mv = _sext(xm, t, 1)
        iv = ((xi >> np.uint32(8 * t)) & np.uint32(255)).astype(np.int64)
        out[:, :, t] = mv.astype(np.float32) * stab[np.where(iv < 16, iv, 0)]
    return out.reshape(m.shape)


def _every_pair(vp):
    m = np.arange(vp.raw_min, vp.raw_max + 1)
    mm, ii = np.meshgrid(m, np.arange(vp.K), indexing="ij")
    n = -(-mm.size // 16) * 16                      # whole chunks
    return (np.resize(mm.reshape(-1), n).astype(np.int8),
            np.resize(ii.reshape(-1), n).astype(np.uint8))


@pytest.mark.parametrize("name", ["W", "y"])
def test_word_conversion_matches_reference(name):
    tv, jv = (TWV, JWV) if name == "W" else (TYV, JYV)
    m, i = _every_pair(tv)
    w = (m.astype(np.int64) * (1 << tv.E) + i).astype(
        np.int16 if name == "W" else np.int8)
    assert np.unique(w).size == (tv.raw_max - tv.raw_min + 1) * tv.K
    got = _words_values(w, tv)
    jm, ji = j_unpack_vp(jnp.asarray(w), jv)
    want = np.asarray(jref.vp_dequant_ref(jm, ji, jv))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        got.view(np.int32),
        np.asarray(jref.vp_dequant_packed_ref(jnp.asarray(w), jv)).view(
            np.int32))


@pytest.mark.parametrize("name", ["W", "y"])
def test_plane_conversion_matches_reference(name):
    tv, jv = (TWV, JWV) if name == "W" else (TYV, JYV)
    m, i = _every_pair(tv)
    got = _planes_values(m, i, tv)
    want = np.asarray(jref.vp_dequant_ref(jnp.asarray(m), jnp.asarray(i),
                                          jv))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# -- (d) the sum ----------------------------------------------------------------

def _batch_mirror(av, bv, a_act=None, b_act=None, tiles=None, chunks=(8, 16)):
    """The batch body on converted operands av (G, M, K), bv (G, K, N):
    each product staged (`_stage`), each output summed in k order from +0
    in f32, skipping muted k-ranges."""
    G, M, K = av.shape
    N = bv.shape[2]
    kp = K + 4
    out = np.zeros((G, M, N), np.float32)
    for g in range(G):
        area = _stage(av[g], bv[g], *chunks)
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


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "masks"])
@pytest.mark.parametrize("kind", ["packed", "planes"])
def test_batch_mirror_matches_reference(kind, masked):
    G = 3
    a, b = _operands((G, *MIMO), seed=21 + masked)
    tiles = (8, 16, 1) if masked else None
    masks = _masks((G,), *MIMO, tiles, seed=9) if masked else (None, None)
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    if kind == "packed":
        ta = (tops.vp_quant(t(a), TWF, TWV, packed=True), None)
        tb = (tops.vp_quant(t(b), TYF, TYV, packed=True), None)
        av = _words_values(ta[0].numpy(), TWV)
        bv = _words_values(tb[0].numpy(), TYV)
    else:
        ta, tb = tops.vp_quant(t(a), TWF, TWV), tops.vp_quant(t(b), TYF, TYV)
        av = _planes_values(*(x.numpy() for x in ta), TWV)
        bv = _planes_values(*(x.numpy() for x in tb), TYV)
    layout = WORDS if kind == "packed" else PLANES
    assert vmm_body(G, *MIMO, layout, True) == "batch"
    got = _batch_mirror(av, bv, *masks, tiles=tiles,
                        chunks=tuple(CHUNK_BYTES // nb for _, nb in layout))
    wants = []
    for interp in (True, None):
        ja = jops.vp_quant(j(a), JWF, JWV, interpret=interp,
                           packed=kind == "packed")
        jb = jops.vp_quant(j(b), JYF, JYV, interpret=interp,
                           packed=kind == "packed")
        if kind == "packed":
            ja, jb = (ja, None), (jb, None)
        wants.append(jops.vp_matmul_batched(
            *ja, *jb, JWV, JYV, a_act=j(masks[0]), b_act=j(masks[1]),
            blocks=tiles, interpret=interp))
    assert_close(got, *wants)
    port = tops.vp_matmul_batched(*ta, *tb, TWV, TYV, a_act=t(masks[0]),
                                  b_act=t(masks[1]), blocks=tiles)
    assert port.dtype == torch.float32
    assert_close(port.numpy(), *wants)
    assert_close(port.numpy(), got)
