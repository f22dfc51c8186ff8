"""The dequant kernels' vector bodies, on the CPU:

  (a) the packed kernel's planner (`split_packed`, `plan_packed`): its
      scalar head, its vector steps (two in flight a thread, then a grid-stride
      loop) and its scalar tail, mirrored, cover each word exactly once,
      at ragged sizes, at element offsets 0-7 from a 16-byte boundary,
      and on grids capped at one wave of resident blocks;
  (b) a mirror of the vector conversion (csrc/vp_dequant.cu: a 16-byte
      chunk unpacked little-endian, m = w >> E sign-extended, the scale
      from the format's table, the significand cast to the output type
      and multiplied in it) is bit-identical to the JAX package's
      `vp_dequant_packed_pallas` in interpret mode, in f32 and bf16, on
      every int16 value as a word of the canonical VP(7,[11,9,8,6]) and
      every int8 value as a word of y's VP(7,[1,-1]);
  (c) the planes kernel (`split_packed` over the significands' offset,
      steps of `planes_vec` significands, `plan_planes`' grid of one step
      a thread; its head, steps and tail cover each element once on that
      grid and on one block): a mirror of its head, vector steps
      (significands sign-extended from 32-bit words, indices from one
      16- or 8-byte load where the index plane is aligned after the
      head, else byte by byte) and tail, at int8 (VP(7, E 2)) and int16
      (VP(10, E 2)) significands, ragged lengths and unaligned offsets,
      writes each element once, bit for bit the plain version and the
      JAX package's `vp_dequant_pallas` in interpret mode over every
      (significand, index) pair of the format; its accepted widths cover
      `significand_dtype(M)` of every format the quantizers serve at W
      12, and it refuses others.
The kernels themselves run only on the card, where `chip_smoke.py` holds
them bit-identical to the plain versions at ragged and unaligned sizes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import FXPFormat as JFXP
from repro.core.formats import VPFormat as JVP
from repro.core.formats import default_vp_format as j_default_vp
from repro.kernels.vp_dequant import (vp_dequant_packed_pallas,
                                     vp_dequant_pallas)
from repro_torch.analysis.contracts import require_quant_safe
from repro_torch.core.formats import FXPFormat as TFXP
from repro_torch.core.formats import VPFormat as TVP
from repro_torch.core.formats import default_vp_format as t_default_vp
from repro_torch.core.vp_tensor import SIGNIFICAND_DTYPES, significand_dtype
from repro_torch.kernels import ref as tref
from repro_torch.kernels.vp_dequant import (
    PACKED_THREADS, PACKED_UNROLL, SM_THREADS, VEC_BYTES,
    plan_packed, plan_planes, planes_vec, split_packed,
    vp_dequant_planes_cuda)

# The canonical serving format (int16 words) and the MIMO y format (int8).
FORMATS = {"int16": (t_default_vp(TFXP(12, 11), 7, 2),
                     j_default_vp(JFXP(12, 11), 7, 2), np.int16),
           "int8": (TVP(7, (1, -1)), JVP(7, (1, -1)), np.int8)}


# -- (a) the planner ------------------------------------------------------------

def _visits(n, offset, word_bytes, sms):
    """How often the packed kernel touches each of n words: thread t0 <
    head takes word t0; vector steps s = t0, t0 + 2 stride, ... each with
    steps s and s + stride (below nv), vec words each from the head on;
    then tail words head + nv vec + t0, + stride, ..."""
    head, nv, tail = split_packed(n, offset, word_bytes)
    vec = VEC_BYTES // word_bytes
    assert head + nv * vec + tail == n and 0 <= tail < vec
    assert head < vec and (offset + head * word_bytes) % VEC_BYTES == 0 \
        or head == n
    blocks, threads = plan_packed(nv, sms)
    assert threads == PACKED_THREADS and threads >= vec
    assert 1 <= blocks <= SM_THREADS // threads * sms
    stride = blocks * threads
    seen = np.zeros(n, np.int64)
    t0 = np.arange(stride)
    seen[t0[t0 < head]] += 1
    for base in range(0, nv, PACKED_UNROLL * stride):
        for r in range(PACKED_UNROLL):
            s = base + r * stride + t0
            s = s[s < nv]
            for k in range(vec):
                np.add.at(seen, head + s * vec + k, 1)
    for e0 in range(head + nv * vec, n, stride):
        e = e0 + t0
        np.add.at(seen, e[e < n], 1)
    return seen, blocks


@pytest.mark.parametrize("word_bytes", [2, 1])
@pytest.mark.parametrize("offset_elems", range(8))
@pytest.mark.parametrize("n", [1, 7, 8, 9, 17, 1000, 3 * 4096 + 5, 100_003])
def test_head_steps_tail_cover_each_word_once(n, offset_elems, word_bytes):
    seen, _ = _visits(n, offset_elems * word_bytes, word_bytes, sms=132)
    assert (seen == 1).all()


def _planes_visits(n, offset, m_bytes, out_bytes, blocks=None):
    """How often the planes kernel touches each of n elements: thread t0
    < head takes element t0; steps s = t0, t0 + stride, ... (below nv)
    take `planes_vec` elements each from the head on; then the tail, as
    in the packed kernel.  On `plan_planes`' grid, or on `blocks`."""
    vec = planes_vec(m_bytes, out_bytes)
    head, nv, tail = split_packed(n, offset, m_bytes, vec * m_bytes)
    assert head + nv * vec + tail == n and 0 <= tail < vec
    assert head < vec and (offset + head * m_bytes) % (vec * m_bytes) == 0 \
        or head == n
    planned, threads = plan_planes(nv)
    assert planned * threads >= nv                  # one step a thread
    stride = (blocks or planned) * threads
    seen = np.zeros(n, np.int64)
    t0 = np.arange(stride)
    seen[t0[t0 < head]] += 1
    for base in range(0, nv, stride):
        s = base + t0
        s = s[s < nv]
        for k in range(vec):
            np.add.at(seen, head + s * vec + k, 1)
    for e0 in range(head + nv * vec, n, stride):
        e = e0 + t0
        np.add.at(seen, e[e < n], 1)
    return seen


@pytest.mark.parametrize("m_bytes,out_bytes", [(1, 4), (1, 2), (2, 4),
                                                (2, 2)])
@pytest.mark.parametrize("offset_elems", [0, 5])
@pytest.mark.parametrize("n", [1, 9, 1000, 3 * 4096 + 5])
def test_planes_steps_cover_each_element_once(n, offset_elems, m_bytes,
                                              out_bytes):
    """The planes kernel's steps of `planes_vec` significands (8 int8 to
    f32, else 16 bytes) from its head on, on its planned grid and on one
    block (the grid-stride loop)."""
    vec = planes_vec(m_bytes, out_bytes)
    assert vec * out_bytes <= 32 and vec * m_bytes in (8, 16)
    for blocks in (None, 1):
        seen = _planes_visits(n, offset_elems * m_bytes, m_bytes, out_bytes,
                              blocks)
        assert (seen == 1).all()


@pytest.mark.parametrize("offset_elems", [0, 3])
def test_grid_stride_past_one_wave(offset_elems):
    """On a 2-SM grid (at most 16 blocks) the steps loop past the wave."""
    n = 16 * PACKED_THREADS * PACKED_UNROLL * 8 * 3 + 11
    seen, blocks = _visits(n, 2 * offset_elems, 2, sms=2)
    assert blocks == 2 * SM_THREADS // PACKED_THREADS
    assert (seen == 1).all()


def test_plan_at_the_weight_panel():
    head, steps, tail = split_packed(1024 * 3072, 0, 2)
    assert (head, tail) == (0, 0) and steps == 1024 * 3072 // 8
    blocks, threads = plan_packed(steps)
    # one round: every thread has its two steps in flight
    assert blocks * threads * PACKED_UNROLL == steps
    assert blocks <= SM_THREADS // threads * 132


# -- (b) the conversion -----------------------------------------------------------

def _stab(vp):
    return np.asarray([np.float32(2.0 ** -f) for f in vp.f], np.float32)


def _vector_values(w, vp, dtype):
    """The kernel's vector steps over whole 16-byte chunks of w: each word
    sign-extended from its lane, vp_scaled<OT>(w >> E, stab[w & (K-1)])."""
    nb = w.dtype.itemsize
    bits, sh = 8 * nb, 32 - 8 * nb
    x = np.ascontiguousarray(w).reshape(-1).view("<u4").reshape(-1, 4)
    words = np.empty((x.shape[0], 4, 4 // nb), np.int64)
    for t in range(4 // nb):
        words[:, :, t] = ((x << np.uint32(sh - bits * t)).view(np.int32)
                          >> sh)
    words = words.reshape(-1)
    m = torch.from_numpy((words >> vp.E).astype(np.float32))
    s = torch.from_numpy(_stab(vp)[words & (vp.K - 1)])
    mo = m.to(dtype).to(torch.float32)          # the significand in OT
    return (mo * s).to(dtype).reshape(w.shape)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.dtype == torch.bfloat16
                      else torch.int32).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", sorted(FORMATS))
def test_vector_conversion_matches_pallas(kind, dtype):
    tv, jv, wdt = FORMATS[kind]
    info = np.iinfo(wdt)
    every = np.arange(info.min, info.max + 1, dtype=np.int64)
    w = np.resize(every, 256 * 256).astype(wdt).reshape(256, 256)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    got = _vector_values(w, tv, tdt)
    want = vp_dequant_packed_pallas(jnp.asarray(w), jv, jdt, interpret=True)
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# -- (c) the planes kernel: int8 and int16 significands -----------------------------

# (torch, JAX) formats: the MIMO W planes' int8 VP(7, E 2) and VP(10, E 2),
# whose significands are int16
PLANES = {"int8": (t_default_vp(TFXP(12, 11), 7, 2),
                   j_default_vp(JFXP(12, 11), 7, 2), np.int8),
          "int16": (t_default_vp(TFXP(12, 11), 10, 2),
                    j_default_vp(JFXP(12, 11), 10, 2), np.int16)}


def _words32(b):
    """Little-endian 32-bit words of a byte array whose length is a
    multiple of 4."""
    return np.ascontiguousarray(b).view("<u4")


def planes_mirror(m, i, m_off, i_off, vp, dtype):
    """The planes kernel over n significands m (int8 / int16) and indices
    i whose first elements lie m_off / i_off bytes past a 16-byte
    boundary: a scalar head up to the boundary of m's step loads, vector
    steps of `planes_vec` significands (sign-extended from the 32-bit
    words of one 16- or 8-byte load; the step's indices from one 16- or
    8-byte load where i is aligned for it after the head, else byte by
    byte) and a scalar tail, each value vp_scaled<OT>(m, stab[i]).  Each
    element is written once."""
    n, mb = m.size, m.itemsize
    V, bits = planes_vec(mb, dtype.itemsize), 8 * mb
    head, nv, tail = split_packed(n, m_off, mb, V * mb)
    sig = np.empty(n, np.int64)
    idx = np.empty(n, np.int64)
    writes = np.zeros(n, np.int64)
    for e in list(range(head)) + list(range(head + nv * V, n)):
        sig[e], idx[e] = m[e], i[e]
        writes[e] += 1
    if nv:
        body = slice(head, head + nv * V)
        x = _words32(m[body].view(np.uint8)).reshape(nv, V * mb // 4)
        lanes = np.empty((nv, V * mb // 4, 4 // mb), np.int64)
        for t in range(4 // mb):
            lanes[:, :, t] = (x << np.uint32(32 - bits - bits * t)).view(
                np.int32) >> (32 - bits)
        sig[body] = lanes.reshape(-1)
        if (i_off + head) % V == 0:   # one V-byte load of the indices
            w = _words32(i[body]).reshape(nv, V // 4)
            k = np.arange(V)
            idx[body] = ((w[:, k >> 2] >> (8 * (k & 3)).astype(np.uint32))
                         & 0xFF).reshape(-1)
        else:
            idx[body] = i[body]
        writes[body] += 1
    assert (writes == 1).all()
    stab = _stab(vp)
    tab = np.concatenate([stab, np.full(16 - vp.K, stab[0], np.float32)])
    s = torch.from_numpy(tab[np.where(idx < 16, idx, 0)])
    mo = torch.from_numpy(sig.astype(np.float32)).to(dtype).to(torch.float32)
    return (mo * s).to(dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", sorted(PLANES))
def test_planes_vector_loop_matches_references(kind, dtype):
    """Every significand of the format with every index, laid out at
    ragged lengths and at offsets that leave the index plane aligned with
    the significands or not: bit for bit the plain version and the JAX
    package's Pallas kernel in interpret mode."""
    tv, jv, mdt = PLANES[kind]
    sig = np.arange(tv.raw_min, tv.raw_max + 1, dtype=np.int64)
    R = 64
    C = -(-sig.size * tv.K // R) + 3
    # element e holds significand sig[e % size] with index e // size: every
    # pair, then a repeat
    m2 = np.resize(sig, R * C).astype(mdt).reshape(R, C)
    i2 = np.resize(np.repeat(np.arange(tv.K), sig.size), R * C).astype(
        np.uint8).reshape(R, C)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    jout = vp_dequant_pallas(jnp.asarray(m2), jnp.asarray(i2), jv, jdt,
                             interpret=True, block=(R, C))
    jflat = torch.from_numpy(np.array(jout.astype(jnp.float32))).reshape(
        -1).to(tdt)
    mf, i_f = m2.reshape(-1), i2.reshape(-1)
    N = mf.size
    for lo, n, i_shift in ((0, N, 0), (3, N - 9, 0), (5, 1003, 0),
                           (1, 37, 2), (0, N - 1, 7), (7, 15, 0), (2, 1, 0)):
        m_off, i_off = (lo * mf.itemsize) % VEC_BYTES, (lo + i_shift) % 16
        # the index plane of this case: i's elements lo .. lo + n placed
        # i_shift bytes further from its boundary than m's
        got = planes_mirror(mf[lo:lo + n], i_f[lo:lo + n], m_off, i_off, tv,
                            tdt)
        want = tref.vp_dequant_ref(torch.from_numpy(mf[lo:lo + n]),
                                   torch.from_numpy(i_f[lo:lo + n]), tv, tdt)
        assert torch.equal(got, want), (lo, n, i_shift)
        assert torch.equal(got, jflat[lo:lo + n]), (lo, n, i_shift)


def test_planes_widths_cover_every_served_format():
    """The planes kernel takes the significands of every format the
    quantizers serve at W 12: `significand_dtype(M)` of each default
    VP(M, E) that passes `require_quant_safe`, int16 for M 9-16."""
    fxp = TFXP(12, 11)
    seen = set()
    for E in (1, 2, 3, 4):
        for M in range(2, 17):
            vp = t_default_vp(fxp, M, E)
            try:
                require_quant_safe(fxp, vp)
            except ValueError:     # VPContractError too
                continue
            seen.add(significand_dtype(M))
            assert significand_dtype(M) in SIGNIFICAND_DTYPES, (M, E)
    assert seen == set(SIGNIFICAND_DTYPES)


def test_planes_wrapper_refuses_other_widths():
    m = torch.zeros(64, dtype=torch.int32)
    i = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError, match="int8 or int16"):
        vp_dequant_planes_cuda(m, i, PLANES["int16"][0], torch.float32)
