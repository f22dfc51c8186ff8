"""`vp_dequant_packed`'s 16-byte vector body, on the CPU:

  (a) its planner (`split_packed`, `plan_packed`): the kernel's scalar
      head, its vector steps (two in flight a thread, then a grid-stride
      loop) and its scalar tail, mirrored, cover each word exactly once,
      at ragged sizes, at element offsets 0-7 from a 16-byte boundary,
      and on grids capped at one wave of resident blocks;
  (b) a mirror of the vector conversion (csrc/vp_dequant.cu: a 16-byte
      chunk unpacked little-endian, m = w >> E sign-extended, the scale
      from the format's table, the significand cast to the output type
      and multiplied in it) is bit-identical to the JAX package's
      `vp_dequant_packed_pallas` in interpret mode, in f32 and bf16, on
      every int16 value as a word of the canonical VP(7,[11,9,8,6]) and
      every int8 value as a word of y's VP(7,[1,-1]).
The kernel itself runs only on the card, where `chip_smoke.py` holds it
bit-identical to the plain version at ragged and unaligned sizes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import FXPFormat as JFXP
from repro.core.formats import VPFormat as JVP
from repro.core.formats import default_vp_format as j_default_vp
from repro.kernels.vp_dequant import vp_dequant_packed_pallas
from repro_torch.core.formats import FXPFormat as TFXP
from repro_torch.core.formats import VPFormat as TVP
from repro_torch.core.formats import default_vp_format as t_default_vp
from repro_torch.kernels.vp_dequant import (
    PACKED_THREADS, PACKED_UNROLL, SM_THREADS, VEC_BYTES, plan_packed,
    split_packed)

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
