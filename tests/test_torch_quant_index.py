"""The O(1) exponent index, the KV cache's one-launch write and the
quantizer planners of the serving paths, on the CPU:

  (a) `index_table` mirrored in numpy (tab[bitlen(raw ^ (raw >> 31))],
      then the significand shifted at that option and clipped) gives the
      JAX package's Fig. 3 cascade (`repro.kernels.ref.vp_quant_ref`) for
      every raw value of every format a path of the repo uses, and of a
      left-shift format inside the proof's conditions;
  (b) `index_table` refuses, and the planner sends to the select chain, a
      format with a left shift past -(M - 1) or one that can wrap int32;
  (c) the KV mode's plain version (`ref.vp_quant_scaled_ref`, which
      `quantize_kv` takes on the CPU) is bit for bit the reference's
      `quantize_kv(layout="packed")`: words and scales, bf16 and f32, with
      an all-zero position, amax 2^k and 2^k (1 + 2^-7), and amax near
      1e-30;
  (d) the planners: `plan_packed`'s grid at the export and decode shapes,
      and `vp_block_quant.plan`'s body at every shape of the vp_block path
      (small at decode, coop at prefill and the layer weights' export,
      two-pass for `lm_head`), the coop grid within the blocks 132 SMs
      hold at once, and the invariants the launcher checks;
  (e) the vp_block layers quantize each distinct activation once (4 per
      layer, plus `lm_head`'s), and the attention block and the MLP in
      vp_block equal the JAX package's.
Inputs are made with numpy and fed to both packages; the JAX side runs as
its own tests run it on the CPU (its ops dispatch to the oracles).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core.formats import FXPFormat as JFXP
from repro.core.formats import VPFormat as JVP
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import model as jmodel
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.core.formats import FXPFormat, VPFormat, default_vp_format
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.vp_block_quant import (
    COOP_PER_SM, SMALL_MAX, THREADS, VEC, fast_block, general_tile, plan)
from repro_torch.kernels.vp_quant import (
    IDX_TAB, index_table, packed_body, plan_packed, table_ok)
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mlp as tmlp
from repro_torch.models import model as tmodel
from repro_torch.models.weights import params_from_numpy

SMS = 132   # the H100 SXM the port is measured on
ARCH = "qwen3-0.6b"

# (FXP(W, F), M, f): every format a path of the repo quantizes with, and
# one with left shifts inside the proof's conditions
FORMATS = {
    "canonical VP(7,[11,9,8,6])": ((12, 11), 7, (11, 9, 8, 6)),
    "KV cache": ((12, 11), 7, None),             # default_vp_format(W, M, E)
    "MIMO W VP(7,[11,9,7,6])": ((12, 11), 7, (11, 9, 7, 6)),
    "MIMO y VP(7,[1,-1])": ((9, 1), 7, (1, -1)),
    "int8 words VP(6,...)": ((12, 11), 6, None),
    "VP(10,[12,8])": ((14, 12), 10, (12, 8)),
    "VP(16,[18,14])": ((20, 18), 16, (18, 14)),
    "left shifts VP(7,[10,8])": ((12, 8), 7, (10, 8)),
}


def _formats(key):
    (W, F), M, f = FORMATS[key]
    fxp = FXPFormat(W, F)
    vp = default_vp_format(fxp, M, 2) if f is None else VPFormat(M, f)
    return fxp, vp


def _shift(v, s):
    """The cascade's shift of int64 values: arithmetic right by s >= 0,
    left by -s (no wrap inside the proof's conditions)."""
    return v >> min(s, 31) if s >= 0 else v << -s


def _mirror(raw, fxp, vp):
    """The kernels' O(1) cascade in numpy: (m, i) of int64 raws."""
    tab = np.asarray(index_table(fxp, vp))
    key = raw ^ (raw >> 63)                       # |raw| without the sign
    L = np.zeros(raw.shape, np.int64)
    nz = key > 0
    L[nz] = np.floor(np.log2(key[nz])).astype(np.int64) + 1
    i = tab[L]
    m = np.zeros_like(raw)
    for k, fk in enumerate(vp.f):
        sel = i == k
        m[sel] = _shift(raw[sel], fxp.F - fk)
    return np.clip(m, vp.raw_min, vp.raw_max), i


# -- (a) the table against the reference's cascade, every raw --------------

@pytest.mark.parametrize("key", sorted(FORMATS))
def test_index_table_matches_reference_on_every_raw(key):
    fxp, vp = _formats(key)
    assert table_ok(fxp, vp) and packed_body(fxp, vp) == "table"
    tab = index_table(fxp, vp)
    assert len(tab) == IDX_TAB and tab == tuple(sorted(tab))  # grows with L
    raw = np.arange(fxp.raw_min, fxp.raw_max + 1, dtype=np.int64)
    x = (raw * 2.0 ** -fxp.F).astype(np.float32)  # exact: the raws back
    jm, ji = jref.vp_quant_ref(jnp.asarray(x), JFXP(fxp.W, fxp.F),
                               JVP(vp.M, vp.f))
    m, i = _mirror(raw, fxp, vp)
    np.testing.assert_array_equal(m, np.asarray(jm).astype(np.int64))
    np.testing.assert_array_equal(i, np.asarray(ji).astype(np.int64))


# -- (b) formats outside the proof ---------------------------------------------

@pytest.mark.parametrize("fxp,vp", [
    (FXPFormat(12, 2), VPFormat(7, (10, 2))),     # s_0 = -8 < -(M - 1)
    (FXPFormat(30, 2), VPFormat(8, (5, 2))),      # W - 1 - s_0 = 32 > 31
], ids=["past -(M-1)", "can wrap int32"])
def test_index_table_refuses_formats_outside_the_proof(fxp, vp):
    assert not table_ok(fxp, vp)
    assert packed_body(fxp, vp) == "chain"
    with pytest.raises(ValueError):
        index_table(fxp, vp)


def test_the_proof_fails_outside_its_conditions():
    """Past -(M - 1) the index is not a function of the bit length: raw 0
    and -1 share it but take different options."""
    fxp, vp = FXPFormat(12, 2), VPFormat(7, (10, 2))
    x = np.array([0.0, -0.25], np.float32)        # raws 0 and -1
    _, ji = jref.vp_quant_ref(jnp.asarray(x), JFXP(12, 2), JVP(7, (10, 2)))
    assert list(np.asarray(ji)) == [0, 1]


# -- (c) the KV cache's write --------------------------------------------------

def _kv_input(dtype, rng):
    x = rng.normal(size=(2, 6, 3, 8)).astype(np.float32) * 3
    x[0, 0] = 0.0                                 # an all-zero position
    x[0, 1] = 4.0                                 # amax 2^2 exactly
    x[0, 2, 0, 0] = 4.0 * (1 + 2.0 ** -7)         # amax 2^2 (1 + 2^-7)
    x[1, 0] = 1.0                                 # amax 2^0
    x[1, 1] *= 1e-31                              # amax near 1e-30
    x[1, 2] = 2.0 ** -3 * (1 + 2.0 ** -7)
    t = torch.from_numpy(x).to(dtype)
    return t, t.float().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kv_mode_plain_version_matches_reference(dtype):
    t, x = _kv_input(dtype, np.random.default_rng(5))
    jq = JQuantConfig(mode="vp", quantize_kv_cache=True)
    tq = TQuantConfig(mode="vp", quantize_kv_cache=True)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    jw, js = jattn.quantize_kv(jx, jq, layout="packed")
    fxp, vp = tattn.kv_cache_formats(tq)
    js = np.asarray(js)
    # XLA's CPU exp2(-99) is 1.5777163e-30, 3.5e-6 below 2^-99 (ROADMAP
    # queue 3, a reference-side fault): there the port's exact power is
    # held to 2^-99 and the reference's to 2^-16 of it; elsewhere bit for
    # bit.
    tiny = (js > 0) & (js < 2.0 ** -90)
    assert tiny.sum() == 2                        # the zero and ~1e-30 rows
    for w, s in (tref.vp_quant_scaled_ref(t, fxp, vp, 2),
                 tattn.quantize_kv(t, tq)):
        assert w.dtype == torch.int16 and s.shape == (2, 6, 1, 1)
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        s = s.numpy()
        np.testing.assert_array_equal(s[~tiny], js[~tiny])
        assert (s[tiny] == np.float32(2.0 ** -99)).all()
        np.testing.assert_allclose(js[tiny], s[tiny], rtol=2 ** -16)
    assert s[0, 0] == 2.0 ** -99                  # not the block scale's 1
    assert s[0, 1] == 4.0 and s[0, 2] == 8.0


# -- (d) the planners ------------------------------------------------------------

def test_plan_packed_grids():
    blocks, threads = plan_packed(1024 * 3072, SMS)
    assert threads == 256 and blocks >= 2 * SMS
    assert blocks * threads * 8 >= 1024 * 3072
    blocks, threads = plan_packed(2048, SMS)       # a decode-sized tensor
    assert threads == 64 and blocks <= SMS and blocks * threads * 8 >= 2048


# (R, C, axis, body) of every quantizer call of the vp_block path at
# qwen3-0.6b's widths: decode and prefill activations, the export
PATH = [(4, 1024, -1, "small"), (4, 3072, -1, "small"),
        (512, 1024, -1, "coop"), (512, 3072, -1, "coop"),
        (1024, 3072, 0, "coop"), (3072, 1024, 0, "coop"),
        (1024, 1024, 0, "coop"), (1024, 512, 0, "coop"),
        (1024, 151936, 0, "two_pass")]


@pytest.mark.parametrize("R,C,axis,body", PATH, ids=str)
def test_block_quant_plan_on_the_path(R, C, axis, body):
    p = plan(R, C, 256, axis, SMS)
    assert p.body == body
    assert (p.amax_blocks > 0) == (body == "two_pass")
    if body == "small":
        assert p.grid == (1 if R * C <= 4096 else 8)   # one cluster
    if body == "coop":   # every block resident at once on 132 SMs
        assert p.grid <= COOP_PER_SM * SMS
    if axis == 0:
        assert p.grid == R // 256 * -(-C // 64)


@pytest.mark.parametrize("seed", range(4))
def test_block_quant_plan_invariants(seed):
    """What the launcher checks, over random shapes and blocks: along the
    rows a CUDA block takes whole index blocks that its threads' vectors
    cover, and the grid covers the tensor."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        block = int(rng.choice([4, 8, 64, 128, 256, 1024]))
        R, C = int(rng.integers(1, 700)), block * int(rng.integers(1, 40))
        for body in (None, "coop", "two_pass", "small"):
            try:
                p = plan(R, C, block, -1, SMS, body=body)
            except ValueError:
                assert body == "small" and R * C > SMALL_MAX or \
                    body == "coop"
                continue
            assert p.chunk % block == 0 and p.chunk >= block
            assert p.threads * p.nv * VEC >= p.chunk
            assert p.grid * p.chunk >= R * C > (p.grid - 1) * p.chunk
            assert p.nv <= (4 if p.body == "small" else 8)
            if p.body != "small":
                assert p.threads == THREADS
            if p.body == "coop":
                assert p.grid <= COOP_PER_SM * SMS


def test_block_quant_plan_refuses_blocks_it_does_not_take():
    """The blocks the fast bodies refuse plan onto the general body; the
    only blocks refused are those that do not divide the axis."""
    assert plan(4, 1026, 6, -1, SMS).body == "general"   # not a multiple of 4
    assert plan(512, 64, 512, 0, SMS).body == "general"  # above 256 rows
    with pytest.raises(ValueError):
        plan(4, 1026, 4, -1, SMS)         # 4 does not divide 1026
    with pytest.raises(ValueError):
        plan(512, 64, 96, 0, SMS)         # 96 does not divide 512
    with pytest.raises(ValueError):
        plan(512, 64, 512, 0, SMS, body="coop")   # a fast body, forced


# Every block that divides the axis plans, on the general body exactly
# where the fast bodies refuse it (axis -1: not a multiple of VEC or
# above THREADS * V * VEC; axis 0: not a multiple of 32 or above 256).
GENERAL_BLOCKS = (1, 4, 6, 16, 48, 96, 256, 512, 8192, 16384)


@pytest.mark.parametrize("block", GENERAL_BLOCKS)
@pytest.mark.parametrize("axis", [-1, 0])
def test_block_quant_plan_takes_every_dividing_block(axis, block):
    R, C = (6, 3 * 16384) if axis == -1 else (3 * 16384, 24)
    p = plan(R, C, block, axis, SMS)
    fast = (block % VEC == 0 and block <= THREADS * 8 * VEC if axis == -1
            else block % 32 == 0 and block <= 256)
    assert fast_block(block, axis) == fast
    assert (p.body == "general") == (not fast)
    if p.body == "general":
        assert p.amax_blocks > 0 and p.threads == THREADS
        if axis == 0:
            ty, width = general_tile(block)
            assert p.nv == ty and ty * width == THREADS * 8
            assert p.grid == R // block * -(-C // width)
        else:
            g = min(32, 1 << (block - 1).bit_length())
            assert p.grid == min(-(-R * C // block // (8 * (32 // g))),
                                 16 * SMS)
    assert plan(R, C, block, axis, SMS, body="general").body == "general"
    if block > 1:                      # a block that does not divide
        with pytest.raises(ValueError):
            plan(R + 1, C, block, 0, SMS) if axis == 0 else \
                plan(R, C + 1, block, -1, SMS)


def _general_rows_cover(R, C, block, grid):
    """The general body along the rows, mirrored: (index block, element)
    pairs each lane visits, as csrc/vp_block_quant.cu:general_rows walks
    them (warps of THREADS / 32 per CUDA block, groups of g lanes)."""
    g = 1
    while g < block and g < 32:
        g <<= 1
    per, nb = 32 // g, R * C // block
    step = grid * (THREADS // 32) * per
    seen = np.zeros(R * C, np.int64)
    blocks = np.zeros(nb, np.int64)
    for cta in range(grid):
        for warp in range(THREADS // 32):
            b0 = (cta * (THREADS // 32) + warp) * per
            while b0 < nb:
                for lane in range(32):
                    b, j = b0 + lane // g, lane % g
                    if b < nb:
                        if j == 0:
                            blocks[b] += 1
                        for k in range(j, block, g):
                            seen[b * block + k] += 1
                b0 += step
    return seen, blocks


def _general_cols_cover(R, C, block, grid, ty_n):
    """The general body along the columns, mirrored: a CUDA block per
    tile of `block` rows x `width` columns, each thread 8 columns of
    every ty_n-th row; the first `width` threads write the indices."""
    tx_n = THREADS // ty_n
    width = tx_n * 8
    ncb = -(-C // width)
    seen = np.zeros((R, C), np.int64)
    idx = np.zeros((R // block, C), np.int64)
    for cta in range(grid):
        tr, c0 = cta // ncb, cta % ncb * width
        for t in range(THREADS):
            if t < width and c0 + t < C:
                idx[tr, c0 + t] += 1
            tx, ty = t % tx_n, t // tx_n
            c = c0 + 8 * tx
            for r in range(ty, block, ty_n):
                for k in range(8):
                    if c + k < C:
                        seen[tr * block + r, c + k] += 1
    return seen, idx


@pytest.mark.parametrize("R,C,block", [(3, 42, 6), (5, 64, 16), (2, 96, 48),
                                       (4, 1026, 1), (2, 600, 600)],
                         ids=str)
def test_general_rows_visit_each_element_once(R, C, block):
    p = plan(R, C, block, -1, SMS, body="general")
    seen, blocks = _general_rows_cover(R, C, block, p.grid)
    assert (seen == 1).all() and (blocks == 1).all()


@pytest.mark.parametrize("R,C,block", [(48, 24, 16), (512, 40, 512),
                                       (18, 70, 6), (7, 33, 1),
                                       (160, 300, 80), (32, 600, 16)],
                         ids=str)
def test_general_cols_visit_each_element_once(R, C, block):
    p = plan(R, C, block, 0, SMS)
    assert p.body == "general"
    seen, idx = _general_cols_cover(R, C, block, p.grid, p.nv)
    assert (seen == 1).all() and (idx == 1).all()


# -- (e) the vp_block layers -----------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jq = JQuantConfig(mode="vp_block", block=64)
    tq = TQuantConfig(mode="vp_block", block=64)
    jcfg = jregistry.get_smoke_config(ARCH, jq)
    tcfg = tregistry.get_smoke_config(ARCH, tq)
    jp = jmodel.init_params(jax.random.PRNGKey(7), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jq, tq, jcfg, tcfg, tree, params_from_numpy(tree, tcfg, "cpu")


def _layer0(tree, tp, part, jq, tq):
    """Layer 0's `part` weights as both packages export them."""
    jl = {k: v[0] for k, v in tree["groups"][0]["sub0"][part].items()}
    tl = tp["layers"][0][part]
    jw, tw = {}, {}
    for name, w in tl.items():
        if w.ndim == 2:
            jw[name] = jlayers.quantize_weight(jnp.asarray(jl[name]), jq)
            tw[name] = tlayers.quantize_weight(w, tq)
        else:
            jw[name], tw[name] = jnp.asarray(jl[name]), w
    return jw, tw


def test_each_distinct_activation_quantized_once(smoke, monkeypatch):
    jq, tq, jcfg, tcfg, tree, tp = smoke
    calls = []
    real = tops.block_vp_quant

    def counted(*args, **kw):
        calls.append(tuple(args[0].shape))
        return real(*args, **kw)

    monkeypatch.setattr(tops, "block_vp_quant", counted)
    qp = tmodel.quantize_params(tp, tcfg)
    calls.clear()
    prompts = torch.from_numpy(np.random.default_rng(8).integers(
        0, tcfg.vocab, (2, 8)))
    cache = tmodel.init_cache(tcfg, 2, 12, device="cpu")
    tmodel.prefill(qp, prompts, cache, tcfg)
    L = tcfg.n_layers
    assert len(calls) == 4 * L + 1, calls      # x, o, x2, h; lm_head's


@pytest.mark.parametrize("part", ["attn", "mlp"])
def test_vp_block_layers_match_reference(smoke, part):
    """Layer 0's attention block (no cache, causal) and MLP in vp_block,
    the reference under jit as it serves: the shared activation quantized
    once gives the reference's result.  Every projection
    is exact block VP; the attention's float sums differ in order (rtol
    1e-5 and atol 1e-5 * max|out|, as tests/test_torch_block.py)."""
    jq, tq, jcfg, tcfg, tree, tp = smoke
    jw, tw = _layer0(tree, tp, part, jq, tq)
    rng = np.random.default_rng(9)
    B, S, d = 2, 8, tcfg.d_model
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    if part == "attn":
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        want = jax.jit(lambda x_, w_, p_: jattn.attn_block(
            x_, w_, jcfg, p_, "causal", None)[0])(
                jnp.asarray(x), jw, jnp.asarray(pos))
        got, _ = tattn.attn_block(torch.from_numpy(x), tw, tcfg,
                                  torch.from_numpy(pos.copy()), "causal",
                                  None)
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
    else:
        want = jax.jit(lambda x_, w_: jmlp.swiglu(x_, w_, jq))(
            jnp.asarray(x), jw)
        got = tmlp.swiglu(torch.from_numpy(x), tw, tq)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
