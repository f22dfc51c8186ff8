"""User-chosen formats and layouts against the JAX package, and the
repaired split decode body's plans and arithmetic.

  (a) `--M` / `--E` formats (6/2 and 5/3 in int8 words, 7/2, 10/2)
      exported bit-identical to the reference's `quantize_weight`, in
      the packed layout and (E in {1, 2, 4, 8}) the planes layout; E = 3
      planes raises in both; qwen2's vp_block export at block 128, where
      only the d_ff-contracting weights tile and the rest fall back to
      per-element VP, in both layouts.
  (b) Two model runs, the reference once per config: qwen2 SMOKE served
      from planes weights in VP(6, E=2) (int8 weight and KV words), and
      stablelm SMOKE in fxp with the planes KV cache: logits at rtol 1e-5
      and atol 1e-5 * max|logit|, greedy tokens equal.
  (c) `require_quant_safe` raises or passes as the reference's does over
      a grid of (FXP, VP) formats, f > F included, with the same
      explanation; the quantize ops call it at entry.
  (d) `vp_math` (products, concatenated indices, VP2FXP, the product
      scale table) bit-identical to the reference on random operands;
      `VPTensor` as the reference's.
  (e) `plan_decode` takes qwen2's G = 7 (two slices of the query rows)
      and gemma3's dh = 168 (8-byte lanes) at 1-byte words, and every
      shape that planned before keeps its plan; a numpy mirror of the
      split body's arithmetic (a lane's words, the position's shuffle
      tree, the G slices, the slot, warp and cluster merges) matches the
      plain version and the JAX package, and gives every row the same
      bits in every slicing.
  (f) The serve CLI on the CPU with `--layout planes --M 6 --E 2`.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import contracts as jcontracts
from repro.configs import registry as jregistry
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import formats as jformats
from repro.core import vp_math as jvp_math
from repro.core.vp_tensor import VPTensor as JVPTensor
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.analysis import contracts as tcontracts
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.core import formats as tformats
from repro_torch.core import vp_math as tvp_math
from repro_torch.core.packing import dequant_words
from repro_torch.core.vp_tensor import VPTensor as TVPTensor
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.vp_attention import (DEC_MAX_G, DecodePlan,
                                              decode_runs, plan_decode)
from repro_torch.launch import serve
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.weights import params_from_numpy
from test_torch_dense_families import (assert_logits_close,
                                       assert_words_equal, float_params,
                                       np_tree, run_jax, run_torch)

FORMATS = [(6, 2), (5, 3), (7, 2), (10, 2)]


def _weight(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 0.05, shape).astype(np.float32)


# -- (a) formats and layouts at export ------------------------------------------

@pytest.mark.parametrize("layout", ["packed", "planes"])
@pytest.mark.parametrize("M,E", FORMATS, ids=str)
def test_format_export_bit_identical(M, E, layout):
    w = _weight((96, 40), seed=M * 10 + E)    # 96 rows: 8 // E divides
    jq = JQuantConfig(mode="vp", M=M, E=E)
    tq = TQuantConfig(mode="vp", M=M, E=E)
    if layout == "planes" and E not in (1, 2, 4, 8):
        with pytest.raises(ValueError):
            jlayers.quantize_weight(jnp.asarray(w), jq, layout=layout)
        with pytest.raises(ValueError):
            tlayers.quantize_weight(torch.from_numpy(w), tq, layout=layout)
        return
    want = np_tree(jlayers.quantize_weight(jnp.asarray(w), jq, layout=layout))
    got = tlayers.quantize_weight(torch.from_numpy(w), tq, layout=layout)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    if layout == "packed":
        assert got["w_packed"].element_size() == (1 if M + E <= 8 else 2)
    # the planes weight as the reference's `_dequant_vp_weight` gives it
    if layout == "planes":
        deq = tlayers.dequant_planes_weight(got, tq, torch.float32)
        jdeq = jlayers._dequant_vp_weight(
            jax.tree_util.tree_map(jnp.asarray, want), jq, jnp.float32)
        np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))


@pytest.mark.parametrize("layout", ["packed", "planes"])
def test_padded_planes_and_vp_block_fallback_export(layout):
    """qwen2 SMOKE at block 128 (d_model 64: only w_down's d_ff = 128
    tiles; the rest fall back, as at full width, where 896 does not
    divide by 256), and an odd d_in that the planes pad to 8 // E."""
    arch = "qwen2-0.5b"
    jcfg = jregistry.get_smoke_config(
        arch, JQuantConfig(mode="vp_block", block=128))
    tcfg = tregistry.get_smoke_config(
        arch, TQuantConfig(mode="vp_block", block=128))
    tree = float_params(arch, jcfg)
    jq = jmodel.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree),
                                jcfg, layout=layout)
    tq = tmodel.quantize_params(params_from_numpy(tree, tcfg, "cpu"), tcfg,
                                layout=layout)
    assert_words_equal(tq, params_from_numpy(np_tree(jq), tcfg, "cpu"))
    layer = tq["layers"][0]
    assert "i_blk" in layer["mlp"]["w_down"]
    fallback = "w_packed" if layout == "packed" else "i_packed"
    assert all(fallback in layer["attn"][k] for k in ("wq", "wk", "wv", "wo"))
    assert fallback in layer["mlp"]["w_up"] and "i_blk" in tq["embed"]
    w = _weight((37, 8), seed=3)
    q = TQuantConfig(mode="vp")
    got = tlayers.quantize_weight(torch.from_numpy(w), q, layout=layout)
    want = np_tree(jlayers.quantize_weight(jnp.asarray(w), JQuantConfig(
        mode="vp"), layout=layout))
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_planes_embedding_gathers_rows_bit_identical():
    tq = TQuantConfig(mode="vp", M=6, E=2)
    w = _weight((52, 16), seed=7)
    table = tlayers.quantize_weight(torch.from_numpy(w), tq, layout="planes")
    toks = torch.tensor([[0, 51, 3], [17, 4, 50]])
    got = tlayers.embed_lookup(toks, table, tq)
    jtable = jax.tree_util.tree_map(jnp.asarray, jlayers.quantize_weight(
        jnp.asarray(w), JQuantConfig(mode="vp", M=6, E=2), layout="planes"))
    want = jlayers.embed_lookup(jnp.asarray(toks.numpy()), jtable,
                                JQuantConfig(mode="vp", M=6, E=2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- (b) model runs in the new formats --------------------------------------------

RUNS = {
    "qwen2-0.5b": dict(mode="vp", M=6, E=2, quantize_kv_cache=True),
    "stablelm-12b": dict(mode="fxp", quantize_kv_cache=True,
                         kv_layout="planes"),
}
LAYOUT = {"qwen2-0.5b": "planes", "stablelm-12b": "packed"}


@pytest.mark.parametrize("arch", sorted(RUNS))
def test_formats_end_to_end(arch):
    jcfg = jregistry.get_smoke_config(arch, JQuantConfig(**RUNS[arch]))
    tcfg = tregistry.get_smoke_config(arch, TQuantConfig(**RUNS[arch]))
    tree = float_params(arch, jcfg, seed=1)
    layout = LAYOUT[arch]
    jq = jmodel.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree),
                                jcfg, layout=layout)
    tq = tmodel.quantize_params(params_from_numpy(tree, tcfg, "cpu"), tcfg,
                                layout=layout)
    assert_words_equal(tq, params_from_numpy(np_tree(jq), tcfg, "cpu"))
    toks = np.random.default_rng(2).integers(0, tcfg.vocab, (2, 8)).astype(
        np.int64)
    want, want_tok, _ = run_jax(jq, jcfg, toks, steps=4)
    got, got_tok, caches = run_torch(tq, tcfg, toks, steps=4)
    np.testing.assert_array_equal(got_tok, want_tok)
    assert_logits_close(got, want)
    if arch == "qwen2-0.5b":   # int8 weight and KV words
        assert tq["layers"][0]["attn"]["wq"]["m"].dtype == torch.int8
        assert caches[0]["k_w"].dtype == torch.int8
    else:
        assert "k_m" in caches[0]


def test_remat_configs_refuse_training():
    """gemma3's and stablelm's full configs set remat="full", which the
    port now trains with (tests/test_torch_remat.py holds it against the
    reference); every family trains now, and what is refused is a batch
    without the stub input its family needs: an encoder-decoder's
    "frames", a VLM's "patches", each named."""
    for arch in ("gemma3-27b", "stablelm-12b"):
        assert tregistry.get_config(arch).remat == "full"
    cfg = dataclasses.replace(tregistry.get_smoke_config("gemma3-27b"),
                              remat="full", n_layers=3)
    params = tmodel.stack_layers(tmodel.init_params(cfg, 0, device="cpu"),
                                 cfg)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    loss, _ = tmodel.loss_fn(params, {"tokens": toks, "labels": toks}, cfg)
    assert bool(torch.isfinite(loss))
    for family, key in (("encdec", "frames"), ("vlm", "patches")):
        with pytest.raises(ValueError, match=key):
            tmodel.loss_fn(params, {"tokens": toks, "labels": toks},
                           dataclasses.replace(cfg, family=family))


# -- (c) the quantize contract --------------------------------------------------

GRID = [((W, F), (M, f))
        for W, F in ((8, 7), (12, 11), (16, 8), (24, 23))
        for M, f in ((7, (11, 9, 8, 6)), (6, (11, 8)), (7, (20, 9)),
                     (5, (30, 12, 3, 0)), (8, (40, 2)), (7, (150, 1)),
                     (4, (3, -2)))]


@pytest.mark.parametrize("fxp,vp", GRID, ids=str)
def test_require_quant_safe_as_the_reference(fxp, vp):
    jf, jv = jformats.FXPFormat(*fxp), jformats.VPFormat(*vp)
    tf, tv = tformats.FXPFormat(*fxp), tformats.VPFormat(*vp)
    try:
        jcontracts.require_quant_safe(jf, jv)
        want = None
    except jcontracts.VPContractError as e:
        want = str(e)
    if want is None:
        assert tcontracts.require_quant_safe(tf, tv) is True
        return
    with pytest.raises(tcontracts.VPContractError) as info:
        tcontracts.require_quant_safe(tf, tv)
    got = str(info.value)
    assert got.startswith("static contract violation in vp_quant:")
    # every problem line of the port's is the reference's
    for line in got.splitlines()[1:]:
        assert line in want.splitlines(), line


def test_quant_ops_check_the_contract_at_entry():
    fxp, vp = tformats.FXPFormat(16, 8), tformats.VPFormat(7, (40, 2))
    x = torch.zeros((4, 4))
    for call in (lambda: tops.vp_quant(x, fxp, vp),
                 lambda: tops.vp_quant(x, fxp, vp, packed=True),
                 lambda: tops.vp_quant_scaled(x, fxp, vp),
                 lambda: tops.vp_quant_matmul(x, x, fxp, vp, fxp, vp),
                 lambda: tops.vp_quant_matmul_batched(x[None], x[None], fxp,
                                                      vp, fxp, vp),
                 lambda: tops.vp_qat_matmul(x, x, fxp, vp)):
        with pytest.raises(tcontracts.VPContractError):
            call()


# -- (d) vp_math and VPTensor -----------------------------------------------------

PAIRS = [((7, (11, 9, 8, 6)), (7, (11, 9, 8, 6)), (24, 22)),
         ((6, (11, 8)), (8, (7, 5, 3, 1)), (20, 12)),
         ((9, (12, 10, 9, 5)), (5, (4, 0)), (16, 8))]


@pytest.mark.parametrize("a,b,out", PAIRS, ids=str)
def test_vp_math_bit_identical(a, b, out):
    rng = np.random.default_rng(sum(a[1]) + b[0])
    ja, jb = jformats.VPFormat(*a), jformats.VPFormat(*b)
    ta, tb = tformats.VPFormat(*a), tformats.VPFormat(*b)
    n = 4096
    m_a = rng.integers(ja.raw_min, ja.raw_max + 1, n).astype(np.int32)
    m_b = rng.integers(jb.raw_min, jb.raw_max + 1, n).astype(np.int32)
    i_a = rng.integers(0, ja.K, n).astype(np.int32)
    i_b = rng.integers(0, jb.K, n).astype(np.int32)
    m_a[:2], m_b[:2] = ja.raw_min, jb.raw_min          # the one wide product
    jm, ji, jp = jvp_math.vp_mul(m_a, i_a, ja, m_b, i_b, jb)
    tm, ti, tp = tvp_math.vp_mul(*map(torch.from_numpy, (m_a, i_a)), ta,
                                 *map(torch.from_numpy, (m_b, i_b)), tb)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (tp.M, tp.f) == (jp.M, jp.f)
    fx_j, fx_t = jformats.FXPFormat(*out), tformats.FXPFormat(*out)
    want = jvp_math.vp_mul_to_fxp(m_a, i_a, ja, m_b, i_b, jb, fx_j)
    got = tvp_math.vp_mul_to_fxp(*map(torch.from_numpy, (m_a, i_a)), ta,
                                 *map(torch.from_numpy, (m_b, i_b)), tb, fx_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        lut = tvp_math.product_scale_lut(ta, tb, dt).to(torch.float32)
        jlut = np.asarray(jvp_math.product_scale_lut(ja, jb, jdt),
                          np.float32)
        np.testing.assert_array_equal(lut.numpy(), jlut)


def test_vp_tensor_as_the_reference():
    rng = np.random.default_rng(0)
    for M, f in ((7, (11, 9, 8, 6)), (12, (14, 9)), (5, (3, 2, 1, 0))):
        jv, tv = jformats.VPFormat(M, f), tformats.VPFormat(M, f)
        fx = (12, 11)
        m = rng.integers(jv.raw_min, jv.raw_max + 1, (3, 5))
        i = rng.integers(0, jv.K, (3, 5)).astype(np.uint8)
        jt = JVPTensor(m=jnp.asarray(m, jnp.int8 if M <= 8 else jnp.int16),
                       i=jnp.asarray(i), fmt=jv,
                       fxp=jformats.FXPFormat(*fx))
        tt = TVPTensor(m=torch.from_numpy(m).to(torch.int8 if M <= 8
                                                else torch.int16),
                       i=torch.from_numpy(i), fmt=tv,
                       fxp=tformats.FXPFormat(*fx))
        assert tuple(tt.shape) == tuple(jt.shape) == (3, 5)
        assert tt.storage_bits_per_element == jt.storage_bits_per_element
        assert repr(tt) == repr(jt)
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            np.testing.assert_array_equal(
                tt.to_float(dt).to(torch.float32).numpy(),
                np.asarray(jt.to_float(jdt), np.float32))


# -- (e) the split decode body at the new shapes -----------------------------------

F32 = np.float32


def _xor_tree(vals: np.ndarray, offsets) -> np.ndarray:
    """Every lane's value after `v += shfl_xor(v, o)` for o in offsets,
    along axis 0 (the lanes), in f32."""
    v = vals.copy()
    for o in offsets:
        v = (v + v[np.arange(v.shape[0]) ^ o]).astype(F32)
    return v


def split_mirror(q, k, v, ks, vs, length, plan: DecodePlan, nw: int,
                 window=None, rolling=False, rows=None):
    """The split body's arithmetic for one (batch, kv head): q (G, dh)
    f32 scaled, k / v (smax, dh) dequantized f32, ks / vs (smax,) ->
    (G, dh); `nw` words a lane.  Rows in slices of `rows` (default the
    plan's), each computed on its own as a block of the grid's z axis
    computes it."""
    G, dh = q.shape
    smax = k.shape[0]
    lpp, step = plan.lpp, plan.step
    lanes = -(-dh // nw)
    pad = lpp * nw - dh            # the tail lane's words past dh are 0
    qp = np.concatenate([q, np.zeros((G, pad), F32)], 1).reshape(G, lpp, nw)
    kp = np.concatenate([k, np.zeros((smax, pad), F32)], 1).reshape(
        smax, lpp, nw)
    rows = rows or plan.rows(G)
    out = np.empty((G, dh), F32)
    runs = decode_runs(plan, length, smax, window, rolling)
    for g0 in range(0, G, rows):
        sl = slice(g0, min(G, g0 + rows))
        warp_parts = []
        for r_lo, r_hi in runs:
            slot_parts = []
            for slot in range(step):
                m = np.full(sl.stop - sl.start, -1e30, F32)
                l = np.zeros_like(m)
                acc = np.zeros((len(m), dh), F32)
                for t in range(r_lo + slot, r_hi, step):
                    # per lane an FMA chain over its words, then the lanes
                    # of the position by a shuffle tree
                    part = np.zeros((lpp, len(m)), F32)
                    for j in range(nw):
                        part = (part.astype(np.float64) + qp[sl, :, j].T
                                .astype(np.float64) * kp[t, :, j][:, None]
                                ).astype(F32)
                    part[lanes:] = 0
                    s = _xor_tree(part, [lpp >> (b + 1) for b in range(
                        lpp.bit_length() - 1)])[0] * ks[t]
                    e = np.exp(-np.abs(s - m)).astype(F32)
                    up = s > m
                    alpha = np.where(up, e, F32(1))
                    p = np.where(up, F32(1), e)
                    m = np.where(up, s, m).astype(F32)
                    l = (l * alpha + p).astype(F32)
                    acc = ((p * vs[t])[:, None] * v[t] + acc * alpha[:, None]
                           ).astype(F32)
                slot_parts.append((m, l, acc))
            # the warp's slots: max over all, then an xor tree over slots
            mw = np.max([p[0] for p in slot_parts], 0)
            scaled = [(l * np.exp(m - mw), a * np.exp(m - mw)[:, None])
                      for m, l, a in slot_parts]
            ls = _xor_tree(np.stack([x[0] for x in scaled]),
                           [1 << b for b in range(step.bit_length() - 1)])
            accs = _xor_tree(np.stack([x[1] for x in scaled]),
                             [1 << b for b in range(step.bit_length() - 1)])
            warp_parts.append((mw, ls[0], accs[0]))
        # the block's warps in warp order, then the cluster's blocks
        blocks = []
        for b in range(plan.cluster):
            part = warp_parts[b * plan.warps:(b + 1) * plan.warps]
            blocks.append(_ordered_merge(part))
        m, l, acc = _ordered_merge(blocks)
        out[sl] = acc / np.maximum(l, F32(1e-30))[:, None]
    return out


def _ordered_merge(parts):
    mt = np.max([p[0] for p in parts], 0)
    l, acc = np.zeros_like(mt), np.zeros_like(parts[0][2])
    for m, li, ai in parts:
        sc = np.exp(m - mt).astype(F32)
        l = (l + li * sc).astype(F32)
        acc = (acc + ai * sc[:, None]).astype(F32)
    return mt, l, acc


INT8_VP = tlayers.canonical_formats(TQuantConfig(M=6, E=2))[1]  # int8 words
INT8_JVP = jlayers.canonical_formats(JQuantConfig(M=6, E=2))[1]
# (KV, smax, G, dh, lengths, window, rolling): qwen2's G 7 over a full
# cache, gemma3's dh 168 over a rolling ring past its wrap
NEW_SHAPES = {"qwen2_g7": (2, 40, 7, 64, [13, 40], None, False),
              "gemma3_dh168": (2, 24, 2, 168, [50, 11], 24, True)}


def test_decode_plans_take_the_new_shapes():
    assert INT8_VP.storage_bits == 8 and INT8_VP.f == INT8_JVP.f
    plan = plan_decode(2, 160, 7, 64, 1)
    assert (plan.slices, plan.rows(7), plan.lane_bytes) == (2, 4, 16)
    plan = plan_decode(16, 1024, 2, 168, 1)
    assert (plan.slices, plan.lane_bytes, plan.lpp) == (1, 8, 32)
    assert plan_decode(8, 160, 4, 160, 1).lane_bytes == 16
    # shapes that planned before keep their plan: one slice, 16-byte lanes
    for shape in [(8, 160, 2, 64, 2), (8, 160, 2, 64, 1), (2, 160, 7, 64, 2),
                  (16, 1024, 2, 168, 2), (8, 160, 4, 160, 2),
                  (8, 160, 4, 64, 1)]:
        p = plan_decode(*shape)
        assert (p.slices, p.lane_bytes) == (1, 16), shape
    assert DEC_MAX_G == {16: 4, 8: 8, 4: 8}
    assert plan_decode(2, 160, 14, 64, 1).rows(14) == 4
    assert plan_decode(2, 1024, 14, 168, 1).rows(14) == 7


@pytest.mark.parametrize("case", sorted(NEW_SHAPES))
def test_split_mirror_at_the_new_shapes(case):
    KV, smax, G, dh, lengths, window, rolling = NEW_SHAPES[case]
    B = len(lengths)
    rng = np.random.default_rng(dh + G)
    q = rng.normal(size=(B, 1, KV * G, dh)).astype(F32)
    k_w = rng.integers(-128, 128, (B, smax, KV, dh)).astype(np.int8)
    v_w = rng.integers(-128, 128, (B, smax, KV, dh)).astype(np.int8)
    k_s = (2.0 ** rng.integers(-3, 3, (B, smax, 1, 1))).astype(F32)
    v_s = (2.0 ** rng.integers(-3, 3, (B, smax, 1, 1))).astype(F32)
    ln = np.asarray(lengths, np.int32)
    plan = plan_decode(KV, smax, G, dh, 1)
    kd = dequant_words(torch.from_numpy(k_w), INT8_VP).numpy()
    vd = dequant_words(torch.from_numpy(v_w), INT8_VP).numpy()
    qs = (q.reshape(B, KV, G, dh) * F32(dh ** -0.5)).astype(F32)
    got = np.empty((B, KV, G, dh), F32)
    for b in range(B):
        for h in range(KV):
            args = (qs[b, h], kd[b, :, h], vd[b, :, h], k_s[b, :, 0, 0],
                    v_s[b, :, 0, 0], int(ln[b]), plan, plan.lane_bytes,
                    window, rolling)
            got[b, h] = split_mirror(*args)
            # each row's bits are the same in every slicing of the rows
            for rows in {1, 3, G}:
                np.testing.assert_array_equal(
                    split_mirror(*args, rows=rows), got[b, h])
    got = got.reshape(B, 1, KV * G, dh)
    kw = dict(window=window, rolling=rolling)
    targs = tuple(map(torch.from_numpy, (q, k_w, v_w, k_s, v_s, ln)))
    want = tref.vp_decode_attention_ref(*targs, INT8_VP, **kw).numpy()
    jwant = np.asarray(jops.vp_decode_attention(
        *map(jnp.asarray, (q, k_w, v_w, k_s, v_s, ln)), INT8_JVP, **kw))
    for w in (want, jwant):
        np.testing.assert_allclose(got, w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))


# -- (f) the CLI -------------------------------------------------------------------

def test_serve_cli_formats_on_cpu(tmp_path):
    out = tmp_path / "report.json"
    report = serve.main([
        "--arch", "qwen2-0.5b", "--smoke", "--device", "cpu", "--quant", "vp",
        "--layout", "planes", "--M", "6", "--E", "2", "--kv-quant",
        "--batch", "2", "--prompt-len", "8", "--gen", "3",
        "--json", str(out)])
    assert json.loads(out.read_text()) == report
    assert (report["layout"], report["M"], report["E"]) == ("planes", 6, 2)
    assert report["tokens_per_s"] > 0 and report["arch"] == "qwen2-0.5b"
