"""Formats past the canonical kernels' first widths against the JAX
package, and the card wrappers' host-side checks over every format the
contracts pass.

  (a) The refusal sweep: for every VP(M, E) on FXP(12, 11) that
      `require_quant_safe` passes (M 2-16, E 0-7), none of the card
      wrappers' checks that need no card refuses it: the format structs
      (`build.vp_fmt_struct`, `build.quant_fmt_struct`, K up to 128),
      `plan_decode` at every config's (dh, G) at the format's word width
      (int32 words at stablelm's dh 160 and gemma3's 168 on 32-byte
      lanes), the packed and planes dequants' widths, and, at every
      block where `require_int_accum_safe` passes, the vp_block
      quantizer's and matmul's significand checks.  E 8 fails the
      contract (no VP format is refused by a wrapper alone).
  (b) The plain path against the JAX package at int32 words (VP(13, E
      4), VP(16, E 1), VP(10, E 7)) and E 5 / E 7: quantize (words and
      planes), the KV cache's write, both dequants and the serving
      matmul, bit for bit (the matmul at f32 tolerance); int16 vp_block
      (M 10 E 2, M 12 E 3) at blocks 16 and 256: the block quantizer
      and the block matmul bit for bit.
  (c) The serving dicts of the wide formats hold the widths the card's
      wrappers take.  A SMOKE serve per format is in
      tests/test_torch_wide_serve.py (the two files each stay under a
      minute on one worker).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import contracts as jcontracts
from repro.core import formats as jformats
from repro.core import quantize as jquantize
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro_torch.analysis import contracts as tcontracts
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.core import formats as tformats
from repro_torch.core.packing import storage_dtype
from repro_torch.core.vp_tensor import SIGNIFICAND_DTYPES, significand_dtype
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.vp_attention import plan_decode
from repro_torch.kernels.vp_block_matmul import block_body, significand_width
from repro_torch.kernels.vp_block_quant import significand_planes
from repro_torch.kernels.vp_dequant import PACKED_DTYPES
from repro_torch.models import model as tmodel

TFXP = tformats.FXPFormat(12, 11)
JFXP = jformats.FXPFormat(12, 11)


def quant_safe(M, E):
    try:
        tcontracts.require_quant_safe(
            TFXP, tformats.default_vp_format(TFXP, M, E))
    except tcontracts.VPContractError:
        return False
    return True


SWEEP = [(M, E) for M in range(2, 17) for E in range(0, 9)
         if quant_safe(M, E)]
ARCHS = tregistry.ARCH_NAMES


# -- (a) the refusal sweep --------------------------------------------------

def test_the_sweep_covers_every_e_up_to_7():
    """Every M 2-16 passes at every E 0-7 and none at E 8 (K 256), so the
    wrappers must take K up to 128; the reference agrees."""
    assert SWEEP == [(M, E) for M in range(2, 17) for E in range(8)]
    for M in (2, 7, 16):
        with pytest.raises(jcontracts.VPContractError):
            jcontracts.require_quant_safe(
                JFXP, jformats.default_vp_format(JFXP, M, 8))
        jcontracts.require_quant_safe(JFXP, jformats.default_vp_format(
            JFXP, M, 7))


@pytest.mark.parametrize("M,E", SWEEP, ids=str)
def test_no_card_wrapper_refuses_a_contract_format(M, E):
    vp = tformats.default_vp_format(TFXP, M, E)
    s = build.vp_fmt_struct(vp)
    n = min(vp.K, build.VP_CHAIN_K)   # the rest: a table on the card
    assert s.K == vp.K and [s.scale[k] for k in range(n)] == [
        2.0 ** -f for f in vp.f[:n]]
    q = build.quant_fmt_struct(TFXP, vp)
    assert [q.shift[k] for k in range(n)] == [TFXP.F - f for f in vp.f[:n]]
    words = storage_dtype(vp)
    assert words in PACKED_DTYPES
    assert significand_dtype(M) in SIGNIFICAND_DTYPES
    for arch in ARCHS:
        cfg = tregistry.get_config(arch)
        G = cfg.n_heads // cfg.n_kv_heads
        for smax in (160, 4096):
            plan = plan_decode(cfg.n_kv_heads, smax, G, cfg.head_dim,
                               words.itemsize)
            assert plan.rows(G) * plan.slices >= G
    for bk in (16, 256):
        try:
            tcontracts.require_int_accum_safe(vp, vp, bk)
        except tcontracts.VPContractError:
            continue
        dt = significand_planes(vp)
        width = significand_width(dt, dt)
        assert block_body(4, 1024, 3072, bk, True, width) in (
            "skinny", "dp4a", "int16")


@pytest.mark.parametrize("E", [5, 7])
def test_wide_tables_are_made_per_cuda_device(E):
    """A wide format's struct is cached per (format, device): made
    without a device or for the CPU it carries no table in device memory
    (the card's wrappers pass their tensors' device), and the CPU's
    struct is not the one a CUDA device would get."""
    vp = tformats.default_vp_format(TFXP, 7, E)
    cpu = torch.device("cpu")
    for s in (build.vp_fmt_struct(vp), build.vp_fmt_struct(vp, cpu)):
        assert s.K == vp.K and not s.wide
    q = build.quant_fmt_struct(TFXP, vp, cpu)
    assert not q.wide_shift and not q.vp.wide
    assert build.vp_fmt_struct(vp, cpu) is not build.vp_fmt_struct(vp)
    assert build.vp_fmt_struct(vp, cpu) is build.vp_fmt_struct(vp, cpu)
    assert not any(cpu in key for key in build._WIDE_TABLES)


def test_int32_decode_lanes_reach_dh_168():
    """int32 rows past dh 128 read on 32-byte lanes (8 words), at most 4
    query rows a slice; every plan that existed keeps its lanes."""
    p = plan_decode(8, 160, 4, 160, 4)
    assert (p.lane_bytes, p.lpp, p.slices) == (32, 32, 1)
    p = plan_decode(16, 1024, 2, 168, 4)
    assert (p.lane_bytes, p.lpp, p.slices) == (32, 32, 1)
    assert plan_decode(8, 160, 8, 160, 4).slices == 2
    assert plan_decode(4, 160, 8, 64, 4).lane_bytes == 16
    assert plan_decode(8, 4096, 6, 128, 4).lane_bytes == 16
    with pytest.raises(ValueError):
        plan_decode(8, 160, 2, 264, 4)


# -- (b) kernels' plain versions against the JAX package ---------------------

WIDE = {"M13E4": (13, 4), "M16E1": (16, 1), "M10E7": (10, 7),
        "M7E5": (7, 5), "M7E7": (7, 7)}


def fmts(M, E):
    return (tformats.default_vp_format(TFXP, M, E),
            jformats.default_vp_format(JFXP, M, E))


@pytest.mark.parametrize("key", sorted(WIDE))
def test_wide_formats_quantize_and_dequantize(key):
    tvp, jvp = fmts(*WIDE[key])
    assert tvp.f == jvp.f
    rng = np.random.default_rng(WIDE[key][0] * 10 + WIDE[key][1])
    x = np.concatenate([rng.normal(0, 0.3, 594), rng.normal(0, 1e-3, 200),
                        [0.0, 2 ** -11, -1.0, 0.9995, 3 * 2 ** -12,
                         -2 ** -30]]).astype(np.float32).reshape(-1, 16)
    tw = tops.vp_quant(torch.from_numpy(x), TFXP, tvp, packed=True)
    jw = np.asarray(jops.vp_quant(jnp.asarray(x), JFXP, jvp, packed=True))
    assert tw.dtype == storage_dtype(tvp)
    np.testing.assert_array_equal(tw.numpy(), jw)
    tm, ti = tops.vp_quant(torch.from_numpy(x), TFXP, tvp)
    jm, ji = jops.vp_quant(jnp.asarray(x), JFXP, jvp)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = tops.vp_dequant(tw, None, tvp, tdt).to(torch.float32).numpy()
        want = np.asarray(jops.vp_dequant(jnp.asarray(jw), None, jvp,
                                          dtype=jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)
        got = tops.vp_dequant(tm, ti, tvp, tdt).to(torch.float32).numpy()
        want = np.asarray(jops.vp_dequant(jm, ji, jvp, dtype=jdt).astype(
            jnp.float32))
        np.testing.assert_array_equal(got, want)
    # the serving matmul over these words
    xs = rng.normal(size=(5, x.shape[0])).astype(np.float32)
    got = tops.vp_dequant_matmul(torch.from_numpy(xs), tw, tvp).numpy()
    want = np.asarray(jops.vp_dequant_matmul(jnp.asarray(xs),
                                             jnp.asarray(jw), jvp))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # the KV cache's write: per-position pow2 scales and words
    kv = rng.normal(0, 2.0, (2, 3, 2, 16)).astype(np.float32)
    gw, gs = tops.vp_quant_scaled(torch.from_numpy(kv), TFXP, tvp)
    ww, ws = tref.vp_quant_scaled_ref(torch.from_numpy(kv), TFXP, tvp)
    assert torch.equal(gw, ww) and torch.equal(gs, ws)
    np.testing.assert_array_equal(gw.numpy(), np.asarray(jops.vp_quant(
        jnp.asarray(kv / gs.numpy()), JFXP, jvp, packed=True)))


BLOCK_WIDE = {"M10E2": (10, 2), "M12E3": (12, 3)}


@pytest.mark.parametrize("bk", [16, 256])
@pytest.mark.parametrize("key", sorted(BLOCK_WIDE))
def test_int16_vp_block_quantize_and_matmul(key, bk):
    """x / pow2(x) block-quantized along rows (activations) and columns
    (weights) into int16 significands, then the block matmul, all bit for
    bit against the reference's `block_vp_quantize` and its op."""
    tvp, jvp = fmts(*BLOCK_WIDE[key])
    tcontracts.require_int_accum_safe(tvp, tvp, bk)
    rng = np.random.default_rng(bk)
    M, K, N = 6, 512, 40
    a = rng.normal(0, 1.5, (M, K)).astype(np.float32)
    b = rng.normal(0, 0.05, (K, N)).astype(np.float32)
    b[:bk, 3] *= 1e-3                       # a quiet block
    got = {}
    for name, x, axis in (("a", a, -1), ("b", b, 0)):
        m, i, s = tops.block_vp_quant(torch.from_numpy(x), TFXP, tvp, bk,
                                      axis=axis)
        js = jlayers._pow2_scale(jnp.asarray(x))
        jm, ji = jquantize.block_vp_quantize(jnp.asarray(x) / js, JFXP, jvp,
                                             bk, axis=axis)
        assert m.dtype == torch.int16
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        assert float(s) == float(js)
        got[name] = (m, i)
    out = tops.block_vp_matmul(*got["a"], *got["b"], tvp, tvp, bk=bk)
    want = jops.block_vp_matmul(*(jnp.asarray(t.numpy()) for t in
                                  (*got["a"], *got["b"])), jvp, jvp, bk=bk)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_wide_configs_export_the_widths_the_kernels_take():
    """The serving dicts of the wide formats hold the widths the card's
    wrappers take: int32 words, int16 block significands."""
    for quant, key, dt in ((dict(mode="vp", M=13, E=4), "w_packed",
                            torch.int32),
                           (dict(mode="vp_block", block=16, M=10, E=2), "m",
                            torch.int16)):
        cfg = tregistry.get_smoke_config("qwen3-0.6b", TQuantConfig(**quant))
        cfg = dataclasses.replace(cfg, n_layers=1)
        qp = tmodel.quantize_params(tmodel.init_params(cfg, 0, "cpu"), cfg)
        assert qp["layers"][0]["mlp"]["w_up"][key].dtype == dt
