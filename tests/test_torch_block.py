"""The port's block-VP (`vp_block`) and FXP (`fxp`) serving modes against
the JAX package: the block quantizer, `ops.block_vp_matmul` and its int32
contract, the exported weights, `qdot`, and qwen3-0.6b SMOKE prefill and
decode, the serving CLI and one QAT step.

Inputs are made with numpy (or carried across from the JAX `init_params`
tree as numpy) and fed to both packages.  The JAX side runs as its own
tests run on the CPU: its ops dispatch to the reference oracles, and its
Pallas body runs with `interpret=True`.  Integer and format results are
compared bit for bit; float reductions at rtol 1e-5 and atol 1e-5 *
max|out| (f32 sums in another order, see tests/test_torch_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import contracts as jcontracts
from repro.configs import registry as jregistry
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import quantize as jquant
from repro.core.formats import VPFormat as JVPFormat
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.optim import optimizer as jopt
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.analysis import contracts as tcontracts
from repro_torch.analysis.contracts import VPContractError
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.core import quantize as tquant
from repro_torch.core.formats import VPFormat as TVPFormat
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.weights import params_from_numpy
from repro_torch.optim import optimizer as topt
from repro_torch.train.train_step import make_train_step

ARCH = "qwen3-0.6b"
JFXP, JVP = jlayers.canonical_formats(JQuantConfig(mode="vp"))
TFXP, TVP = tlayers.canonical_formats(TQuantConfig(mode="vp"))


def assert_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _heavy(rng, shape, scale=0.3):
    """Heavy-tailed reals with exact zeros, FXP(12, 11) grid ties and a
    few values past the format's range (saturation)."""
    x = (rng.standard_t(3, size=shape) * scale).astype(np.float32)
    flat = x.reshape(-1)
    flat[::29] = 0.0
    k = rng.integers(-2048, 2048, flat[1::11].shape)
    flat[1::11] = ((k + 0.5) * 2.0 ** -11).astype(np.float32)
    flat[2::97] = 3.0
    return x


# ---------------------------------------------------------------------------
# The block quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [16, 64, 256])
@pytest.mark.parametrize("axis", [0, -1])
def test_block_vp_quantize_and_dequantize_bit_exact(block, axis):
    shape = (512, 24) if axis == 0 else (6, 512)
    x = _heavy(np.random.default_rng(block + axis), shape)
    jm, ji = jquant.block_vp_quantize(jnp.asarray(x), JFXP, JVP, block,
                                      axis=axis)
    tm, ti = tquant.block_vp_quantize(torch.from_numpy(x), TFXP, TVP, block,
                                      axis=axis)
    assert tm.dtype == torch.int8 and ti.dtype == torch.uint8
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    want = jquant.block_vp_dequantize(jm, ji, JVP, block, axis=axis)
    got = tquant.block_vp_dequantize(tm, ti, TVP, block, axis=axis)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


def test_block_vp_quantize_rejects_ragged_axis():
    with pytest.raises(ValueError, match="not divisible"):
        tquant.block_vp_quantize(torch.zeros(4, 100), TFXP, TVP, 64)


# ---------------------------------------------------------------------------
# ops.block_vp_matmul and its contract
# ---------------------------------------------------------------------------

def _operands(rng, M, K, N, bk):
    """int8 significands over VP(7)'s whole range and uint8 indices over
    its four options, per (row, k-tile) and (k-tile, col)."""
    a_m = rng.integers(JVP.raw_min, JVP.raw_max + 1, (M, K)).astype(np.int8)
    b_m = rng.integers(JVP.raw_min, JVP.raw_max + 1, (K, N)).astype(np.int8)
    a_i = rng.integers(0, JVP.K, (M, K // bk)).astype(np.uint8)
    b_i = rng.integers(0, JVP.K, (K // bk, N)).astype(np.uint8)
    return a_m, a_i, b_m, b_i


@pytest.mark.parametrize("mkn,bk", [((256, 512, 256), 128),
                                    ((128, 256, 384), 64),
                                    ((3, 256, 131), 64)], ids=str)
def test_block_vp_matmul(mkn, bk):
    """The plain version bit for bit against the reference oracle (both
    exact per k-tile, f32 additions in k-tile order), and within 1e-5 of
    the Pallas body in interpret mode."""
    M, K, N = mkn
    ops_in = _operands(np.random.default_rng(M + N), M, K, N, bk)
    got = tops.block_vp_matmul(*map(torch.from_numpy, ops_in), TVP, TVP,
                               bk=bk)
    assert got.dtype == torch.float32
    jin = tuple(map(jnp.asarray, ops_in))
    want = np.asarray(jref.block_vp_matmul_ref(*jin, JVP, JVP, bk=bk))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(jops.block_vp_matmul(*jin, JVP, JVP, bk=bk)), want)
    blocks = (min(M, 128) if M % 8 == 0 else 8, bk, 128)
    interp = jops.block_vp_matmul(*jin, JVP, JVP, bk=bk, blocks=blocks,
                                  interpret=True)
    assert_close(got.numpy(), interp)
    bf = tops.block_vp_matmul(*map(torch.from_numpy, ops_in), TVP, TVP,
                              bk=bk, out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(bf.float().numpy(),
                                  got.to(torch.bfloat16).float().numpy())


def _raises(fn, exc):
    try:
        fn()
    except exc:
        return True
    return False


@pytest.mark.parametrize("ma,mb", [(7, 7), (8, 8), (7, 8), (4, 8), (8, 2)])
def test_block_vp_matmul_contract_matches_reference(ma, mb):
    """The int32 no-wraparound contract raises at the same depths as the
    reference's (`analysis.contracts.require_int_accum_safe`), just past
    each pair's horizon K * max|m_a m_b| <= 2^31 - 1, and through the op
    on the CPU before any work."""
    jfa, jfb = JVPFormat(ma, (11, 9, 8, 6)), JVPFormat(mb, (11, 9))
    tfa, tfb = TVPFormat(ma, (11, 9, 8, 6)), TVPFormat(mb, (11, 9))
    horizon = (2 ** 31 - 1) // ((1 << (ma - 1)) * (1 << (mb - 1)))
    for depth in (16, 256, horizon, horizon + 1, 4 * horizon):
        want = _raises(lambda: jcontracts.require_int_accum_safe(
            jfa, jfb, depth), jcontracts.VPContractError)
        assert want == (depth > horizon)
        got = _raises(lambda: tcontracts.require_int_accum_safe(
            tfa, tfb, depth), VPContractError)
        assert got == want, (ma, mb, depth)
        if depth == horizon:
            continue            # safe; the op would run a depth-K product
        z = torch.zeros((1, depth), dtype=torch.int8)
        op = _raises(lambda: tops.block_vp_matmul(
            z, torch.zeros((1, 1), dtype=torch.uint8), z.t().contiguous(),
            torch.zeros((1, 1), dtype=torch.uint8), tfa, tfb, bk=depth),
            VPContractError)
        assert op == want, (ma, mb, depth)


def test_block_vp_matmul_rejects_other_k_tile_on_cpu():
    a_m, a_i, b_m, b_i = map(torch.from_numpy, _operands(
        np.random.default_rng(0), 4, 128, 8, 64))
    with pytest.raises(ValueError, match="must equal index block size"):
        tops.block_vp_matmul(a_m, a_i, b_m, b_i, TVP, TVP, bk=64,
                             blocks=(8, 32, 8))
    with pytest.raises(ValueError, match="index shapes"):
        tops.block_vp_matmul(a_m, a_i[:, :1], b_m, b_i, TVP, TVP, bk=64)


# ---------------------------------------------------------------------------
# Exported weights and qdot
# ---------------------------------------------------------------------------

def _quant(mode, block=64, kv=False):
    return (JQuantConfig(mode=mode, block=block, quantize_kv_cache=kv),
            TQuantConfig(mode=mode, block=block, quantize_kv_cache=kv))


@pytest.mark.parametrize("mode,shape", [("fxp", (64, 48)),
                                        ("vp_block", (256, 48)),
                                        ("vp_block", (24, 8))], ids=str)
def test_quantize_weight_bit_identical(mode, shape):
    """fxp and vp_block exports equal the reference's key for key; a
    (24, 8) weight is not block-tileable and falls back to packed VP."""
    jq, tq = _quant(mode)
    w = _heavy(np.random.default_rng(shape[0]), shape, 0.05)
    want = jlayers.quantize_weight(jnp.asarray(w), jq)
    got = tlayers.quantize_weight(torch.from_numpy(w), tq)
    assert sorted(got) == sorted(want)
    if shape == (24, 8):
        assert sorted(got) == ["scale", "w_packed"]
    for key in got:
        g, wnt = got[key].numpy(), np.asarray(want[key])
        assert g.dtype == wnt.dtype, key
        np.testing.assert_array_equal(g, wnt, err_msg=key)


@pytest.mark.parametrize("mode", ["fxp", "vp_block"])
@pytest.mark.parametrize("lead", [(4,), (2, 16)], ids=["decode", "prefill"])
def test_qdot_matches_reference(mode, lead):
    jq, tq = _quant(mode)
    rng = np.random.default_rng(len(lead))
    w = _heavy(rng, (256, 96), 0.05)
    x = rng.normal(size=lead + (256,)).astype(np.float32)
    jw = jlayers.quantize_weight(jnp.asarray(w), jq)
    tw = tlayers.quantize_weight(torch.from_numpy(w), tq)
    got = tlayers.qdot(torch.from_numpy(x), tw, tq)
    assert_close(got.numpy(), jlayers.qdot(jnp.asarray(x), jw, jq))


# ---------------------------------------------------------------------------
# The model: SMOKE prefill and decode, the CLI, one QAT step
# ---------------------------------------------------------------------------

B, S, STEPS = 2, 8, 4


@pytest.fixture(scope="module")
def jax_params():
    jcfg = jregistry.get_smoke_config(ARCH, JQuantConfig(mode="vp_block"))
    return jmodel.init_params(jax.random.PRNGKey(0), jcfg)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run_jax(params, cfg, toks):
    logits, caches = jmodel.prefill(params, jnp.asarray(toks),
                                    jmodel.init_cache(cfg, B, S + STEPS), cfg)
    outs, tokens = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        tokens.append(np.asarray(tok))
        logits, caches = jmodel.decode_step(params, tok, caches, cfg)
        outs.append(np.asarray(logits))
    return outs, np.concatenate(tokens, 1)


def _run_torch(params, cfg, toks):
    logits, caches = tmodel.prefill(
        params, torch.from_numpy(toks),
        tmodel.init_cache(cfg, B, S + STEPS, device="cpu"), cfg)
    outs, tokens = [logits.numpy()], []
    for _ in range(STEPS):
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        tokens.append(tok.numpy())
        logits, caches = tmodel.decode_step(params, tok, caches, cfg)
        outs.append(logits.numpy())
    return outs, np.concatenate(tokens, 1)


@pytest.mark.parametrize("mode,kv", [("vp_block", True), ("vp_block", False),
                                     ("fxp", True), ("fxp", False)])
def test_prefill_decode_logits_and_tokens(jax_params, mode, kv):
    """Block 64 divides every SMOKE contraction dim, the vocab (256) of
    the embedding table included, so every weight, the embedding too,
    takes the block layout ({"m", "i_blk", "scale"})."""
    jq, tq = _quant(mode, kv=kv)
    jcfg = jregistry.get_smoke_config(ARCH, jq)
    tcfg = tregistry.get_smoke_config(ARCH, tq)
    jp = jmodel.quantize_params(jax_params, jcfg)
    tp = tmodel.quantize_params(
        params_from_numpy(_np_tree(jax_params), tcfg, "cpu"), tcfg)
    if mode == "vp_block":
        assert sorted(tp["embed"]) == ["i_blk", "m", "scale"]
        assert sorted(tp["layers"][0]["mlp"]["w_down"]) == [
            "i_blk", "m", "scale"]
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab, (B, S)).astype(np.int64)
    want, want_tok = _run_jax(jp, jcfg, toks)
    got, got_tok = _run_torch(tp, tcfg, toks)
    np.testing.assert_array_equal(got_tok, want_tok)
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            g, w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()),
            err_msg=f"step {step}")


def test_static_cli_runs_vp_block_on_cpu():
    report = serve.main([
        "--smoke", "--device", "cpu", "--quant", "vp_block", "--block", "64",
        "--kv-quant", "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert report["quant"] == "vp_block" and report["block"] == 64
    assert report["tokens_per_s"] > 0 and report["device"] == "cpu"


@pytest.mark.parametrize("qat_mode", ["fake", "packed"])
def test_qat_steps_in_vp_block_match_reference(jax_params, qat_mode):
    """Two train steps with float masters under mode vp_block: training
    takes the per-element QAT branch, as in the reference.  Each loss
    within 1e-5 relative."""
    jq = JQuantConfig(mode="vp_block", block=64, qat_mode=qat_mode)
    tq = TQuantConfig(mode="vp_block", block=64, qat_mode=qat_mode)
    jcfg = jregistry.get_smoke_config(ARCH, jq)
    tcfg = tregistry.get_smoke_config(ARCH, tq)
    opt_kw = dict(lr=1e-3, warmup_steps=1, total_steps=2)
    data = tdata.SyntheticLM(tdata.DataConfig(tcfg.vocab, 16, 4, seed=3),
                             device="cpu")
    batches = [data.batch_at(i) for i in range(2)]

    jstep = jax.jit(j_make_train_step(jcfg, jopt.OptConfig(**opt_kw)))
    jp = jax_params
    jo = jopt.init_opt_state(jp, jopt.OptConfig(**opt_kw))
    want = []
    for b in batches:
        jp, jo, m = jstep(jp, jo, {k: jnp.asarray(v.numpy())
                                   for k, v in b.items()})
        want.append(float(m["loss"]))

    tp = tmodel.stack_layers(params_from_numpy(_np_tree(jax_params), tcfg,
                                               "cpu"), tcfg)
    tstep = make_train_step(tcfg, topt.OptConfig(**opt_kw))
    to = topt.init_opt_state(tp, topt.OptConfig(**opt_kw))
    got = []
    for b in batches:
        tp, to, m = tstep(tp, to, b)
        got.append(float(m["loss"]))
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_train_cli_accepts_block_and_fxp_modes():
    from repro_torch.launch import train as train_cli
    for mode in ("vp_block", "fxp"):
        report = train_cli.main([
            "--smoke", "--device", "cpu", "--steps", "1", "--batch", "2",
            "--seq", "16", "--quant", mode, "--log-every", "1"])
        assert len(report["steps"]) == 1
        assert np.isfinite(report["steps"][0]["loss"])

