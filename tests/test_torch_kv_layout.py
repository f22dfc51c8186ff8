"""The port's KV cache layouts and chunked prefill against the JAX package.

  * `pack_indices` / `unpack_indices` bit for bit, every E;
  * the planes layout's `quantize_kv(layout="planes")`, `dequantize_kv`
    and the packed `dequantize_kv_packed`, bit for bit on the same numpy
    inputs (f32 and bf16);
  * `_chunked_prefill_attention`, and a whole prompt prefilled in two
    parts (a prefill, then a chunked prefill) on qwen3-0.6b SMOKE in
    every KV layout, at 1e-5 of max|value| in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import vp_tensor as jvpt
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.core import vp_tensor as tvpt
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.weights import params_from_numpy

KV_LAYOUTS = ("float", "packed", "planes")


def _np(x):
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _torch(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _same(got: torch.Tensor, want, what: str):
    """Bit-for-bit equality of a port tensor and a JAX array."""
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        assert want.dtype.name == "bfloat16", what
        got_np = got.view(torch.int16).numpy()
        want = want.view(np.int16)
    else:
        got_np = got.numpy()
        assert got_np.dtype == want.dtype, (what, got_np.dtype, want.dtype)
    assert got_np.shape == want.shape, (what, got_np.shape, want.shape)
    np.testing.assert_array_equal(got_np, want, err_msg=what)


@pytest.mark.parametrize("E", [1, 2, 4, 8])
def test_pack_unpack_indices_bit_exact(E):
    rng = np.random.default_rng(E)
    i = rng.integers(0, 1 << E, (3, 5, 16)).astype(np.uint8)
    packed = tvpt.pack_indices(torch.from_numpy(i), E)
    _same(packed, jvpt.pack_indices(jnp.asarray(i), E), "pack")
    _same(tvpt.unpack_indices(packed, E, 16),
          jvpt.unpack_indices(jnp.asarray(packed.numpy()), E, 16), "unpack")
    np.testing.assert_array_equal(
        tvpt.unpack_indices(packed, E, 16).numpy(), i)


def _kv_input(dtype, shape=(2, 7, 2, 16)):
    """Random K/V with no all-zero position (there the reference's scale
    is XLA's inexact exp2(-99); see test_torch_quant_index)."""
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    x[:, 1] *= 1e-3
    x[:, 2] *= 40.0
    jx = jnp.asarray(x, jnp.dtype(dtype))
    return jx, _torch(x, getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_planes_quantize_dequantize_bit_exact(dtype):
    jq = JQuantConfig(mode="vp", quantize_kv_cache=True, kv_layout="planes")
    tq = TQuantConfig(mode="vp", quantize_kv_cache=True, kv_layout="planes")
    jx, tx = _kv_input(dtype)
    jm, ji, js = jattn.quantize_kv(jx, jq, layout="planes")
    tm, ti, ts = tattn.quantize_kv(tx, tq, layout="planes")
    assert ti.shape[-1] == tx.shape[-1] // 4       # E = 2: 4 to a byte
    _same(tm, jm, "significands")
    _same(ti, ji, "packed indices")
    _same(ts, js, "scales")
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    _same(tattn.dequantize_kv(tm, ti, ts, tq, tdt),
          jattn.dequantize_kv(jm, ji, js, jq, jdt), "planes dequant")
    # The same planes through the reference's dequant, from numpy.
    _same(tattn.dequantize_kv(_torch(jm), _torch(ji), _torch(js), tq, tdt),
          jattn.dequantize_kv(jm, ji, js, jq, jdt), "planes dequant (numpy)")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_dequantize_bit_exact(dtype):
    jq = JQuantConfig(mode="vp", quantize_kv_cache=True)
    tq = TQuantConfig(mode="vp", quantize_kv_cache=True)
    jx, _ = _kv_input(dtype)
    jw, js = jattn.quantize_kv(jx, jq)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    _same(tattn.dequantize_kv_packed(_torch(jw), _torch(js), tq, tdt),
          jattn.dequantize_kv_packed(jw, js, jq, jdt), "packed dequant")


def test_chunked_prefill_attention_matches():
    rng = np.random.default_rng(5)
    B, S, H, KV, dh, hist = 2, 3, 4, 2, 16, 9
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, hist + S, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, hist + S, KV, dh)).astype(np.float32)
    k[:, 6:hist] = 1e4        # unwritten history past the offsets
    offset = np.array([4, 6], np.int32)
    want = np.asarray(jattn._chunked_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(offset),
        hist))
    got = tattn._chunked_prefill_attention(
        _torch(q), _torch(k), _torch(v), _torch(offset), hist).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _configs(kv: str):
    kw = dict(mode="vp")
    if kv != "float":
        kw.update(quantize_kv_cache=True, kv_layout=kv)
    return (jregistry.get_smoke_config("qwen3-0.6b", JQuantConfig(**kw)),
            tregistry.get_smoke_config("qwen3-0.6b", TQuantConfig(**kw)))


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _configs("packed")
    return jmodel.init_params(jax.random.PRNGKey(0), jcfg)


@pytest.mark.parametrize("kv", KV_LAYOUTS)
def test_chunked_prefill_matches_reference(jax_params, kv):
    """A prompt prefilled whole up to 5 tokens, then its last 4 as one
    chunk: the chunk's logits against the reference's, and then one
    decode step on the filled caches."""
    jcfg, tcfg = _configs(kv)
    B, S0, C, smax = 2, 5, 4, 16
    toks = np.random.default_rng(2).integers(
        0, tcfg.vocab, (B, S0 + C)).astype(np.int32)
    jp = jmodel.quantize_params(jax_params, jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           "cpu")
    jc = jmodel.init_cache(jcfg, B, smax)
    _, jc = jmodel.prefill(jp, jnp.asarray(toks[:, :S0]), jc, jcfg)
    jl, jc = jmodel.prefill(jp, jnp.asarray(toks[:, S0:]), jc, jcfg,
                            chunked=True)
    jd, _ = jmodel.decode_step(jp, jnp.asarray(toks[:, :1]), jc, jcfg)
    tc = tmodel.init_cache(tcfg, B, smax, device="cpu")
    assert sorted(tc[0]) == sorted(jc[0]["sub0"])
    _, tc = tmodel.prefill(tp, torch.from_numpy(toks[:, :S0]), tc, tcfg)
    tl, tc = tmodel.prefill(tp, torch.from_numpy(toks[:, S0:]), tc, tcfg,
                            chunked=True)
    assert tc[0]["len"].tolist() == [S0 + C] * B
    td, _ = tmodel.decode_step(tp, torch.from_numpy(toks[:, :1]), tc, tcfg)
    for got, want in ((tl, jl), (td, jd)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_chunked_prefill_rejects_windowed_cache():
    _, tcfg = _configs("packed")
    import dataclasses
    tcfg = dataclasses.replace(tcfg, sliding_window=4)
    params = tmodel.init_params(tcfg, seed=0, device="cpu")
    caches = tmodel.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="windowed"):
        tmodel.prefill(params, torch.zeros((1, 3), dtype=torch.int64),
                       caches, tcfg, chunked=True)
