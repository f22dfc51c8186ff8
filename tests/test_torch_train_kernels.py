"""The training path's kernels and trainable ops against the JAX package:
the plain versions of `vp_matmul_dx` / `vp_matmul_dw` against the
reference's oracles and its Pallas bodies in interpret mode, the
autograd Functions against `jax.grad` through the reference's custom
VJPs, and the training attention walk.

Float reductions are compared at 1e-5 of max|reference| (f32 sums in
another order).  The gradients of the autograd Functions are held bit
for bit against torch autograd through dequantize-then-matmul on the
CPU, the port's counterpart of `tests/test_train_vjp.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as JQuantConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models.layers import canonical_formats as j_canonical
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.core.packing import dequant_words
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.vp_bwd_matmul import (
    vp_matmul_dw_cuda, vp_matmul_dx_cuda)
from repro_torch.models import attention as tattn
from repro_torch.models.layers import canonical_formats as t_canonical

JFXP, JVP = j_canonical(JQuantConfig(mode="vp"))
TFXP, TVP = t_canonical(TQuantConfig(mode="vp"))


def assert_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _words(rng, shape):
    """Packed words (int16) of random weights in (-1, 1)."""
    x = rng.normal(0.0, 0.3, shape).clip(-0.99, 0.99).astype(np.float32)
    return tops.vp_quant(torch.from_numpy(x), TFXP, TVP, packed=True).numpy()


SHAPES = [(8, 8, 8), (16, 24, 8), (16, 8, 24), (33, 40, 24)]


@pytest.mark.parametrize("mkn", SHAPES)
def test_vp_matmul_dx(mkn):
    """g (M, N) @ dequant(w (K, N))^T against the reference's oracle and
    its Pallas body (interpret mode, blocks (8, 8, 8); (33, 40, 24) is
    no tile multiple)."""
    M, K, N = mkn
    rng = np.random.default_rng(M * 100 + K)
    g = rng.normal(size=(M, N)).astype(np.float32)
    w = _words(rng, (K, N))
    got = tops.vp_matmul_dx(torch.from_numpy(g), torch.from_numpy(w),
                            TVP).numpy()
    jg, jw = jnp.asarray(g), jnp.asarray(w)
    assert_close(got, jref.vp_matmul_dx_ref(jg, jw, JVP))
    assert_close(got, jops.vp_matmul_dx(jg, jw, JVP, blocks=(8, 8, 8),
                                        interpret=True))


@pytest.mark.parametrize("mkn", SHAPES)
def test_vp_matmul_dw(mkn):
    """dequant(a (M, K))^T @ g (M, N), the same two references."""
    M, K, N = mkn
    rng = np.random.default_rng(M * 100 + N)
    a = _words(rng, (M, K))
    g = rng.normal(size=(M, N)).astype(np.float32)
    got = tops.vp_matmul_dw(torch.from_numpy(a), torch.from_numpy(g),
                            TVP).numpy()
    ja, jg = jnp.asarray(a), jnp.asarray(g)
    assert_close(got, jref.vp_matmul_dw_ref(ja, jg, JVP))
    assert_close(got, jops.vp_matmul_dw(ja, jg, JVP, blocks=(8, 8, 8),
                                        interpret=True))


def test_bwd_plain_versions_in_bf16():
    """bf16: the words dequantize exactly into bf16 (7-bit significands),
    so dx and dw stay within bf16 rounding (2^-8) of the f32 product."""
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.normal(size=(16, 24)).astype(np.float32))
    w = torch.from_numpy(_words(rng, (40, 24)))
    a = torch.from_numpy(_words(rng, (16, 40)))
    for got, want in (
            (tref.vp_matmul_dx_ref(g.bfloat16(), w, TVP, torch.bfloat16),
             tref.vp_matmul_dx_ref(g.bfloat16().float(), w, TVP)),
            (tref.vp_matmul_dw_ref(a, g.bfloat16(), TVP, torch.bfloat16),
             tref.vp_matmul_dw_ref(a, g.bfloat16().float(), TVP))):
        assert got.dtype == torch.bfloat16
        err = (got.float() - want).abs().max() / want.abs().max()
        assert float(err) <= 2 ** -7


def test_bwd_kernel_wrappers_take_cuda_tensors_only():
    w = torch.zeros((8, 8), dtype=torch.int16)
    g = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        vp_matmul_dx_cuda(g, w, TVP, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        vp_matmul_dw_cuda(w, g, TVP, torch.float32)


# ---------------------------------------------------------------------------
# Autograd Functions: jax.grad through the custom VJPs, and bit for bit
# against torch autograd through dequantize-then-matmul
# ---------------------------------------------------------------------------

def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _t(x, grad=True):
    return torch.from_numpy(x).requires_grad_(grad)


def test_dequant_matmul_grad():
    x, g = _inputs(0, (8, 32), (8, 16))
    w = _words(np.random.default_rng(1), (32, 16))
    jw = jnp.asarray(w)
    jdx = jax.grad(lambda x: jnp.vdot(jops.vp_dequant_matmul(x, jw, JVP),
                                      jnp.asarray(g)))(jnp.asarray(x))

    tx = _t(x)
    out = tops.vp_dequant_matmul(tx, torch.from_numpy(w), TVP)
    (out * torch.from_numpy(g)).sum().backward()
    ox = _t(x)
    oracle = ox @ dequant_words(torch.from_numpy(w), TVP)
    (oracle * torch.from_numpy(g)).sum().backward()
    assert torch.equal(tx.grad, ox.grad)
    assert_close(tx.grad.numpy(), jdx)


def test_qat_matmul_grads():
    x, w, g = _inputs(1, (8, 32), (32, 16), (8, 16))
    w *= 0.3
    jdx, jdw = jax.grad(
        lambda x, w: jnp.vdot(jops.vp_qat_matmul(x, w, JFXP, JVP),
                              jnp.asarray(g)), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))

    tx, tw = _t(x), _t(w)
    out = tops.vp_qat_matmul(tx, tw, TFXP, TVP)
    (out * torch.from_numpy(g)).sum().backward()
    w_q = tops.vp_quant(torch.from_numpy(w), TFXP, TVP, packed=True)
    ox, ow = _t(x), _t(w)
    qw = ow + (dequant_words(w_q, TVP) - ow).detach()
    ((ox @ qw) * torch.from_numpy(g)).sum().backward()
    assert torch.equal(tx.grad, ox.grad) and torch.equal(tw.grad, ow.grad)
    assert_close(tx.grad.numpy(), jdx)
    assert_close(tw.grad.numpy(), jdw)


def test_quant_matmul_ste_grads():
    a, b, g = _inputs(2, (8, 32), (32, 16), (8, 16))
    jda, jdb = jax.grad(
        lambda a, b: jnp.vdot(jops.vp_quant_matmul(a, b, JFXP, JVP, JFXP,
                                                   JVP), jnp.asarray(g)),
        argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))

    ta, tb = _t(a), _t(b)
    out = tops.vp_quant_matmul(ta, tb, TFXP, TVP, TFXP, TVP)
    (out * torch.from_numpy(g)).sum().backward()
    a_w = tops.vp_quant(torch.from_numpy(a), TFXP, TVP, packed=True)
    b_w = tops.vp_quant(torch.from_numpy(b), TFXP, TVP, packed=True)
    oa, ob = _t(a), _t(b)
    qa = oa + (dequant_words(a_w, TVP) - oa).detach()
    qb = ob + (dequant_words(b_w, TVP) - ob).detach()
    ((qa @ qb) * torch.from_numpy(g)).sum().backward()
    assert torch.equal(ta.grad, oa.grad) and torch.equal(tb.grad, ob.grad)
    assert_close(ta.grad.numpy(), jda)
    assert_close(tb.grad.numpy(), jdb)


def test_grad_free_calls_skip_the_functions():
    """Under no_grad, or with inputs that need no gradient, the ops run
    their forward alone and return tensors without a graph."""
    x, b = _inputs(3, (4, 8), (8, 4))
    w = torch.from_numpy(_words(np.random.default_rng(3), (8, 4)))
    with torch.no_grad():
        out = tops.vp_dequant_matmul(_t(x), w, TVP)
    assert out.grad_fn is None
    out = tops.vp_quant_matmul(_t(x, False), _t(b, False), TFXP, TVP, TFXP,
                               TVP)
    assert out.grad_fn is None


def test_packed_matmul_backward_reaches_float_inputs():
    """Integer word operands carry no gradient: a graph through the packed
    `vp_matmul` still runs backward to its float inputs (counterpart of
    `test_packed_matmul_grads_are_float0`)."""
    rng = np.random.default_rng(4)
    a_w = torch.from_numpy(_words(rng, (8, 16)))
    b_w = torch.from_numpy(_words(rng, (16, 8)))
    x = torch.ones((4, 8), requires_grad=True)
    y = tops.vp_matmul(a_w, None, b_w, None, TVP, TVP)
    assert not y.requires_grad
    (x @ y).sum().backward()
    assert x.grad.shape == x.shape
    torch.testing.assert_close(x.grad, y.sum(1).expand(4, 8))


# ---------------------------------------------------------------------------
# The training attention walk
# ---------------------------------------------------------------------------

WALK_CASES = {
    "causal": dict(S=24, pattern="causal", window=None, chunk=8),
    "local": dict(S=24, pattern="local", window=8, chunk=8),
    "causal-padded": dict(S=21, pattern="causal", window=None, chunk=8),
    "full-padded": dict(S=13, pattern="full", window=None, chunk=8),
}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_flash_attention_walk(case):
    """Values and q/k/v gradients against the reference's pair walk (the
    path its training graph takes on the CPU), several chunks per side."""
    c = WALK_CASES[case]
    B, H, KV, dh, S = 2, 4, 2, 8, c["S"]
    q, k, v, g = _inputs(len(case), (B, S, H, dh), (B, S, KV, dh),
                         (B, S, KV, dh), (B, S, H, dh))
    kw = dict(pattern=c["pattern"], window=c["window"], chunk=c["chunk"])

    def jloss(q, k, v):
        out = jattn.flash_attention(q, k, v, scale=dh ** -0.5, **kw)
        return jnp.vdot(out, jnp.asarray(g)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q), _t(k), _t(v)
    out = tattn.flash_attention_walk(tq, tk, tv, **kw)
    (out * torch.from_numpy(g)).sum().backward()
    assert_close(out.detach().numpy(), jout)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        assert_close(got.numpy(), want)
