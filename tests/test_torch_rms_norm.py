"""RMSNorm (`ops.rms_norm`) against the reference's `layers.rms_norm`.

On the CPU `ops.rms_norm` runs its plain version (`ref.rms_norm_ref`);
on the card the kernel of csrc/rms_norm.cu, held against it by
`chip_smoke.py`, bit for bit.  Here: forward and gradients against JAX
at the model's shapes (a gamma of (D,) and rwkv6's per-head (H, N)), the
plain version's summation order against a numpy mirror of the kernel's,
the autograd Function's backward with the kernel's forward stood in by
the plain version, and the wrapper's host-side refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rms_norm import rms_norm_cuda

SHAPES = (((3, 5, 64), (64,)), ((2, 3, 4, 16), (4, 16)), ((7, 1024), (1024,)))


def _inputs(xs, gs, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(xs) * 3).astype(np.float32)
    g = (rng.standard_normal(gs) * 0.1).astype(np.float32)
    return x, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xs,gs", SHAPES, ids=str)
def test_rms_norm_matches_reference(xs, gs, dtype):
    x, g = _inputs(xs, gs)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jlayers.rms_norm(jx, jnp.asarray(g)).astype(
        jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ops.rms_norm(tx, torch.from_numpy(g))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("xs,gs", SHAPES, ids=str)
def test_rms_norm_gradients_match_reference(xs, gs):
    x, g = _inputs(xs, gs, seed=1)
    w = np.random.default_rng(2).standard_normal(xs).astype(np.float32)
    jgx, jgg = jax.grad(lambda a, b: jnp.sum(jlayers.rms_norm(a, b) * w),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tg = torch.from_numpy(g).requires_grad_()
    (ops.rms_norm(tx, tg) * torch.from_numpy(w)).sum().backward()
    for got, want in ((tx.grad, jgx), (tg.grad, jgg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("xs,gs", SHAPES[:2], ids=str)
def test_function_backward_matches_autograd_of_the_plain_version(
        monkeypatch, need, xs, gs, dtype):
    """`ops._RMSNorm` (the card's training path), its forward stood in by
    the plain version: its hand-written backward gives autograd's
    gradients through `ref.rms_norm_ref` (f32 within 1e-5 of the largest,
    bf16 within 1e-2), for each subset of inputs that needs them."""
    monkeypatch.setattr(ops, "rms_norm_cuda", ref.rms_norm_ref)
    x, g = _inputs(xs, gs, seed=3)
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(
        xs).astype(np.float32))
    dt = getattr(torch, dtype)
    grads = []
    for fn in (lambda a, b: ops._RMSNorm.apply(a, b, 1e-6),
               lambda a, b: ref.rms_norm_ref(a, b, 1e-6)):
        tx = torch.from_numpy(x).to(dt).requires_grad_(need[0])
        tg = torch.from_numpy(g).requires_grad_(need[1])
        (fn(tx, tg).float() * w).sum().backward()
        grads.append([t.grad for t in (tx, tg)])
    tol = 1e-5 if dtype == "float32" else 1e-2
    for a, b, n in zip(*grads, need):
        assert (a is None) == (not n)
        if n:
            assert a.dtype == b.dtype and a.shape == b.shape
            scale = float(b.float().abs().max())
            assert float((a.float() - b.float()).abs().max()) <= tol * scale


def _kernel_order(x, g, eps=1e-6):
    """csrc/rms_norm.cu in numpy, one f32 rounding a step: lane l of a
    warp sums the squares of columns l, l + 32, ... in turn; lanes l and
    l ^ o add for o = 16 .. 1; then divide, add eps, 1 / sqrt, scale."""
    f = np.float32
    D = x.shape[-1]
    rows, gr = x.reshape(-1, D), g.reshape(-1, D)
    out = np.empty_like(rows)
    for i, row in enumerate(rows):
        acc = np.zeros(32, f)
        for c in range(D):
            acc[c % 32] = f(acc[c % 32] + f(row[c] * row[c]))
        for o in (16, 8, 4, 2, 1):
            acc = (acc + acc[np.arange(32) ^ o]).astype(f)
        r = f(f(1) / f(np.sqrt(f(f(acc[0] / f(D)) + f(eps)))))
        out[i] = ((row * r).astype(f) * (f(1) + gr[i % len(gr)])).astype(f)
    return out.reshape(x.shape)


@pytest.mark.parametrize("xs,gs", SHAPES + (((2, 70), (70,)), ((3, 7), (7,))),
                         ids=str)
def test_plain_version_takes_the_kernels_order(xs, gs):
    """`ref.rms_norm_ref` sums in the kernel's order (`_kernel_order`),
    bit for bit, at widths past, below and off a multiple of 32: on the
    card `chip_smoke.py` holds the kernel to it bit for bit."""
    x, g = _inputs(xs, gs, seed=5)
    got = ref.rms_norm_ref(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _kernel_order(x, g).view(np.uint32))


def test_kernel_wrapper_refuses_before_the_card():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="trailing shape"):
        rms_norm_cuda(x, torch.zeros(4))
    with pytest.raises(ValueError, match="trailing shape"):
        rms_norm_cuda(x, torch.zeros(()))
    with pytest.raises(ValueError, match="f32 or bf16"):
        rms_norm_cuda(x.half(), torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rms_norm_cuda(x, torch.zeros(8))
