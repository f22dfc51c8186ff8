"""Training of the SSM and hybrid families against the JAX package:
rwkv6-3b and zamba2-7b on their SMOKE configs (`loss_fn` and its
gradients with and without remat, float and fake-quant QAT), the
parameter tree carried across and back, and the static serve in mode
vp_block (`test_torch_ssm.check_static`, kept here to share the time).  Inputs and tolerances are
those of `test_torch_ssm.py`, whose helpers this file shares.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jmodel
from repro_torch.models import model as tmodel
from repro_torch.models.weights import params_from_numpy
from repro_torch.tree import tree_paths

from test_torch_ssm import (ARCHS, B, cfgs, check_static, close, float_tree,
                            np_tree, to_jax)


def ref_loss_grads(arch, remat, tokens, labels, **quant):
    jc, _ = cfgs(arch, remat, **quant)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jb, jc, train=True), has_aux=True))(
            to_jax(float_tree(arch)))
    return float(jl), dict(tree_paths(np_tree(jg)))


def port_loss_grads(arch, remat, tokens, labels, **quant):
    _, tc = cfgs(arch, remat, **quant)
    params = tmodel.stack_layers(params_from_numpy(float_tree(arch), tc,
                                                   "cpu"), tc)
    flat = dict(tree_paths(params))
    for t in flat.values():
        t.requires_grad_(True)
    loss, _ = tmodel.loss_fn(params, {"tokens": torch.from_numpy(tokens),
                                      "labels": torch.from_numpy(labels)},
                             tc, train=True)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), dict(zip(flat, grads))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("quant", [None, "vp"])
def test_loss_and_gradients_match_reference(arch, quant):
    """loss_fn and every gradient, remat "full" bit for bit against
    "none" and both within tolerance of `jax.value_and_grad`; the
    gradient tree has the reference's paths (the shared block's once,
    the sum over its applications).  quant "vp": fake-quant QAT."""
    qkw = dict(mode="vp") if quant else {}
    rng = np.random.default_rng(6)
    _, tc = cfgs(arch)
    tokens = rng.integers(0, tc.vocab, (B, 12)).astype(np.int32)
    labels = rng.integers(0, tc.vocab, (B, 12)).astype(np.int32)
    labels[1, -3:] = -1
    loss, grads = port_loss_grads(arch, "none", tokens, labels, **qkw)
    l2, g2 = port_loss_grads(arch, "full", tokens, labels, **qkw)
    assert torch.equal(loss, l2)
    for path in grads:
        assert torch.equal(grads[path], g2[path]), path
    jl, jg = ref_loss_grads(arch, "full", tokens, labels, **qkw)
    close(float(loss), jl, "loss")
    assert sorted(grads) == sorted(jg)
    for path, g in grads.items():
        close(g.numpy(), jg[path], path)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_round_trip(arch):
    """The reference's tree -> the port's serving list -> its training
    layout gives the reference's tree back, leaf for leaf; every
    application of zamba2's shared block is one dict of the same
    tensors."""
    _, tc = cfgs(arch)
    tree = float_tree(arch)
    serving = params_from_numpy(tree, tc, "cpu")
    back = dict(tree_paths(tmodel.stack_layers(serving, tc)))
    want = dict(tree_paths(tree))
    assert sorted(back) == sorted(want)
    for path in want:
        np.testing.assert_array_equal(back[path].numpy(), want[path], path)
    shared = [layer for spec, layer in zip(tmodel.layer_plan(tc),
                                           serving["layers"])
              if spec.pattern == "shared_attn"]
    assert len(shared) == (2 if arch == "zamba2-7b" else 0)
    assert all(s is shared[0] for s in shared)


def test_static_serve_vp_block_matches_reference():
    """rwkv6 in mode vp_block (block 16, packed KV cache): logits per step
    within tolerance of the JAX static path and the same tokens."""
    check_static("rwkv6-3b", dict(mode="vp_block", block=16,
                                  quantize_kv_cache=True))
