"""A SMOKE serve per wide format against the JAX package: int32 packed
words (VP(13, E 4), qwen2 SMOKE) and 32 and 128 exponents (VP(7, E 5),
VP(7, E 7)), each with a packed VP KV cache, one layer deep (int16
block-VP significands: tests/test_torch_wide_block_serve.py).  The
reference's export carried across (`params_from_numpy`) equals the
port's own bit for bit; greedy tokens equal, logits at rtol 1e-5, atol
1e-5 of max|logit| (f32 sums in another order).  The kernels' plain versions at
these formats are in tests/test_torch_wide_formats.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import QuantConfig as JQuantConfig
from repro.models import model as jmodel
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.models import model as tmodel
from repro_torch.models.weights import params_from_numpy


SERVES = {
    "vp M13E4 (int32 words)": ("qwen2-0.5b", dict(mode="vp", M=13, E=4)),
    "vp M7E5": ("qwen3-0.6b", dict(mode="vp", M=7, E=5)),
    "vp M7E7": ("stablelm-12b", dict(mode="vp", M=7, E=7)),
}


def _serve_jax(jq, cfg, toks, steps):
    logits, caches = jax.jit(jmodel.prefill, static_argnums=(3,))(
        jq, jnp.asarray(toks), jmodel.init_cache(cfg, *toks.shape[:1],
                                                 toks.shape[1] + steps), cfg)
    dec = jax.jit(jmodel.decode_step, static_argnums=(3,))
    outs, tokens = [np.asarray(logits)], []
    for _ in range(steps):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        tokens.append(np.asarray(tok))
        logits, caches = dec(jq, tok, caches, cfg)
        outs.append(np.asarray(logits))
    return outs, np.concatenate(tokens, 1)


def _serve_torch(tq, cfg, toks, steps):
    B, S = toks.shape
    logits, caches = tmodel.prefill(tq, torch.from_numpy(toks),
                                    tmodel.init_cache(cfg, B, S + steps,
                                                      device="cpu"), cfg)
    outs, tokens = [logits.numpy()], []
    for _ in range(steps):
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        tokens.append(tok.numpy())
        logits, caches = tmodel.decode_step(tq, tok, caches, cfg)
        outs.append(logits.numpy())
    return outs, np.concatenate(tokens, 1)


@pytest.mark.parametrize("case", sorted(SERVES))
def test_smoke_serve_per_format(case):
    arch, quant = SERVES[case]
    quant = dict(quant, quantize_kv_cache=True)
    jcfg = dataclasses.replace(jregistry.get_smoke_config(
        arch, JQuantConfig(**quant)), n_layers=1)
    tcfg = dataclasses.replace(tregistry.get_smoke_config(
        arch, TQuantConfig(**quant)), n_layers=1)
    tree = jmodel.init_params(jax.random.PRNGKey(4), jcfg)
    jq = jmodel.quantize_params(tree, jcfg)
    tq = tmodel.quantize_params(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), tcfg, "cpu"), tcfg)
    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq),
                                tcfg, "cpu")
    for path_t, path_j in zip(_leaves(tq), _leaves(carried)):
        assert path_t[0] == path_j[0]
        assert path_t[1].dtype == path_j[1].dtype, path_t[0]
        assert torch.equal(path_t[1], path_j[1]), path_t[0]
    toks = np.random.default_rng(6).integers(0, tcfg.vocab, (2, 8)).astype(
        np.int32)
    want, want_tok = _serve_jax(jq, jcfg, toks, 3)
    got, got_tok = _serve_torch(tq, tcfg, toks, 3)
    np.testing.assert_array_equal(got_tok, want_tok)
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=f"step {step}")


def _leaves(node, prefix=""):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _leaves(node[k], f"{prefix}/{k}")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, node
