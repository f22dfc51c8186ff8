"""The port's dense serving path against the JAX package on qwen3-0.6b
SMOKE: exported words, prefill and decode logits, greedy tokens, CLI.

Both packages get the same parameters (the JAX tree carried across as
numpy) and the same prompts (numpy).  Logits are compared at rtol 1e-5
and atol 1e-5 * max|logit| (f32 sums in another order).
"""
import json

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
from repro_torch.launch import serve
from repro_torch.models import model as tmodel
from repro_torch.models.weights import params_from_numpy

B, S, STEPS = 2, 8, 4


def _configs(mode, kv):
    jcfg = jregistry.get_smoke_config(
        "qwen3-0.6b", JQuantConfig(mode=mode, quantize_kv_cache=kv))
    tcfg = tregistry.get_smoke_config(
        "qwen3-0.6b", TQuantConfig(mode=mode, quantize_kv_cache=kv))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _configs("vp", True)
    return jmodel.init_params(jax.random.PRNGKey(0), jcfg)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _words(node, prefix=""):
    """{path: array} of every packed leaf ("w_packed" / "scale")."""
    out = {}
    if isinstance(node, dict):
        for k, v in node.items():
            out.update(_words(v, f"{prefix}/{k}"))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            out.update(_words(v, f"{prefix}/{i}"))
    elif prefix.endswith(("w_packed", "scale")):
        out[prefix] = np.asarray(node)
    return out


def test_quantize_params_bit_identical(jax_params):
    jcfg, tcfg = _configs("vp", True)
    jq = _np_tree(jmodel.quantize_params(jax_params, jcfg))
    tq = tmodel.quantize_params(
        params_from_numpy(_np_tree(jax_params), tcfg, "cpu"), tcfg)
    # The JAX tree is stacked per layer; carried across it must equal the
    # port's own export word for word.
    carried = params_from_numpy(jq, tcfg, "cpu")
    got, want = _words(tq), _words(carried)
    assert len(got) == 2 * (2 + 7 * tcfg.n_layers)
    assert sorted(got) == sorted(want)
    for path in got:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


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


@pytest.mark.parametrize("mode,kv", [("vp", True), ("none", False)])
def test_prefill_decode_logits_and_tokens(jax_params, mode, kv):
    jcfg, tcfg = _configs(mode, kv)
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab, (B, S)).astype(np.int64)
    jp = jmodel.quantize_params(jax_params, jcfg)
    tp = tmodel.quantize_params(
        params_from_numpy(_np_tree(jax_params), tcfg, "cpu"), tcfg)
    want, want_tok = _run_jax(jp, jcfg, toks)
    got, got_tok = _run_torch(tp, tcfg, toks)
    np.testing.assert_array_equal(got_tok, want_tok)
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            g, w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()),
            err_msg=f"step {step}")


def test_static_cli_runs_on_cpu(tmp_path):
    out = tmp_path / "report.json"
    report = serve.main([
        "--smoke", "--device", "cpu", "--quant", "vp", "--kv-quant",
        "--batch", "2", "--prompt-len", "8", "--gen", "3",
        "--json", str(out)])
    assert json.loads(out.read_text()) == report
    assert report["tokens_per_s"] > 0 and report["device"] == "cpu"
