"""The rest of the dense path against the JAX package: qwen2-0.5b (QKV
bias, G = 7 at full width), gemma3-27b (local:global layers in two
scanned groups, rolling rings) and stablelm-12b, each on its SMOKE
config.

Both packages get the same parameters (the JAX tree carried across as
numpy, qwen2's biases drawn from a numpy seed: the reference initializes
them to zero, and a zero bias tests nothing) and the same prompts
(numpy).  Per config the reference runs once, in a module-scoped fixture
(jitted prefill and decode): exported words bit for bit, prefill and
decode logits at rtol 1e-5 and atol 1e-5 * max|logit| (f32 sums in
another order), greedy tokens equal.  gemma3's prompt is longer than its
local window (8) and decodes past the ring's wrap; its caches are
compared per layer after prefill, on the positions a read can reach.
The engine serves gemma3 with global layers paged and local layers on
dense rings, and gives the tokens of the port's static oracle and of the
JAX static run.
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
from repro_torch.models.weights import caches_from_numpy, params_from_numpy
from repro_torch.serving import ServingEngine, VirtualClock, oracle_generate
from repro_torch.serving.page_cache import DENSE, PAGED, plan_cache

B, STEPS = 2, 6
# arch -> (quant of its run, prompt length): gemma3's 12 > its window 8,
# and 12 + 6 decode steps wrap the ring of 8 twice over
CASES = {
    "qwen2-0.5b": (dict(mode="vp", quantize_kv_cache=True), 8),
    "gemma3-27b": (dict(mode="vp", quantize_kv_cache=True), 12),
    "stablelm-12b": (dict(mode="vp_block", block=64,
                          quantize_kv_cache=True), 8),
}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def float_params(arch: str, cfg, seed: int = 0):
    """The reference's float tree as numpy; nonzero QKV biases (numpy
    seed 5) where the config has them."""
    tree = np_tree(jmodel.init_params(jax.random.PRNGKey(seed), cfg))
    if cfg.qkv_bias:
        rng = np.random.default_rng(5)
        for group in tree["groups"]:
            for sub in group.values():
                for b in ("bq", "bk", "bv"):
                    a = sub["attn"][b]
                    sub["attn"][b] = rng.normal(0, 0.5, a.shape).astype(
                        a.dtype)
    return tree


def words(node, prefix=""):
    """{path: array} of every exported leaf of a quantized tree."""
    out = {}
    if isinstance(node, dict):
        for k, v in node.items():
            out.update(words(v, f"{prefix}/{k}"))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            out.update(words(v, f"{prefix}/{i}"))
    elif prefix.rsplit("/", 1)[-1] in ("w_packed", "scale", "m", "i_packed",
                                       "i_blk"):
        out[prefix] = np.asarray(node)
    return out


def assert_words_equal(got_tree, want_tree):
    got, want = words(got_tree), words(want_tree)
    assert got and sorted(got) == sorted(want)
    for path in got:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def assert_logits_close(got, want):
    assert len(got) == len(want)
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            g, w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()),
            err_msg=f"step {step}")


_JIT = {}


def run_jax(params, cfg, toks, steps=STEPS):
    """Jitted reference prefill + `steps` greedy decode steps -> (logits
    per step, tokens (B, steps), caches after prefill as numpy)."""
    if not _JIT:
        _JIT["prefill"] = jax.jit(jmodel.prefill, static_argnums=(3,))
        _JIT["decode"] = jax.jit(jmodel.decode_step, static_argnums=(3,))
    Bn, S = toks.shape
    logits, caches = _JIT["prefill"](
        params, jnp.asarray(toks), jmodel.init_cache(cfg, Bn, S + steps), cfg)
    after = np_tree(caches)
    outs, tokens = [np.asarray(logits)], []
    for _ in range(steps):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        tokens.append(np.asarray(tok))
        logits, caches = _JIT["decode"](params, tok, caches, cfg)
        outs.append(np.asarray(logits))
    return outs, np.concatenate(tokens, 1), after


def run_torch(params, cfg, toks, steps=STEPS):
    Bn, S = toks.shape
    logits, caches = tmodel.prefill(
        params, torch.from_numpy(toks),
        tmodel.init_cache(cfg, Bn, S + steps, device="cpu"), cfg)
    after = [{k: v.clone() for k, v in c.items()} for c in caches]
    outs, tokens = [logits.numpy()], []
    for _ in range(steps):
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        tokens.append(tok.numpy())
        logits, caches = tmodel.decode_step(params, tok, caches, cfg)
        outs.append(logits.numpy())
    return outs, np.concatenate(tokens, 1), after


_RUNS = {}


def get_case(arch: str) -> dict:
    """One reference run per config (kept for the module): its configs,
    trees, prompts and the outputs of both packages."""
    if arch not in _RUNS:
        _RUNS[arch] = _make_case(arch)
    return _RUNS[arch]


@pytest.fixture(params=sorted(CASES))
def case(request):
    return get_case(request.param)


def _make_case(arch: str) -> dict:
    quant, S = CASES[arch]
    jcfg = jregistry.get_smoke_config(arch, JQuantConfig(**quant))
    tcfg = tregistry.get_smoke_config(arch, TQuantConfig(**quant))
    tree = float_params(arch, jcfg)
    jq = jmodel.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree),
                                jcfg)
    tq = tmodel.quantize_params(params_from_numpy(tree, tcfg, "cpu"), tcfg)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (B, S)).astype(
        np.int64)
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jq=jq, tq=tq, toks=toks,
                want=run_jax(jq, jcfg, toks), got=run_torch(tq, tcfg, toks))


def test_configs_are_the_references():
    """The port's copies carry the reference's values, letter for letter,
    in every field the port has."""
    for arch in CASES:
        for get in ("get_config", "get_smoke_config"):
            want = getattr(jregistry, get)(arch)
            got = getattr(tregistry, get)(arch)
            for f in dataclasses.fields(got):
                if f.name != "quant":
                    assert getattr(got, f.name) == getattr(want, f.name), (
                        arch, get, f.name)


def test_export_bit_identical(case):
    carried = params_from_numpy(np_tree(case["jq"]), case["tcfg"], "cpu")
    assert_words_equal(case["tq"], carried)


def test_prefill_decode_logits_and_tokens(case):
    got, got_tok, _ = case["got"]
    want, want_tok, _ = case["want"]
    np.testing.assert_array_equal(got_tok, want_tok)
    assert_logits_close(got, want)


def test_qkv_biases_carried_and_used():
    """qwen2's biases reach the port's layers and move the logits."""
    case = get_case("qwen2-0.5b")
    tq = case["tq"]
    attn = tq["layers"][0]["attn"]
    assert {"bq", "bk", "bv"} <= set(attn) and float(attn["bq"].abs().max())
    zeroed = {**tq, "layers": [
        {**p, "attn": {k: (torch.zeros_like(v) if k[0] == "b" and len(k) == 2
                           else v) for k, v in p["attn"].items()}}
        for p in tq["layers"]]}
    toks = case["toks"]
    lg, _ = tmodel.prefill(zeroed, torch.from_numpy(toks), tmodel.init_cache(
        case["tcfg"], *toks.shape, device="cpu"), case["tcfg"])
    assert not np.allclose(lg.numpy(), case["got"][0][0])


def _reachable(cache: dict, key: str, length: int) -> torch.Tensor:
    """The positions of a cache buffer a decode can read: [0, length),
    or the whole ring once the prompt filled it."""
    return cache[key][:, :min(length, cache[key].shape[1])]


def test_caches_per_layer_after_prefill(case):
    """The per-layer caches after prefill (global layers full length,
    local layers rings of the window) equal the reference's stacked
    caches, carried across, bit for bit on what a read can reach (the
    reference also quantizes the zero padding past the prompt)."""
    tcfg, S = case["tcfg"], case["toks"].shape[1]
    got = case["got"][2]
    want = caches_from_numpy(case["want"][2], tcfg, "cpu")
    plan = tmodel.layer_plan(tcfg)
    assert len(got) == len(want) == tcfg.n_layers == len(plan)
    for spec, g, w in zip(plan, got, want):
        assert sorted(g) == sorted(w)
        buf = min(S + STEPS, spec.window or S + STEPS)
        for key in g:
            if key == "len":
                assert torch.equal(g[key], w[key])
                continue
            assert g[key].shape == w[key].shape and g[key].shape[1] == buf
            assert torch.equal(_reachable(g, key, S), _reachable(w, key, S)), (
                spec, key)


def test_gemma3_layers_and_windows():
    cfg = tregistry.get_smoke_config("gemma3-27b")
    pats = [s.pattern for s in tmodel.layer_plan(cfg)]
    assert pats == ["local", "local", "global"] * 2 + ["local"]
    full = tmodel.layer_plan(tregistry.get_config("gemma3-27b"))
    assert [s.pattern for s in full[:6]] == ["local"] * 5 + ["global"]
    assert [s.window for s in full if s.pattern == "global"] == [None] * 10
    assert {s.window for s in full if s.pattern == "local"} == {1024}
    assert (full[-1].gi, full[-1].sub) == (1, 1)


# -- the engine on gemma3: paged global layers, dense local rings --------------

CAP, PAGE = 24, 8


def test_gemma3_engine_matches_oracles():
    case = get_case("gemma3-27b")
    tcfg, tq, toks = case["tcfg"], case["tq"], case["toks"]
    specs = plan_cache(tcfg, CAP)
    kinds = {(s.pattern, s.kind, s.buf_len, s.reps, s.layers) for s in specs}
    assert kinds == {("local", DENSE, 8, 2, (0, 3)),
                     ("local", DENSE, 8, 2, (1, 4)),
                     ("global", PAGED, CAP, 2, (2, 5)),
                     ("local", DENSE, 8, 1, (6,))}
    eng = ServingEngine(tq, tcfg, max_slots=2, capacity=CAP, page_size=PAGE,
                        clock=VirtualClock(), decode_lookahead=2)
    for row in toks:
        eng.submit([int(t) for t in row], STEPS, 0.0)
    got = [r["tokens"] for r in eng.run()]
    oracle = [oracle_generate(tq, tcfg, [int(t) for t in row], STEPS, CAP)
              for row in toks]
    assert got == oracle
    assert got == case["want"][1].tolist()    # the JAX static run
    with pytest.raises(ValueError, match="chunked prefill"):
        ServingEngine(tq, tcfg, max_slots=2, capacity=CAP, page_size=PAGE,
                      prefill_chunk=4)
