"""The port's MoE family against the JAX package: qwen3-moe-30b-a3b
(top-8 of 8 experts at SMOKE, qk-norm) and mixtral-8x22b (top-2 of 4,
sliding window 8) on their SMOKE configs.

Both packages get the same inputs, made with numpy: the reference's
parameter tree carried across as numpy (`params_from_numpy`), router and
expert weights drawn from a numpy seed for the block tests, prompts and
batches.  Tolerances: exported words and routing bit for bit; float
outputs, logits, aux terms, losses and gradients at rtol 1e-5 with an
atol of 1e-5 of the largest value (f32 sums in another order).
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
from repro.models import moe as jmoe
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.weights import params_from_numpy

ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x22b")
B, S, STEPS = 2, 10, 4   # mixtral's prompt of 10 passes its window of 8


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


def cfgs(arch, **quant):
    jc, tc = jregistry.get_smoke_config(arch), tregistry.get_smoke_config(arch)
    if quant:
        jc = dataclasses.replace(jc, quant=JQuantConfig(**quant))
        tc = dataclasses.replace(tc, quant=TQuantConfig(**quant))
    return jc, tc


def block_inputs(cfg, seed=0, router_scale=0.3):
    rng = np.random.default_rng(seed)
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    p = {"w_router": rng.normal(0, router_scale, (d, E)).astype(np.float32),
         "w_gate": rng.normal(0, 0.1, (E, d, ff)).astype(np.float32),
         "w_up": rng.normal(0, 0.1, (E, d, ff)).astype(np.float32),
         "w_down": rng.normal(0, 0.1, (E, ff, d)).astype(np.float32)}
    x = rng.normal(size=(B, 8, d)).astype(np.float32)
    return p, x


def run_blocks(arch, p, x, cf):
    jc, tc = cfgs(arch)
    jo, ja = jmoe.moe_block(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, p), jc, capacity_factor=cf)
    to, ta = tmoe.moe_block(torch.from_numpy(x), {
        k: torch.from_numpy(v) for k, v in p.items()}, tc,
        capacity_factor=cf)
    return (np.asarray(jo), ja), (to.numpy(), ta)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_moe_block_matches_reference(arch, cf):
    """Outputs and both aux terms; at capacity factor 0.25 experts drop
    tokens (checked), and the dropped ones must drop on both sides."""
    p, x = block_inputs(tregistry.get_smoke_config(arch))
    (jo, ja), (to, ta) = run_blocks(arch, p, x, cf)
    close(to, jo, "output")
    for k in ("load_balance", "router_z"):
        close(float(ta[k]), float(ja[k]), k)
    tc = tregistry.get_smoke_config(arch)
    T, k = x.shape[0] * x.shape[1], tc.experts_per_token
    C = tmoe.capacity(T, k, tc.n_experts, cf)
    _, idx = tmoe.top_k(torch.softmax(torch.from_numpy(
        x.reshape(T, -1) @ p["w_router"]), -1), k)
    worst = int(torch.bincount(idx.reshape(-1),
                               minlength=tc.n_experts).max())
    if cf < 1:
        assert worst > C, (worst, C)   # the drops are exercised


def test_capacity_rounds_as_the_reference():
    """int(max(1, round(Tg k / E * cf))) with Python's round (half to
    even) and the group count dividing T."""
    for Tg, k, E, cf in [(16, 2, 4, 1.25), (4, 8, 128, 1.25),
                         (20, 2, 8, 1.0), (12, 2, 8, 1.25), (1, 1, 8, 0.1)]:
        assert tmoe.capacity(Tg, k, E, cf) == int(
            max(1, round(Tg * k / E * cf)))
    for T in (1, 16, 4096, 8192, 12288, 5000):
        assert tmoe._moe_group_count(T) == jmoe._moe_group_count(T)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_break_toward_the_lower_expert(arch):
    """A zero router gives every expert the same probability: top-k picks
    experts 0 .. k-1 as jax.lax.top_k does, and the block agrees."""
    tc = tregistry.get_smoke_config(arch)
    p, x = block_inputs(tc)
    p["w_router"] = np.zeros_like(p["w_router"])
    probs = np.full((3, 5, tc.n_experts), 1.0 / tc.n_experts, np.float32)
    probs[1, 2, -1] = probs[1, 2, 0]          # ties everywhere
    jv, ji = jax.lax.top_k(jnp.asarray(probs), tc.experts_per_token)
    tv, ti = tmoe.top_k(torch.from_numpy(probs), tc.experts_per_token)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    (jo, ja), (to, ta) = run_blocks(arch, p, x, 1.25)
    close(to, jo, "output under ties")
    close(float(ta["load_balance"]), float(ja["load_balance"]))


# -- the whole model: export, static serving, training ---------------------

_RUNS = {}


def served(arch):
    """One reference run per config: the float tree exported by both
    packages (vp words and a packed VP KV cache), prefill + STEPS greedy
    decode steps on both."""
    if arch in _RUNS:
        return _RUNS[arch]
    quant = dict(mode="vp", quantize_kv_cache=True)
    jc, tc = cfgs(arch, **quant)
    tree = jmodel.init_params(jax.random.PRNGKey(0), jc)
    jq = jmodel.quantize_params(tree, jc)
    tq = tmodel.quantize_params(params_from_numpy(np_tree(tree), tc, "cpu"),
                                tc)
    toks = np.random.default_rng(3).integers(0, tc.vocab, (B, S)).astype(
        np.int32)
    logits, caches = jax.jit(jmodel.prefill, static_argnums=(3,))(
        jq, jnp.asarray(toks), jmodel.init_cache(jc, B, S + STEPS), jc)
    dec = jax.jit(jmodel.decode_step, static_argnums=(3,))
    jl, jt = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        jt.append(np.asarray(tok))
        logits, caches = dec(jq, tok, caches, jc)
        jl.append(np.asarray(logits))
    tl, tt = [], []
    logits, tcache = tmodel.prefill(tq, torch.from_numpy(toks),
                                    tmodel.init_cache(tc, B, S + STEPS,
                                                      device="cpu"), tc)
    tl.append(logits.numpy())
    for _ in range(STEPS):
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        tt.append(tok.numpy())
        logits, tcache = tmodel.decode_step(tq, tok, tcache, tc)
        tl.append(logits.numpy())
    _RUNS[arch] = dict(jq=np_tree(jq), tq=tq, tc=tc, jl=jl, tl=tl,
                       jt=np.concatenate(jt, 1), tt=np.concatenate(tt, 1))
    return _RUNS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_static_serve_matches_reference(arch):
    """Greedy tokens equal the JAX static path's; every step's logits
    within tolerance."""
    run = served(arch)
    np.testing.assert_array_equal(run["tt"], run["jt"])
    for step, (g, w) in enumerate(zip(run["tl"], run["jl"])):
        close(g, w, f"step {step}")


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_stacks_export_bit_for_bit(arch):
    """`quantize_params` exports each expert of a (E, d, ff) stack with
    its own scale, as the reference's vmap does: every word and scale
    equal, the router left f32."""
    run = served(arch)
    plan = tmodel.layer_plan(run["tc"])
    for spec in plan:
        want = run["jq"]["groups"][spec.gi][f"sub{spec.sub}"]["moe"]
        got = run["tq"]["layers"][spec.index]["moe"]
        assert got["w_router"].dtype == torch.float32
        np.testing.assert_array_equal(got["w_router"].numpy(),
                                      want["w_router"][spec.rep])
        for name in ("w_gate", "w_up", "w_down"):
            for leaf in ("w_packed", "scale"):
                g, w = got[name][leaf].numpy(), want[name][leaf][spec.rep]
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w, err_msg=(name, leaf))
            assert got[name]["scale"].shape == (run["tc"].n_experts,)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_round_trip(arch):
    """The reference's exported tree carried across holds the same words
    per layer (the (L, E, d, ff) stacks cut per layer) and serves the
    same first logits as the port's own export."""
    run = served(arch)
    tq = params_from_numpy(run["jq"], run["tc"], "cpu")
    for spec in tmodel.layer_plan(run["tc"]):
        a, b = tq["layers"][spec.index]["moe"], run["tq"]["layers"][
            spec.index]["moe"]
        for name in ("w_gate", "w_up", "w_down"):
            assert torch.equal(a[name]["w_packed"], b[name]["w_packed"])
            assert torch.equal(a[name]["scale"], b[name]["scale"])
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, run["tc"].vocab, (B, S)).astype(np.int32))
    logits, _ = tmodel.prefill(tq, toks, tmodel.init_cache(
        run["tc"], B, S, device="cpu"), run["tc"])
    close(logits.numpy(), run["tl"][0])


def test_layered_expert_stacks_export_as_the_reference():
    """A 4-D (L, E, d, ff) stack (the training layout) exports to the
    reference's nested vmap: words (L, E, d, ff) and scales (L, E)."""
    jc, tc = cfgs("mixtral-8x22b", mode="vp")
    rng = np.random.default_rng(9)
    w = rng.normal(0, 0.05, (2, tc.n_experts, 16, 24)).astype(np.float32)
    w[1, 2] *= 8.0
    jq = jmodel.quantize_params({"w_up": jnp.asarray(w)}, jc)
    tq = tmodel.quantize_params({"w_up": torch.from_numpy(w)}, tc)
    for leaf in ("w_packed", "scale"):
        np.testing.assert_array_equal(tq["w_up"][leaf].numpy(),
                                      np.asarray(jq["w_up"][leaf]))
    assert tq["w_up"]["scale"].shape == (2, tc.n_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """loss = ce + 0.01 lb + 1e-3 z, its three metrics and every gradient
    (router and experts included) against `jax.value_and_grad` of the
    reference's loss on the same parameters and batch."""
    jc, tc = cfgs(arch)
    tree = jmodel.init_params(jax.random.PRNGKey(1), jc)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, tc.vocab, (B, 8)).astype(np.int32)
    labels = rng.integers(0, tc.vocab, (B, 8)).astype(np.int32)
    labels[0, :2] = -1
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jb, jc, train=True), has_aux=True))(tree)
    params = tmodel.stack_layers(params_from_numpy(np_tree(tree), tc, "cpu"),
                                 tc)
    req = params

    def leaves(node, prefix=""):
        if isinstance(node, dict):
            node = node.items()
        elif isinstance(node, list):
            node = enumerate(node)
        else:
            yield prefix, node
            return
        for k, v in node:
            yield from leaves(v, f"{prefix}/{k}")

    flat = dict(leaves(req))
    for t in flat.values():
        t.requires_grad_(True)
    loss, metrics = tmodel.loss_fn(req, {"tokens": torch.from_numpy(tokens),
                                         "labels": torch.from_numpy(labels)},
                                   tc, train=True)
    grads = torch.autograd.grad(loss, list(flat.values()))
    close(float(loss.detach()), float(jl), "loss")
    for k in ("ce", "load_balance", "router_z"):
        close(float(metrics[k].detach()), float(jm[k]), k)
    assert float(metrics["load_balance"].detach()) > 0
    want = dict(leaves(np_tree(jg)))
    assert sorted(want) == sorted(flat)
    for (path, _), g in zip(flat.items(), grads):
        close(g.numpy(), want[path], path)
