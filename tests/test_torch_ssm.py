"""The SSM and hybrid families against the JAX package: rwkv6-3b (RWKV6
time and channel mix) and zamba2-7b (Mamba2 layers and one shared
attention block applied after every 2 of them) on their SMOKE configs.

Both packages get the same inputs, made with numpy: the reference's
parameter tree carried across as numpy (`params_from_numpy`), its
zero-initialized vectors (decays, bonus, norms, conv bias, skip) redrawn
from a numpy seed so that each term matters, states and prompts.
Tolerances: exported words bit for bit; float outputs, states, logits,
losses and gradients at rtol 1e-5 with an atol of 1e-5 of the largest
value (f32 sums in another order: the scans' einsums may contract in
another order than JAX's); greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import QuantConfig as JQuantConfig
from repro.models import mamba2 as jmamba
from repro.models import model as jmodel
from repro.models import rwkv6 as jrwkv
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import model as tmodel
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.weights import caches_from_numpy, params_from_numpy
from repro_torch.tree import tree_paths

ARCHS = ("rwkv6-3b", "zamba2-7b")
B = 2
# vectors the reference initializes to constants, redrawn: name -> (mean,
# spread); mu_* stay in (0, 1)
REDRAW = {"w_dec0": (0.0, 0.5), "u_bonus": (0.0, 0.5), "ln_x": (0.0, 0.2),
          "conv_b": (0.0, 0.2), "dt_bias": (0.0, 0.5), "a_log": (0.0, 0.5),
          "d_skip": (1.0, 0.3), "out_norm": (0.0, 0.2), "ln": (0.0, 0.2),
          "ln1": (0.0, 0.2), "ln2": (0.0, 0.2), "final_norm": (0.0, 0.2)}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


def cfgs(arch, remat="none", **quant):
    jc, tc = jregistry.get_smoke_config(arch), tregistry.get_smoke_config(arch)
    jc = dataclasses.replace(jc, remat=remat)
    tc = dataclasses.replace(tc, remat=remat)
    if quant:
        jc = dataclasses.replace(jc, quant=JQuantConfig(**quant))
        tc = dataclasses.replace(tc, quant=TQuantConfig(**quant))
    return jc, tc


def redraw(tree, seed=3):
    """The tree with its constant-initialized vectors redrawn (numpy)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k.startswith("mu_"):
                    out[k] = rng.uniform(0.1, 0.9, v.shape).astype(v.dtype)
                elif k in REDRAW and not isinstance(v, dict):
                    mean, sd = REDRAW[k]
                    out[k] = (mean + rng.normal(0, sd, v.shape)).astype(
                        v.dtype)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(tree)


_TREES = {}


def float_tree(arch):
    if arch not in _TREES:
        jc, _ = cfgs(arch)
        _TREES[arch] = redraw(np_tree(jax.jit(
            jmodel.init_params, static_argnums=1)(jax.random.PRNGKey(0), jc)))
    return _TREES[arch]


def first_layer(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree["groups"][0]["sub0"])


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def block_state(arch, rng):
    _, tc = cfgs(arch)
    d = tc.d_model
    if arch == "rwkv6-3b":
        H = d // trwkv.HEAD_DIM
        return {"s": rng.normal(0, 0.5, (B, H, 64, 64)).astype(np.float32),
                "last_tm": rng.normal(size=(B, d)).astype(np.float32),
                "last_cm": rng.normal(size=(B, d)).astype(np.float32)}
    _, n, nh, p, conv_dim, _ = tmamba.mamba2_dims(tc)
    return {"h": rng.normal(0, 0.5, (B, nh, p, n)).astype(np.float32),
            "conv": rng.normal(size=(B, 3, conv_dim)).astype(np.float32)}


def run_block(arch, x, state):
    """The first layer's block(s) on both sides -> ((jax out, state),
    (torch out, state))."""
    jc, tc = cfgs(arch)
    p = first_layer(float_tree(arch))
    jp, tp = to_jax(p), to_torch(p)
    js = None if state is None else to_jax(state)
    ts = None if state is None else to_torch(state)
    if arch == "rwkv6-3b":
        jo, jst = jrwkv.rwkv6_time_mix(jnp.asarray(x), jp, jc, state=js)
        jo2, jst2 = jrwkv.rwkv6_channel_mix(jnp.asarray(x), jp, jc, state=js)
        to, tst = trwkv.rwkv6_time_mix(torch.from_numpy(x), tp, tc, state=ts)
        to2, _ = trwkv.rwkv6_channel_mix(torch.from_numpy(x), tp, tc,
                                         state=ts)
        jst = None if js is None else {**jst, **jst2}
        return (np.asarray(jo), np.asarray(jo2), jst), (
            to.numpy(), to2.numpy(), tst)
    jo, jst = jmamba.mamba2_block(jnp.asarray(x), jp, jc, state=js)
    to, tst = tmamba.mamba2_block(torch.from_numpy(x), tp, tc, state=ts)
    return (np.asarray(jo), None, jst), (to.numpy(), None, tst)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S,with_state", [(12, False), (12, True),
                                          (1, True), (16, False)])
def test_ssm_blocks_match_reference(arch, S, with_state):
    """rwkv6_time_mix, rwkv6_channel_mix and mamba2_block: a prefill (S
    12 runs chunks of 12, S 16 of 16 and 8), a prompt chunk continuing
    a state (chunked scan) and one-token decode (the recurrence); the
    new state is written into the given tensors and equals the
    reference's returned one."""
    _, tc = cfgs(arch)
    rng = np.random.default_rng(S + 10 * with_state)
    x = rng.normal(size=(B, S, tc.d_model)).astype(np.float32)
    state = block_state(arch, rng) if with_state else None
    (jo, jo2, jst), (to, to2, tst) = run_block(arch, x, state)
    close(to, jo, "out")
    if jo2 is not None:
        close(to2, jo2, "channel mix")
    if state is None:
        assert tst is None
        return
    for k, v in tst.items():
        close(v.numpy(), np.asarray(jst[k]), k)
        assert not np.array_equal(v.numpy(), state[k]), k


def test_wkv_chunked_divisor_and_exponent_range():
    """S 7 runs one chunk of 7 (the largest divisor <= 16), S 48 three
    of 16; logw at the clip floor (-4) over 16 steps reaches exp(64)
    in f32 and stays finite."""
    rng = np.random.default_rng(1)
    H, N = 2, 64
    for S in (7, 48):
        r, k, v = (rng.normal(size=(B, S, H, N)).astype(np.float32)
                   for _ in range(3))
        logw = np.full((B, S, H, N), -4.0, np.float32)
        u = rng.normal(size=(H, N)).astype(np.float32)
        jy, js = jrwkv._wkv_chunked(*map(jnp.asarray, (r, k, v, logw, u)))
        ty, ts = trwkv._wkv_chunked(*map(torch.from_numpy, (r, k, v, logw,
                                                            u)))
        assert torch.isfinite(ty).all() and torch.isfinite(ts).all()
        close(ty.numpy(), np.asarray(jy), f"y S={S}")
        close(ts.numpy(), np.asarray(js), f"s S={S}")


# -- the model: static serve, chunked prefill ---------------------------

_JIT = {}


def jfns():
    if not _JIT:
        _JIT["prefill"] = jax.jit(jmodel.prefill, static_argnums=(3,),
                                  static_argnames=("chunked",))
        _JIT["decode"] = jax.jit(jmodel.decode_step, static_argnums=(3,))
    return _JIT["prefill"], _JIT["decode"]


def export(arch, **quant):
    """(jax params, torch params, jax cfg, torch cfg) of the redrawn
    tree, exported by the reference under `quant`."""
    jc, tc = cfgs(arch, **quant)
    jp = to_jax(float_tree(arch))
    if jc.quant.mode != "none":
        jp = jmodel.quantize_params(jp, jc)
    return jp, params_from_numpy(np_tree(jp), tc, "cpu"), jc, tc


def prompts(vocab, S, seed=4):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch,quant", [
    ("rwkv6-3b", dict(mode="vp", quantize_kv_cache=True)),
    ("zamba2-7b", dict(mode="vp", quantize_kv_cache=True)),
    ("zamba2-7b", dict(mode="fxp"))],
    ids=["rwkv6-vp", "zamba2-vp", "zamba2-fxp"])
def test_static_serve_matches_reference(arch, quant):
    """Prefill of 12 then 5 greedy decode steps against the JAX static
    path (the vp_block case is in test_torch_ssm_train.py, which shares
    this check)."""
    check_static(arch, quant)


def check_static(arch, quant):
    """Logits per step within tolerance, the same tokens, and (vp) the
    port's own export of the float tree gives the reference's words bit
    for bit, the shared block's weights exported once."""
    jp, tp, jc, tc = export(arch, **quant)
    toks = prompts(tc.vocab, 12)
    pre, dec = jfns()
    S, steps = toks.shape[1], 5
    jl, jcache = pre(jp, jnp.asarray(toks), jmodel.init_cache(
        jc, B, S + steps), jc)
    tl, tcache = tmodel.prefill(tp, torch.from_numpy(toks).long(),
                                tmodel.init_cache(tc, B, S + steps, "cpu"), tc)
    for step in range(steps):
        close(tl.numpy(), np.asarray(jl), f"logits {step}")
        jt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl, -1).to(torch.int32)[:, None]
        assert np.array_equal(tt.numpy(), np.asarray(jt)), step
        jl, jcache = dec(jp, jt, jcache, jc)
        tl, tcache = tmodel.decode_step(tp, tt, tcache, tc)
    if quant["mode"] == "vp":
        mine = tmodel.quantize_params(params_from_numpy(
            float_tree(arch), tc, "cpu"), tc)
        want = dict(tree_paths(tmodel.stack_layers(tp, tc)))
        got = dict(tree_paths(tmodel.stack_layers(mine, tc)))
        assert sorted(got) == sorted(want)
        for path in got:
            assert torch.equal(got[path], want[path]), path
        ids = {id(layer["attn"]["wq"]["w_packed"])
               for spec, layer in zip(tmodel.layer_plan(tc), mine["layers"])
               if spec.pattern == "shared_attn"}
        assert len(ids) == (1 if arch == "zamba2-7b" else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_last_chunk_one_token(arch):
    """A prompt of 9 in chunks of 4, 4 and 1 (the last takes the
    one-token recurrence) continuing the caches: logits after each chunk
    and every cache, states included, against the reference's chunked
    prefill."""
    jp, tp, jc, tc = export(arch, mode="vp", quantize_kv_cache=True)
    toks = prompts(tc.vocab, 9, seed=8)
    pre, _ = jfns()
    jcache = jmodel.init_cache(jc, B, 16)
    tcache = tmodel.init_cache(tc, B, 16, "cpu")
    for a, b in ((0, 4), (4, 8), (8, 9)):
        jl, jcache = pre(jp, jnp.asarray(toks[:, a:b]), jcache, jc,
                         chunked=True)
        tl, tcache = tmodel.prefill(tp, torch.from_numpy(toks[:, a:b]).long(),
                                    tcache, tc, chunked=True)
        close(tl.numpy(), np.asarray(jl), f"chunk {a}:{b}")
    want = caches_from_numpy(np_tree(jcache), tc, "cpu")
    for i, (g, w) in enumerate(zip(tcache, want)):
        for k in w:
            if g[k].dtype.is_floating_point:
                close(g[k].numpy(), w[k].numpy(), f"layer {i} {k}")
            else:
                assert torch.equal(g[k], w[k]), (i, k)
