"""The encoder-decoder family (whisper-tiny SMOKE) against the JAX package:
`layer_norm`, `gelu_mlp` and `sinusoid_pos`; the encoder and the cross
K/V in modes none, vp (packed and planes) and vp_block; prefill and 4
greedy decode steps; `loss_fn` and its gradients; the training tree;
both VP codecs per leaf; the port's refusals.

Both packages get the same inputs, made with numpy: the reference's
parameter tree carried across as numpy (`params_from_numpy`), its
constant-initialized gains and biases (LayerNorm gains and biases, the
GELU MLP's biases, the RMSNorm gammas) redrawn from a numpy seed so that
each term matters, frames and prompts.  Caches are sized prompt +
steps on both sides, so the reference never clamps a write.
Tolerances: exported words bit for bit; float outputs, logits, losses
and gradients at rtol 1e-5 with an atol of 1e-5 of the largest value
(f32 sums in another order); greedy tokens equal.  `sinusoid_pos` is
the reference's formula; XLA's `sin` / `cos` and PyTorch's differ by a
few f32 ulps at angles up to 1500 (up to 3.8e-6 at whisper's 1500 x
384), so it is held to 1e-5 absolute.

`test_torch_vlm.py` shares this file's helpers for internvl2-1b.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import QuantConfig as JQuantConfig
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import model as jmodel
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.models import layers as tlayers
from repro_torch.models import mlp as tmlp
from repro_torch.models import model as tmodel
from repro_torch.models.weights import caches_from_numpy, params_from_numpy
from repro_torch.tree import tree_paths

from test_torch_train_layout import check_grad_codec, check_moment_codec

ARCH = "whisper-tiny"
B, S, STEPS = 2, 8, 4
# mode -> (QuantConfig fields, weight layout)
MODES = {
    "none": ({}, "packed"),
    "vp": (dict(mode="vp", quantize_kv_cache=True), "packed"),
    "planes": (dict(mode="vp", quantize_kv_cache=True, kv_layout="planes"),
               "planes"),
    "vp_block": (dict(mode="vp_block", block=16, quantize_kv_cache=True),
                 "packed"),
}
# constant-initialized leaves redrawn: name -> (mean, spread)
REDRAW = {"ln1_g": (1.0, 0.2), "ln2_g": (1.0, 0.2), "ln_g": (1.0, 0.2),
          "enc_ln_g": (1.0, 0.2), "ln1_b": (0.0, 0.2), "ln2_b": (0.0, 0.2),
          "ln_b": (0.0, 0.2), "enc_ln_b": (0.0, 0.2), "b_in": (0.0, 0.05),
          "b_out": (0.0, 0.05), "ln1": (0.0, 0.2), "ln2": (0.0, 0.2),
          "final_norm": (0.0, 0.2), "bq": (0.0, 0.5), "bk": (0.0, 0.5),
          "bv": (0.0, 0.5)}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


def cfgs(arch, mode="none"):
    quant, _ = MODES[mode]
    jc, tc = jregistry.get_smoke_config(arch), tregistry.get_smoke_config(arch)
    return (dataclasses.replace(jc, quant=JQuantConfig(**quant)),
            dataclasses.replace(tc, quant=TQuantConfig(**quant)))


def redraw(tree, seed=3):
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k in REDRAW and not isinstance(v, dict):
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
    """The reference's float tree (PRNGKey(0)) as numpy, redrawn."""
    if arch not in _TREES:
        jc, _ = cfgs(arch)
        _TREES[arch] = redraw(np_tree(jax.jit(
            jmodel.init_params, static_argnums=1)(jax.random.PRNGKey(0), jc)))
    return _TREES[arch]


_EXPORTS = {}


def export(arch, mode):
    """(jax params, torch params, jax cfg, torch cfg): the redrawn tree
    exported by the reference under `mode` and carried across; the
    port's own export of the float tree gives the same words (cached per
    arch and mode)."""
    if (arch, mode) not in _EXPORTS:
        _EXPORTS[arch, mode] = _export(arch, mode)
    return _EXPORTS[arch, mode]


def _export(arch, mode):
    jc, tc = cfgs(arch, mode)
    layout = MODES[mode][1]
    jp = to_jax(float_tree(arch))
    if jc.quant.mode == "none":
        return jp, params_from_numpy(float_tree(arch), tc, "cpu"), jc, tc
    jp = jax.jit(jmodel.quantize_params, static_argnums=(1, 2))(
        jp, jc, layout)
    tp = params_from_numpy(np_tree(jp), tc, "cpu")
    mine = tmodel.quantize_params(params_from_numpy(float_tree(arch), tc,
                                                    "cpu"), tc, layout=layout)
    want = dict(tree_paths(tmodel.stack_layers(tp, tc)))
    got = dict(tree_paths(tmodel.stack_layers(mine, tc)))
    assert sorted(got) == sorted(want)
    for path in got:
        assert got[path].dtype == want[path].dtype, path
        assert torch.equal(got[path], want[path]), path
    return jp, tp, jc, tc


_JIT = {}


def jfn(name):
    if not _JIT:
        _JIT["prefill"] = jax.jit(jmodel.prefill, static_argnums=(3,))
        _JIT["decode"] = jax.jit(jmodel.decode_step, static_argnums=(3,))
        _JIT["encoder"] = jax.jit(jmodel._encoder_forward,
                                  static_argnums=(2,))
        _JIT["cross_kv"] = jax.jit(jmodel._cross_kv, static_argnums=(2,))
    return _JIT[name]


def inputs(arch, seed=4):
    """Prompts (B, S) and the family's stub input: frames (B, encoder_seq,
    d) or patches (B, n_patches, d), numpy."""
    jc, _ = cfgs(arch)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    n = jc.encoder_seq if jc.family == "encdec" else jc.n_patches
    return toks, rng.normal(size=(B, n, jc.d_model)).astype(np.float32)


def check_static(arch, mode):
    """Prefill (of the patches and the prompt, or of the prompt against
    the encoded frames) and STEPS greedy decode steps on both sides:
    logits per step within tolerance, tokens equal; the caches sized to
    the whole sequence on both sides."""
    jp, tp, jc, tc = export(arch, mode)
    toks, extra = inputs(arch)
    P = jc.n_patches
    if jc.family == "encdec":
        jx = jfn("cross_kv")(jp, jfn("encoder")(jp, jnp.asarray(extra), jc),
                             jc)
        tx = tmodel.cross_kv(tp, tmodel.encoder_forward(
            tp, torch.from_numpy(extra), tc), tc)
        jpre, tpre = dict(patches=jx), dict(cross_kv=tx)
        jdec, tdec = dict(cross_kv=jx), dict(cross_kv=tx)
    else:
        jpre = dict(patches=jnp.asarray(extra))
        tpre = dict(patches=torch.from_numpy(extra))
        jdec = tdec = {}
    jl, jcache = jfn("prefill")(jp, jnp.asarray(toks), jmodel.init_cache(
        jc, B, P + S + STEPS), jc, **jpre)
    tl, tcache = tmodel.prefill(tp, torch.from_numpy(toks).long(),
                                tmodel.init_cache(tc, B, P + S + STEPS, "cpu"),
                                tc, **tpre)
    want = caches_from_numpy(np_tree(jcache), tc, "cpu")
    for i, (g, w) in enumerate(zip(tcache, want, strict=True)):
        for k in w:
            if g[k].dtype.is_floating_point:
                close(g[k].numpy(), w[k].numpy(), f"layer {i} {k}")
            else:
                assert torch.equal(g[k], w[k]), (i, k)
    for step in range(STEPS):
        close(tl.numpy(), np.asarray(jl), f"logits {step}")
        jt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl, -1).to(torch.int32)[:, None]
        assert np.array_equal(tt.numpy(), np.asarray(jt)), step
        jl, jcache = jfn("decode")(jp, jt, jcache, jc, **jdec)
        tl, tcache = tmodel.decode_step(tp, tt, tcache, tc, **tdec)
    close(tl.numpy(), np.asarray(jl), "logits last")


def batch_of(arch, seed=6, zero_stub=False):
    """A numpy batch: tokens, labels (a few -1) and the stub input (zeros
    with `zero_stub`, as the train CLIs give it)."""
    jc, _ = cfgs(arch)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jc.vocab, (B, 12)).astype(np.int32)
    labels = rng.integers(0, jc.vocab, (B, 12)).astype(np.int32)
    labels[1, -3:] = -1
    key = "frames" if jc.family == "encdec" else "patches"
    n = jc.encoder_seq if jc.family == "encdec" else jc.n_patches
    extra = rng.normal(size=(B, n, jc.d_model)).astype(np.float32)
    return {"tokens": tokens, "labels": labels,
            key: np.zeros_like(extra) if zero_stub else extra}


_GRADS = {}


def ref_loss_grads(arch, mode="none", zero_stub=False):
    """The reference's loss and gradient tree (numpy) on `batch_of`."""
    key = (arch, mode, zero_stub)
    if key not in _GRADS:
        jc, _ = cfgs(arch, mode)
        jb = to_jax(batch_of(arch, zero_stub=zero_stub))
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss_fn(p, jb, jc, train=True), has_aux=True))(
                to_jax(float_tree(arch)))
        _GRADS[key] = (float(loss), np_tree(g))
    return _GRADS[key]


def port_loss_grads(arch, mode="none", zero_stub=False):
    _, tc = cfgs(arch, mode)
    params = tmodel.stack_layers(params_from_numpy(float_tree(arch), tc,
                                                   "cpu"), tc)
    flat = dict(tree_paths(params))
    for t in flat.values():
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v)
             for k, v in batch_of(arch, zero_stub=zero_stub).items()}
    loss, _ = tmodel.loss_fn(params, batch, tc, train=True)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return float(loss.detach()), dict(zip(flat, grads))


def check_loss_and_grads(arch, mode, zero_stub=False):
    loss, grads = port_loss_grads(arch, mode, zero_stub)
    jl, jg = ref_loss_grads(arch, mode, zero_stub)
    jg = dict(tree_paths(jg))
    close(loss, jl, "loss")
    assert sorted(grads) == sorted(jg)
    for path, g in grads.items():
        assert tuple(g.shape) == jg[path].shape, path
        close(g.numpy(), jg[path], path)


def check_tree(arch):
    """The reference's tree -> the port's serving params -> its training
    layout: the reference's paths, shapes, dtypes and values, leaf for
    leaf (the encoder and cross stacks as (L, ...) leaves)."""
    _, tc = cfgs(arch)
    tree = float_tree(arch)
    back = dict(tree_paths(tmodel.stack_layers(
        params_from_numpy(tree, tc, "cpu"), tc)))
    want = dict(tree_paths(tree))
    assert sorted(back) == sorted(want)
    for path, w in want.items():
        assert back[path].numpy().dtype == w.dtype, path
        np.testing.assert_array_equal(back[path].numpy(), w, path)
    # the port's own init gives the reference's paths and shapes
    mine = dict(tree_paths(tmodel.stack_layers(
        tmodel.init_params(tc, 0, "cpu"), tc)))
    assert {p: tuple(t.shape) for p, t in mine.items()} == {
        p: w.shape for p, w in want.items()}


# -- the blocks ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 1500, 384)])
def test_layer_norm_matches_reference(shape):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=shape) * 3 + 0.5).astype(np.float32)
    g = (1 + rng.normal(0, 0.2, shape[-1])).astype(np.float32)
    b = rng.normal(0, 0.2, shape[-1]).astype(np.float32)
    want = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = tlayers.layer_norm(*map(torch.from_numpy, (x, g, b)))
    assert got.dtype == torch.float32
    close(got.numpy(), np.asarray(want))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tlayers.layer_norm(xb, *map(torch.from_numpy, (g, b))).dtype == \
        torch.bfloat16


@pytest.mark.parametrize("mode", ["none", "vp"])
def test_gelu_mlp_matches_reference(mode):
    """The encoder's first MLP (redrawn biases), float or exported packed
    VP, on random x: the tanh GELU of `jax.nn.gelu`'s default."""
    jp, tp, jc, tc = export(ARCH, mode)
    jm = jax.tree_util.tree_map(lambda a: a[0], jp["encoder"]["mlp"])
    x = np.random.default_rng(2).normal(size=(B, 7, jc.d_model)).astype(
        np.float32)
    want = jmlp.gelu_mlp(jnp.asarray(x), jm, jc.quant)
    got = tmlp.gelu_mlp(torch.from_numpy(x), tp["encoder"][0]["mlp"],
                        tc.quant)
    close(got.numpy(), np.asarray(want))
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    tanh = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    assert not torch.equal(exact, tanh)   # the two forms differ


@pytest.mark.parametrize("s,d", [(16, 64), (1500, 384), (160, 384), (9, 3)])
def test_sinusoid_pos_matches_reference(s, d):
    want = np.asarray(jmodel.sinusoid_pos(s, d, jnp.float32))
    got = tlayers.sinusoid_pos(torch.arange(s), d, torch.float32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    rows = torch.tensor([[s - 1, 0], [1, s // 2]])
    np.testing.assert_array_equal(
        tlayers.sinusoid_pos(rows, d, torch.float32).numpy(),
        got[rows.numpy()])


# -- the encoder and the cross K/V -------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_encoder_and_cross_kv_match_reference(mode):
    """The encoder's output and every decoder layer's (k, v), each within
    tolerance, from the reference's export carried across (whose words
    the port's own export equals, `export`)."""
    jp, tp, jc, tc = export(ARCH, mode)
    _, frames = inputs(ARCH)
    jenc = jfn("encoder")(jp, jnp.asarray(frames), jc)
    tenc = tmodel.encoder_forward(tp, torch.from_numpy(frames), tc)
    close(tenc.numpy(), np.asarray(jenc), "encoder")
    jk, jv = jfn("cross_kv")(jp, jenc, jc)
    got = tmodel.cross_kv(tp, tenc, tc)
    assert len(got) == tc.n_layers
    for i, (k, v) in enumerate(got):
        assert k.shape == (B, tc.encoder_seq, tc.n_kv_heads, tc.head_dim)
        close(k.numpy(), np.asarray(jk[i]), f"k {i}")
        close(v.numpy(), np.asarray(jv[i]), f"v {i}")


# -- serving -------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "planes", "vp"])
def test_static_serve_matches_reference(mode):
    """vp_block's encoder and cross K/V are held above; its decoder is
    the dense one that `test_torch_vlm.py` serves in vp_block."""
    check_static(ARCH, mode)


def test_decoder_caches_and_refusals():
    """One full-causal self cache per decoder layer, nothing cached for
    the cross source; a prompt longer than the cache, a decode step past
    its end, a chunked prefill and a missing cross source each raise."""
    _, tp, _, tc = export(ARCH, "vp")
    toks, frames = inputs(ARCH)
    tx = tmodel.cross_kv(tp, tmodel.encoder_forward(
        tp, torch.from_numpy(frames), tc), tc)
    caches = tmodel.init_cache(tc, B, S, "cpu")
    assert len(caches) == tc.n_layers
    assert all(c["k_w"].shape == (B, S, tc.n_kv_heads, tc.head_dim)
               for c in caches)
    p = torch.from_numpy(toks).long()
    with pytest.raises(ValueError, match="does not fit"):
        tmodel.prefill(tp, p, tmodel.init_cache(tc, B, S - 1, "cpu"), tc,
                       cross_kv=tx)
    with pytest.raises(ValueError, match="chunked"):
        tmodel.prefill(tp, p, caches, tc, chunked=True, cross_kv=tx)
    with pytest.raises(ValueError, match="cross_kv"):
        tmodel.prefill(tp, p, caches, tc)
    logits, caches = tmodel.prefill(tp, p, caches, tc, cross_kv=tx)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    with pytest.raises(ValueError, match="passes the end"):
        tmodel.decode_step(tp, tok, caches, tc, cross_kv=tx)


def test_serve_cli_encodes_frames():
    from repro_torch.launch import serve
    report = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--quant", "vp", "--kv-quant", "--batch", "2",
                         "--prompt-len", "6", "--gen", "3"])
    assert np.array(report["tokens"]).shape == (2, 3)
    assert report["encode_s"] > 0 and report["patches"] == 0


def test_engine_refuses_encdec():
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--engine",
                    "--batch", "2", "--prompt-len", "6", "--gen", "3"])


# -- training -------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "vp_fake"])
def test_loss_and_gradients_match_reference(mode):
    """loss_fn (frames through the encoder, the cross K/V, the decoder) and
    every gradient against `jax.value_and_grad`; "vp_fake": fake-quant
    QAT (the cross K/V's wk / wv stay float matmuls, as the reference's
    `_cross_kv` takes no `train`)."""
    check_loss_and_grads(ARCH, "vp" if mode == "vp_fake" else mode)


def test_training_tree_matches_reference():
    check_tree(ARCH)


def test_vp_gradient_codec_matches_reference_per_leaf(monkeypatch):
    """Both codecs as `test_torch_train_layout.py` holds them, on the
    reference's gradients of `batch_of` (frames included)."""
    check_grad_codec(ARCH, monkeypatch, ref_loss_grads(ARCH)[1])


def test_vp_moment_codec_matches_reference_per_leaf(monkeypatch):
    check_moment_codec(ARCH, monkeypatch, ref_loss_grads(ARCH)[1])


def test_loss_needs_frames():
    _, tc = cfgs(ARCH)
    params = tmodel.stack_layers(tmodel.init_params(tc, 0, "cpu"), tc)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="frames"):
        tmodel.loss_fn(params, {"tokens": toks, "labels": toks}, tc)


def test_param_count_is_the_references():
    for arch in tregistry.ARCH_NAMES:
        for get in ("get_config", "get_smoke_config"):
            assert getattr(tregistry, get)(arch).param_count() == getattr(
                jregistry, get)(arch).param_count(), (arch, get)
