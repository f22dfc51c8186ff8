"""The training layout against the reference's tree: every per-leaf
scale of the gradient and moment codecs covers the reference's elements.

The reference keeps one stacked leaf per (scanned group, sub-layer)
(`repro.models.model.init_params`), and its VP gradient codec
(`train/compression.py`) and VP moment codec (`optim/optimizer.py`) take
one pow2 scale per leaf.  The port trains in that same tree
(`models.model.stack_layers`), so on a model of several groups and
sub-layers (gemma3-27b SMOKE: two repetitions of 2 local + 1 global
layers, then a local tail; zamba2-7b SMOKE: two repetitions of 2 Mamba2
layers and the shared attention block, then a Mamba2 tail) both codecs
give the reference's decoded values bit for bit, leaf by leaf.  The
gradients are the reference's own (`jax.value_and_grad` of its
`loss_fn`, `PRNGKey(2)`, a numpy batch), carried across as numpy.
`check_grad_codec` and `check_moment_codec` also serve the
encoder-decoder and VLM files (`test_torch_encdec.py`,
`test_torch_vlm.py`).

One reference-side defect would show here (ROADMAP, notes on the
reference side): both codecs scale a leaf by exp2(ceil(log2(amax))), a
power of two by the reference's own definition (`core.quantize.
vp_pack_tensor`), but XLA's `exp2` on the CPU is not exact at most
exponents below -14 (2^-17 comes out 9 ulps low), where the moments and
many gradients lie.  The codec tests therefore run the reference with
`jnp.exp2` exact at integer exponents (`exact_exp2`, patched only around
the codec calls) and compare every leaf bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import model as jmodel
from repro.optim import optimizer as jopt
from repro.train import compression as jcmp
from repro_torch.configs import registry as tregistry
from repro_torch.models import model as tmodel
from repro_torch.models.weights import params_from_numpy
from repro_torch.optim import optimizer as topt
from repro_torch.train import compression as tcmp
from repro_torch.tree import tree_map, tree_paths

ARCHS = ("gemma3-27b", "zamba2-7b")
B, S, ROUNDS = 2, 12, 3


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


_GRADS = {}


def ref_grads(arch):
    """The reference's gradient tree as numpy (cached per arch); an
    encoder-decoder's batch carries random frames, a VLM's patches."""
    if arch not in _GRADS:
        jc = jregistry.get_smoke_config(arch)
        tree = jax.jit(jmodel.init_params, static_argnums=1)(
            jax.random.PRNGKey(2), jc)
        rng = np.random.default_rng(11)
        tokens = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
        labels = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
        labels[1, -3:] = -1
        jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
        stub = {"encdec": ("frames", jc.encoder_seq),
                "vlm": ("patches", jc.n_patches)}.get(jc.family)
        if stub:
            jb[stub[0]] = jnp.asarray(rng.normal(
                size=(B, stub[1], jc.d_model)).astype(np.float32))
        _, jg = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss_fn(p, jb, jc, train=True)[0]))(tree)
        _GRADS[arch] = np_tree(jg)
    return _GRADS[arch]


def port_tree(arch, tree):
    """A reference-shaped numpy tree -> the port's training layout, by
    way of its serving list (`params_from_numpy`, `stack_layers`)."""
    tc = tregistry.get_smoke_config(arch)
    return tmodel.stack_layers(params_from_numpy(tree, tc, "cpu"), tc)


def bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


_EXP2 = jnp.exp2


def exact_exp2(x):
    """2**x, exact where x is an integer of the normal f32 range (built
    from the exponent bits); XLA's exp2 elsewhere."""
    x = jnp.asarray(x)
    e = jnp.clip(x, -126, 127).astype(jnp.int32)
    exact = jax.lax.bitcast_convert_type(
        jnp.left_shift(e + 127, 23), jnp.float32)
    return jnp.where((x == jnp.round(x)) & (x >= -126) & (x <= 127),
                     exact, _EXP2(x)).astype(jnp.result_type(x, jnp.float32))


def test_exact_exp2_is_the_power_of_two():
    e = np.arange(-126, 128, dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(exact_exp2(e)),
                                  np.ldexp(np.float32(1), e.astype(int)))
    assert float(exact_exp2(jnp.float32(0.5))) == float(_EXP2(0.5))


def assert_leaves_identical(got, want, what):
    """Leaf by leaf bit for bit."""
    got, want = dict(tree_paths(got)), dict(tree_paths(np_tree(want)))
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        g = got[path].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, (what, path)
        np.testing.assert_array_equal(bits(g), bits(w), f"{what} {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_vp_gradient_codec_matches_reference_per_leaf(arch, monkeypatch):
    check_grad_codec(arch, monkeypatch)


def check_grad_codec(arch, monkeypatch, g=None):
    """Three rounds of error feedback through the VP gradient codec (the
    gradient scaled by 1, 1.5, 2; `g`, a reference-shaped numpy tree, or
    `ref_grads(arch)`): decoded gradients and residuals bit for bit, leaf
    by leaf."""
    g = ref_grads(arch) if g is None else g
    monkeypatch.setattr(jnp, "exp2", exact_exp2)
    jcodec = jax.jit(lambda gr, st: jcmp.compress_decompress(
        gr, st, jcmp.CompressionConfig(codec="vp")))
    config = tcmp.CompressionConfig(codec="vp")
    jstate = jcmp.init_compressor_state(g)
    tstate = None
    for r in range(ROUNDS):
        gr = jax.tree_util.tree_map(lambda a: a * np.float32(1 + 0.5 * r), g)
        jdeq, jstate = jcodec(jax.tree_util.tree_map(jnp.asarray, gr),
                              jstate)
        tdeq, tstate = tcmp.compress_decompress(port_tree(arch, gr), tstate,
                                                config)
        assert_leaves_identical(tdeq, jdeq, f"round {r} decoded")
        assert_leaves_identical(tstate, jstate, f"round {r} residual")


@pytest.mark.parametrize("arch", ARCHS)
def test_vp_moment_codec_matches_reference_per_leaf(arch, monkeypatch):
    check_moment_codec(arch, monkeypatch)


def check_moment_codec(arch, monkeypatch, g=None):
    """Adam's first and second moments of three rounds of gradients,
    each stored through the VP moment codec (encode, then decode for the
    next round): words, scales and decoded moments bit for bit, leaf by
    leaf.  The moments are formed in numpy and fed to both codecs."""
    g = ref_grads(arch) if g is None else g
    monkeypatch.setattr(jnp, "exp2", exact_exp2)
    jcfg, tcfg = jopt.OptConfig(moment_codec="vp"), topt.OptConfig(
        moment_codec="vp")
    jfxp, jvp = jcfg.moment_formats()
    tfxp, tvp = tcfg.moment_formats()
    jencode = jax.jit(lambda t: jax.tree_util.tree_map(
        lambda a: jopt.encode_moment(a, jfxp, jvp), t))
    mu = jax.tree_util.tree_map(np.zeros_like, g)
    nu = jax.tree_util.tree_map(np.zeros_like, g)
    for r in range(ROUNDS):
        gr = jax.tree_util.tree_map(lambda a: a * np.float32(1 + 0.5 * r), g)
        for name, new in (
                ("mu", jax.tree_util.tree_map(
                    lambda m, a: np.float32(0.9) * m + np.float32(0.1) * a,
                    mu, gr)),
                ("nu", jax.tree_util.tree_map(
                    lambda v, a: np.float32(0.95) * v
                    + np.float32(0.05) * a * a, nu, gr))):
            jenc = jencode(new)
            tenc = tree_map(lambda t: topt.encode_moment(t, tfxp, tvp),
                            port_tree(arch, new))
            assert_leaves_identical(tenc, jenc, f"round {r} {name} words")
            jdec = jax.tree_util.tree_map(
                lambda leaf: jopt.decode_moment(leaf, jvp), jenc,
                is_leaf=jopt.is_packed_moment)
            tdec = tree_map(lambda leaf: topt.decode_moment(leaf, tvp), tenc,
                            is_leaf=topt.is_packed_moment)
            assert_leaves_identical(tdec, jdec, f"round {r} {name}")
            if name == "mu":
                mu = np_tree(jdec)
            else:
                nu = np_tree(jdec)


def test_one_stack_over_all_layers_would_change_the_codec():
    """The layout this replaces, one (L, ...) stack per parameter over
    all of gemma3's layers, scales some leaves differently: its decoded
    gradient differs from the per-(group, sub-layer) one."""
    arch = "gemma3-27b"
    tc = tregistry.get_smoke_config(arch)
    serving = params_from_numpy(ref_grads(arch), tc, "cpu")
    per_sub = tmodel.stack_layers(serving, tc)
    one = {"layers": tmodel.stack_layers(
        {"layers": serving["layers"]},
        dataclasses.replace(tc, local_global_period=0))["groups"][0]["sub0"]}
    config = tcmp.CompressionConfig(codec="vp")
    deq_one, _ = tcmp.compress_decompress(one, None, config)
    deq_sub, _ = tcmp.compress_decompress(
        {"groups": per_sub["groups"]}, None, config)
    plan = tmodel.layer_plan(tc)
    differ = 0
    for path, t in tree_paths(deq_one["layers"]):
        for spec in plan:
            node = deq_sub["groups"][spec.gi][f"sub{spec.sub}"]
            for k in path.split("/"):
                node = node[k]
            differ += not torch.equal(t[spec.index], node[spec.rep])
    assert differ > 0


@pytest.mark.parametrize("arch", ARCHS + ("rwkv6-3b", "qwen3-0.6b",
                                          "whisper-tiny", "internvl2-1b"))
def test_stack_then_unbind_gives_the_serving_list_back(arch):
    """`stack_layers` then `_unbind` returns every layer's tensors equal
    to the serving list's, in `layer_plan` order; the shared block is
    one dict in the training tree, its tensors not copied, and every
    application in the unbound list is that dict."""
    tc = tregistry.get_smoke_config(arch)
    serving = tmodel.init_params(tc, 3, device="cpu")
    train = tmodel.stack_layers(serving, tc)
    back = tmodel._unbind(train, tc)
    assert len(back) == len(serving["layers"]) == tc.n_layers + sum(
        s.pattern == "shared_attn" for s in tmodel.layer_plan(tc))
    for a, b in zip(back, serving["layers"]):
        pa, pb = dict(tree_paths(a)), dict(tree_paths(b))
        assert sorted(pa) == sorted(pb)
        for path in pa:
            assert torch.equal(pa[path], pb[path]), path
    shared = [(spec, layer) for spec, layer in zip(tmodel.layer_plan(tc),
                                                   back)
              if spec.pattern == "shared_attn"]
    if arch != "zamba2-7b":
        assert not shared and "shared_attn" not in train
        return
    assert len(shared) == 2 and all(layer is train["shared_attn"]
                                    for _, layer in shared)
    wq = train["shared_attn"]["attn"]["wq"]
    assert wq.ndim == 2
    assert wq.data_ptr() == serving["layers"][2]["attn"]["wq"].data_ptr()
    assert all("shared_attn" not in str(k) for g in train["groups"]
               for k in g)
