"""The VLM family (internvl2-1b SMOKE: 8 patches, QKV bias, G 2) against
the JAX package: the patch projection, prefill of the patches and the
prompt and 4 greedy decode steps in modes none, vp (packed and planes)
and vp_block; `loss_fn` (labels padded with -1 over the patches) and its
gradients; the training tree; both VP codecs per leaf; the port's
refusal of a cache sized without the patches.

Inputs and tolerances are those of `test_torch_encdec.py`, whose helpers
this file shares.  The caches hold n_patches + prompt + steps positions
on both sides, so the reference never clamps a write; sized without the
patches, as the reference's static CLI sizes them, the reference keeps
the prefill's last positions as a ring and clamps every decode write
onto its last slot (ROADMAP, notes on the reference side), where the
port raises.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel

from test_torch_encdec import (B, MODES, S, STEPS, check_loss_and_grads,
                               check_static, check_tree, close, export,
                               inputs, jfn, ref_loss_grads)
from test_torch_train_layout import check_grad_codec, check_moment_codec

ARCH = "internvl2-1b"


@pytest.mark.parametrize("mode", sorted(MODES))
def test_patch_projection_matches_reference(mode):
    """`qdot` of the patches through the exported `patch_proj` (whose words
    the port's own export equals)."""
    jp, tp, jc, tc = export(ARCH, mode)
    _, patches = inputs(ARCH)
    want = jlayers.qdot(jnp.asarray(patches), jp["patch_proj"], jc.quant)
    got = tlayers.qdot(torch.from_numpy(patches), tp["patch_proj"], tc.quant)
    close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_static_serve_matches_reference(mode):
    check_static(ARCH, mode)


def test_cache_without_room_for_the_patches_raises():
    """The reference's static CLI sizes a VLM's cache to prompt + gen; the
    port refuses the prefill of P + S positions into it, and a decode
    step past a cache of exactly P + S, where the reference clamps."""
    _, tp, jc, tc = export(ARCH, "vp")
    toks, patches = inputs(ARCH)
    P = tc.n_patches
    p, pt = torch.from_numpy(toks).long(), torch.from_numpy(patches)
    with pytest.raises(ValueError, match="does not fit"):
        tmodel.prefill(tp, p, tmodel.init_cache(tc, B, S + STEPS, "cpu"), tc,
                       patches=pt)
    logits, caches = tmodel.prefill(
        tp, p, tmodel.init_cache(tc, B, P + S, "cpu"), tc, patches=pt)
    assert all(int(c["len"].max()) == P + S for c in caches)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    with pytest.raises(ValueError, match="passes the end"):
        tmodel.decode_step(tp, tok, caches, tc)
    with pytest.raises(ValueError, match="whole-prompt"):
        tmodel.prefill(tp, p, tmodel.init_cache(tc, B, P + S, "cpu"), tc,
                       chunked=True, patches=pt)
    # the reference writes past its buffer without a word: its length
    # runs past the slots it has
    jp, _, _, _ = export(ARCH, "vp")
    jl, jcache = jfn("prefill")(jp, jnp.asarray(toks), jmodel.init_cache(
        jc, B, P + S), jc, patches=jnp.asarray(patches))
    jt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    _, jcache = jfn("decode")(jp, jt, jcache, jc)
    assert int(jcache[0]["sub0"]["len"].max()) == P + S + 1
    assert jcache[0]["sub0"]["k_w"].shape[2] == P + S


def test_serve_cli_prefills_zero_patches():
    from repro_torch.launch import serve
    report = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--quant", "vp", "--kv-quant", "--batch", "2",
                         "--prompt-len", "6", "--gen", "3"])
    assert np.array(report["tokens"]).shape == (2, 3)
    assert report["patches"] == 8 and report["encode_s"] == 0.0


@pytest.mark.parametrize("mode", ["none", "vp_fake", "zero_patches"])
def test_loss_and_gradients_match_reference(mode):
    """loss_fn (patches projected and prepended, their labels -1) and every
    gradient against `jax.value_and_grad`; "vp_fake": fake-quant QAT
    (`patch_proj` included); "zero_patches": the train CLI's stub input,
    whose all-zero rows reach RMSNorm where its derivative is
    1 / sqrt(eps) (the reference's bv gradient grows with depth and width
    there, to a norm of 4.3e4 at 4 layers of d 512 and 256 patches; the
    port's follows it)."""
    check_loss_and_grads(ARCH, "vp" if mode == "vp_fake" else "none",
                         zero_stub=mode == "zero_patches")


def test_training_tree_matches_reference():
    check_tree(ARCH)


def test_vp_gradient_codec_matches_reference_per_leaf(monkeypatch):
    check_grad_codec(ARCH, monkeypatch, ref_loss_grads(ARCH)[1])


def test_vp_moment_codec_matches_reference_per_leaf(monkeypatch):
    check_moment_codec(ARCH, monkeypatch, ref_loss_grads(ARCH)[1])


def test_loss_needs_patches():
    _, tp, _, tc = export(ARCH, "none")
    params = tmodel.stack_layers(tp, tc)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="patches"):
        tmodel.loss_fn(params, {"tokens": toks, "labels": toks}, tc)
