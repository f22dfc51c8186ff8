"""Training with activation checkpointing (`remat="full"`) against the
JAX package and against the port without it: gemma3-27b (two scanned
groups: two repetitions of 2 local + 1 global layers, then a local tail)
and stablelm-12b (one group of 2) on their SMOKE configs, and the MoE
family's qwen3-moe-30b-a3b, whose full config sets remat too.

The reference wraps each scanned group's body in `jax.checkpoint`; the
port checkpoints each repetition of a group (`torch.utils.checkpoint`,
non-reentrant).  Both packages get the same parameters (the JAX tree
carried across as numpy) and the same batch (numpy).  The port's loss
and gradients with remat are bit for bit those without it (the
recomputation repeats the same arithmetic), and within rtol 1e-5, atol
1e-5 of the largest value, of the reference's (f32 sums in another
order).
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
from repro_torch.launch import train as train_cli
from repro_torch.models import model as tmodel
from repro_torch.models.weights import params_from_numpy

B, S = 2, 12   # gemma3's 12 positions pass its local window of 8


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


def cfgs(arch, remat, **quant):
    out = []
    for reg, qc in ((jregistry, JQuantConfig), (tregistry, TQuantConfig)):
        c = dataclasses.replace(reg.get_smoke_config(arch), remat=remat)
        if quant:
            c = dataclasses.replace(c, quant=qc(**quant))
        out.append(c)
    return out


def batch(vocab):
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[1, -3:] = -1
    return tokens, labels


def port_grads(tree, tcfg, tokens, labels):
    """(loss, metrics, {path: grad}) of the port's loss_fn in training,
    on the stacked training layout."""
    params = tmodel.stack_layers(params_from_numpy(np_tree(tree), tcfg,
                                                   "cpu"), tcfg)
    flat = dict(_leaves(params))
    for t in flat.values():
        t.requires_grad_(True)
    loss, metrics = tmodel.loss_fn(params, {
        "tokens": torch.from_numpy(tokens),
        "labels": torch.from_numpy(labels)}, tcfg, train=True)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(flat, grads)))


def _leaves(node, prefix=""):
    if isinstance(node, dict):
        node = node.items()
    elif isinstance(node, list):
        node = enumerate(node)
    else:
        yield prefix, node
        return
    for k, v in node:
        yield from _leaves(v, f"{prefix}/{k}")


def ref_grads_by_layer(jg, tcfg):
    """The reference's gradient tree by path: the port's training layout
    is the reference's tree (one stack per sub-layer of each scanned
    group), so the paths are the same."""
    return dict(_leaves(np_tree(jg)))


@pytest.mark.parametrize("arch,quant", [
    ("gemma3-27b", None), ("stablelm-12b", None), ("stablelm-12b", "vp"),
    ("qwen3-moe-30b-a3b", None), ("qwen3-moe-30b-a3b", "vp")])
def test_remat_matches_reference_and_no_remat(arch, quant):
    """loss_fn with remat="full": its loss, metrics and every gradient bit
    for bit those of remat="none" (and "dots", which runs as "none"), and
    within tolerance of the reference's `jax.value_and_grad` with its
    own remat="full".  quant "vp": fake-quant QAT of every weight
    matmul."""
    qkw = dict(mode="vp") if quant else {}
    jcfg, tcfg = cfgs(arch, "full", **qkw)
    tree = jmodel.init_params(jax.random.PRNGKey(2), jcfg)
    tokens, labels = batch(tcfg.vocab)
    loss, metrics, grads = port_grads(tree, tcfg, tokens, labels)
    for other in ("none", "dots"):
        l2, m2, g2 = port_grads(tree, dataclasses.replace(tcfg, remat=other),
                                tokens, labels)
        assert torch.equal(loss, l2), other
        for k in metrics:
            assert torch.equal(metrics[k], m2[k]), (other, k)
        for path in grads:
            assert torch.equal(grads[path], g2[path]), (other, path)

    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jb, jcfg, train=True), has_aux=True))(tree)
    close(float(loss), float(jl), "loss")
    for k in ("ce", "load_balance", "router_z"):
        close(float(metrics[k]), float(jm[k]), k)
    want = ref_grads_by_layer(jg, tcfg)
    assert sorted(want) == sorted(grads)
    for path, g in grads.items():
        close(g.numpy(), want[path], path)


def test_remat_checkpoints_each_group_repetition(monkeypatch):
    """gemma3 SMOKE (7 layers: two repetitions of 3 sub-layers, then a
    tail of 1) checkpoints 3 units, each a whole repetition, and only
    while gradients are on."""
    _, tcfg = cfgs("gemma3-27b", "full")
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(fn, *args, **kw):
        calls.append([s.index for s in args[2]])
        return real(fn, *args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    params = tmodel.stack_layers(tmodel.init_params(tcfg, 0, device="cpu"),
                                 tcfg)
    tokens, labels = batch(tcfg.vocab)
    b = {"tokens": torch.from_numpy(tokens),
         "labels": torch.from_numpy(labels)}
    with torch.no_grad():
        tmodel.loss_fn(params, b, tcfg, train=True)
    assert calls == []
    with torch.enable_grad():
        tmodel.loss_fn(params, b, tcfg, train=True)
    assert calls == [[0, 1, 2], [3, 4, 5], [6]]


@pytest.mark.parametrize("arch", ["gemma3-27b", "stablelm-12b",
                                  "qwen3-moe-30b-a3b"])
def test_train_cli_runs_remat_configs(arch, tmp_path, capsys):
    """The train CLI on a SMOKE config with remat="full" set (the full
    configs' setting): packed QAT, VP gradients and moments, 2 steps,
    finite losses."""
    train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--remat", "full", "--steps", "2", "--batch", "2",
                    "--seq", "16", "--qat", "packed", "--compress-grads",
                    "--grad-codec", "vp", "--compress-moments",
                    "--log-every", "1"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss")[1].split()[0])
              for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses)), out
