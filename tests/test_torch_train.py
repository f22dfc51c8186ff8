"""The port's training path against the JAX package on qwen3-0.6b SMOKE:
codecs, optimizer, gradient compression, data, the whole train step,
checkpoints, restarts and the CLI.

Both packages get the same inputs: parameters from the JAX `init_params`
tree carried across as numpy, gradients and batches made with numpy.
The JAX side runs on the CPU as its own tests run it (its ops dispatch
to the reference oracles there).  Tolerances are stated per test; codec
words are compared bit for bit.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import quantize as jquant
from repro.core.formats import FXPFormat as JFXP
from repro.core.formats import default_vp_format as j_default_vp
from repro.data import pipeline as jdata
from repro.models import model as jmodel
from repro.optim import optimizer as jopt
from repro.train import compression as jcmp
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.core import quantize as tquant
from repro_torch.core.formats import FXPFormat as TFXP
from repro_torch.core.formats import default_vp_format as t_default_vp
from repro_torch.data import pipeline as tdata
from repro_torch.launch import train as train_cli
from repro_torch.models import model as tmodel
from repro_torch.models.weights import params_from_numpy
from repro_torch.optim import optimizer as topt
from repro_torch.train import compression as tcmp
from repro_torch.train.ckpt import CheckpointCorruptError, CheckpointManager
from repro_torch.train.ft import run_with_restarts
from repro_torch.train.train_step import make_train_step, value_and_grad
from repro_torch.tree import tree_leaves, tree_map, tree_paths

ARCH = "qwen3-0.6b"
BATCH, SEQ, STEPS = 4, 16, 3


def _np(x):
    return np.asarray(x)


def _formats(M=7, E=2, W=12):
    jf, tf = JFXP(W, W - 1), TFXP(W, W - 1)
    return jf, j_default_vp(jf, M, E), tf, t_default_vp(tf, M, E)


def _codec_input(rng, shape, scale=1.0):
    """Heavy-tailed values with exact zeros, grid ties (k + 0.5) 2^-11 of
    the pow2-normalized range and the extreme element set last."""
    x = (rng.standard_t(3, size=shape) * scale).astype(np.float32)
    flat = x.reshape(-1)
    flat[::17] = 0.0
    amax = np.abs(flat).max()
    s = 2.0 ** np.ceil(np.log2(amax))
    k = rng.integers(-2048, 2048, flat[1::13].shape)
    flat[1::13] = ((k + 0.5) * 2.0 ** -11 * s).astype(np.float32)
    flat[0] = s * 0.75
    return x


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,E", [(7, 2), (6, 2)])
def test_vp_pack_tensor_words_bit_exact(M, E):
    jf, jv, tf, tv = _formats(M, E)
    rng = np.random.default_rng(M)
    for x in (_codec_input(rng, (64, 48), 1e-3),
              np.zeros((5, 7), np.float32)):
        jw, js = jquant.vp_pack_tensor(jnp.asarray(x), jf, jv)
        tw, ts = tquant.vp_pack_tensor(torch.from_numpy(x), tf, tv)
        assert str(tw.dtype).split(".")[-1] == str(jw.dtype)
        np.testing.assert_array_equal(tw.numpy(), _np(jw))
        assert float(ts) == float(js)
        np.testing.assert_array_equal(
            tquant.vp_unpack_tensor(tw, ts, tv).numpy(),
            _np(jquant.vp_unpack_tensor(jw, js, jv)))


@pytest.mark.parametrize("clip_grad", [False, True])
def test_vp_fake_quant_ste_values_and_grads(clip_grad):
    jf, jv, tf, tv = _formats()
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(32, 24)) * 0.7).astype(np.float32)
    x[0, :4] = [1.5, -1.5, 0.9995, -1.0]         # outside / on the envelope
    g = rng.normal(size=x.shape).astype(np.float32)

    def jf_(x):
        return jnp.vdot(jquant.vp_fake_quant_ste(x, jf, jv, clip_grad), g)

    jy = jquant.vp_fake_quant_ste(jnp.asarray(x), jf, jv, clip_grad)
    jg = jax.grad(jf_)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tquant.vp_fake_quant_ste(tx, tf, tv, clip_grad)
    (ty * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), _np(jy))
    np.testing.assert_array_equal(tx.grad.numpy(), _np(jg))
    assert bool((tx.grad == 0).any()) == clip_grad


# ---------------------------------------------------------------------------
# Optimizer and gradient compression
# ---------------------------------------------------------------------------

def _param_pair(rng):
    """A small parameter tree (a matrix, a stacked matrix, a vector) as
    JAX arrays and as tensors, and gradients for it."""
    p = {"w": rng.normal(0, 0.02, (24, 16)).astype(np.float32),
         "stack": rng.normal(0, 0.02, (2, 8, 12)).astype(np.float32),
         "norm": rng.normal(0, 0.1, (16,)).astype(np.float32)}
    g = {k: _codec_input(rng, v.shape, 1e-2) for k, v in p.items()}
    return p, g


def _jtree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _ttree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("codec", [None, "vp"])
def test_apply_updates_matches_reference(codec):
    """Two AdamW steps on the same params and grads: params within 1e-6
    relative.  Packed moment words: equal where the f32 moments the two
    packages encode are equal; where f32 rounding of the recurrence moves
    a value across a rounding boundary of the grid, one VP step apart.
    At most 1 % of the words may differ (0 of 1,184 do here)."""
    rng = np.random.default_rng(5)
    p, g = _param_pair(rng)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, moment_codec=codec)
    jcfg, tcfg = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    jp, tp = _jtree(p), _ttree(p)
    js, ts = jopt.init_opt_state(jp, jcfg), topt.init_opt_state(tp, tcfg)
    for _ in range(2):
        jp, js, jm = jopt.apply_updates(jp, _jtree(g), js, jcfg)
        tp, ts, tm = topt.apply_updates(tp, _ttree(g), ts, tcfg)
    assert int(ts.step) == int(js.step) == 2
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), _np(jp[k]), rtol=1e-6,
                                   atol=1e-6 * np.abs(_np(jp[k])).max())
    if codec is None:
        for k in p:
            np.testing.assert_allclose(ts.mu[k].numpy(), _np(js.mu[k]),
                                       rtol=1e-6, atol=1e-12)
        return
    _, jv, _, _ = _formats(6, 2)
    for name in ("mu", "nu"):
        for k in p:
            jl, tl = getattr(js, name)[k], getattr(ts, name)[k]
            assert topt.is_packed_moment(tl) and tl["w"].dtype == torch.int8
            assert float(tl["s"]) == float(jl["s"])
            jw, tw = _np(jl["w"]).astype(np.int32), tl["w"].numpy().astype(
                np.int32)
            jd = _np(jquant.vp_unpack_tensor(jl["w"], jl["s"], jv))
            td = topt.decode_moment(tl, t_default_vp(TFXP(12, 11), 6, 2))
            diff = jw != tw
            assert diff.mean() <= 0.01, (name, k, diff.mean())
            step = 2.0 ** -5 * float(jl["s"])   # one step of the coarsest f
            assert np.abs(td.numpy() - jd).max() <= step


@pytest.mark.parametrize("codec", ["int8", "vp"])
def test_compress_decompress_bit_exact(codec):
    """Three rounds of error feedback on the same grads: decoded grads and
    residuals equal bit for bit."""
    rng = np.random.default_rng(11)
    jcfg, tcfg = jcmp.CompressionConfig(codec), tcmp.CompressionConfig(codec)
    _, g0 = _param_pair(rng)
    js, ts = jcmp.init_compressor_state(_jtree(g0)), None
    for r in range(3):
        _, g = _param_pair(rng)
        jd, js = jcmp.compress_decompress(_jtree(g), js, jcfg)
        td, ts = tcmp.compress_decompress(_ttree(g), ts, tcfg)
        for k in g:
            np.testing.assert_array_equal(td[k].numpy(), _np(jd[k]),
                                          err_msg=f"round {r} {k}")
            np.testing.assert_array_equal(ts[k].numpy(), _np(js[k]),
                                          err_msg=f"round {r} {k}")


def test_compress_tree_mismatch_raises_with_paths():
    g = {"a": torch.ones(3), "b": torch.ones(2)}
    state = tcmp.init_compressor_state({"a": torch.ones(3)})
    with pytest.raises(ValueError, match=r"only in grads: \['b'\]"):
        tcmp.compress_decompress(g, state)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def test_synthetic_batches_equal_reference():
    kw = dict(vocab=256, seq_len=24, global_batch=6, seed=3)
    jd = jdata.SyntheticLM(jdata.DataConfig(**kw), host_id=1, n_hosts=2)
    td = tdata.SyntheticLM(tdata.DataConfig(**kw), host_id=1, n_hosts=2,
                           device="cpu")
    for i in range(4):
        jb, tb = jd.batch_at(i), td.batch_at(i)
        for key in ("tokens", "labels"):
            assert tb[key].dtype == torch.int32
            np.testing.assert_array_equal(tb[key].numpy(), _np(jb[key]))


# ---------------------------------------------------------------------------
# The whole slice: 3 train steps in both packages
# ---------------------------------------------------------------------------

def _cfgs():
    jcfg = dataclasses.replace(jregistry.get_smoke_config(ARCH), n_layers=2)
    tcfg = dataclasses.replace(tregistry.get_smoke_config(ARCH), n_layers=2)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _cfgs()
    return jmodel.init_params(jax.random.PRNGKey(0), jcfg)


def _torch_params(jax_params, tcfg):
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    return tmodel.stack_layers(params_from_numpy(tree, tcfg, "cpu"), tcfg)


def _batches(n, vocab):
    data = tdata.SyntheticLM(tdata.DataConfig(vocab, SEQ, BATCH, seed=7),
                             device="cpu")
    return [data.batch_at(i) for i in range(n)]


def _opt_kw():
    return dict(lr=1e-3, warmup_steps=1, total_steps=STEPS, moment_codec="vp")


def _run_jax(params, qat_mode, microbatches):
    jcfg, _ = _cfgs()
    step = jax.jit(j_make_train_step(
        jcfg, jopt.OptConfig(**_opt_kw()), microbatches=microbatches,
        compress_grads=jcmp.CompressionConfig(codec="vp"),
        qat=JQuantConfig(mode="vp", qat_mode=qat_mode)))
    opt = jopt.init_opt_state(params, jopt.OptConfig(**_opt_kw()))
    cmp = jcmp.init_compressor_state(params)
    losses = []
    for b in _batches(STEPS, jcfg.vocab):
        jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
        params, opt, m, cmp = step(params, opt, jb, cmp)
        losses.append(float(m["loss"]))
    return losses, params


def _run_torch(params, qat_mode, microbatches):
    _, tcfg = _cfgs()
    step = make_train_step(
        tcfg, topt.OptConfig(**_opt_kw()), microbatches=microbatches,
        compress_grads=tcmp.CompressionConfig(codec="vp"),
        qat=TQuantConfig(mode="vp", qat_mode=qat_mode))
    opt = topt.init_opt_state(params, topt.OptConfig(**_opt_kw()))
    cmp = tcmp.init_compressor_state(params)
    losses = []
    for b in _batches(STEPS, tcfg.vocab):
        params, opt, m, cmp = step(params, opt, b, cmp)
        losses.append(float(m["loss"]))
    return losses, params


_PORT_RUNS = {}


@pytest.mark.parametrize("qat_mode,microbatches",
                         [("packed", 1), ("packed", 2), ("fake", 1),
                          ("fake", 2)])
def test_train_steps_match_reference(jax_params, qat_mode, microbatches):
    """3 steps with VP gradient compression and VP moments.

    Every loss within 1e-5 relative.  Final params within 1e-4 of
    max|param| per leaf, except where a VP rounding flipped: gradients
    agree to ~5e-7 relative (f32 sums in another order), and the rare
    element that lies that close to a rounding boundary of the gradient
    or moment codec is quantized one VP step apart, which Adam turns into
    an lr-sized move.  Such elements are at most 1e-4 of all elements
    (at most 4 of 106,880 in these runs, each under 4e-5), each within
    2 * lr * STEPS.
    """
    _, tcfg = _cfgs()
    want, jp = _run_jax(jax_params, qat_mode, microbatches)
    got, tp = _run_torch(_torch_params(jax_params, tcfg), qat_mode,
                         microbatches)
    _PORT_RUNS[qat_mode, microbatches] = got
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jl = dict(tree_paths(jax.tree_util.tree_map(np.asarray, jp)))
    tl = dict(tree_paths(tp))
    assert sorted(jl) == sorted(tl)
    move = 2 * _opt_kw()["lr"] * STEPS
    flips, total = {}, 0
    for path, t in tl.items():
        w = jl[path]
        diff = np.abs(t.numpy() - w)
        n = int((diff > 1e-4 * np.abs(w).max()).sum())
        if n:
            flips[path] = n
        total += w.size
        assert diff.max() <= move, (path, float(diff.max()))
    assert sum(flips.values()) <= 1e-4 * total, flips


def test_packed_qat_tracks_fake_baseline(jax_params):
    """The port's packed and fake QAT land within 1e-3 of each other's
    final loss (counterpart of `test_qat_packed_matches_fake_baseline`)."""
    _, tcfg = _cfgs()
    runs = {mode: _PORT_RUNS.get((mode, 1)) or _run_torch(
        _torch_params(jax_params, tcfg), mode, 1)[0]
        for mode in ("packed", "fake")}
    fake, packed = runs["fake"][-1], runs["packed"][-1]
    assert abs(fake - packed) < 1e-3 * max(1.0, abs(fake)), (fake, packed)


def _tiny_cfg():
    return tregistry.get_smoke_config(ARCH, TQuantConfig(mode="none"))


def _tiny_params(cfg, seed=0):
    return tmodel.stack_layers(tmodel.init_params(cfg, seed, device="cpu"),
                               cfg)


def test_microbatch_parity():
    """microbatches=2 equals microbatches=1 up to f32 order: same loss,
    params within rtol 2e-5, the same metric keys."""
    cfg = _tiny_cfg()
    opt_cfg = topt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = _tiny_params(cfg)
    batch = _batches(1, cfg.vocab)[0]
    outs = {}
    for k in (1, 2):
        p, _, m = make_train_step(cfg, opt_cfg, microbatches=k)(
            params, topt.init_opt_state(params, opt_cfg), batch)
        outs[k] = (p, m)
    assert set(outs[1][1]) == set(outs[2][1])
    assert abs(float(outs[1][1]["loss"]) - float(outs[2][1]["loss"])) < 1e-5
    for a, b in zip(tree_leaves(outs[1][0]), tree_leaves(outs[2][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-6)


def test_microbatch_indivisible_raises():
    cfg = _tiny_cfg()
    opt_cfg = topt.OptConfig()
    params = _tiny_params(cfg)
    step = make_train_step(cfg, opt_cfg, microbatches=3)
    with pytest.raises(ValueError, match="divisible by microbatches=3"):
        step(params, topt.init_opt_state(params, opt_cfg),
             _batches(1, cfg.vocab)[0])


# ---------------------------------------------------------------------------
# Checkpoints, restarts, CLI
# ---------------------------------------------------------------------------

def _state(seed=0):
    cfg = tregistry.get_smoke_config(ARCH)
    params = _tiny_params(cfg, seed)
    params["lm_head"] = params["lm_head"].to(torch.bfloat16)
    opt_cfg = topt.OptConfig(moment_codec="vp")
    opt = topt.init_opt_state(params, opt_cfg)
    return {"params": params, "opt": opt._asdict(),
            "cmp": tcmp.init_compressor_state(params)}


def _assert_tree_equal(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype, path
        assert torch.equal(x, y), path


def test_checkpoint_round_trip_and_sweep(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, ".tmp_step_9_12345"))
    open(os.path.join(d, ".LATEST.tmp"), "w").close()
    mgr = CheckpointManager(d, keep=2)
    assert sorted(os.listdir(d)) == []
    state = _state()
    mgr.save(3, state, extra={"data_index": 3})
    mgr.wait()
    restored, manifest = mgr.restore(3, _state(seed=1))
    _assert_tree_equal(restored, state)
    assert manifest["extra"] == {"data_index": 3}
    assert "params/lm_head" in manifest["bf16"]
    assert isinstance(topt.OptState(**restored["opt"]).step, torch.Tensor)
    for s in (4, 5):
        mgr.save(s, state, extra={"data_index": s})
    mgr.wait()
    assert mgr.all_steps() == [4, 5] and mgr.latest_step() == 5


def test_restore_latest_skips_corrupt(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    good, bad = _state(seed=0), _state(seed=1)
    mgr.save(1, good, extra={"data_index": 1})
    mgr.save(2, bad, extra={"data_index": 2})
    path = os.path.join(str(tmp_path), "step_2", "arrays.npz")
    with open(path, "r+b") as f:
        f.seek(100)
        f.write(b"\x00" * 16)
    with pytest.raises(CheckpointCorruptError):
        mgr.verify(2)
    tree, manifest, step = mgr.restore_latest(_state(seed=2))
    assert step == 1 and manifest["extra"]["data_index"] == 1
    _assert_tree_equal(tree, good)


def _restartable_loop(cfg, directory, crash_at=None):
    """A 4-step training loop that resumes from `directory`'s latest
    checkpoint, saves after step 2 and, once, crashes at `crash_at`."""
    opt_cfg = topt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    step_fn = make_train_step(cfg, opt_cfg)
    batches = _batches(4, cfg.vocab)
    mgr = CheckpointManager(directory)
    crashed = []

    def loop(attempt):
        params = _tiny_params(cfg)
        opt = topt.init_opt_state(params, opt_cfg)
        start = 0
        res = mgr.restore_latest({"params": params, "opt": opt._asdict()})
        if res is not None:
            tree, manifest, _ = res
            params, opt = tree["params"], topt.OptState(**tree["opt"])
            start = manifest["extra"]["data_index"]
        for i in range(start, 4):
            if i == crash_at and not crashed:
                crashed.append(attempt)
                raise RuntimeError("simulated failure")
            params, opt, _ = step_fn(params, opt, batches[i])
            if i == 1:
                mgr.save(2, {"params": params, "opt": opt._asdict()},
                         extra={"data_index": 2})
        mgr.wait()
        return params

    return loop, crashed


def test_run_with_restarts_resumes_from_latest(tmp_path):
    """A loop that crashes at step 3 is restarted, resumes from the
    checkpoint of step 2 and ends with the params of an uninterrupted
    run."""
    cfg = _tiny_cfg()
    loop, crashed = _restartable_loop(cfg, str(tmp_path / "a"), crash_at=3)
    resumed = run_with_restarts(loop, max_restarts=1)
    straight, _ = _restartable_loop(cfg, str(tmp_path / "b"))
    assert crashed == [0]
    _assert_tree_equal(resumed, straight(0))


def test_train_cli_trains_and_resumes(tmp_path, capsys):
    args = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
            "--qat", "packed", "--compress-grads", "--grad-codec", "vp",
            "--compress-moments", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--log-every", "1"]
    first = train_cli.main(["--steps", "4"] + args)
    losses = [s["loss"] for s in first["steps"]]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    capsys.readouterr()
    second = train_cli.main(["--steps", "6"] + args)
    assert "[resume] from step 4" in capsys.readouterr().out
    assert second["resumed_from"] == 4
    assert [s["step"] for s in second["steps"]] == [4, 5]
    json.dumps(first)


def test_train_cli_ft_sim_restarts_and_resumes(tmp_path, capsys):
    """--ft-sim: a simulated host crash at step 2 restarts the loop, which
    resumes from the step-2 checkpoint and repeats step 2 bit for bit."""
    report = train_cli.main([
        "--smoke", "--device", "cpu", "--steps", "4", "--batch", "2",
        "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
        "--log-every", "1", "--ft-sim", "--ft-fail-steps", "2",
        "--ft-straggler", "1"])
    out = capsys.readouterr().out
    assert "[restart] attempt 1" in out and "[resume] from step 2" in out
    assert "[ft] topology changed" in out
    assert report["restarts"] == 1 and report["resumed_from"] == 2
    steps = [s["step"] for s in report["steps"]]
    assert steps == [0, 1, 2, 2, 3]
    assert report["steps"][2]["loss"] == report["steps"][3]["loss"]


def test_train_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdata.SyntheticLM(tdata.DataConfig(16, 4, 2))


def test_value_and_grad_leaves_params_untouched():
    cfg = _tiny_cfg()
    params = _tiny_params(cfg)
    loss, metrics, grads = value_and_grad(params, _batches(1, cfg.vocab)[0],
                                          cfg)
    assert all(not p.requires_grad for p in tree_leaves(params))
    assert [p for p, _ in tree_paths(grads)] == [
        p for p, _ in tree_paths(params)]
    assert float(loss) == float(metrics["ce"])
    assert tree_map(lambda g: g.dtype, grads) == tree_map(
        lambda p: p.dtype, params)
