"""Oracles and checks shared by `test_torch_sharded_model.py` and
`test_torch_sharded_engine.py`: the reference's tiny configs (as its
`tests/test_sharded_parity.py` builds them) and their single-device
results, made in the test process; the ranks get them as numpy
(`_torch_dist_jobs`)."""
import jax
import numpy as np

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import QuantConfig as JQuantConfig
from repro.models import decode_step, init_cache, init_params, prefill, \
    quantize_params
from repro.serving.runner import oracle_generate
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import QuantConfig as TQuantConfig

MATRIX = [("vp", "packed"), ("vp", "planes"), ("fxp", "packed"),
          ("vp_block", "packed"), ("vp", "float")]
MOE = ("vp", "none")
REQS = [([1, 2, 3, 4, 5], 4, 0.0), (list(range(7)), 5, 0.0),
        ([9, 8, 7], 3, 0.05)]
B, S, CAP = 2, 16, 32


def close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


def quant(mode, kv):
    kw = {"mode": mode}
    if kv != "float":
        kw.update(quantize_kv_cache=True, kv_layout=kv)
    if mode == "vp_block":
        kw["block"] = 16
    return kw


def cfgs(quant, family="dense", **kw):
    base = dict(name="tiny", family=family, n_layers=2, d_model=64,
                n_heads=8, n_kv_heads=4, d_ff=128, vocab=128,
                dtype="float32")
    if family == "moe":
        base.update(n_experts=8, experts_per_token=2)
    base.update(kw)
    return (JModelConfig(quant=JQuantConfig(**quant), **base),
            TModelConfig(quant=TQuantConfig(**quant), **base))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def model_case(jcfg, tcfg):
    """The reference's params, prefill and one greedy decode step (and,
    for vp_block, each row's decode step alone: its per-tensor
    activation scale couples the rows of a batch, so a data shard of
    the batch is held to the one-row oracle)."""
    params = init_params(jax.random.PRNGKey(0), jcfg)
    if jcfg.quant.mode != "none":
        params = quantize_params(params, jcfg)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                           jcfg.vocab))
    logits, caches = jax.jit(
        lambda p, t, c: prefill(p, t, c, jcfg))(params, tokens,
                                                init_cache(jcfg, B, CAP))
    tok = np.asarray(np.argmax(np.asarray(logits), -1), np.int32)[:, None]
    dec = jax.jit(lambda p, t, c: decode_step(p, t, c, jcfg))
    want = {"logits": np.asarray(logits), "tok": tok,
            "dlogits": np.asarray(dec(params, tok, caches)[0])}
    if jcfg.quant.mode == "vp_block":
        want["rows"] = np.concatenate([np.asarray(dec(
            params, tok[i:i + 1], jax.tree_util.tree_map(
                lambda c: c[:, i:i + 1], caches))[0]) for i in range(B)])
    return ({"cfg": tcfg, "params": np_tree(params), "tokens": tokens,
             "cap": CAP}, want)


def engine_case():
    jcfg, tcfg = cfgs(quant("vp", "packed"), n_heads=4, n_kv_heads=2)
    params = quantize_params(init_params(jax.random.PRNGKey(0), jcfg), jcfg)
    oracle = {rid: oracle_generate(params, jcfg, p, g, 24)
              for rid, (p, g, _) in enumerate(REQS)}
    return ({"cfg": tcfg, "params": np_tree(params), "reqs": REQS,
             "slots": 2}, oracle)


def _same(got, want, what):
    for a, b in zip(want, got):
        assert a.keys() == b.keys()
        for k in a:
            if np.issubdtype(a[k].dtype, np.integer):
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"{what} {k}")
            else:
                close(b[k], a[k], f"{what} {k}")


def check_model(run, key, rows=False):
    """`run`: {"ranks": each rank's model job results, "want": the
    oracles}.  Logits against the reference and the port's unsharded run; the
    prefill's caches equal to the unsharded ones (words bit for bit),
    and after the decode step too, except where `rows` holds the decode
    to the one-row oracle."""
    want = run["want"][key]
    for r in run["ranks"]:
        got = r[key]
        (l1, d1, p1, c1), (l2, d2, p2, c2) = got["plain"], got["sharded"]
        np.testing.assert_array_equal(got["tok"], want["tok"])
        close(l2, want["logits"], "prefill logits vs reference")
        close(l2, l1, "prefill logits vs the port unsharded")
        _same(p2, p1, "prefill caches")
        if rows:
            close(d2, want["rows"], "decode logits vs the one-row oracle")
            continue
        close(d2, want["dlogits"], "decode logits vs reference")
        close(d2, d1, "decode logits vs the port unsharded")
        _same(c2, c1, "decode caches")
