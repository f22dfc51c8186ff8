"""The port's distribution layer against the reference's single-device
oracle: the sharded packed-VP ops at tp 2 and 4, the backward pair and
the data-parallel gradient codec, and the subcarrier-sharded wideband
equalizer (the op half of the reference's `tests/test_sharded_parity.py`;
the model and engine half is `test_torch_sharded_model.py`).

Gloo ranks on the CPU (`_torch_dist_jobs.spawn`), one spawn per world
size for the whole module; the reference's oracles are computed here,
single-device, and each rank is also held against the port's own
unsharded plain run.  Integer results (packed words) bit for bit; float
results within 1e-5 relative (f32; a CPU matmul over a column shard may
round otherwise than over the whole); on the CPU the sharded and the
unsharded plain runs agree bit for bit at these shapes, which is checked
too (the concatenation contract).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import QuantConfig as JQuantConfig
from repro.kernels import ops as kops
from repro.models.attention import flash_attention as jflash
from repro.models.layers import canonical_formats as jformats
from repro.train.compression import CompressionConfig as JCompression
from repro.train.compression import compress_decompress as jcompress

import _torch_dist_jobs as jobs

WORLDS = (2, 4)
MODES = ("column", "gather", "ring")


def close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"x": f(16, 64), "w": f(64, 128), "g": f(16, 128),
            "q": f(2, 1, 8, 32), "k": f(2, 32, 4, 32), "v": f(2, 32, 4, 32),
            "lens": np.asarray([32, 16], np.int32),
            "fq": f(2, 16, 8, 32), "fk": f(2, 16, 4, 32),
            "fv": f(2, 16, 4, 32)}


def _oracle(inp):
    """The reference's single-device results on the same inputs."""
    fxp, vp = jformats(JQuantConfig(mode="vp"))
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    w_pk = kops.vp_quant(j["w"], fxp, vp, packed=True)
    x_pk = kops.vp_quant(j["x"], fxp, vp, packed=True)
    k_w = kops.vp_quant(j["k"], fxp, vp, packed=True)
    v_w = kops.vp_quant(j["v"], fxp, vp, packed=True)
    ones = jnp.ones(inp["k"].shape[:2] + (1, 1), jnp.float32)
    return {
        "words": np.asarray(w_pk), "x_words": np.asarray(x_pk),
        "y": np.asarray(kops.vp_dequant_matmul(j["x"], w_pk, vp)),
        "attn": np.asarray(kops.vp_decode_attention(
            j["q"], k_w, v_w, ones, ones, j["lens"], vp)),
        "flash": np.asarray(jflash(j["fq"], j["fk"], j["fv"])),
        "dx": np.asarray(kops.vp_matmul_dx(j["g"], w_pk, vp)),
        "dw": np.asarray(kops.vp_matmul_dw(x_pk, j["g"], vp)),
    }


def _dp_oracle(grads, codec):
    """Each rank's local compress-decompress, then the mean; residuals
    per rank."""
    cfg = JCompression(codec=codec)
    deqs, errs = [], []
    for i in range(grads.shape[0]):
        g = {"w": jnp.asarray(grads[i:i + 1])}
        d, e = jcompress(g, {"w": jnp.zeros_like(g["w"])}, cfg)
        deqs.append(np.asarray(d["w"]))
        errs.append(np.asarray(e["w"]))
    return np.mean(np.concatenate(deqs), axis=0), errs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inp = _inputs()
    want = _oracle(inp)
    out = {}
    for world in WORLDS:
        grads = np.random.default_rng(3).normal(
            size=(world, 16, 16)).astype(np.float32)
        payload = {"ops": inp, "dp": {"grads": grads},
                   "equalizer": {"S": (2 * world, 2 * world + 1), "n": 4,
                                 "seed": 5}}
        ranks = jobs.spawn(world, payload,
                           tmp_path_factory.mktemp(f"world{world}"))
        out[world] = {"ranks": ranks, "dp_want": {
            c: _dp_oracle(grads, c) for c in ("int8", "vp")}}
    return want, out


@pytest.mark.parametrize("world", WORLDS)
def test_words_bit_exact(runs, world):
    want, out = runs
    for r in out[world]["ranks"]:
        np.testing.assert_array_equal(r["ops"]["words"], want["words"])
        np.testing.assert_array_equal(r["ops"]["x_words"], want["x_words"])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", WORLDS)
def test_dequant_matmul_modes(runs, world, mode):
    """Every rank returns the whole product: the reference's within
    1e-5, the port's unsharded launch bit for bit."""
    want, out = runs
    for r in out[world]["ranks"]:
        close(r["ops"][mode], want["y"], mode)
        np.testing.assert_array_equal(r["ops"][mode], r["ops"]["full"])


def test_bad_modes_raise(runs):
    ops = runs[1][2]["ranks"][0]["ops"]
    assert "mode" in ops["bad_mode"] and "scatter" in ops["bad_mode"]
    assert "mode" in ops["dx_bad_mode"]
    assert "mode" in ops["attn_bad_mode"]


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_move_packed_words(runs, world):
    """column gathers M x N/tp outputs; gather moves the words (int16:
    half the f32 bytes); ring rotates them tp - 1 times."""
    c = runs[1][world]["ranks"][0]["ops"]["collectives"]
    assert c["launches"] == {"all_gather": 2, "ppermute": world - 1}
    assert c["bytes"]["ppermute"] * 2 == c["f32_bytes"]["ppermute"]
    assert c["bytes"]["ppermute"] == (world - 1) * 64 * (128 // world) * 2


@pytest.mark.parametrize("world", WORLDS)
def test_shard_launches_at_shard_shapes(runs, world):
    got = runs[1][world]["ranks"][0]["ops"]["shard_launches"]
    n = 128 // world
    assert got[("vp_dequant_matmul", (16, 64, n))] == 1 + world
    assert got[("vp_dequant_matmul", (16, 64, 128))] == 1
    assert got[("vp_matmul_dw", (16, 64, n))] == 1
    assert got[("vp_matmul_dx", (16 // world, 64, n))] == 2 * world
    assert got[("vp_decode_attention", (2, 32, 4 // world, 32))] == 1
    assert got[("flash_prefill", (2, 16, 8 // world, 32))] == 1


@pytest.mark.parametrize("mode", ["seq", "heads"])
@pytest.mark.parametrize("world", WORLDS)
def test_decode_attention_modes(runs, world, mode):
    want, out = runs
    for r in out[world]["ranks"]:
        close(r["ops"][mode], want["attn"], mode)
        np.testing.assert_array_equal(r["ops"][mode], r["ops"]["attn_full"])


@pytest.mark.parametrize("world", WORLDS)
def test_flash_prefill_heads(runs, world):
    want, out = runs
    for r in out[world]["ranks"]:
        close(r["ops"]["flash"], want["flash"])
        np.testing.assert_array_equal(r["ops"]["flash"],
                                      r["ops"]["flash_full"])


@pytest.mark.parametrize("mode", ["psum", "ring"])
@pytest.mark.parametrize("world", WORLDS)
def test_matmul_dx_modes(runs, world, mode):
    """dx reduces partial products across the shards: f32 tolerance
    against the reference and the unsharded kernel."""
    want, out = runs
    for r in out[world]["ranks"]:
        close(r["ops"][f"dx_{mode}"], want["dx"], mode)
        close(r["ops"][f"dx_{mode}"], r["ops"]["dx_full"], mode)


@pytest.mark.parametrize("world", WORLDS)
def test_matmul_dx_ring_scatter_and_ragged(runs, world):
    """gather=False leaves each rank its row chunk; the chunks in rank
    order are dx; M = 5 does not divide the ring."""
    want, out = runs
    ranks = out[world]["ranks"]
    close(np.concatenate([r["ops"]["dx_scatter"] for r in ranks]),
          want["dx"])
    assert all(r["ops"]["dx_scatter"].shape == (16 // world, 64)
               for r in ranks)
    assert "M=5" in ranks[0]["ops"]["dx_ragged"]
    assert "divisible" in ranks[0]["ops"]["dx_ragged"]


@pytest.mark.parametrize("world", WORLDS)
def test_matmul_dw_local_columns(runs, world):
    """Each rank's dw is its columns of the whole dw, bit for bit against
    the port's unsharded kernel."""
    want, out = runs
    n = 128 // world
    for i, r in enumerate(out[world]["ranks"]):
        cols = slice(i * n, (i + 1) * n)
        close(r["ops"]["dw"], want["dw"][:, cols])
        np.testing.assert_array_equal(r["ops"]["dw"],
                                      r["ops"]["dw_full"][:, cols])


@pytest.mark.parametrize("codec", ["int8", "vp"])
@pytest.mark.parametrize("world", WORLDS)
def test_dp_compress_reduce(runs, world, codec):
    """The mean of every rank's decoded gradient, on every rank; each
    rank keeps its own residual."""
    mean, errs = runs[1][world]["dp_want"][codec]
    for i, r in enumerate(runs[1][world]["ranks"]):
        red, state = r["dp"][codec]
        np.testing.assert_allclose(red[0], mean, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(state, errs[i], rtol=0, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_equalizer_shard_map(runs, world):
    """S = 2 x world subcarriers: each rank equalizes its slab, the
    gathered band equals the flat path's bit for bit; S = 2 x world + 1
    does not divide the mesh and runs unsharded, counted."""
    for r in runs[1][world]["ranks"]:
        even, odd = r["equalizer"][2 * world], r["equalizer"][2 * world + 1]
        np.testing.assert_array_equal(even["shard_map"], even["flat"])
        assert even["unsharded"] == {}
        np.testing.assert_array_equal(odd["shard_map"], odd["flat"])
        assert odd["unsharded"] == {"shard_over_subcarriers": 1}
