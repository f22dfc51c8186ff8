"""The port's expert-parallel MoE forward and mesh-native serving engine
against the reference's single-device oracle (the rest of the
reference's `tests/test_sharded_parity.py`; see also
`test_torch_sharded_model.py`).

Gloo ranks on the CPU (`_torch_dist_jobs.spawn`): world 2 runs the tiny
MoE config (8 experts, top 2) with each rank holding 4 experts, vp and
float, and the engine at mesh (data, model) = (1, 2); world 4 the engine
at (2, 2) with a run-ahead of 2 (its 2-slot bucket split over "data").
MoE logits within 1e-5 relative (f32) of the reference and of the
port's unsharded run, its caches bit for bit; the engine's greedy
tokens equal to the reference's static oracle and to the port's
unsharded engine, and its pools equal on every rank.
"""
import dataclasses

import pytest

import _torch_dist_jobs as jobs
import _torch_sharded_cases as cases

MESHES = {(1, 2): (2, 1), (2, 2): (4, 2)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    made = {("moe", m): cases.model_case(*cases.cfgs(
        cases.quant(m, "packed" if m == "vp" else "float"), family="moe"))
        for m in cases.MOE}
    engine, tokens = cases.engine_case()
    out = {}
    for mesh, (world, lookahead) in MESHES.items():
        payload = {"engine": dict(engine, mesh=mesh, lookahead=lookahead)}
        if mesh == (1, 2):
            payload["model"] = {k: dict(c, mesh=mesh)
                                for k, (c, _) in made.items()}
        ranks = jobs.spawn(world, payload,
                           tmp_path_factory.mktemp(f"world{world}"))
        out[mesh] = {"ranks": [r.get("model") for r in ranks],
                     "engine": [r["engine"] for r in ranks],
                     "want": {k: w for k, (_, w) in made.items()},
                     "tokens": tokens}
    return out


@pytest.mark.parametrize("mode", cases.MOE)
def test_model_parity_moe_expert_parallel(runs, mode):
    cases.check_model(runs[(1, 2)], ("moe", mode))


@pytest.mark.parametrize("mesh", list(MESHES), ids=["tp2", "dp2tp2"])
def test_engine_mesh_parity(runs, mesh):
    """Every rank serves the reference's greedy tokens, equal to the
    port's unsharded engine's, and ends with the same pools; on the CPU
    nothing is captured and nothing is reported eager."""
    run = runs[mesh]
    for e in run["engine"]:
        assert e["got"] == e["want"] == run["tokens"]
        assert len(set(e["digests"])) == 1
        assert e["graph_log"] == [] and "eager_decodes" not in e["stats"]


def test_engine_collectives_and_data_shards(runs):
    """Tensor parallel gathers on every projection and agrees on the
    clock; the (2, 2) engine also gathers its decode writes over
    "data"."""
    tp, dp = runs[(1, 2)]["engine"][0], runs[(2, 2)]["engine"][0]
    assert tp["collectives"]["launches"]["all_gather"] > 0
    assert tp["collectives"]["launches"]["agree"] > 0
    assert dp["collectives"]["launches"]["all_gather"] > \
        tp["collectives"]["launches"]["all_gather"]


def test_configs_mirror():
    """The port's tiny configs carry the reference's values."""
    jcfg, tcfg = cases.cfgs(cases.quant("vp", "packed"), family="moe")
    for f in dataclasses.fields(tcfg):
        if f.name != "quant":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
