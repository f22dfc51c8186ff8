"""The port's sharded forward against the reference's single-device
oracle: the tiny dense config of the reference's
`tests/test_sharded_parity.py` over its quant x KV-layout MATRIX (the
MoE config and the engine are in `test_torch_sharded_engine.py`, the
ops in `test_torch_sharded.py`).

Gloo ranks on the CPU (`_torch_dist_jobs.spawn`): world 2 at mesh
(data, model) = (1, 2), world 4 at (2, 2) with the decode batch split
over "data".  Every rank is held against the reference (logits within
1e-5 relative, f32; the greedy token equal) and against the port's own
unsharded run (logits within 1e-5, the packed caches bit for bit).
vp_block's per-tensor activation scale couples the rows of a batch
(ROADMAP notes), so with the decode batch split over "data" its decode
is held to the reference's one-row decode of each row, as the unsharded
engine holds vp_block at one slot.
"""
import pytest

import _torch_dist_jobs as jobs
import _torch_sharded_cases as cases

MESHES = {(1, 2): 2, (2, 2): 4}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    made = {key: cases.model_case(*cases.cfgs(cases.quant(*key)))
            for key in cases.MATRIX}
    out = {}
    for mesh, world in MESHES.items():
        model = {k: dict(c, mesh=mesh) for k, (c, _) in made.items()}
        out[mesh] = {"ranks": [r["model"] for r in jobs.spawn(
            world, {"model": model},
            tmp_path_factory.mktemp(f"world{world}"))],
            "want": {k: w for k, (_, w) in made.items()}}
    return out


@pytest.mark.parametrize("mesh", list(MESHES), ids=["tp2", "dp2tp2"])
@pytest.mark.parametrize("mode,kv", cases.MATRIX)
def test_model_parity(runs, mesh, mode, kv):
    cases.check_model(runs[mesh], (mode, kv),
                      rows=mode == "vp_block" and mesh[0] > 1)
