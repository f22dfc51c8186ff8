"""The port's distribution layer without processes: the mesh factory
(`launch/mesh.py`), the placement rules (`parallel/shard_ops.py:
shard_param_specs`) against the reference's own spec tree, the autotune
mesh scope, and the shard planners, which give a shard the unsharded
launch's split and cluster (so the concatenated shards equal the
unsharded launch bit for bit on the card).

The factory's positive cases run in a world of one gloo rank made in
this process (a FileStore under tmp_path) and torn down after.
"""
import jax
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import QuantConfig as JQuantConfig
from repro.kernels import autotune as jat
from repro.models import init_params as jinit_params
from repro.models import quantize_params as jquantize_params
from repro.parallel import shard_ops as jshard
from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core.formats import VPFormat
from repro_torch.kernels import autotune
from repro_torch.kernels import vp_block_matmul as block_mm
from repro_torch.kernels.vp_attention import plan_decode, shard_decode
from repro_torch.kernels.vp_bwd_matmul import plan_tiles, shard_cols
from repro_torch.kernels.vp_dequant_matmul import (SKINNY_KERNEL,
                                                   plan_skinny, shard_skinny,
                                                   shard_tiles)
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tmodel
from repro_torch.models.weights import params_from_numpy
from repro_torch.parallel import shard_ops, sharding

SMS = 132
VP7 = VPFormat(7, (11, 9, 8, 6))


@pytest.fixture
def world1(tmp_path):
    tmesh.init_world(0, 1, store=dist.FileStore(str(tmp_path / "store"), 1),
                     device="cpu")
    yield
    dist.destroy_process_group()


# -- the mesh factory ----------------------------------------------------------

def test_mesh_validation_errors():
    with pytest.raises(ValueError, match="devices"):
        tmesh.elastic_mesh(1, 3, 5)
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.elastic_mesh(0, 1, 8)
    with pytest.raises(ValueError, match="exposes"):
        tmesh.best_effort_mesh(1024)
    with pytest.raises(ValueError, match="prefer"):
        tmesh.best_effort_mesh(1, prefer="pod")
    with pytest.raises(ValueError, match="needs 256 devices"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="initialise torch.distributed"):
        tmesh.smoke_mesh()


def test_meshes_over_one_rank(world1):
    m = tmesh.smoke_mesh()
    assert tmesh.mesh_shape(m) == {"data": 1, "model": 1}
    assert tmesh.mesh_shape(tmesh.best_effort_mesh(1, prefer="data")) == \
        {"data": 1, "model": 1}
    assert tmesh.mesh_shape(tmesh.elastic_mesh(1, 1, 1)) == \
        {"data": 1, "model": 1}
    assert m.device_type == "cpu"
    assert autotune.mesh_desc(m) == "model1.N"
    assert autotune.mesh_desc(m, "data", "B") == "data1.B"
    assert autotune.mesh_desc(m, "pod") == "pod1.N"
    assert shard_ops.tp_size(m) == shard_ops.tp_size(m, "data") == 1
    assert shard_ops.tp_size(m, "pod") == 1
    with pytest.raises(ValueError, match="devices"):
        tmesh.elastic_mesh(1, 1, 2)


def test_subcarrier_mesh_over_one_rank(world1):
    """The subcarrier mesh's one "sc" dim, the mesh helpers of
    `parallel/sharding.py`, and a one-rank mesh running the band
    unsharded, counted as the reference degrades."""
    m = sharding.subcarrier_mesh()
    assert m.mesh_dim_names == ("sc",) and m.size(0) == 1
    prod = tmesh.smoke_mesh()
    assert sharding.batch_axes(prod) == ("data",)
    assert sharding.tp_size(prod) == 1
    sharding.UNSHARDED.clear()
    x = torch.arange(12.0).reshape(4, 3)
    fn = sharding.shard_over_subcarriers(lambda a: a * 2, mesh=m,
                                         n_subcarriers=4)
    assert torch.equal(fn(x), x * 2)
    assert sharding.UNSHARDED == {"shard_over_subcarriers": 1}


# -- placement rules -------------------------------------------------------------

def _tiny(family, mode="vp", **kw):
    base = dict(name="tiny", family=family, n_layers=2, d_model=64,
                n_heads=8, n_kv_heads=4, d_ff=128, vocab=128,
                dtype="float32")
    if family == "moe":
        base.update(n_experts=8, experts_per_token=2)
    base.update(kw)
    return (JModelConfig(quant=JQuantConfig(mode=mode), **base),
            ModelConfig(quant=QuantConfig(mode=mode), **base))


def _ref_dim(spec, stacked: bool):
    """The reference's PartitionSpec as the port's spec: the sharded dim,
    less the reference's leading stack axis inside its groups."""
    dims = [i for i, a in enumerate(spec) if a == "model"]
    if not dims:
        return shard_ops.REPLICATED
    return dims[0] - stacked


def _flatten(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flatten(v, path + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _flatten(v, path + (i,))
    else:
        yield path, node


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family,mode", [("dense", "vp"), ("moe", "vp"),
                                         ("dense", "vp_block"),
                                         ("dense", "fxp")])
def test_specs_are_the_references(family, mode, tp):
    """Every leaf of the port's tree (carried from the reference's) is
    sharded along the dim the reference's spec names, expert stacks along
    their expert dim, everything else replicated."""
    jcfg, tcfg = _tiny(family, mode)
    jparams = jquantize_params(jinit_params(jax.random.PRNGKey(0), jcfg),
                               jcfg)
    jspecs = jshard.shard_param_specs(jparams, jcfg, tp=tp)
    tparams = params_from_numpy(
        jax.tree_util.tree_map(lambda a: jax.device_get(a), jparams), tcfg,
        "cpu")
    specs = shard_ops.shard_param_specs(tparams, tcfg, tp=tp)
    plan = tmodel.layer_plan(tcfg)
    seen = 0
    for path, dim in _flatten(specs):
        if path[0] == "layers":
            s = plan[path[1]]
            ref = jspecs["groups"][s.gi][f"sub{s.sub}"]
            for k in path[2:]:
                ref = ref[k]
            want = _ref_dim(ref, True)
        else:
            ref = jspecs
            for k in path:
                ref = ref[k]
            want = _ref_dim(ref, False)
        assert dim == want, path
        seen += dim != shard_ops.REPLICATED
    assert seen > 0


def test_specs_divisibility_error():
    _, tcfg = _tiny("dense", d_ff=100)     # 100 % 8 != 0
    params = tmodel.quantize_params(tmodel.init_params(tcfg, 0, "cpu"), tcfg)
    with pytest.raises(shard_ops.ShardSpecError, match="divisible"):
        shard_ops.shard_param_specs(params, tcfg, tp=8)
    with pytest.raises(shard_ops.ShardSpecError, match=">= 1"):
        shard_ops.shard_param_specs(params, tcfg, tp=0)


def test_specs_replicate_floats():
    _, tcfg = _tiny("dense", "none")
    params = tmodel.init_params(tcfg, 0, "cpu")
    specs = shard_ops.shard_param_specs(params, tcfg, tp=8)
    assert {d for _, d in _flatten(specs)} == {shard_ops.REPLICATED}


def test_batch_dim_specs_and_tp_quant():
    tree = [{"k": torch.zeros(2, 4, 3), "len": torch.zeros(2)}]
    assert shard_ops.batch_dim_specs(tree, "data", 1) == [
        {"k": 1, "len": shard_ops.REPLICATED}]
    q = shard_ops.tp_quant(QuantConfig(mode="vp"))
    assert q.tp_axis == "model" and q.mode == "vp"


# -- the autotune mesh scope -----------------------------------------------------

def test_autotune_mesh_key_scoped():
    key0 = autotune.make_key("vp_dequant_matmul", (8, 64, 128), (), "ref")
    assert key0.endswith("|mesh=1")
    with autotune.mesh_scope("model8.N"):
        key8 = autotune.make_key("vp_dequant_matmul", (8, 64, 128), (),
                                 "ref")
        assert autotune.current_mesh_desc() == "model8.N"
    with jat.mesh_scope("model8.N"):
        want = jat.make_key("vp_dequant_matmul", (8, 64, 128), (), "ref")
    assert key8 == want and key8.endswith("|mesh=model8.N") and key8 != key0
    assert autotune.current_mesh_desc() == "1"


def test_unsharded_reads_the_scope():
    assert autotune.unsharded("N", 384) == 384
    with autotune.mesh_scope("model8.N"):
        assert autotune.unsharded("N", 384) == 3072
        assert autotune.unsharded("H", 2) == 2
    with autotune.mesh_scope("model4.H"):
        assert autotune.unsharded("H", 2) == 8
        assert autotune.unsharded("N", 384) == 384


# -- each shard gets the unsharded launch's plan ---------------------------------

@pytest.mark.parametrize("tp", [2, 4, 8])
def test_skinny_split_is_the_unsharded_launchs(tp):
    M, K, N = 4, 1024, 3072
    full = plan_skinny(M, K, N, SMS)
    with autotune.mesh_scope(f"model{tp}.N"):
        got = shard_skinny(M, K, N // tp, SMS)
    assert (got.split, got.k_per) == (full.split, full.k_per)
    assert got.groups == -(-(N // tp) // 64)
    # unpinned, the shard's own heuristic sums in another order
    own = shard_skinny(M, K, N // tp, SMS)
    assert (own.split, own.k_per) != (full.split, full.k_per)


@pytest.mark.parametrize("tp", [2, 4])
def test_tensor_core_split_is_the_unsharded_launchs(tp):
    M, K, N = 512, 1024, 1024
    with autotune.mesh_scope(f"model{tp}.N"):
        got = shard_tiles(M, K, N // tp, SMS)
    assert got == plan_tiles(M, N, K, SMS)
    assert shard_tiles(M, K, N // tp, SMS) != got


@pytest.mark.parametrize("tp", [2, 4])
def test_dw_split_is_the_unsharded_launchs(tp):
    """dw's output (K, N) is cut along N; dx contracts over the cut N and
    keeps its own plan (its partials are reduced afterwards)."""
    M, K, N = 1024, 256, 512
    full = plan_tiles(K, N, M, SMS)
    with autotune.mesh_scope(f"model{tp}.N"):
        got = plan_tiles(K, shard_cols("vp_matmul_dw", N // tp), M, SMS)
        assert shard_cols("vp_matmul_dx", 64) == 64
    assert got == full
    assert plan_tiles(K, shard_cols("vp_matmul_dw", N // tp), M, SMS) != full


@pytest.mark.parametrize("tp", [2, 4])
def test_block_skinny_split_is_the_unsharded_launchs(tp):
    M, K, N = 4, 3072, 16896
    full = block_mm.plan_skinny(M, K, N, SMS)
    with autotune.mesh_scope(f"model{tp}.N"):
        got = block_mm.shard_skinny(M, K, N // tp, SMS)
    assert (got.split, got.tile_groups, got.mt) == (
        full.split, full.tile_groups, full.mt)
    assert got.groups == -(-(N // tp) // 32)
    assert block_mm.shard_skinny(M, K, N // tp, SMS).split != full.split


@pytest.mark.parametrize("tp", [2, 4])
def test_decode_cluster_is_the_unsharded_launchs(tp):
    """The heads mode cuts KV; the cluster aims at DEC_BLOCKS / KV."""
    KV, smax, G, dh = 32, 160, 1, 112
    full = plan_decode(KV, smax, G, dh, 2)
    with autotune.mesh_scope(f"model{tp}.H"):
        got = shard_decode(KV // tp, smax, G, dh, 2)
    assert got == full
    assert shard_decode(KV // tp, smax, G, dh, 2) != full


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.setattr(autotune, "backend_name", lambda device: "FakeCard")
    autotune.clear_cache()
    yield
    autotune.clear_cache()


def test_shard_reads_the_unsharded_cache_entry(cache):
    """On a card a shard takes the plan cached for the unsharded shape,
    never one tuned under a mesh key for the shard's own shape."""
    M, K, N = 4, 1024, 3072
    autotune.record(autotune.make_key(SKINNY_KERNEL, (K, N), (VP7,),
                                      "FakeCard", mesh="1"), (4, 256))
    autotune.record(autotune.make_key(SKINNY_KERNEL, (K, N // 2), (VP7,),
                                      "FakeCard", mesh="model2.N"), (2, 512))
    with autotune.mesh_scope("model2.N"):
        got = shard_skinny(M, K, N // 2, SMS, None, VP7, 0)
    assert (got.split, got.k_per) == (4, 256)
