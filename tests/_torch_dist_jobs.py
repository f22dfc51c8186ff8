"""Rank-side jobs of the sharded parity tests (`test_torch_sharded*.py`).

The test modules import JAX; this one imports only torch and the port, so
a spawned rank never loads JAX.  The parent writes a payload (numpy
inputs, the port's configs, the reference's parameter trees as numpy) to
a file, `spawn` starts `world` gloo ranks on the CPU (one thread each,
rendezvous through a FileStore in the run's directory), each rank runs
the payload's jobs and saves its results to `rank<i>.pt`, which `spawn`
returns, one dict per rank.
"""
from __future__ import annotations

import datetime
import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120


def spawn(world: int, payload: dict, run_dir) -> list:
    run_dir = str(run_dir)
    path = os.path.join(run_dir, "payload.pt")
    torch.save(payload, path)
    ctx = mp.start_processes(_rank_main, args=(world, run_dir), nprocs=world,
                             join=False, start_method="spawn")
    while not ctx.join(timeout=TIMEOUT_S):
        pass
    return [torch.load(os.path.join(run_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _rank_main(rank: int, world: int, run_dir: str) -> None:
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_world

    init_world(rank, world, store=dist.FileStore(
        os.path.join(run_dir, "store"), world), device="cpu",
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    payload = torch.load(os.path.join(run_dir, "payload.pt"),
                         weights_only=False)
    out = {name: JOBS[name](spec, world) for name, spec in payload.items()}
    torch.save(out, os.path.join(run_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().copy()
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np(v) for v in t]
    return t


# ---------------------------------------------------------------------------
# Op level at tp = world
# ---------------------------------------------------------------------------

def _ops(spec, world):
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import elastic_mesh
    from repro_torch.models.layers import canonical_formats
    from repro_torch.parallel import comm, shard_ops

    fxp, vp = canonical_formats(QuantConfig(mode="vp"))
    mesh = elastic_mesh(1, 1, world)
    x, w, g = _t(spec["x"]), _t(spec["w"]), _t(spec["g"])
    words = ops.vp_quant(w, fxp, vp, packed=True)
    out = {"words": words.numpy(),
           "full": ops.vp_dequant_matmul(x, words, vp).numpy()}
    shard_ops.SHARD_LAUNCHES.clear()
    comm.reset()
    with comm.use_mesh(mesh):
        w_loc = comm.slab(words, "model", dim=1)
        for mode in shard_ops.MODES:
            out[mode] = shard_ops.sharded_dequant_matmul(
                x, w_loc, vp, mode=mode).numpy()
        out["collectives"] = comm.snapshot()

        q, k, v = _t(spec["q"]), _t(spec["k"]), _t(spec["v"])
        k_w = ops.vp_quant(k, fxp, vp, packed=True)
        v_w = ops.vp_quant(v, fxp, vp, packed=True)
        ones = torch.ones(k.shape[:2] + (1, 1))
        lens = _t(spec["lens"])
        out["attn_full"] = ops.vp_decode_attention(
            q, k_w, v_w, ones, ones, lens, vp).numpy()
        out["seq"] = shard_ops.sharded_decode_attention(
            q, *(comm.slab(t, "model", 1) for t in (k_w, v_w, ones, ones)),
            lens, vp, mode="seq").numpy()
        out["heads"] = shard_ops.sharded_decode_attention(
            *(comm.slab(t, "model", 2) for t in (q, k_w, v_w)), ones, ones,
            lens, vp, mode="heads").numpy()
        try:
            shard_ops.sharded_decode_attention(q, k_w, v_w, ones, ones, lens,
                                               vp, mode="rows")
        except ValueError as e:
            out["attn_bad_mode"] = str(e)

        fq, fk, fv = _t(spec["fq"]), _t(spec["fk"]), _t(spec["fv"])
        out["flash_full"] = ops.flash_prefill(fq, fk, fv).numpy()
        out["flash"] = shard_ops.sharded_flash_prefill(
            *(comm.slab(t, "model", 2) for t in (fq, fk, fv))).numpy()

        x_pk = ops.vp_quant(x, fxp, vp, packed=True)
        out["x_words"] = x_pk.numpy()
        out["dx_full"] = ops.vp_matmul_dx(g, words, vp).numpy()
        out["dw_full"] = ops.vp_matmul_dw(x_pk, g, vp).numpy()
        for mode in ("psum", "ring"):
            out[f"dx_{mode}"] = shard_ops.sharded_matmul_dx(
                g, w_loc, vp, mode=mode).numpy()
        out["dx_scatter"] = shard_ops.sharded_matmul_dx(
            g, w_loc, vp, mode="ring", gather=False).numpy()
        try:
            shard_ops.sharded_matmul_dx(g[:5], w_loc, vp, mode="ring")
        except shard_ops.ShardSpecError as e:
            out["dx_ragged"] = str(e)
        try:
            shard_ops.sharded_matmul_dx(g, w_loc, vp, mode="gather")
        except ValueError as e:
            out["dx_bad_mode"] = str(e)
        try:
            shard_ops.sharded_dequant_matmul(x, w_loc, vp, mode="scatter")
        except ValueError as e:
            out["bad_mode"] = str(e)
        out["dw"] = shard_ops.sharded_matmul_dw(x_pk, g, vp).numpy()
    out["shard_launches"] = dict(shard_ops.SHARD_LAUNCHES)
    return out


def _dp(spec, world):
    from repro_torch.launch.mesh import elastic_mesh
    from repro_torch.parallel import comm, shard_ops
    from repro_torch.train.compression import (CompressionConfig,
                                               init_compressor_state)

    mesh = elastic_mesh(1, world, 1)
    out = {}
    with comm.use_mesh(mesh):
        r = comm.axis_index("data")
        grads = {"w": _t(spec["grads"])[r:r + 1]}
        for codec in ("int8", "vp"):
            red, st = shard_ops.dp_compress_reduce(
                grads, init_compressor_state(grads), axis="data",
                config=CompressionConfig(codec=codec))
            out[codec] = (red["w"].numpy(), st["w"].numpy())
    return out


# ---------------------------------------------------------------------------
# Whole model and engine
# ---------------------------------------------------------------------------

def _model(spec, world):
    from repro_torch.launch.mesh import elastic_mesh
    from repro_torch.models import model as tm
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.parallel import shard_ops

    out = {}
    for name, case in spec.items():
        cfg, (data, model) = case["cfg"], case["mesh"]
        mesh = elastic_mesh(1, data, model)
        params = params_from_numpy(case["params"], cfg, "cpu")
        toks = _t(case["tokens"])
        B = toks.shape[0]
        c1 = tm.init_cache(cfg, B, case["cap"], device="cpu")
        l1, c1 = tm.prefill(params, toks, c1, cfg)
        p1 = _np(list(c1))
        tok = torch.argmax(l1, -1).to(torch.int32)[:, None]
        d1, c1 = tm.decode_step(params, tok, c1, cfg)

        placed = shard_ops.place_params(params, cfg, mesh)
        pf, df = shard_ops.sharded_forward_fns(
            params, cfg, mesh, data_axis="data" if data > 1 else None)
        c2 = tm.init_cache(cfg, B, case["cap"], device="cpu")
        l2, c2 = pf(placed, toks, c2)
        p2 = _np(list(c2))
        d2, c2 = df(placed, tok, c2, batch_sharded=data > 1)
        out[name] = {"plain": (l1.numpy(), d1.numpy(), p1, _np(list(c1))),
                     "sharded": (l2.numpy(), d2.numpy(), p2, _np(list(c2))),
                     "tok": tok.numpy()}
    return out


def _digest(kv) -> str:
    """A hash of an engine's pools past the dummy page, dense rows and
    lengths."""
    h = hashlib.sha256()
    for k in sorted(kv.pools):
        h.update(kv.pools[k][:, 1:].contiguous().view(torch.uint8).numpy())
    for k in sorted(kv.dense):
        h.update(kv.dense[k].contiguous().view(torch.uint8).numpy())
    h.update(kv.lengths.numpy().tobytes())
    return h.hexdigest()


def _engine(spec, world):
    from repro_torch.launch.mesh import elastic_mesh
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.parallel import comm
    from repro_torch.serving import ServingEngine, VirtualClock

    cfg, (data, model) = spec["cfg"], spec["mesh"]
    params = params_from_numpy(spec["params"], cfg, "cpu")

    def run(mesh):
        eng = ServingEngine(params, cfg, max_slots=spec["slots"],
                            capacity=24, page_size=8, clock=VirtualClock(),
                            mesh=mesh, decode_lookahead=spec["lookahead"])
        for prompt, gen, t in spec["reqs"]:
            eng.submit(prompt, gen, t)
        return {r["rid"]: r["tokens"] for r in eng.run()}, eng

    want, _ = run(None)
    mesh = elastic_mesh(1, data, model)
    comm.reset()
    got, eng = run(mesh)
    digest = _digest(eng.kv)
    digests = [None] * world
    dist.all_gather_object(digests, digest)
    return {"want": want, "got": got, "digests": digests,
            "collectives": comm.snapshot(), "graph_log": eng.runner.graph_log,
            "stats": dict(eng.stats)}


def _equalizer(spec, world):
    from repro_torch.mimo import equalizer, ofdm
    from repro_torch.mimo.channel import ChannelConfig
    from repro_torch.parallel import sharding

    out = {}
    for S in spec["S"]:
        gen = torch.Generator().manual_seed(spec["seed"])
        ens = ofdm.make_wideband_ensemble(
            gen, ChannelConfig(), ofdm.OFDMConfig(n_subcarriers=S), spec["n"],
            20.0)
        specs = ofdm.WidebandCalibrator(
            equalizer.table1_specs()[2]).specs_for(ens)
        sharding.UNSHARDED.clear()
        flat = ofdm.equalize_wideband(specs, ens.w_beam, ens.y_beam)
        shard = ofdm.equalize_wideband(specs, ens.w_beam, ens.y_beam,
                                       how="shard_map")
        out[S] = {"flat": flat.numpy(), "shard_map": shard.numpy(),
                  "unsharded": dict(sharding.UNSHARDED)}
    return out


JOBS = {"ops": _ops, "dp": _dp, "model": _model, "engine": _engine,
        "equalizer": _equalizer}
