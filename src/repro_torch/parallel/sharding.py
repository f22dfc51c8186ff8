"""Mesh dims and the wideband equalizer's subcarrier mesh (port of the
subcarrier part of `repro.parallel.sharding`).

The wideband equalizer is embarrassingly parallel across subcarriers
(independent per-subcarrier MVM batches), so its fleet layout is pure
data parallelism over the band: each rank owns a contiguous slab of
subcarriers, runs the batched VP kernel on it, and the slabs are
all-gathered.  The reference's GSPMD placement rules for whole models
(`param_shardings`, `batch_shardings`, `cache_shardings`), which only its
compile-only dry run reads, are not ported.
"""
from __future__ import annotations

import collections
import functools
from typing import Dict, Optional

import torch
import torch.distributed as dist

from . import comm

# Calls that ran unsharded because the subcarriers do not divide the
# mesh (or the mesh is one rank), as the reference degrades.
UNSHARDED: Dict[str, int] = collections.Counter()


def batch_axes(mesh):
    names = tuple(mesh.mesh_dim_names or ())
    return ("pod", "data") if "pod" in names else ("data",)


def subcarrier_mesh(n_devices: Optional[int] = None):
    """1-D mesh with a single "sc" (subcarrier) dim over the first
    `n_devices` ranks of the initialised world (all of them by
    default)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("initialise torch.distributed first "
                           "(launch.mesh.init_world)")
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(dev, torch.arange(n), mesh_dim_names=("sc",))


def shard_over_subcarriers(fn, mesh=None,
                           n_subcarriers: Optional[int] = None):
    """`fn` run on this rank's slab of the leading (subcarrier) dim of
    each argument, its output slabs all-gathered along that dim.

    `fn` maps (S_local, ...) tensors to an (S_local, ...) tensor (the
    flat wideband path in `mimo/ofdm.py`).  When the subcarrier count
    does not divide the mesh, or the mesh is one rank, `fn` runs
    unsharded on the whole band, as in the reference; such calls are
    counted in `UNSHARDED`."""
    if mesh is None:
        mesh = subcarrier_mesh()
    n_dev = mesh.size(0)
    if n_dev == 1 or (n_subcarriers is not None and n_subcarriers % n_dev):
        @functools.wraps(fn)
        def unsharded(*args):
            UNSHARDED["shard_over_subcarriers"] += 1
            return fn(*args)

        return unsharded

    @functools.wraps(fn)
    def sharded(*args):
        with comm.use_mesh(mesh):
            out = fn(*(comm.slab(a, "sc") for a in args))
            return comm.all_gather(out, "sc", dim=0)

    return sharded


def tp_size(mesh) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.size(names.index("model"))
