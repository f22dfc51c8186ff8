"""Mesh factory over the initialised `torch.distributed` world (port of
`repro.launch.mesh`).

Single pod: 16 x 16 = 256 ranks, dims ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 ranks, dims ("pod", "data", "model"); the
leading "pod" dim is pure data parallelism.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named dims
over ranks 0 .. n - 1 of the world, which must be initialised first
(`init_world`, or the caller's own `init_process_group`); every rank
calls the factory with the same sizes.  Its device type is "cuda" when
the world runs NCCL and "cpu" otherwise (gloo, whose CUDA tensors
`parallel.comm` stages through the host).  Functions, not constants, so
importing this module touches no process group.
"""
from __future__ import annotations

import datetime
import math
from typing import Optional

import torch
import torch.distributed as dist


def init_world(rank: int, world_size: int, *, store=None,
               init_method: Optional[str] = None, device: str = "cuda",
               backend: Optional[str] = None,
               timeout: Optional[datetime.timedelta] = None) -> torch.device:
    """Initialise the default process group -> this rank's device.

    NCCL on CUDA (the rank's card: rank modulo the visible cards), gloo
    on the CPU, unless `backend` says otherwise (gloo on CUDA stages its
    collectives through the host).  `store` (a `dist.Store`) or
    `init_method` ("tcp://localhost:<port>", "file://...") names the
    rendezvous: nothing here reads the environment.  `timeout` bounds
    every collective's wait (a rank that never arrives raises)."""
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_world: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    kw = {"store": store} if store is not None else {
        "init_method": init_method}
    if backend == "nccl":
        kw["device_id"] = dev
    if timeout is not None:
        kw["timeout"] = timeout
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)
    return dev


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _build(shape, axes):
    if not dist.is_initialized():
        raise RuntimeError("initialise torch.distributed first "
                           "(launch.mesh.init_world)")
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=tuple(axes))


def _mk(shape, axes):
    n_have = _world()
    n_need = math.prod(shape)
    if n_need != n_have:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {n_need} devices but "
            f"the platform exposes {n_have}; pick axis sizes whose "
            f"product is {n_have} (elastic_mesh / best_effort_mesh) or "
            f"launch with more ranks")
    return _build(shape, axes)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes)


def elastic_mesh(pods: int, data: int, model: int):
    """Mesh for an elastic restart on a reduced healthy set."""
    if min(pods, data, model) < 1:
        raise ValueError(
            f"mesh axis sizes must be >= 1, got pods={pods} data={data} "
            f"model={model}")
    if pods > 1:
        return _mk((pods, data, model), ("pod", "data", "model"))
    return _mk((data, model), ("data", "model"))


def best_effort_mesh(n_devices=None, *, prefer: str = "model"):
    """("data", "model") mesh over the first `n_devices` ranks, all of
    them on the preferred dim."""
    if prefer not in ("data", "model"):
        raise ValueError(f"prefer must be 'data' or 'model': {prefer!r}")
    n_have = _world()
    n = n_have if n_devices is None else int(n_devices)
    if not 1 <= n <= n_have:
        raise ValueError(
            f"best_effort_mesh(n_devices={n_devices}): platform exposes "
            f"{n_have} devices")
    return _build((1, n) if prefer == "model" else (n, 1), ("data", "model"))


def smoke_mesh():
    """1-rank mesh with production dim names."""
    return _mk((1, 1), ("data", "model"))


def mesh_shape(mesh) -> dict:
    """{dim name: size}, the reference's `dict(mesh.shape)`."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
