"""Collectives keyed by mesh axis name (the port's counterpart of JAX's
named collectives inside `shard_map`).

Every rank runs the same program on its own shard; an axis name resolves
to its process group through the active mesh (`use_mesh`, a
`torch.distributed.device_mesh.DeviceMesh` with named dims):

  all_gather   `jax.lax.all_gather(..., tiled=True)`: the ranks' pieces
               concatenated along `dim`, in rank order
  all_reduce   `jax.lax.psum`
  ppermute     `jax.lax.ppermute` with perm [(i, (i - 1) % n)]: each rank
               sends to its left neighbour and receives from its right
               (one paired `isend` / `irecv`)
  axis_index   `jax.lax.axis_index`: the rank within the axis's group
  axis_size    `jax.lax.psum(1, axis)`

A collective runs even on an axis of size 1, so a world of one rank runs
(and a CUDA graph captures) the same calls as a larger one.  Over NCCL the
tensors stay on the card.  A gloo group cannot take a CUDA tensor: there
each tensor is copied to the host, reduced or gathered there, and copied
back, a transport for several ranks on one
card, never chosen silently (the group's backend decides) and never
capturable into a CUDA graph (`capturable`).

`LAUNCHES[name]` counts each collective a rank issues, as
`kernels.build.LAUNCHES` counts kernels; `BYTES[name]` the bytes that
reach this rank from the others (all_gather: the n - 1 foreign pieces;
all_reduce: 2 (n - 1) / n of the tensor, a ring's share; ppermute: the
tensor), and `F32_BYTES[name]` the same count had every element been an
f32 (packed words against the float plane they stand for).
"""
from __future__ import annotations

import collections
import contextlib
import threading
import warnings
from typing import Dict, Iterator

import torch
import torch.distributed as dist

LAUNCHES: Dict[str, int] = collections.Counter()
BYTES: Dict[str, int] = collections.Counter()
F32_BYTES: Dict[str, int] = collections.Counter()

_local = threading.local()
# torch 2.13 names it all_gather_single; older ones have only this name
warnings.filterwarnings("ignore", message=".*all_gather_into_tensor",
                        category=FutureWarning)


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[None]:
    """Resolve axis names through `mesh` inside the block."""
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield
    finally:
        _local.mesh = prev


def active_mesh():
    mesh = getattr(_local, "mesh", None)
    if mesh is None:
        raise RuntimeError("no active mesh: run sharded code inside "
                           "`comm.use_mesh(mesh)`")
    return mesh


def reset() -> None:
    """Zero every counter."""
    for c in (LAUNCHES, BYTES, F32_BYTES):
        c.clear()


def snapshot() -> Dict[str, Dict[str, int]]:
    return {"launches": dict(LAUNCHES), "bytes": dict(BYTES),
            "f32_bytes": dict(F32_BYTES)}


def group(axis: str):
    return active_mesh().get_group(axis)


def axis_size(axis: str) -> int:
    mesh = active_mesh()
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(axis: str) -> int:
    return active_mesh().get_local_rank(axis)


def _staged(g, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(g) == "gloo"


def capturable(mesh) -> bool:
    """Whether a CUDA graph can capture this mesh's collectives: NCCL
    groups on every dim (a gloo group runs on the host)."""
    return all(dist.get_backend(mesh.get_group(n)) == "nccl"
               for n in mesh.mesh_dim_names)


def _count(name: str, t: torch.Tensor, share: float) -> None:
    LAUNCHES[name] += 1
    BYTES[name] += int(t.numel() * t.element_size() * share)
    F32_BYTES[name] += int(t.numel() * 4 * share)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """t's bits as a flat uint8 tensor: gather and permute move bits, and
    neither gloo nor NCCL takes every dtype (int16 words: neither)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def all_gather(x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim`, in rank order."""
    g = group(axis)
    n = dist.get_world_size(g)
    dim = dim % x.ndim
    staged = _staged(g, x)
    src = _bytes(x.cpu() if staged else x)
    buf = src.new_empty((n * src.numel(),))
    dist.all_gather_into_tensor(buf, src, group=g)
    _count("all_gather", x, n - 1)
    parts = buf.view(x.dtype).reshape((n,) + tuple(x.shape))
    out = parts[0] if n == 1 else torch.cat(parts.unbind(0), dim=dim)
    return out.to(x.device) if staged else out


def all_reduce(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of the ranks' `x` (a new tensor)."""
    g = group(axis)
    n = dist.get_world_size(g)
    staged = _staged(g, x)
    out = x.cpu().clone() if staged else x.clone()
    dist.all_reduce(out, group=g)
    _count("all_reduce", x, 2 * (n - 1) / n)
    return out.to(x.device) if staged else out


def ppermute(x: torch.Tensor, axis: str) -> torch.Tensor:
    """What the right neighbour ((i + 1) % n) holds: every rank sends its
    `x` to (i - 1) % n, the reference's perm [(i, (i - 1) % n)]."""
    g = group(axis)
    n = dist.get_world_size(g)
    i = dist.get_group_rank(g, dist.get_rank())
    staged = _staged(g, x)
    src = _bytes(x.cpu() if staged else x)
    if n == 1:
        out = src.clone()
    else:
        out = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src,
                          dist.get_global_rank(g, (i - 1) % n), g),
               dist.P2POp(dist.irecv, out,
                          dist.get_global_rank(g, (i + 1) % n), g)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    _count("ppermute", x, 1)
    out = out.view(x.dtype).reshape(x.shape)
    return out.to(x.device) if staged else out


def slab(x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous 1/n of `x` along `dim` (a view); `dim`'s
    size must divide by the axis size."""
    n = axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"by the '{axis}' axis size {n}")
    loc = x.shape[dim] // n
    return x.narrow(dim, axis_index(axis) * loc, loc)


def agree_max(value: float) -> float:
    """The largest of the ranks' `value`s, over the whole world (one
    all-reduce; on the card under NCCL, a synchronizing one)."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([value], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    LAUNCHES["agree"] += 1
    return float(t[0])
