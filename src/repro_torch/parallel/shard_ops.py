"""Sharded execution of the packed VP datapath on `torch.distributed`
(port of `repro.parallel.shard_ops`).

Every rank runs the same program on its own shard (the reference's
`shard_map`), inside `comm.use_mesh(mesh)`, and the collectives are
`parallel.comm`'s, keyed by mesh dim name.  Three weight-sharded modes
of the serving matmul, each equal to the unsharded launch bit for bit:
every collective is a concatenation, and each shard's launch sums every
output in the unsharded launch's order (`kernels.autotune.mesh_scope`:
the planners take the unsharded shape's split):

  column  dequant-matmul on the local weight columns, then all-gather
          the output columns.  The serving default: a decode step's
          activations (M x N/tp) are far smaller than the weight shard.
  gather  all-gather the PACKED weight words, then one full launch: int
          words cross the wire (2-4x fewer bytes than f32 weights), but
          every rank holds the whole weight.
  ring    per step, dequant-matmul the resident packed chunk into its
          owner's columns while the chunk moves one rank round the ring
          (`comm.ppermute` of the words, never floats).

The backward runs under the same mesh: `sharded_matmul_dx` reduces
dL/dx over the tensor dim (one all-reduce, or a ring reduce-scatter of
row chunks), `sharded_matmul_dw` is local, and `dp_compress_reduce`
runs the error-feedback gradient codec before the data-dim mean.

`shard_param_specs` places a whole param tree of the port's layout (the
per-layer list of `models.model`): every quantized weight shards its
OUTPUT (last) dim over the tensor dim, MoE expert stacks their expert
dim (expert parallelism), everything else is replicated.  `qdot`,
`embed_lookup` and `moe_block` all-gather their local outputs when
`QuantConfig.tp_axis` is set, so the whole model runs sharded with no
other change (`sharded_forward_fns`, `place_params`).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.kernels import autotune
from repro_torch.kernels import ops
from . import comm

MODES = ("column", "gather", "ring")
REPLICATED = "replicated"

# Quantized-leaf members whose last dim is the OUTPUT dim (every layout
# `quantize_weight` exports keeps d_out last).
_WEIGHT_MEMBERS = ("w_packed", "m", "w", "i_packed", "i_blk")

# (kernel, shard's operand shape) -> launches, for every kernel launch
# the op-level functions make on a shard.
SHARD_LAUNCHES: Dict[Tuple[str, tuple], int] = collections.Counter()


class ShardSpecError(ValueError):
    """A param tree cannot be placed on the requested tensor dim."""


def _scope(axis: str, spec: str):
    return autotune.mesh_scope(autotune.mesh_desc(comm.active_mesh(), axis,
                                                  spec))


def _launched(kernel: str, *shape) -> None:
    SHARD_LAUNCHES[(kernel, tuple(int(d) for d in shape))] += 1


# ---------------------------------------------------------------------------
# Op level (every rank calls these inside `comm.use_mesh`)
# ---------------------------------------------------------------------------

def sharded_dequant_matmul(x, w_packed, fmt, *, axis: str = "model",
                           mode: str = "ring", out_dtype=None):
    """x (M, K) replicated, w_packed (K, N/tp) this rank's columns ->
    (M, N) replicated, bit-identical to the unsharded launch."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}: {mode!r}")
    tp = comm.axis_size(axis)
    M, K = x.shape
    n_loc = w_packed.shape[1]
    if mode == "column":
        with _scope(axis, "N"):
            y = ops.vp_dequant_matmul(x, w_packed, fmt, out_dtype=out_dtype)
        _launched("vp_dequant_matmul", M, K, n_loc)
        return comm.all_gather(y, axis, dim=1)
    if mode == "gather":
        # the launch runs on the reassembled weight: the unsharded one
        w_full = comm.all_gather(w_packed, axis, dim=1)
        _launched("vp_dequant_matmul", M, K, n_loc * tp)
        return ops.vp_dequant_matmul(x, w_full, fmt, out_dtype=out_dtype)
    idx = comm.axis_index(axis)
    dtype = out_dtype if out_dtype is not None else x.dtype
    y = torch.empty((M, n_loc * tp), dtype=dtype, device=x.device)
    chunk = w_packed
    with _scope(axis, "N"):
        for step in range(tp):
            owner = (idx + step) % tp
            y[:, owner * n_loc:(owner + 1) * n_loc] = ops.vp_dequant_matmul(
                x, chunk, fmt, out_dtype=out_dtype)
            _launched("vp_dequant_matmul", M, K, n_loc)
            if step < tp - 1:
                chunk = comm.ppermute(chunk, axis)
    return y


def sharded_matmul_dx(g, w_packed, fmt, *, axis: str = "model",
                      mode: str = "psum", out_dtype=torch.float32,
                      gather: bool = True):
    """dL/dx (M, K) from the replicated output cotangent g (M, N) and
    this rank's packed columns w_packed (K, N/tp): each rank's partial
    g[:, own cols] @ dequant(w_loc)^T (`ops.vp_matmul_dx`), then

      psum  one all-reduce of the M x K partials;
      ring  a reduce-scatter over row chunks of M / tp (the buffer moves
            one rank round the ring per step); `gather=True`
            all-gathers the reduced chunks, False leaves dx row-sharded.

    The two add the tp partials in different orders: they agree to f32
    rounding, not bit for bit."""
    if mode not in ("psum", "ring"):
        raise ValueError(f"mode must be 'psum' or 'ring': {mode!r}")
    tp = comm.axis_size(axis)
    idx = comm.axis_index(axis)
    n_loc = w_packed.shape[1]
    K = w_packed.shape[0]
    g_loc = g[:, idx * n_loc:(idx + 1) * n_loc]
    if mode == "psum":
        with _scope(axis, "N"):
            dx = ops.vp_matmul_dx(g_loc, w_packed, fmt, out_dtype=out_dtype)
        _launched("vp_matmul_dx", g.shape[0], K, n_loc)
        return comm.all_reduce(dx, axis)
    m = g.shape[0]
    if m % tp:
        raise ShardSpecError(
            f"ring dx reduce-scatter chunks the batch dim: M={m} is not "
            f"divisible by tensor-parallel size {tp}")
    m_loc = m // tp

    def chunk_term(c):
        _launched("vp_matmul_dx", m_loc, K, n_loc)
        return ops.vp_matmul_dx(g_loc[c * m_loc:(c + 1) * m_loc], w_packed,
                                fmt, out_dtype=out_dtype)

    # after step s, rank i's buffer holds the sum over ranks i .. i + s
    # of their partials of chunk (i + 1 + s) % tp: after tp - 1 steps,
    # chunk i, fully reduced
    with _scope(axis, "N"):
        buf = chunk_term((idx + 1) % tp)
        for s in range(1, tp):
            buf = comm.ppermute(buf, axis) + chunk_term((idx + 1 + s) % tp)
    if gather:
        return comm.all_gather(buf, axis, dim=0)
    return buf


def sharded_matmul_dw(a_w, g, fmt, *, axis: str = "model",
                      out_dtype=torch.float32):
    """dL/dW of this rank's weight columns: dequant(a_w)^T @ g[:, own
    cols] -> (K, N/tp), with no collective (each shard is touched only by
    its own output columns), bit-identical to those columns of the
    unsharded product."""
    tp = comm.axis_size(axis)
    idx = comm.axis_index(axis)
    n_loc = g.shape[1] // tp
    g_loc = g[:, idx * n_loc:(idx + 1) * n_loc]
    _launched("vp_matmul_dw", a_w.shape[0], a_w.shape[1], n_loc)
    with _scope(axis, "N"):
        return ops.vp_matmul_dw(a_w, g_loc, fmt, out_dtype=out_dtype)


def dp_compress_reduce(grads, state, *, axis: str = "data", config=None):
    """Error-feedback compressed data-parallel gradient mean: each rank
    codes its LOCAL gradient tree (int8 or packed VP words,
    `CompressionConfig.codec`) carrying its residual in `state`, then the
    decoded trees are averaged over `axis` -> (mean grads, new state);
    the residuals stay with their rank."""
    from repro_torch.tree import tree_map
    from repro_torch.train.compression import (CompressionConfig,
                                               compress_decompress)

    if config is None:
        config = CompressionConfig()
    dp = comm.axis_size(axis)
    deq, new_state = compress_decompress(grads, state, config)
    return tree_map(lambda g: comm.all_reduce(g, axis) / dp, deq), new_state


def sharded_decode_attention(q, k_w, v_w, k_s, v_s, lengths, fmt, *,
                             axis: str = "model", mode: str = "seq",
                             window: Optional[int] = None,
                             rolling: bool = False):
    """Packed-KV decode attention, bit-identical to the unsharded op.

    mode "seq":   caches cut along the sequence (dim 1): the PACKED words
                  and their scales are all-gathered and the unchanged op
                  runs on the whole cache.
    mode "heads": q cut along H and the caches along KV (dim 2): GQA
                  groups are independent, so each rank attends locally
                  (planned as the unsharded launch) and the outputs
                  concatenate along the heads; no cache collective."""
    if mode == "seq":
        k_w, v_w, k_s, v_s = (comm.all_gather(t, axis, dim=1)
                              for t in (k_w, v_w, k_s, v_s))
        _launched("vp_decode_attention", *k_w.shape)
        return ops.vp_decode_attention(q, k_w, v_w, k_s, v_s, lengths, fmt,
                                       window=window, rolling=rolling)
    if mode == "heads":
        with _scope(axis, "H"):
            out = ops.vp_decode_attention(q, k_w, v_w, k_s, v_s, lengths,
                                          fmt, window=window, rolling=rolling)
        _launched("vp_decode_attention", *k_w.shape)
        return comm.all_gather(out, axis, dim=2)
    raise ValueError(f"mode must be 'seq' or 'heads': {mode!r}")


def sharded_flash_prefill(q, k, v, *, axis: str = "model",
                          pattern: str = "causal",
                          window: Optional[int] = None):
    """Flash prefill with q cut along H and k / v along KV (dim 2): head
    groups never interact, so each rank's pass equals its heads of the
    unsharded pass bit for bit; outputs concatenate along the heads."""
    from repro_torch.models.attention import flash_attention

    with _scope(axis, "H"):
        out = flash_attention(q, k, v, pattern=pattern, window=window)
    _launched("flash_prefill", *q.shape)
    return comm.all_gather(out, axis, dim=2)


# ---------------------------------------------------------------------------
# Param-tree placement
# ---------------------------------------------------------------------------

def _is_quant_leaf(node) -> bool:
    return isinstance(node, dict) and any(
        k in node for k in _WEIGHT_MEMBERS) and not any(
        isinstance(v, (dict, list)) for v in node.values())


def _leaf_specs(node: dict, path: str, axis: str, tp: int,
                expert: bool) -> dict:
    """Specs of one exported weight dict: each storage member shards its
    last dim (d_out), or, for an MoE expert stack ((E, d_in, d_out),
    recognised by the sibling `w_router`), its expert dim (ndim - 3),
    where the per-expert scales follow it; the rest is replicated."""
    out = {}
    for k, v in node.items():
        if k in _WEIGHT_MEMBERS:
            dim = v.ndim - 3 if expert else v.ndim - 1
            if v.shape[dim] % tp:
                raise ShardSpecError(
                    f"{path}.{k}: dim {dim} of shape {tuple(v.shape)} is "
                    f"not divisible by tensor-parallel size {tp}; pick a "
                    f"mesh whose '{axis}' axis divides every quantized "
                    f"{'expert count' if expert else 'output dim'}")
            out[k] = dim
        elif k == "scale" and expert:
            out[k] = v.ndim - 1
        else:
            out[k] = REPLICATED
    return out


def shard_param_specs(params, cfg: ModelConfig, *, axis: str = "model",
                      tp: int):
    """A tree mirroring `params` whose leaves are the dim each tensor is
    sharded along over `axis`, or REPLICATED.

    Exported weight dicts shard per `_leaf_specs`; every float tensor
    (norms, biases, the router, an unquantized model) is replicated, so
    routing and norms run alike on every rank.  Raises ShardSpecError
    naming the leaf when a dim does not divide by `tp`."""
    if tp < 1:
        raise ShardSpecError(f"tensor-parallel size must be >= 1: {tp}")

    def walk(node, path, expert_ctx=False):
        if _is_quant_leaf(node):
            return _leaf_specs(node, path, axis, tp, expert_ctx) if tp > 1 \
                else {k: REPLICATED for k in node}
        if isinstance(node, dict):
            has_router = "w_router" in node
            return {k: walk(v, f"{path}.{k}" if path else k,
                            has_router and k in ("w_gate", "w_up", "w_down"))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{path}[{i}]") for i, v in enumerate(node)]
        return REPLICATED

    return walk(params, "")


def tp_quant(q: QuantConfig, axis: str = "model") -> QuantConfig:
    """The QuantConfig the sharded forward runs under."""
    return dataclasses.replace(q, tp_axis=axis)


def tp_size(mesh, axis: str = "model") -> int:
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.size(names.index(axis)) if axis in names else 1


def batch_dim_specs(tree, axis: str, dim: int):
    """Per-leaf specs sharding `dim` over `axis` where a tensor has it
    (cache trees); `axis` names the mesh dim the caller shards over."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return dim if node.ndim > dim else REPLICATED

    return walk(tree)


def place_params(params, cfg: ModelConfig, mesh, *, axis: str = "model"):
    """This rank's shard of `params` (the whole tree, on every rank):
    each sharded tensor's slice along its spec's dim (contiguous), the
    rest as they are.  A dict met twice (the hybrid's shared block) is
    placed once and shared, as in `params`."""
    tp = tp_size(mesh, axis)
    specs = shard_param_specs(params, cfg, axis=axis, tp=tp)
    idx = mesh.get_local_rank(axis) if tp > 1 else 0
    done: Dict[int, dict] = {}

    def walk(node, spec):
        if isinstance(node, dict):
            if id(node) not in done:
                done[id(node)] = {k: walk(v, spec[k])
                                  for k, v in node.items()}
            return done[id(node)]
        if isinstance(node, (list, tuple)):
            return [walk(v, s) for v, s in zip(node, spec)]
        if spec == REPLICATED:
            return node
        n = node.shape[spec] // tp
        return node.narrow(spec, idx * n, n).contiguous()

    return walk(params, specs)


# ---------------------------------------------------------------------------
# Whole-model wrappers
# ---------------------------------------------------------------------------

def _rows(caches, axis: str):
    """This rank's slab of every cache tensor along the batch (dim 0)."""
    from repro_torch.models.model import Caches

    local = [{k: comm.slab(v, axis) for k, v in c.items()} for c in caches]
    return Caches(local, caches.hi) if isinstance(caches, Caches) else local


def _gathered(caches, axis: str):
    from repro_torch.models.model import Caches

    full = [{k: comm.all_gather(v, axis, dim=0) for k, v in c.items()}
            for c in caches]
    return Caches(full, caches.hi) if isinstance(caches, Caches) else full


def sharded_forward_fns(params, cfg: ModelConfig, mesh, *,
                        axis: str = "model", data_axis: Optional[str] = None):
    """(prefill_fn, decode_fn): the model's `prefill` / `decode_step`
    under `mesh`, taking this rank's parameter shards (`place_params`)
    and the same other arguments (minus cfg).

    Activations, caches and logits are whole on every rank.  With
    `data_axis`, `decode_fn(..., batch_sharded=True)` takes the whole
    batch, decodes this rank's slab of its rows (the batch must divide by
    the data dim's size) and all-gathers the logits and the caches' rows
    over `data_axis`.  `params`, when not None, is the whole tree,
    checked against the mesh here (ShardSpecError)."""
    from repro_torch.models import model as M

    if params is not None:
        shard_param_specs(params, cfg, axis=axis, tp=tp_size(mesh, axis))
    cfg_sh = dataclasses.replace(cfg, quant=tp_quant(cfg.quant, axis))

    def prefill_fn(p, tokens, caches, patches=None, chunked=False,
                   cross_kv=None):
        with comm.use_mesh(mesh):
            return M.prefill(p, tokens, caches, cfg_sh, chunked=chunked,
                             patches=patches, cross_kv=cross_kv)

    def decode_fn(p, token, caches, cross_kv=None, batch_sharded=False):
        with comm.use_mesh(mesh):
            if not (batch_sharded and data_axis is not None):
                return M.decode_step(p, token, caches, cfg_sh,
                                     cross_kv=cross_kv)
            if cross_kv is not None:
                cross_kv = [tuple(comm.slab(t, data_axis) for t in kv)
                            for kv in cross_kv]
            logits, out = M.decode_step(
                p, comm.slab(token, data_axis), _rows(caches, data_axis),
                cfg_sh, cross_kv=cross_kv)
            return (comm.all_gather(logits, data_axis, dim=0),
                    _gathered(out, data_axis))

    return prefill_fn, decode_fn
