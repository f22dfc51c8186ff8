"""Quantization-aware building blocks (port of `repro.models.layers`).

Every weight matmul goes through `qdot`, which dispatches on the keys of
the weight's exported dict, as the reference does:

  none      x @ W
  fxp       x @ (int8 W * scale)           {"m", "scale"}
  vp        ops.vp_dequant_matmul(x, W_packed) * scale: one packed VP
            word per weight, consumed directly by the kernel (unpack and
            pow2 scale on chip, no float weight matrix in device memory)
                                           {"w_packed", "scale"}
  vp_block  ops.block_vp_matmul(x_q, W_q) * (s_x * scale): int8
            significands with one exponent index per `block` weights
            along the contraction; the activations are block-quantized
            on the fly with a dynamic pow2 scale s_x (`ops.block_vp_quant`,
            one kernel on the card, which also exports the weights)
                                           {"m", "i_blk", "scale"}
            A weight whose contraction dim is not a multiple of `block`
            (the embedding table: it is indexed by vocab) falls back to
            the per-element layout of vp.

Mode vp (and vp_block's fallback) stores one of two layouts, chosen at
export (`quantize_weight(..., layout=)`): "packed" words, or "planes":
significands and the E-bit indices packed 8 // E to a byte along d_in,
{"m", "i_packed", "scale"}, dequantized whole by `ops.vp_dequant` (the
planes kernel on the card) and multiplied in plain PyTorch, as the
reference multiplies its planes weight with a plain `jnp.dot`.

Training (`train=True`) keeps float master weights and, under mode vp or
vp_block, fine-tunes them into the per-element serving format (QAT):
`qat_mode="packed"` runs `ops.vp_qat_matmul` (quant and serving kernels
forward, the packed-word `vp_matmul_dx` kernel backward),
`qat_mode="fake"` the fake-quant STE in the float graph.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core.convert import vp_to_float
from repro_torch.core.formats import FXPFormat, default_vp_format
from repro_torch.core.packing import dequant_words
from repro_torch.core.quantize import pow2_scale, vp_fake_quant_ste
from repro_torch.core.vp_tensor import pack_indices, unpack_indices
from repro_torch.kernels import autotune, ops
from repro_torch.parallel import comm

LAYOUTS = ("packed", "planes")


def canonical_formats(q: QuantConfig):
    """FXP(W, W-1) and its default VP(M, E) format: VP(7,[11,9,8,6])
    on FXP(12,11) for the defaults."""
    fxp = FXPFormat(q.W, q.W - 1)
    return fxp, default_vp_format(fxp, q.M, q.E)


def quantize_weight(w: torch.Tensor, q: QuantConfig,
                    layout: str = "packed") -> Any:
    """Float weight (d_in, d_out) -> its serving form.

    none: the float tensor.  fxp: {"m" int8, "scale"}.  vp, layout
    "packed": {"w_packed", "scale"}, the words of w / scale (exported by
    the quant kernel on the card); layout "planes": {"m", "i_packed",
    "scale"}, the planes of w / scale (the planes kernel on the card),
    the indices padded along d_in to a multiple of 8 // E and packed
    there.  vp_block: {"m" int8, "i_blk" uint8 (d_in / block, d_out),
    "scale"}, w / scale block-quantized along d_in by
    `ops.block_vp_quant` (scale and division in w's dtype, as in the
    reference), or the vp dict of `layout` when d_in is not a multiple
    of the block.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"unsupported weight layout {layout!r}")
    if q.mode == "none":
        return w
    fxp, vp = canonical_formats(q)
    if q.mode == "vp_block" and w.shape[0] % q.block == 0:
        m, i_blk, s = ops.block_vp_quant(w, fxp, vp, q.block, axis=0)
        return {"m": m, "i_blk": i_blk, "scale": s}
    s = pow2_scale(w)
    wn = w / s
    if q.mode == "fxp":
        m = torch.clamp(torch.round(wn * 127.0), -128, 127).to(torch.int8)
        return {"m": m, "scale": (s / 127.0).to(torch.float32)}
    if layout == "packed":
        return {"w_packed": ops.vp_quant(wn.to(torch.float32), fxp, vp,
                                         packed=True),
                "scale": s.to(torch.float32)}
    if not vp.E:   # the reference's planes dequant breaks there too
        raise ValueError("the planes layout needs an index (E >= 1)")
    m, i = ops.vp_quant(wn.to(torch.float32), fxp, vp, packed=False)
    pad = (-w.shape[0]) % (8 // vp.E)
    if pad:
        i = torch.cat([i, i.new_zeros((pad,) + tuple(i.shape[1:]))])
    ip = pack_indices(i.movedim(0, -1), vp.E)
    return {"m": m, "i_packed": ip.movedim(-1, 0).contiguous(),
            "scale": s.to(torch.float32)}


def _planes_indices(ip: torch.Tensor, vp, rows=None) -> torch.Tensor:
    """The uint8 indices of a planes weight (d_in, ...) from its packed
    plane, whole, or only at the d_in rows `rows` (the bits of row r sit
    in packed row r // (8 // E) at (r % (8 // E)) * E)."""
    per = 8 // vp.E
    if rows is None:
        i = unpack_indices(ip.movedim(0, -1), vp.E, ip.shape[0] * per)
        return i.movedim(-1, 0)
    shift = ((rows % per) * vp.E).to(torch.int32)[..., None]
    return ((ip[rows // per].to(torch.int32) >> shift)
            & ((1 << vp.E) - 1)).to(torch.uint8)


def dequant_planes_weight(wq: dict, q: QuantConfig,
                          dtype: torch.dtype) -> torch.Tensor:
    """A planes weight dict -> the real weight (d_in, d_out) in `dtype`:
    the indices unpacked, `ops.vp_dequant` (the planes kernel on the
    card), times the scale; m * 2^-f * scale rounds as the reference's
    m.astype(dtype) * 2^-f * scale (pow2 factors)."""
    _, vp = canonical_formats(q)
    m = wq["m"]
    i = _planes_indices(wq["i_packed"], vp)[:m.shape[0]]
    return ops.vp_dequant(m, i, vp, dtype) * wq["scale"].to(dtype)


def block_activation(x: torch.Tensor, wqs, q: QuantConfig):
    """x's block-VP quantization (a_m, a_i, scale) for `qdot`'s `xq`
    where every weight of `wqs` is exported block VP (mode vp_block,
    serving), else None: the projections that share x quantize it once.
    The kernel is deterministic, so this is what each `qdot` would take
    itself (the reference's `jit` computes the shared term once too)."""
    if not all(isinstance(w, dict) and "i_blk" in w for w in wqs):
        return None
    fxp, vp = canonical_formats(q)
    return ops.block_vp_quant(x.reshape(-1, x.shape[-1]), fxp, vp, q.block,
                              axis=-1, math_dtype=torch.float32)


def qdot(x: torch.Tensor, wq: Any, q: QuantConfig,
         train: bool = False, xq=None) -> torch.Tensor:
    """x (..., d_in) @ W (d_in, d_out) under the quantization mode.

    `wq` is a float tensor (training, or mode none) or the dict that
    `quantize_weight` exports (serving), dispatched on its keys.  With
    `train` and mode vp or vp_block a float master weight is quantized
    on the fly (QAT, module docstring); its pow2 scale carries no
    gradient and commutes exactly with the contraction.  `xq`: x already
    block-VP quantized (`block_activation`), used by a block-VP weight.

    With `q.tp_axis` set (the sharded forward, `parallel.shard_ops`), an
    exported weight dict is this rank's shard of the output columns: the
    local product (planned as the unsharded launch, `autotune.
    mesh_scope`) is all-gathered along the columns, a concatenation, so
    the result equals the unsharded product bit for bit.  Float weights
    (mode none, the router) are replicated and need no collective.
    """
    if q.tp_axis is None or not isinstance(wq, dict):
        return _qdot_local(x, wq, q, train, xq)
    with autotune.mesh_scope(autotune.mesh_desc(comm.active_mesh(),
                                                q.tp_axis)):
        out = _qdot_local(x, wq, q, train, xq)
    return comm.all_gather(out, q.tp_axis, dim=-1)


def _qdot_local(x: torch.Tensor, wq: Any, q: QuantConfig, train: bool,
                xq) -> torch.Tensor:
    dtype = x.dtype
    if not isinstance(wq, dict):
        w = wq
        if train and q.mode in ("vp", "vp_block"):
            fxp, vp = canonical_formats(q)
            s = pow2_scale(w.detach())
            if q.qat_mode == "packed" and w.ndim == 2:
                lead = x.shape[:-1]
                x2 = x.reshape(-1, x.shape[-1]).to(dtype)
                out = ops.vp_qat_matmul(x2, w / s, fxp, vp)
                out = out.to(dtype) * s.to(dtype)
                return out.reshape(*lead, -1)
            w = vp_fake_quant_ste(w / s, fxp, vp) * s
        return x @ w.to(dtype)
    fxp, vp = canonical_formats(q)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if "w_packed" in wq:
        out = ops.vp_dequant_matmul(x2, wq["w_packed"], vp, out_dtype=dtype)
        out = out * wq["scale"].to(dtype)
    elif "i_packed" in wq:
        out = x2 @ dequant_planes_weight(wq, q, dtype)
    elif "i_blk" in wq:
        a_m, a_i, sa = xq if xq is not None else ops.block_vp_quant(
            x2, fxp, vp, q.block, axis=-1, math_dtype=torch.float32)
        out = ops.block_vp_matmul(a_m, a_i, wq["m"], wq["i_blk"], vp, vp,
                                  bk=q.block)
        out = (out * (sa * wq["scale"])).to(dtype)
    else:
        out = x2 @ (wq["m"].to(dtype) * wq["scale"].to(dtype))
    return out.reshape(*lead, -1)


def per_row(fn, *xs: torch.Tensor) -> torch.Tensor:
    """`fn` of each row of the leading axis alone, the rows concatenated.
    A library matmul or batched product may pick another kernel, and so
    another summation order, for another number of rows; taken one row
    at a time, a row's bits do not depend on the rows it is batched
    with (the engine's decode buckets)."""
    return torch.cat([fn(*(x[i:i + 1] for x in xs))
                      for i in range(xs[0].shape[0])])


def row_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (kept).  On the card in a fixed tree of sums
    of at most 32 terms each: PyTorch's reduction spreads one row's sum
    over more threads, in another order, when a launch holds fewer rows,
    so a plain sum over a decode row would depend on its batch; a sum of
    at most 32 terms takes one order at any row count.  Elsewhere one
    sum."""
    if not t.is_cuda:
        return t.sum(-1, keepdim=True)
    while t.shape[-1] > 32:
        n = t.shape[-1]
        c = max(c for c in range(1, 33) if n % c == 0)
        if c == 1:   # a prime past 32: one sum
            break
        t = t.reshape(*t.shape[:-1], n // c, c).sum(-1)
    return t.sum(-1, keepdim=True)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) * (1 + gamma) in f32, cast back to x's
    dtype (`ops.rms_norm`: on the card one launch of the RMSNorm kernel,
    whose row's bits do not depend on its batch)."""
    return ops.rms_norm(x, gamma, eps)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5):
    """(x - mean) * rsqrt(var + eps) * gamma + beta over the last axis in
    f32 (population variance), cast back to x's dtype: the reference's
    `layer_norm`, plain PyTorch (the encoder-decoder's norms; the
    reference leaves it to XLA)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.to(torch.float32) + beta.to(torch.float32)).to(
        x.dtype)


def sinusoid_pos(positions: torch.Tensor, d: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """Whisper-style sinusoidal positions (*positions.shape, d): angle
    pos / 10000 ** (j / max(d // 2 - 1, 1)) for j < d // 2, its sines
    then its cosines, in f32, cast to `dtype` (the reference's
    `sinusoid_pos(s, d, dtype)` is this at positions arange(s); each row
    depends on its position alone, so a gathered row equals the table's)."""
    pos = positions.to(torch.float32)[..., None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    ang = pos / (10000.0 ** (dim / max(d // 2 - 1, 1)))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4):
    """Rotary embedding: x (..., S, H, dh), positions (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_lookup(tokens: torch.Tensor, table: Any, q: QuantConfig,
                 train: bool = False):
    """Token embedding, dispatched on the table's keys.  A quantized
    table gathers the rows of its tokens first and dequantizes only those
    (f32, like the reference; every value is an elementwise function of
    its row, so this equals dequantizing the table and then gathering):
    packed words; planes, whose row r takes its indices from packed row
    r // (8 // E) (`ops.vp_dequant`, the planes kernel on the card);
    block VP, whose row r takes the indices of block r // block; int8
    FXP.  A float table is gathered as it is, in
    training too (`train` is accepted for the reference's signature; the
    embedding is not fake-quantized).  Under `q.tp_axis` a quantized
    table is this rank's shard of d_model (its last dim): the rows of the
    local columns are all-gathered along d_model."""
    if not isinstance(table, dict):
        return table[tokens]
    if q.tp_axis is not None:
        return comm.all_gather(_embed_local(tokens, table, q), q.tp_axis,
                               dim=-1)
    return _embed_local(tokens, table, q)


def _embed_local(tokens: torch.Tensor, table: dict, q: QuantConfig):
    _, vp = canonical_formats(q)
    if "w_packed" in table:
        rows = dequant_words(table["w_packed"][tokens], vp, torch.float32)
    elif "i_packed" in table:
        rows = ops.vp_dequant(table["m"][tokens],
                              _planes_indices(table["i_packed"], vp, tokens),
                              vp)
    elif "i_blk" in table:
        rows = vp_to_float(table["m"][tokens],
                           table["i_blk"][tokens // q.block], vp)
    else:
        rows = table["m"][tokens].to(torch.float32)
    return rows * table["scale"]


def weight_bytes(params: Dict[str, Any]) -> int:
    """Bytes of every tensor in a parameter tree, each counted once (the
    hybrid's shared block appears at each of its applications)."""
    seen: Dict[int, int] = {}

    def walk(node):
        if isinstance(node, torch.Tensor):
            seen[id(node)] = node.numel() * node.element_size()
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(params)
    return sum(seen.values())
