"""Plain PyTorch versions of the port's kernels (port of the matching
oracles in `repro.kernels.ref`): the serving path's packed quantize,
matmul and attention, the MIMO path's two-plane quantize, VP x VP
matmuls (with CSPADE tile muting) and fused quantize + matmul, the
training path's backward matmuls over packed words, the block-VP
matmul of the `vp_block` serving mode and its activation quantizer, and
the two dequantizers behind `ops.vp_dequant`.

`ops.py` runs these for CPU tensors, and inside `ops.force_backend("ref")`
on the card; the CPU tests hold them against the JAX package, and
`chip_smoke.py` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.convert import fxp2vp, vp_to_float
from repro_torch.core.formats import FXPFormat, VPFormat
from repro_torch.core.fxp import fxp_quantize
from repro_torch.core.packing import dequant_words, pack_vp, unpack_vp
from repro_torch.core.quantize import block_vp_quantize, pow2_scale
from repro_torch.core.vp_tensor import significand_dtype

NEG_INF = -1e30


def vp_quant_ref(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float -> (significand, uint8 index) planes through the FXP grid;
    the significand plane is `significand_dtype(vp.M)`."""
    m, i = fxp2vp(fxp_quantize(x, fxp), fxp, vp)
    return m.to(significand_dtype(vp.M)), i.to(torch.uint8)


def vp_quant_packed_ref(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat
                        ) -> torch.Tensor:
    """float -> packed VP words (`core.packing` layout, one plane)."""
    m, i = fxp2vp(fxp_quantize(x, fxp), fxp, vp)
    return pack_vp(m, i, vp)


def vp_quant_scaled_ref(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat,
                        group_dims: int = 2
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each group of the last `group_dims` dims over its pow2 scale
    s = exp2(ceil(log2(max(amax|x|, 1e-30)))) in f32, then packed VP
    words -> (words of x's shape, s of shape x.shape[:-group_dims] +
    (1,) * group_dims).  The KV cache's write (`models/attention.py:
    quantize_kv`); an all-zero group gets 2^-99."""
    s = kv_scale(x, group_dims)
    return vp_quant_packed_ref(x.to(torch.float32) / s, fxp, vp), s


def kv_scale(x: torch.Tensor, group_dims: int = 2) -> torch.Tensor:
    """The pow2 scale of each group of the last `group_dims` dims,
    exp2(ceil(log2(max(amax|x|, 1e-30)))) in f32, shaped
    x.shape[:-group_dims] + (1,) * group_dims."""
    dims = tuple(range(-group_dims, 0))
    amax = x.to(torch.float32).abs().amax(dim=dims, keepdim=True)
    return torch.exp2(torch.ceil(torch.log2(torch.clamp(amax, min=1e-30))))


def vp_dequant_ref(m: torch.Tensor, i: torch.Tensor, vp: VPFormat,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(significand, index) -> real values m * 2^-f_i."""
    return vp_to_float(m, i, vp, dtype)


def vp_dequant_packed_ref(w: torch.Tensor, vp: VPFormat,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Packed VP words -> real values (word table or unpack, exact)."""
    return dequant_words(w, vp, dtype)


def block_vp_quant_ref(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat,
                       block: int, axis: int = -1,
                       math_dtype: Optional[torch.dtype] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x / pow2_scale(x), both in `math_dtype` (default x's), then
    `block_vp_quantize` of its f32 value along `axis` -> (significands,
    uint8 indices, the scale as a 0-d f32)."""
    xm = x.to(math_dtype or x.dtype)
    s = pow2_scale(xm)
    m, i = block_vp_quantize((xm / s).to(torch.float32), fxp, vp, block,
                             axis=axis)
    return m, i, s.to(torch.float32)


def block_vp_matmul_ref(a_m: torch.Tensor, a_i: torch.Tensor,
                        b_m: torch.Tensor, b_i: torch.Tensor,
                        a_fmt: VPFormat, b_fmt: VPFormat, bk: int,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Block-VP matmul: a_m (M, K) significands with a_i (M, K/bk)
    indices per (row, k-tile), b_m (K, N) with b_i (K/bk, N) per
    (k-tile, col).  For k-tile t, in order 0 .. nk-1:

        out += f32(A_t @ B_t) * 2^-f_a[a_i[:, t]] * 2^-f_b[b_i[t, :]]

    into an f32 accumulator, cast to `out_dtype` at the end (as the
    Pallas body and the CUDA kernel do).  Each tile's integer product is
    taken in f64, exact while the int32 contract holds (and `torch.mm`
    has no integer path on the card); every scale is a power of two, so
    each term is exact and only the f32 additions round.  The terms of
    all k-tiles are taken in one batched product; only the additions
    run tile by tile.
    """
    M, K = a_m.shape
    N = b_m.shape[1]
    nk = K // bk
    lut_a = torch.tensor([2.0 ** (-f) for f in a_fmt.f],
                         dtype=torch.float32, device=a_m.device)
    lut_b = torch.tensor([2.0 ** (-f) for f in b_fmt.f],
                         dtype=torch.float32, device=a_m.device)
    at = a_m.double().reshape(M, nk, bk).transpose(0, 1)     # (nk, M, bk)
    bt = b_m.double().reshape(nk, bk, N)
    sa = lut_a[a_i.long()].t()[:, :, None]                    # (nk, M, 1)
    sb = lut_b[b_i.long()][:, None, :]                        # (nk, 1, N)
    terms = torch.bmm(at, bt).float() * sa * sb
    out = torch.zeros((M, N), dtype=torch.float32, device=a_m.device)
    for t in range(nk):
        out = out + terms[t]
    return out.to(out_dtype)


def tile_activity(x_abs_max: torch.Tensor, threshold) -> torch.Tensor:
    """CSPADE tile-activity flag: a tile is loud if its max magnitude
    reaches the threshold (paper Sec. IV-A, tile-granular adaptation)."""
    return x_abs_max >= threshold


def cspade_tile_masks_batched(a_deq, b_deq, bm: int, bk: int, bn: int,
                              thresh_a, thresh_b):
    """`cspade_tile_masks` with a leading batch axis: A (G, M, K), B (G,
    K, N) -> (a_act (G, M/bm, K/bk), b_act (G, K/bk, N/bn)) int32."""
    G, M, K = a_deq.shape
    N = b_deq.shape[2]
    a_tiles = a_deq.abs().reshape(G, M // bm, bm, K // bk, bk).amax((2, 4))
    b_tiles = b_deq.abs().reshape(G, K // bk, bk, N // bn, bn).amax((2, 4))
    return (tile_activity(a_tiles, thresh_a).to(torch.int32),
            tile_activity(b_tiles, thresh_b).to(torch.int32))


def vp_matmul_batched_ref(a_m, a_i, b_m, b_i, a_fmt: VPFormat,
                          b_fmt: VPFormat, a_act=None, b_act=None,
                          tiles: Tuple[int, int, int] = (128, 128, 128),
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """(G, M, K) x (G, K, N) -> (G, M, N): `vp_matmul_ref` per batch
    element, with the muting per (batch, tile pair)."""
    a = vp_to_float(a_m, a_i, a_fmt, out_dtype)
    b = vp_to_float(b_m, b_i, b_fmt, out_dtype)
    if a_act is None:
        return torch.bmm(a, b)
    bm, bk, bn = tiles
    G, M, K = a.shape
    N = b.shape[2]
    nm, nk, nn = M // bm, K // bk, N // bn
    keep = (a_act[:, :, :, None] | b_act[:, None, :, :]).to(out_dtype)
    a_t = a.reshape(G, nm, bm, nk, bk).permute(0, 1, 3, 2, 4)
    b_t = b.reshape(G, nk, bk, nn, bn).permute(0, 1, 3, 2, 4)
    prod = torch.einsum("gxyab,gyzbc->gxyzac", a_t, b_t)
    out = (prod * keep[:, :, :, :, None, None]).sum(2)
    return out.permute(0, 1, 3, 2, 4).reshape(G, M, N)


def vp_matmul_batched_packed_ref(a_w, b_w, a_fmt: VPFormat, b_fmt: VPFormat,
                                 a_act=None, b_act=None,
                                 tiles: Tuple[int, int, int] = (128, 128, 128),
                                 out_dtype: torch.dtype = torch.float32
                                 ) -> torch.Tensor:
    """Batched packed-word matmul: unpack, then `vp_matmul_batched_ref`."""
    return vp_matmul_batched_ref(
        *unpack_vp(a_w, a_fmt), *unpack_vp(b_w, b_fmt), a_fmt, b_fmt,
        a_act=a_act, b_act=b_act, tiles=tiles, out_dtype=out_dtype)


def vp_quant_matmul_batched_ref(a, b, a_fxp: FXPFormat, a_vp: VPFormat,
                                b_fxp: FXPFormat, b_vp: VPFormat,
                                a_act=None, b_act=None,
                                tiles: Tuple[int, int, int] = (128, 128, 128),
                                out_dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
    """Batched fused quantize + matmul: quantize, then the batched
    matmul."""
    return vp_matmul_batched_ref(
        *vp_quant_ref(a, a_fxp, a_vp), *vp_quant_ref(b, b_fxp, b_vp),
        a_vp, b_vp, a_act=a_act, b_act=b_act, tiles=tiles,
        out_dtype=out_dtype)


def vp_dequant_matmul_ref(x: torch.Tensor, w: torch.Tensor, w_fmt: VPFormat,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """x (M, K) @ dequant(packed w (K, N)) -> (M, N) in `out_dtype`.

    Computed in f32 and cast at the end, as the Pallas body and the CUDA
    kernel do (x.astype(f32), f32 accumulation).  In f32 this is the
    reference oracle's computation exactly.
    """
    deq = dequant_words(w, w_fmt, torch.float32)
    return (x.to(torch.float32) @ deq).to(out_dtype)


def vp_matmul_dx_ref(g: torch.Tensor, w: torch.Tensor, w_fmt: VPFormat,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """g (M, N) @ dequant(packed w (K, N))^T -> (M, K), the activation
    gradient of `vp_dequant_matmul_ref`.

    As the reference oracle does, the words are dequantized INTO
    `out_dtype` and the product is taken in it (the kernel, like the
    Pallas body, accumulates in f32 and casts once; in bf16 the two
    differ by bf16 rounding).  In f32 this is the product autograd takes
    for the forward's `x @ deq` (`grad.mm(deq.t())`), bit for bit.
    """
    deq = dequant_words(w, w_fmt, out_dtype)
    return g.to(out_dtype).mm(deq.t())


def vp_matmul_dw_ref(a_w: torch.Tensor, g: torch.Tensor, a_fmt: VPFormat,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """dequant(packed a_w (M, K))^T @ g (M, N) -> (K, N), the gradient of
    `deq_a @ b` with respect to b (`deq_a.t().mm(grad)`, as autograd
    takes it), dequantized into and contracted in `out_dtype`."""
    deq = dequant_words(a_w, a_fmt, out_dtype)
    return deq.t().mm(g.to(out_dtype))


def _one(x):
    """A batch of one (None stays None)."""
    return None if x is None else x[None]


def cspade_tile_masks(a_deq, b_deq, bm: int, bk: int, bn: int,
                      thresh_a, thresh_b):
    """Per-tile activity of A (M, K) and B (K, N) on the (bm, bk, bn)
    grid: (a_act (M/bm, K/bk), b_act (K/bk, N/bn)) int32 flags."""
    a_act, b_act = cspade_tile_masks_batched(
        a_deq[None], b_deq[None], bm, bk, bn, thresh_a, thresh_b)
    return a_act[0], b_act[0]


def vp_matmul_ref(a_m, a_i, b_m, b_i, a_fmt: VPFormat, b_fmt: VPFormat,
                  a_act=None, b_act=None,
                  tiles: Tuple[int, int, int] = (128, 128, 128),
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(M, K) x (K, N) VP matmul: `vp_matmul_batched_ref` on a batch of
    one, as the kernel runs it."""
    return vp_matmul_batched_ref(
        a_m[None], a_i[None], b_m[None], b_i[None], a_fmt, b_fmt,
        _one(a_act), _one(b_act), tiles, out_dtype)[0]


def vp_matmul_packed_ref(a_w, b_w, a_fmt: VPFormat, b_fmt: VPFormat,
                         a_act=None, b_act=None,
                         tiles: Tuple[int, int, int] = (128, 128, 128),
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Packed-word (M, K) x (K, N) matmul on a batch of one."""
    return vp_matmul_batched_packed_ref(
        a_w[None], b_w[None], a_fmt, b_fmt, _one(a_act), _one(b_act),
        tiles, out_dtype)[0]


def vp_quant_matmul_ref(a, b, a_fxp: FXPFormat, a_vp: VPFormat,
                        b_fxp: FXPFormat, b_vp: VPFormat,
                        a_act=None, b_act=None,
                        tiles: Tuple[int, int, int] = (128, 128, 128),
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Fused quantize + (M, K) x (K, N) matmul on a batch of one."""
    return vp_quant_matmul_batched_ref(
        a[None], b[None], a_fxp, a_vp, b_fxp, b_vp, _one(a_act),
        _one(b_act), tiles, out_dtype)[0]


def decode_attention_ref(q, k_cache, v_cache, cache_len,
                         window: Optional[int] = None, rolling: bool = False):
    """Masked single-token attention over a float cache.

    q (B, 1, H, dh), caches (B, Smax, KV, dh), cache_len (B,) ->
    (B, 1, H, dh).  Positions outside the valid span get NEG_INF before
    the softmax; the reference slices a window first, which drops only
    exact zeros.  `chip_smoke._f64_attention` mirrors this in float64:
    keep the two in step.
    """
    B, _, H, dh = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qr = q.reshape(B, KV, G, dh).to(torch.float32) * dh ** -0.5
    kr = k_cache.transpose(1, 2).to(torch.float32)
    vr = v_cache.transpose(1, 2).to(torch.float32)
    s = torch.einsum("bkgd,bksd->bkgs", qr, kr)
    pos = torch.arange(Smax, device=q.device)[None, :]
    length = cache_len.to(torch.int64)[:, None]
    if rolling:
        valid = pos < torch.clamp(length, max=Smax)
    else:
        valid = pos < length
        if window:
            valid &= pos >= length - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, vr)
    return out.reshape(B, 1, H, dh).to(q.dtype)


def vp_decode_attention_ref(q, k_w, v_w, k_s, v_s, lengths, fmt: VPFormat,
                            window: Optional[int] = None,
                            rolling: bool = False):
    """Decode attention over a packed VP cache.

    k_w / v_w (B, Smax, KV, dh) packed words, k_s / v_s per-position pow2
    scales ((B, Smax) or (B, Smax, 1, 1)).  Dequantize in f32, scale,
    cast to q's dtype, then the float-cache decode attention.
    """
    B, Smax = k_w.shape[:2]
    k_s = k_s.reshape(B, Smax, 1, 1)
    v_s = v_s.reshape(B, Smax, 1, 1)
    kr = (dequant_words(k_w, fmt, torch.float32) * k_s).to(q.dtype)
    vr = (dequant_words(v_w, fmt, torch.float32) * v_s).to(q.dtype)
    return decode_attention_ref(q, kr, vr, lengths, window, rolling)


def flash_prefill_ref(q, k, v, pattern: str = "causal",
                      window: Optional[int] = None):
    """Unfused prefill attention: full (Sq, Sk) scores + mask.

    q (B, Sq, H, dh), k/v (B, Sk, KV, dh) -> (B, Sq, H, dh).  The
    unnormalized probabilities are cast to v's dtype before the PV
    product, as the TPU kernel and the reference model's prefill scan
    do (a no-op in f32); the denominator stays in f32.
    `chip_smoke._f64_attention` mirrors this in float64: keep the two in
    step.
    """
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qr = q.reshape(B, Sq, KV, G, dh).to(torch.float32) * dh ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.to(torch.float32))
    if pattern in ("causal", "local"):
        q_pos = torch.arange(Sq, device=q.device)[:, None]
        k_pos = torch.arange(Sk, device=q.device)[None, :]
        mask = k_pos <= q_pos
        if pattern == "local" and window:
            mask &= q_pos - k_pos < window
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)                                    # (B, KV, G, Sq)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).to(torch.float32),
                      v.to(torch.float32))
    out = (pv / l[..., None]).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, dh).to(q.dtype)


def rms_norm_ref(x: torch.Tensor, gamma: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """x * (1 / sqrt(mean(x^2) + eps)) * (1 + gamma) in f32, cast back to
    x's dtype (the reference's `models/layers.py:rms_norm`), over x's
    last axis; gamma (D,) or x's trailing shape.  The sum of squares in
    the kernel's order (csrc/rms_norm.cu): 32 partial sums, partial l
    adding columns l, l + 32, ... in turn, then halved five times."""
    xf = x.to(torch.float32)
    D = xf.shape[-1]
    sq = xf * xf
    sq = torch.nn.functional.pad(sq, (0, -D % 32))
    sq = sq.reshape(*sq.shape[:-1], -1, 32)
    acc = sq[..., 0, :]
    for k in range(1, sq.shape[-2]):
        acc = acc + sq[..., k, :]
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    # tensor / tensor: a scalar divisor would be taken as its reciprocal
    mean = acc / torch.full_like(acc, float(D))
    r = torch.sqrt(mean + eps).reciprocal()
    out = (xf * r) * (1.0 + gamma.to(torch.float32))
    return out.to(x.dtype)
