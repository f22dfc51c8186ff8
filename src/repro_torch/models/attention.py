"""Attention block with a VP (packed or planes) or float KV cache, and
cross-attention over a precomputed source (port of the serving and
training branches of `repro.models.attention`).

Prefill runs `ops.flash_prefill` (the flash kernel on the card) and writes
the prompt's K/V into the cache; decode appends one position and runs
`ops.vp_decode_attention` on the packed words.  The two-plane KV layout
("planes") and a float cache are dequantized whole and attended in
plain PyTorch, as in the reference; so is a chunk of a chunked prefill,
against the dequantized history.  Training runs
`flash_attention_walk`, the reference's own training path (module
docstring of `repro.models.attention`): the reference defines no
gradient for its flash kernel, so its training graph walks the chunk
pairs in plain array code, and so does the port's, under autograd.  The cache tensors are
updated IN PLACE (the reference is functional and returns new arrays):
a decode step writes one position per sequence instead of copying the
whole cache.  The returned dict holds the same tensors and the new
lengths.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core.formats import FXPFormat, default_vp_format
from repro_torch.core.vp_tensor import pack_indices, unpack_indices
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ref import NEG_INF
from repro_torch.kernels.autotune import _pow2_at_least
from .layers import block_activation, qdot, rms_norm, rope


def flash_attention(q, k, v, pattern: str = "causal",
                    window: Optional[int] = None):
    """Serving attention: q (B, Sq, H, dh), k/v (B, Sk, KV, dh) ->
    (B, Sq, H, dh) through `ops.flash_prefill` (the flash kernel on the
    card).  Training takes `flash_attention_walk` instead."""
    return ops.flash_prefill(q, k, v, pattern=pattern, window=window)


def _chunk_and_pad(s: int, target: int = 512):
    """Chunk size (the largest power of two <= target needed to cover s)
    and the length s pads up to."""
    c = min(target, _pow2_at_least(max(s, 1)))
    return c, s + (-s) % c


def _chunk_pairs(n_q: int, n_k: int, pattern: str, window_chunks: int):
    """The (qi, ki) chunk pairs that can contribute under the mask."""
    pairs = []
    for qi in range(n_q):
        for ki in range(n_k):
            if pattern == "causal" and ki > qi:
                continue
            if pattern == "local" and (ki > qi or qi - ki > window_chunks):
                continue
            pairs.append((qi, ki))
    return pairs


def _pad_seq(x: torch.Tensor, length: int) -> torch.Tensor:
    if x.shape[1] == length:
        return x
    pad = x.new_zeros((x.shape[0], length - x.shape[1], *x.shape[2:]))
    return torch.cat([x, pad], dim=1)


def flash_attention_walk(q, k, v, pattern: str = "causal",
                         window: Optional[int] = None, chunk: int = 512):
    """Training attention (port of the reference's `flash_attention` off
    the TPU): q (B, Sq, H, dh), k/v (B, Sk, KV, dh) -> (B, Sq, H, dh).

    Walks the contributing (q-chunk, k-chunk) pairs in the reference's
    order with a running (max, denominator, accumulator) per q chunk, in
    plain differentiable PyTorch.  Scores and the PV product accumulate
    in f32 (operands cast up, products exact); p is cast to v's dtype
    before the PV product, as in the reference.  GQA maps query head h
    to kv head h // G.  pattern: causal | local (banded, `window`) | full.
    """
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    c, sqp = _chunk_and_pad(Sq, chunk)
    ck, skp = _chunk_and_pad(Sk, chunk)
    if pattern in ("causal", "local"):
        if Sq != Sk:
            raise ValueError(
                f"causal/local attention requires Sq == Sk, got {Sq} != {Sk}")
        ck, skp = c, sqp
    nq, nk = sqp // c, skp // ck
    wc = max(1, (window or sqp) // c) if pattern == "local" else nk
    q, k, v = _pad_seq(q, sqp), _pad_seq(k, skp), _pad_seq(v, skp)
    # (B, KV, G, nq, c, dh) for q; (B, KV, nk, ck, dh) for k and v.
    qr = q.reshape(B, sqp, KV, G, dh).permute(0, 2, 3, 1, 4)
    qr = qr.reshape(B, KV, G, nq, c, dh) * dh ** -0.5
    kr = k.transpose(1, 2).reshape(B, KV, nk, ck, dh)
    vr = v.transpose(1, 2).reshape(B, KV, nk, ck, dh)
    q_off = torch.arange(c, device=q.device)[:, None]
    k_off = torch.arange(ck, device=q.device)[None, :]

    f32 = torch.float32
    m = [torch.full((B, KV, G, c), NEG_INF, dtype=f32, device=q.device)
         for _ in range(nq)]
    l = [torch.zeros((B, KV, G, c), dtype=f32, device=q.device)
         for _ in range(nq)]
    acc = [torch.zeros((B, KV, G, c, dh), dtype=f32, device=q.device)
           for _ in range(nq)]
    for qi, ki in _chunk_pairs(nq, nk, pattern, wc):
        qb, kb, vb = qr[:, :, :, qi], kr[:, :, ki], vr[:, :, ki]
        s = torch.einsum("bkgqd,bkcd->bkgqc", qb.to(f32), kb.to(f32))
        q_pos, k_pos = qi * c + q_off, ki * ck + k_off
        mask = None
        if pattern in ("causal", "local"):
            mask = k_pos <= q_pos
            if pattern == "local" and window:
                mask = mask & (q_pos - k_pos < window)
        if skp != Sk:
            valid = k_pos < Sk
            mask = valid if mask is None else mask & valid
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m[qi], s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m[qi] - m_new)
        l[qi] = l[qi] * corr + p.sum(dim=-1)
        acc[qi] = acc[qi] * corr[..., None] + torch.einsum(
            "bkgqc,bkcd->bkgqd", p.to(vb.dtype).to(f32), vb.to(f32))
        m[qi] = m_new
    out = torch.stack(acc, dim=3) / torch.clamp(
        torch.stack(l, dim=3), min=1e-30)[..., None]
    out = out.reshape(B, KV, G, sqp, dh).permute(0, 3, 1, 2, 4)
    return out.reshape(B, sqp, H, dh)[:, :Sq].to(q.dtype)


def kv_cache_formats(q: QuantConfig):
    fxp = FXPFormat(q.W, q.W - 1)
    return fxp, default_vp_format(fxp, q.M, q.E)


def quantize_kv(x: torch.Tensor, q: QuantConfig, layout: str = "packed"):
    """KV block (B, S, KV, dh) -> VP storage and a per-position f32 scale
    (B, S, 1, 1), the smallest 2^n >= max|x| over (KV, dh).

    layout "packed": (words, scale), each position over its scale and
    quantized to packed VP words in one launch on the card
    (`ops.vp_quant_scaled`, the quant kernel's KV mode); the reference
    takes `_kv_scale`, the division and the plain quantizer here, with
    the same result bit for bit.
    layout "planes": (significands, indices, scale): the scale and the
    division in plain f32 (`ref.kv_scale`, bit for bit the reference's
    `_kv_scale`), the planes from `ops.vp_quant` (the planes kernel on
    the card), the E-bit indices packed 8 // E to a byte where dh allows.
    """
    fxp, vp = kv_cache_formats(q)
    if layout == "packed":
        return ops.vp_quant_scaled(x, fxp, vp, group_dims=2)
    s = kref.kv_scale(x)
    m, i = ops.vp_quant(x.to(torch.float32) / s, fxp, vp, packed=False)
    if vp.E and x.shape[-1] % (8 // vp.E) == 0:
        i = pack_indices(i, vp.E)
    return m, i, s


def dequantize_kv(m, i, s, q: QuantConfig, dtype):
    """Planes cache -> reals in `dtype`: the indices unpacked, then
    `ops.vp_dequant` (the planes kernel on the card) times the scale."""
    _, vp = kv_cache_formats(q)
    if i.shape[-1] != m.shape[-1]:
        i = unpack_indices(i, vp.E, m.shape[-1])
    return (ops.vp_dequant(m, i, vp) * s).to(dtype)


def dequantize_kv_packed(w, s, q: QuantConfig, dtype):
    """Packed-word cache -> reals in `dtype`: `ops.vp_dequant` of the
    words (the packed dequant kernel on the card) times the scale."""
    _, vp = kv_cache_formats(q)
    return (ops.vp_dequant(w, None, vp) * s).to(dtype)


def _layout(cache: dict) -> str:
    if "k_w" in cache:
        return "packed"
    return "planes" if "k_m" in cache else "float"


_KEY_BUF = {"packed": "k_w", "planes": "k_m", "float": "k"}


def buffer_len(cache: dict) -> int:
    """The positions an attention cache's buffers hold (smax)."""
    return cache[_KEY_BUF[_layout(cache)]].shape[1]


def _write(buf: torch.Tensor, val: torch.Tensor, at: torch.Tensor) -> None:
    """buf[b, at[b] + j] = val[b, j] for every sequence b, in place."""
    S = val.shape[1]
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    cols = at.to(torch.int64)[:, None] + torch.arange(S, device=buf.device)
    buf[rows, cols] = val.to(buf.dtype)


def _store(cache: dict, layout: str, k, v, q: QuantConfig, at) -> None:
    """Quantize K and V into the cache's layout and write them at `at`."""
    if layout == "packed":
        w_k, s_k = quantize_kv(k, q)
        w_v, s_v = quantize_kv(v, q)
        vals = {"k_w": w_k, "k_s": s_k, "v_w": w_v, "v_s": s_v}
    elif layout == "planes":
        m_k, i_k, s_k = quantize_kv(k, q, "planes")
        m_v, i_v, s_v = quantize_kv(v, q, "planes")
        vals = {"k_m": m_k, "k_i": i_k, "k_s": s_k,
                "v_m": m_v, "v_i": i_v, "v_s": s_v}
    else:
        vals = {"k": k, "v": v}
    for name, val in vals.items():
        _write(cache[name], val, at)


def _dequantized(cache: dict, layout: str, q: QuantConfig, dtype):
    """The whole cache's K and V as reals in `dtype`."""
    if layout == "packed":
        return (dequantize_kv_packed(cache["k_w"], cache["k_s"], q, dtype),
                dequantize_kv_packed(cache["v_w"], cache["v_s"], q, dtype))
    if layout == "planes":
        return (dequantize_kv(cache["k_m"], cache["k_i"], cache["k_s"], q,
                              dtype),
                dequantize_kv(cache["v_m"], cache["v_i"], cache["v_s"], q,
                              dtype))
    return cache["k"].to(dtype), cache["v"].to(dtype)


def _chunked_prefill_attention(qp, k_all, v_all, offset, hist_len: int):
    """Causal attention of a prompt chunk against the cache history and
    itself, in plain f32 (as the reference's is plain jnp).

    qp (B, S, H, dh) are the chunk's queries; k_all / v_all (B, hist_len
    + S, KV, dh) the dequantized history followed by the chunk's own K/V.
    offset (B,) is the valid history span: history position t
    contributes iff t < offset, chunk position c iff c <= s.  Everything
    else is masked to NEG_INF, so unwritten cache slots cannot leak.
    """
    B, S, H, dh = qp.shape
    KV = k_all.shape[2]
    qr = qp.reshape(B, S, KV, H // KV, dh).to(torch.float32) * dh ** -0.5
    scores = torch.einsum("bskgd,btkd->bkgst", qr, k_all.to(torch.float32))
    t = torch.arange(k_all.shape[1], device=qp.device)[None, None, :]
    s_idx = torch.arange(S, device=qp.device)[None, :, None]
    mask = (t < offset.to(torch.int64)[:, None, None]) | (
        (t >= hist_len) & (t - hist_len <= s_idx))          # (B, S, T)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgst,btkd->bskgd", p / torch.clamp(l, min=1e-30),
                       v_all.to(torch.float32))
    return out.reshape(B, S, H, dh).to(qp.dtype)


def attn_block(x, params, cfg: ModelConfig, positions, pattern: str,
               window: Optional[int], cache: Optional[dict] = None,
               train: bool = False, chunked: bool = False,
               kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Self- or cross-attention block -> (out, cache).

    cache: {"k_w", "k_s", "v_w", "v_s", "len"} packed VP words, {"k_m",
    "k_i", "k_s", "v_m", "v_i", "v_s", "len"} VP planes, or {"k", "v",
    "len"} floats; None runs attention without a cache.  A multi-token
    `x` with a cache is a prefill into an empty cache (its K/V go to
    slots [0, S), slots past S stay as they were and are never read),
    or with `chunked` a prompt chunk appended at offset `len`: it attends
    to the valid history (dequantized whole, once per chunk) and itself,
    full-causal caches only.  One token is a decode step.  `train` (no
    cache) makes every projection a QAT `qdot` and runs
    `flash_attention_walk`.  With `qkv_bias` the params carry "bq", "bk" and
    "bv", added to the projections before qk-norm and rope.
    `positions=None` applies no rope (the encoder-decoder's attentions),
    and pattern "full" masks nothing but padding.

    A prompt longer than a full-causal buffer raises ValueError: the
    port never clamps a write (`models.model` checks a decode step's
    room before its layers run).

    kv_override (k, v), each (B, Sk, KV, dh) floats in x's dtype, is a
    cross-attention source (the encoder's K/V): only wq projects x, no
    qk-norm or rope touches the source, no cache is written; a prompt
    runs `ops.flash_prefill` at pattern "full" (Sq != Sk: the flash
    kernel on the card), a decode step the plain `ref.decode_attention_ref`
    over the whole source (the reference's step is plain array code too).
    """
    q_cfg = cfg.quant
    B, S = x.shape[:2]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    if kv_override is None:
        xq = block_activation(
            x, (params["wq"], params["wk"], params["wv"]), q_cfg)
    else:
        xq = block_activation(x, (params["wq"],), q_cfg)
    qp = qdot(x, params["wq"], q_cfg, train, xq)
    if params.get("bq") is not None:   # qkv_bias, in the projection's dtype
        qp = qp + params["bq"].to(qp.dtype)
    qp = qp.reshape(B, S, H, dh)
    if kv_override is None:
        kp = qdot(x, params["wk"], q_cfg, train, xq)
        vp_ = qdot(x, params["wv"], q_cfg, train, xq)
        if params.get("bk") is not None:
            kp = kp + params["bk"].to(kp.dtype)
            vp_ = vp_ + params["bv"].to(vp_.dtype)
        kp = kp.reshape(B, S, KV, dh)
        vp_ = vp_.reshape(B, S, KV, dh)
    else:
        kp, vp_ = kv_override
    if cfg.qk_norm:
        qp = rms_norm(qp, params["q_norm"])
        if kv_override is None:
            kp = rms_norm(kp, params["k_norm"])
    if positions is not None and kv_override is None:
        qp = rope(qp, positions, cfg.rope_theta)
        kp = rope(kp, positions, cfg.rope_theta)

    layout = None if cache is None else _layout(cache)
    if kv_override is not None:
        if cache is not None:
            raise ValueError("cross-attention writes no KV cache")
        if S == 1:
            src_len = torch.full((B,), kp.shape[1], dtype=torch.int32,
                                 device=x.device)
            out = kref.decode_attention_ref(qp, kp, vp_, src_len)
        elif train:
            out = flash_attention_walk(qp, kp, vp_, pattern="full")
        else:
            out = flash_attention(qp, kp, vp_, pattern="full")
    elif train:
        if cache is not None:
            raise ValueError("training attention takes no KV cache")
        out = flash_attention_walk(qp, kp, vp_, pattern=pattern,
                                   window=window)
    elif cache is None:
        out = flash_attention(qp, kp, vp_, pattern=pattern, window=window)
    elif S > 1 and chunked:
        if window is not None:
            raise NotImplementedError(
                "chunked prefill over rolling/windowed caches is not "
                "implemented; use whole-prompt prefill")
        smax = cache[_KEY_BUF[layout]].shape[1]
        idx = cache["len"]
        k_hist, v_hist = _dequantized(cache, layout, q_cfg, kp.dtype)
        k_all = torch.cat([k_hist, kp.to(k_hist.dtype)], dim=1)
        v_all = torch.cat([v_hist, vp_.to(v_hist.dtype)], dim=1)
        out = _chunked_prefill_attention(qp, k_all, v_all, idx, smax)
        _store(cache, layout, kp, vp_, q_cfg, idx)
        cache = {**cache, "len": idx + S}
    elif S > 1:
        smax = cache[_KEY_BUF[layout]].shape[1]
        if S > smax and window is None:
            raise ValueError(
                f"a prompt of {S} positions does not fit a full-causal KV "
                f"cache of {smax}: size the cache to the whole sequence")
        out = flash_attention(qp, kp, vp_, pattern=pattern, window=window)
        kw, vw = kp, vp_
        if S > smax:
            # Ring buffer shorter than the prompt: keep the tail, slot j
            # holding the position p with p % smax == j.
            kw = torch.roll(kp[:, -smax:], S % smax, dims=1)
            vw = torch.roll(vp_[:, -smax:], S % smax, dims=1)
        _store(cache, layout, kw, vw, q_cfg, torch.zeros_like(cache["len"]))
        cache = {**cache, "len": cache["len"] + S}
    else:
        smax = cache[_KEY_BUF[layout]].shape[1]
        rolling = window is not None and smax <= window
        idx = cache["len"]
        widx = idx % smax if rolling else idx
        new_len = idx + 1
        _store(cache, layout, kp, vp_, q_cfg, widx)
        if layout == "packed":
            _, vp_fmt = kv_cache_formats(q_cfg)
            out = ops.vp_decode_attention(
                qp, cache["k_w"], cache["v_w"], cache["k_s"], cache["v_s"],
                new_len, vp_fmt, window=window, rolling=rolling)
        else:
            k_full, v_full = _dequantized(cache, layout, q_cfg, kp.dtype)
            out = kref.decode_attention_ref(
                qp, k_full, v_full, new_len, window, rolling=rolling)
        cache = {**cache, "len": new_len}

    out = out.reshape(B, S, H * dh)
    return qdot(out, params["wo"], q_cfg, train), cache
