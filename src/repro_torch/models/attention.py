"""Attention block with a packed VP (or float) KV cache (port of the
serving and training branches of `repro.models.attention`).

Prefill runs `ops.flash_prefill` (the flash kernel on the card) and writes
the prompt's K/V into the cache; decode appends one position and runs
`ops.vp_decode_attention` on the packed words.  Training runs
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

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core.formats import FXPFormat, default_vp_format
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


def quantize_kv(x: torch.Tensor, q: QuantConfig):
    """KV block (B, S, KV, dh) -> (packed words, per-position f32 scale
    (B, S, 1, 1)): each position over its pow2 scale, the smallest 2^n >=
    max|x| over (KV, dh), then packed VP words, in one launch on the card
    (`ops.vp_quant_scaled`, the quant kernel's KV mode).  The reference
    takes `_kv_scale`, the division and the plain quantizer here, with
    the same result bit for bit."""
    fxp, vp = kv_cache_formats(q)
    return ops.vp_quant_scaled(x, fxp, vp, group_dims=2)


def _write(buf: torch.Tensor, val: torch.Tensor, at: torch.Tensor) -> None:
    """buf[b, at[b] + j] = val[b, j] for every sequence b, in place."""
    S = val.shape[1]
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    cols = at.to(torch.int64)[:, None] + torch.arange(S, device=buf.device)
    buf[rows, cols] = val.to(buf.dtype)


def attn_block(x, params, cfg: ModelConfig, positions, pattern: str,
               window: Optional[int], cache: Optional[dict] = None,
               train: bool = False):
    """Self-attention block -> (out, cache).

    cache: {"k_w", "k_s", "v_w", "v_s", "len"} packed VP words, or
    {"k", "v", "len"} floats; None runs attention without a cache.
    A multi-token `x` with a cache is a prefill into an empty cache (its
    K/V go to slots [0, S), slots past S stay as they were and are never
    read); one token is a decode step.  `train` (no cache) makes every
    projection a QAT `qdot` and runs `flash_attention_walk`.
    """
    q_cfg = cfg.quant
    B, S = x.shape[:2]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    xq = block_activation(x, (params["wq"], params["wk"], params["wv"]),
                          q_cfg)
    qp = qdot(x, params["wq"], q_cfg, train, xq).reshape(B, S, H, dh)
    kp = qdot(x, params["wk"], q_cfg, train, xq).reshape(B, S, KV, dh)
    vp_ = qdot(x, params["wv"], q_cfg, train, xq).reshape(B, S, KV, dh)
    if cfg.qk_norm:
        qp = rms_norm(qp, params["q_norm"])
        kp = rms_norm(kp, params["k_norm"])
    qp = rope(qp, positions, cfg.rope_theta)
    kp = rope(kp, positions, cfg.rope_theta)

    packed = cache is not None and "k_w" in cache
    if train:
        if cache is not None:
            raise ValueError("training attention takes no KV cache")
        out = flash_attention_walk(qp, kp, vp_, pattern=pattern,
                                   window=window)
    elif cache is None:
        out = flash_attention(qp, kp, vp_, pattern=pattern, window=window)
    elif S > 1:
        smax = cache["k_w" if packed else "k"].shape[1]
        out = flash_attention(qp, kp, vp_, pattern=pattern, window=window)
        kw, vw = kp, vp_
        if S > smax:
            # Ring buffer shorter than the prompt: keep the tail, slot j
            # holding the position p with p % smax == j.
            kw = torch.roll(kp[:, -smax:], S % smax, dims=1)
            vw = torch.roll(vp_[:, -smax:], S % smax, dims=1)
        zero = torch.zeros_like(cache["len"])
        if packed:
            w_k, s_k = quantize_kv(kw, q_cfg)
            w_v, s_v = quantize_kv(vw, q_cfg)
            _write(cache["k_w"], w_k, zero)
            _write(cache["k_s"], s_k, zero)
            _write(cache["v_w"], w_v, zero)
            _write(cache["v_s"], s_v, zero)
        else:
            _write(cache["k"], kw, zero)
            _write(cache["v"], vw, zero)
        cache = {**cache, "len": cache["len"] + S}
    else:
        smax = cache["k_w" if packed else "k"].shape[1]
        rolling = window is not None and smax <= window
        idx = cache["len"]
        widx = idx % smax if rolling else idx
        new_len = idx + 1
        if packed:
            w_k, s_k = quantize_kv(kp, q_cfg)
            w_v, s_v = quantize_kv(vp_, q_cfg)
            _write(cache["k_w"], w_k, widx)
            _write(cache["k_s"], s_k, widx)
            _write(cache["v_w"], w_v, widx)
            _write(cache["v_s"], s_v, widx)
            _, vp_fmt = kv_cache_formats(q_cfg)
            out = ops.vp_decode_attention(
                qp, cache["k_w"], cache["v_w"], cache["k_s"], cache["v_s"],
                new_len, vp_fmt, window=window, rolling=rolling)
        else:
            _write(cache["k"], kp, widx)
            _write(cache["v"], vp_, widx)
            out = kref.decode_attention_ref(
                qp, cache["k"], cache["v"], new_len, window, rolling=rolling)
        cache = {**cache, "len": new_len}

    out = out.reshape(B, S, H * dh)
    return qdot(out, params["wo"], q_cfg, train), cache
