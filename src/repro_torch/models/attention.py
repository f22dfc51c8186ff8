"""Attention block with a packed VP (or float) KV cache (port of the
serving branches of `repro.models.attention`).

Prefill runs `ops.flash_prefill` (the flash kernel on the card) and writes
the prompt's K/V into the cache; decode appends one position and runs
`ops.vp_decode_attention` on the packed words.  The cache tensors are
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
from .layers import qdot, rms_norm, rope


def flash_attention(q, k, v, pattern: str = "causal",
                    window: Optional[int] = None):
    """q (B, Sq, H, dh), k/v (B, Sk, KV, dh) -> (B, Sq, H, dh).

    Always `ops.flash_prefill` (the reference walks a `lax.scan` off the
    TPU; both compute the same masked softmax).
    """
    return ops.flash_prefill(q, k, v, pattern=pattern, window=window)


def kv_cache_formats(q: QuantConfig):
    fxp = FXPFormat(q.W, q.W - 1)
    return fxp, default_vp_format(fxp, q.M, q.E)


def _kv_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-position pow2 scale: smallest 2^n >= max|x| over (KV, dh)."""
    amax = x.to(torch.float32).abs().amax(dim=(-2, -1), keepdim=True)
    return torch.exp2(torch.ceil(torch.log2(torch.clamp(amax, min=1e-30))))


def quantize_kv(x: torch.Tensor, q: QuantConfig):
    """KV block (B, S, KV, dh) -> (packed words, per-position f32 scale
    (B, S, 1, 1)).  The words go through `ops.vp_quant` (the quant kernel
    on the card); the reference calls its plain version here, with the
    same result bit for bit."""
    fxp, vp = kv_cache_formats(q)
    s = _kv_scale(x)
    xn = x.to(torch.float32) / s
    return ops.vp_quant(xn, fxp, vp, packed=True), s


def _write(buf: torch.Tensor, val: torch.Tensor, at: torch.Tensor) -> None:
    """buf[b, at[b] + j] = val[b, j] for every sequence b, in place."""
    S = val.shape[1]
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    cols = at.to(torch.int64)[:, None] + torch.arange(S, device=buf.device)
    buf[rows, cols] = val.to(buf.dtype)


def attn_block(x, params, cfg: ModelConfig, positions, pattern: str,
               window: Optional[int], cache: Optional[dict] = None):
    """Self-attention block -> (out, cache).

    cache: {"k_w", "k_s", "v_w", "v_s", "len"} packed VP words, or
    {"k", "v", "len"} floats; None runs attention without a cache.
    A multi-token `x` with a cache is a prefill into an empty cache (its
    K/V go to slots [0, S), slots past S stay as they were and are never
    read); one token is a decode step.
    """
    q_cfg = cfg.quant
    B, S = x.shape[:2]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    qp = qdot(x, params["wq"], q_cfg).reshape(B, S, H, dh)
    kp = qdot(x, params["wk"], q_cfg).reshape(B, S, KV, dh)
    vp_ = qdot(x, params["wv"], q_cfg).reshape(B, S, KV, dh)
    if cfg.qk_norm:
        qp = rms_norm(qp, params["q_norm"])
        kp = rms_norm(kp, params["k_norm"])
    qp = rope(qp, positions, cfg.rope_theta)
    kp = rope(kp, positions, cfg.rope_theta)

    packed = cache is not None and "k_w" in cache
    if cache is None:
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
    return qdot(out, params["wo"], q_cfg), cache
