"""Plain PyTorch versions of the four main-path kernels (port of the
matching oracles in `repro.kernels.ref`).

`ops.py` runs these for CPU tensors, and inside `ops.force_backend("ref")`
on the card; the CPU tests hold them against the JAX package, and
`chip_smoke.py` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.convert import fxp2vp
from repro_torch.core.formats import FXPFormat, VPFormat
from repro_torch.core.fxp import fxp_quantize
from repro_torch.core.packing import dequant_words, pack_vp

NEG_INF = -1e30


def vp_quant_packed_ref(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat
                        ) -> torch.Tensor:
    """float -> packed VP words (`core.packing` layout, one plane)."""
    m, i = fxp2vp(fxp_quantize(x, fxp), fxp, vp)
    return pack_vp(m, i, vp)


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


def decode_attention_ref(q, k_cache, v_cache, cache_len,
                         window: Optional[int] = None, rolling: bool = False):
    """Masked single-token attention over a float cache.

    q (B, 1, H, dh), caches (B, Smax, KV, dh), cache_len (B,) ->
    (B, 1, H, dh).  Positions outside the valid span get NEG_INF before
    the softmax; the reference slices a window first, which drops only
    exact zeros.
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
