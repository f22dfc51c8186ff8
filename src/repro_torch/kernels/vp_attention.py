"""Wrappers of the attention kernels (csrc/vp_attention.cu).

Replace `repro/kernels/vp_attention.py:vp_decode_attention_pallas` and
`flash_prefill_pallas`.  The plain versions are
`ref.vp_decode_attention_ref` and `ref.flash_prefill_ref`; dispatch,
the q pre-scaling and the reshapes live in `ops.py`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.formats import VPFormat
from repro_torch.core.packing import storage_dtype
from . import build


def vp_decode_attention_cuda(q, k_w, v_w, k_s, v_s, lengths, fmt: VPFormat,
                             window: Optional[int], rolling: bool):
    """q (B, KV, G, dh) f32, already scaled by dh**-0.5; k_w / v_w
    (B, Smax, KV, dh) packed words; k_s / v_s (B, Smax) f32; lengths (B,)
    -> (B, KV, G, dh) f32."""
    B, KV, G, dh = q.shape
    smax = k_w.shape[1]
    if not all(t.is_cuda and t.device == q.device
               for t in (q, k_w, v_w, k_s, v_s, lengths)):
        raise ValueError("vp_decode_attention kernel takes CUDA tensors on "
                         "one device")
    if k_w.shape != (B, smax, KV, dh) or v_w.shape != k_w.shape:
        raise ValueError(f"cache shape {tuple(k_w.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if k_w.dtype != storage_dtype(fmt) or v_w.dtype != k_w.dtype:
        raise ValueError(f"packed words of {fmt} are {storage_dtype(fmt)}")
    q = q.to(torch.float32).contiguous()
    k_w, v_w = k_w.contiguous(), v_w.contiguous()
    k_s = k_s.reshape(B, smax).to(torch.float32).contiguous()
    v_s = v_s.reshape(B, smax).to(torch.float32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.library("vp_attention")
    f = build.vp_fmt_struct(fmt)
    with torch.cuda.device(q.device):
        err = lib.vp_decode_attention_launch(
            q.data_ptr(), k_w.data_ptr(), v_w.data_ptr(), k_s.data_ptr(),
            v_s.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, KV, G, dh, smax, int(window or 0), int(rolling),
            k_w.element_size(), ctypes.byref(f),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "vp_decode_attention")
    build.LAUNCHES["vp_decode_attention"] += 1
    return out


def flash_prefill_cuda(q, k, v, causal: bool, window: Optional[int]):
    """q (B, Sq, H, dh) already scaled by dh**-0.5, k / v (B, Sk, KV, dh),
    all f32 or all bf16 -> (B, Sq, H, dh) in q's dtype."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_prefill kernel takes CUDA tensors on one "
                         "device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_prefill kernel takes q, k, v of one dtype")
    if H % KV or v.shape != k.shape:
        raise ValueError(f"bad GQA shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    code = build.dtype_code(q.dtype, "q")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.library("vp_attention")
    with torch.cuda.device(q.device):
        err = lib.flash_prefill_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, KV, dh, int(causal), int(window or 0), code,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "flash_prefill")
    build.LAUNCHES["flash_prefill"] += 1
    return out
