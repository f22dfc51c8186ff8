"""Wrappers of the dequant kernels (csrc/vp_dequant.cu).

`vp_dequant_planes_cuda` replaces `repro/kernels/vp_dequant.py:
vp_dequant_pallas` and `vp_dequant_packed_cuda` replaces
`vp_dequant_packed_pallas`.  The plain versions are `ref.vp_dequant_ref`
and `ref.vp_dequant_packed_ref`; dispatch lives in `ops.vp_dequant`.

The packed kernel reads its words in 16-byte vector steps: `split_packed`
cuts n words at a byte offset into a scalar head up to the first 16-byte
boundary, whole steps and a scalar tail, and `plan_packed` sizes the
grid: at most one wave of resident blocks, each thread with two steps in
flight, then a grid-stride loop.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.formats import VPFormat
from repro_torch.core.packing import storage_dtype
from . import build
from .vp_quant import SMS

VEC_BYTES = 16           # one load of a thread step
PACKED_THREADS = 256     # threads of a block of the packed kernel
PACKED_UNROLL = 2        # vector steps a thread has in flight (DQ_UNROLL)
SM_THREADS = 2048        # resident threads of an SM (H100)


def split_packed(n: int, offset: int, word_bytes: int) -> Tuple[int, int,
                                                                int]:
    """(head, steps, tail) of n words of `word_bytes` bytes whose first
    word lies `offset` bytes past a 16-byte boundary: `head` scalar words
    up to the next boundary (at most n), `steps` vector steps of
    16 // word_bytes words, and the `tail` words left."""
    vec = VEC_BYTES // word_bytes
    head = min(n, (-offset % VEC_BYTES) // word_bytes)
    steps = (n - head) // vec
    return head, steps, n - head - steps * vec


def plan_packed(steps: int, sms: int = SMS) -> Tuple[int, int]:
    """(blocks, threads) of the packed kernel for `steps` vector steps:
    blocks of PACKED_THREADS, PACKED_UNROLL steps a thread, at most one
    wave of resident blocks (SM_THREADS / PACKED_THREADS per SM); past
    that, a grid-stride loop.  At least one block, for the head and the
    tail."""
    per_block = PACKED_THREADS * PACKED_UNROLL
    wave = SM_THREADS // PACKED_THREADS * sms
    return max(1, min(-(-steps // per_block), wave)), PACKED_THREADS


def vp_dequant_planes_cuda(m: torch.Tensor, i: torch.Tensor, vp: VPFormat,
                           dtype: torch.dtype) -> torch.Tensor:
    """(significand, uint8 index) planes of one shape -> reals in dtype."""
    if not (m.is_cuda and i.device == m.device):
        raise ValueError("vp_dequant_planes kernel takes CUDA tensors on one "
                         "device")
    if m.shape != i.shape or i.dtype != torch.uint8:
        raise ValueError(f"planes must share a shape with a uint8 index, got "
                         f"{tuple(m.shape)} {m.dtype} and {tuple(i.shape)} "
                         f"{i.dtype}")
    if m.dtype != torch.int8:
        raise ValueError(f"the kernel takes int8 significands, got {m.dtype}")
    oc = build.dtype_code(dtype, "dtype")
    m, i = m.contiguous(), i.contiguous()
    out = torch.empty(m.shape, dtype=dtype, device=m.device)
    if m.numel() == 0:
        return out
    lib = build.library("vp_dequant")
    fmt = build.vp_fmt_struct(vp)
    with torch.cuda.device(m.device):
        err = lib.vp_dequant_planes_launch(
            m.data_ptr(), i.data_ptr(), out.data_ptr(),
            m.numel(), oc, ctypes.byref(fmt),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "vp_dequant_planes")
    build.LAUNCHES["vp_dequant_planes"] += 1
    return out


def vp_dequant_packed_cuda(w: torch.Tensor, vp: VPFormat,
                           dtype: torch.dtype) -> torch.Tensor:
    """Packed VP words (any shape) -> reals in dtype."""
    if not w.is_cuda:
        raise ValueError("vp_dequant_packed kernel takes a CUDA tensor")
    if w.dtype != storage_dtype(vp):
        raise ValueError(f"packed words of {vp} are {storage_dtype(vp)}, "
                         f"got {w.dtype}")
    if w.dtype not in (torch.int8, torch.int16):
        raise ValueError(f"the kernel takes int8 or int16 words, got {w.dtype}")
    oc = build.dtype_code(dtype, "dtype")
    w = w.contiguous()
    out = torch.empty(w.shape, dtype=dtype, device=w.device)
    if w.numel() == 0:
        return out
    lib = build.library("vp_dequant")
    fmt = build.vp_fmt_struct(vp)
    head, steps, _ = split_packed(w.numel(), w.data_ptr() % VEC_BYTES,
                                  w.element_size())
    blocks, threads = plan_packed(steps, torch.cuda.get_device_properties(
        w.device).multi_processor_count)
    with torch.cuda.device(w.device):
        err = lib.vp_dequant_packed_launch(
            w.data_ptr(), w.element_size(), out.data_ptr(), w.numel(), oc,
            ctypes.byref(fmt), head, blocks, threads,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "vp_dequant_packed")
    build.LAUNCHES["vp_dequant_packed"] += 1
    return out
