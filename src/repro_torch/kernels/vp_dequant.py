"""Wrappers of the dequant kernels (csrc/vp_dequant.cu).

`vp_dequant_planes_cuda` replaces `repro/kernels/vp_dequant.py:
vp_dequant_pallas` and `vp_dequant_packed_cuda` replaces
`vp_dequant_packed_pallas`.  The plain versions are `ref.vp_dequant_ref`
and `ref.vp_dequant_packed_ref`; dispatch lives in `ops.vp_dequant`.

Both kernels read vector steps: 16 bytes of packed words (16 int8, 8
int16 or 4 int32: every `storage_dtype` of a format), or
`planes_vec` significands (int8 or int16, `SIGNIFICAND_DTYPES`: 16 bytes of
them, 8 for int8 to f32) with the step's indices in one 8- or 16-byte
load.  `split_packed` cuts n elements at a byte offset into a scalar
head up to the first boundary of a step's load, whole steps and a scalar
tail.  `plan_packed` sizes the packed kernel's grid: at most one wave of
resident blocks, each thread with two steps in flight, then a
grid-stride loop; `plan_planes` gives each thread of the planes kernel
one step.  The planes kernel takes its head from the significands'
offset; an index plane or output not aligned after it is read or
written one element at a time in the steps.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.formats import VPFormat
from repro_torch.core.packing import storage_dtype
from repro_torch.core.vp_tensor import SIGNIFICAND_DTYPES
from . import build
from .vp_quant import SMS

VEC_BYTES = 16           # one load of a thread step
PACKED_THREADS = 256     # threads of a block of either kernel
PACKED_UNROLL = 2        # vector steps a thread has in flight (DQ_UNROLL)
SM_THREADS = 2048        # resident threads of an SM (H100)
# Packed words the packed kernel takes: every `storage_dtype` of a format
# (int32 for M + E > 16).
PACKED_DTYPES = (torch.int8, torch.int16, torch.int32)


def split_packed(n: int, offset: int, word_bytes: int,
                 vec_bytes: int = VEC_BYTES) -> Tuple[int, int, int]:
    """(head, steps, tail) of n words of `word_bytes` bytes whose first
    word lies `offset` bytes past a `vec_bytes` boundary: `head` scalar
    words up to the next boundary (at most n), `steps` vector steps of
    vec_bytes // word_bytes words, and the `tail` words left."""
    vec = vec_bytes // word_bytes
    head = min(n, (-offset % vec_bytes) // word_bytes)
    steps = (n - head) // vec
    return head, steps, n - head - steps * vec


def planes_vec(m_bytes: int, out_bytes: int) -> int:
    """Significands of one vector step of the planes kernel
    (csrc/vp_dequant.cu:planes_vec): 16 bytes of them, or fewer where
    their values would pass 32 bytes (int8 to f32: 8)."""
    return min(VEC_BYTES // m_bytes, 32 // out_bytes)


def plan_packed(steps: int, sms: int = SMS) -> Tuple[int, int]:
    """(blocks, threads) of the packed kernel for `steps` vector steps:
    blocks of PACKED_THREADS, PACKED_UNROLL steps a thread, at most one
    wave of resident blocks (SM_THREADS / PACKED_THREADS per SM); past
    that, a grid-stride loop.  At least one block, for the head and the
    tail."""
    per_block = PACKED_THREADS * PACKED_UNROLL
    wave = SM_THREADS // PACKED_THREADS * sms
    return max(1, min(-(-steps // per_block), wave)), PACKED_THREADS


def plan_planes(steps: int) -> Tuple[int, int]:
    """(blocks, threads) of the planes kernel for `steps` vector steps:
    one step a thread, in blocks of PACKED_THREADS (the kernel loops over
    any grid; this one, with every load issued at once, ran faster on the
    card than a one-wave grid with two steps in flight).  At least one
    block, for the head and the tail."""
    return max(1, -(-steps // PACKED_THREADS)), PACKED_THREADS


def vp_dequant_planes_cuda(m: torch.Tensor, i: torch.Tensor, vp: VPFormat,
                           dtype: torch.dtype) -> torch.Tensor:
    """(significand (int8 or int16), uint8 index) planes of one shape ->
    reals in dtype."""
    if m.dtype not in SIGNIFICAND_DTYPES:
        raise ValueError(f"the kernel takes int8 or int16 significands, got "
                         f"{m.dtype}")
    if m.shape != i.shape or i.dtype != torch.uint8:
        raise ValueError(f"planes must share a shape with a uint8 index, got "
                         f"{tuple(m.shape)} {m.dtype} and {tuple(i.shape)} "
                         f"{i.dtype}")
    if not (m.is_cuda and i.device == m.device):
        raise ValueError("vp_dequant_planes kernel takes CUDA tensors on one "
                         "device")
    oc = build.dtype_code(dtype, "dtype")
    m, i = m.contiguous(), i.contiguous()
    out = torch.empty(m.shape, dtype=dtype, device=m.device)
    if m.numel() == 0:
        return out
    lib = build.library("vp_dequant")
    fmt = build.vp_fmt_struct(vp, out.device)
    mb = m.element_size()
    head, steps, _ = split_packed(m.numel(), m.data_ptr() % VEC_BYTES, mb,
                                  planes_vec(mb, out.element_size()) * mb)
    blocks, threads = plan_planes(steps)
    with torch.cuda.device(m.device):
        err = lib.vp_dequant_planes_launch(
            m.data_ptr(), m.element_size(), i.data_ptr(), out.data_ptr(),
            m.numel(), oc, ctypes.byref(fmt), head, blocks, threads,
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
    if w.dtype not in PACKED_DTYPES:
        raise ValueError(f"the kernel takes int8, int16 or int32 words, got "
                         f"{w.dtype}")
    oc = build.dtype_code(dtype, "dtype")
    w = w.contiguous()
    out = torch.empty(w.shape, dtype=dtype, device=w.device)
    if w.numel() == 0:
        return out
    lib = build.library("vp_dequant")
    fmt = build.vp_fmt_struct(vp, out.device)
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
