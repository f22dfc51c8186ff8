"""Public ops of the serving path: dispatch between kernel and plain version.

Counterpart of `repro.kernels.ops` with the same argument order.  Each op
picks its path from the device of its input tensors (the port of
`substrate.resolve_backend`):

  * a CUDA tensor goes to the hand-written CUDA kernel;
  * a CPU tensor goes to the plain PyTorch version in `ref.py`.

There is no fallback: a failed build or launch raises.  Inside
`force_backend("ref")` every op runs its plain version whatever the
device; only comparisons use that (chip_smoke.py, tests).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from repro_torch.core.formats import FXPFormat, VPFormat
from . import ref
from .vp_attention import flash_prefill_cuda, vp_decode_attention_cuda
from .vp_dequant_matmul import vp_dequant_matmul_cuda
from .vp_quant import vp_quant_packed_cuda

# Set only by `force_backend`.
_FORCED: list = []


@contextlib.contextmanager
def force_backend(backend: str) -> Iterator[None]:
    """Run every op's plain version inside the context, on any device."""
    if backend != "ref":
        raise ValueError(f"unknown backend {backend!r}; only 'ref' can be "
                         "forced (CUDA tensors take the kernels by default)")
    _FORCED.append(backend)
    try:
        yield
    finally:
        _FORCED.pop()


def _use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA inputs, False for CPU inputs or a forced "ref"."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind == "cuda" and not _FORCED


def vp_quant(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat,
             packed: bool = True) -> torch.Tensor:
    """float tensor (any rank) -> packed VP words of the same shape.

    Only the packed layout is ported; the two-plane layout waits for a
    later slice.
    """
    if not packed:
        raise NotImplementedError("the two-plane VP layout is not ported")
    if _use_kernel(x):
        return vp_quant_packed_cuda(x.to(torch.float32), fxp, vp)
    return ref.vp_quant_packed_ref(x, fxp, vp)


def vp_dequant_matmul(x: torch.Tensor, w: torch.Tensor, w_fmt: VPFormat,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Serving matmul: real x (M, K) @ dequant(w (K, N) packed VP words).

    `out_dtype` defaults to x's dtype.
    """
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad matmul shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if _use_kernel(x, w):
        return vp_dequant_matmul_cuda(x, w, w_fmt, out_dtype)
    return ref.vp_dequant_matmul_ref(x, w, w_fmt, out_dtype=out_dtype)


def vp_decode_attention(q, k_w, v_w, k_s, v_s, lengths, fmt: VPFormat,
                        window: Optional[int] = None, rolling: bool = False):
    """Single-token decode attention over a packed VP KV cache.

    q (B, 1, H, dh); k_w / v_w (B, Smax, KV, dh) packed words; k_s / v_s
    (B, Smax, 1, 1) per-position pow2 scales; lengths (B,) valid lengths.
    Only positions in the valid span are read (past `lengths`, outside
    `window`, or past the `rolling` ring's fill level are skipped).
    """
    if not _use_kernel(q, k_w, v_w, k_s, v_s, lengths):
        return ref.vp_decode_attention_ref(
            q, k_w, v_w, k_s, v_s, lengths, fmt, window=window,
            rolling=rolling)
    B, _, H, dh = q.shape
    KV = k_w.shape[2]
    qr = q.reshape(B, KV, H // KV, dh).to(torch.float32) * dh ** -0.5
    out = vp_decode_attention_cuda(qr, k_w, v_w, k_s, v_s, lengths, fmt,
                                   window, rolling)
    return out.reshape(B, 1, H, dh).to(q.dtype)


def flash_prefill(q, k, v, pattern: str = "causal",
                  window: Optional[int] = None):
    """Prefill attention: q (B, Sq, H, dh) x k/v (B, Sk, KV, dh).

    pattern: causal | local (banded causal, `window`) | full.  GQA maps
    query head h to kv head h // G.
    """
    if pattern not in ("causal", "local", "full"):
        raise ValueError(f"unknown attention pattern {pattern!r}")
    Sq, Sk = q.shape[1], k.shape[1]
    if pattern in ("causal", "local") and Sq != Sk:
        raise ValueError(
            f"causal/local prefill requires Sq == Sk, got {Sq} != {Sk}")
    if not _use_kernel(q, k, v):
        return ref.flash_prefill_ref(q, k, v, pattern=pattern, window=window)
    dh = q.shape[-1]
    qs = q * torch.tensor(dh ** -0.5, dtype=q.dtype, device=q.device)
    return flash_prefill_cuda(
        qs, k, v, causal=pattern != "full",
        window=window if pattern == "local" else None)
