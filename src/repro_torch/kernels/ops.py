"""Public ops: dispatch between kernel and plain version.

Counterpart of `repro.kernels.ops` with the same argument order.  Each op
picks its path from the device of its input tensors (the port of
`substrate.resolve_backend`):

  * a CUDA tensor goes to the hand-written CUDA kernel;
  * a CPU tensor goes to the plain PyTorch version in `ref.py`.

There is no fallback: a failed build or launch raises.  Inside
`force_backend("ref")` every op runs its plain version whatever the
device; only comparisons use that (chip_smoke.py, tests).

The trainable ops are `torch.autograd.Function`s, each the counterpart
of a `jax.custom_vjp` of the reference: `vp_dequant_matmul` (dx from the
`vp_matmul_dx` kernel over the packed words), `vp_qat_matmul` (packed
forward, straight-through backward) and the unmasked `vp_quant_matmul`
(dx and dw kernels over the quantized operands saved as packed words),
and `rms_norm` (the kernel forward, its backward in PyTorch ops; the
reference's is XLA's autodiff of its jnp).  A call
that needs no gradient skips the Function and runs the forward alone.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Iterator, Optional

import torch

from repro_torch.analysis import contracts
from repro_torch.core.formats import FXPFormat, VPFormat
from repro_torch.core.packing import unpack_vp
from repro_torch.core.vp_tensor import significand_dtype
from . import autotune, ref
from .autotune import Blocks
from .vp_attention import flash_prefill_cuda, vp_decode_attention_cuda
from .vp_block_matmul import block_vp_matmul_cuda
from .vp_block_quant import block_vp_quant_cuda
from .vp_bwd_matmul import vp_matmul_dw_cuda, vp_matmul_dx_cuda
from .vp_dequant import vp_dequant_packed_cuda, vp_dequant_planes_cuda
from .vp_dequant_matmul import vp_dequant_matmul_cuda
from .vp_matmul import vp_matmul_cuda
from .vp_quant import (vp_quant_packed_cuda, vp_quant_planes_cuda,
                       vp_quant_scaled_cuda)
from .rms_norm import rms_norm_cuda
from .vp_quant_matmul import vp_quant_matmul_cuda

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


def uses_kernel(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether ops on these tensors launch the CUDA kernels: True for
    CUDA inputs, False for CPU inputs or a forced "ref".  None entries
    (absent optional inputs) are skipped."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind == "cuda" and not _FORCED


def _wants_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd records this call (then the op runs its
    Function; otherwise the forward alone)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _RMSNorm(torch.autograd.Function):
    """The kernel forward; the backward in PyTorch ops from the saved
    inputs: with r = rsqrt(mean(x^2) + eps) and t = dy (1 + gamma),
    dx = r t - x r^3 mean(t x), dgamma = the sum over rows of dy x r."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return rms_norm_cuda(x, gamma, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        xf, gf = x.to(torch.float32), g.to(torch.float32)
        r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + ctx.eps)
        dx = dgamma = None
        if ctx.needs_input_grad[0]:
            t = gf * (1.0 + gamma.to(torch.float32))
            dx = (r * t - xf * (r * r * r * torch.mean(
                t * xf, dim=-1, keepdim=True))).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dgamma = (gf * xf * r).reshape(-1, *gamma.shape).sum(0).to(
                gamma.dtype)
        return dx, dgamma, None


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) * (1 + gamma) in f32, cast back to x's
    dtype, over x's last axis; gamma (D,), or x's trailing shape (a
    per-head gamma).  On the card one launch whose row's bits do not
    depend on the number of rows."""
    if uses_kernel(x, gamma):
        if _wants_grad(x, gamma):
            return _RMSNorm.apply(x, gamma, eps)
        return rms_norm_cuda(x, gamma, eps)
    return ref.rms_norm_ref(x, gamma, eps)


def vp_quant(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat,
             packed: bool = False):
    """float tensor (any rank) -> VP-quantized planes of the same shape.

    ``packed=False``: (significand of `significand_dtype(vp.M)`, uint8
    index) planes.  ``packed=True``: one plane of packed words
    (`core.packing` layout), the layout every matmul op accepts as
    (words, None).
    """
    contracts.require_quant_safe(fxp, vp, "vp_quant")
    if uses_kernel(x):
        x32 = x.to(torch.float32)
        if packed:
            return vp_quant_packed_cuda(x32, fxp, vp)
        return vp_quant_planes_cuda(x32, fxp, vp)
    if packed:
        return ref.vp_quant_packed_ref(x, fxp, vp)
    return ref.vp_quant_ref(x, fxp, vp)


def vp_quant_scaled(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat,
                    group_dims: int = 2):
    """f32 or bf16 tensor -> (packed VP words of x's shape, f32 scales of
    shape x.shape[:-group_dims] + (1,) * group_dims): each group of the
    last `group_dims` dims divided by its pow2 scale exp2(ceil(log2(
    max(amax|x|, 1e-30)))) in f32, then quantized (the KV cache's write;
    one launch on the card)."""
    contracts.require_quant_safe(fxp, vp, "vp_quant_scaled")
    if uses_kernel(x):
        return vp_quant_scaled_cuda(x, fxp, vp, group_dims)
    return ref.vp_quant_scaled_ref(x, fxp, vp, group_dims)


def vp_dequant(m: torch.Tensor, i: Optional[torch.Tensor] = None,
               vp: Optional[VPFormat] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(significand, index) planes, or packed words with ``i=None``, back
    to real values of any shape: ``vp_dequant(m, i, fmt)`` or
    ``vp_dequant(w, None, fmt)``."""
    if isinstance(i, VPFormat) or vp is None:
        raise TypeError(
            "vp_dequant takes (m, i, vp) for planes or (w, None, vp) for "
            "packed words: the format is always the THIRD argument")
    contracts.require_format_serviceable(vp, "vp_dequant")
    if i is None:
        if uses_kernel(m):
            return vp_dequant_packed_cuda(m, vp, dtype)
        return ref.vp_dequant_packed_ref(m, vp, dtype)
    if uses_kernel(m, i):
        return vp_dequant_planes_cuda(m, i, vp, dtype)
    return ref.vp_dequant_ref(m, i, vp, dtype)


def block_vp_quant(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat,
                   block: int, axis: int = -1,
                   math_dtype: Optional[torch.dtype] = None):
    """x (R, C) / pow2_scale(x), block-VP quantized along `axis` ->
    (significands of `significand_dtype(vp.M)` shaped like x, uint8
    indices with `axis` reduced by `block`, the scale as a 0-d f32).

    The scale and the division are taken in `math_dtype` (default x's
    dtype; f32 for a bf16 x upcasts it exactly), as `qdot` does for its
    activations (f32) and `quantize_weight` for a weight (its dtype).
    The scale stays on the device: no host sync.
    """
    math_dtype = math_dtype or x.dtype
    if uses_kernel(x):
        if math_dtype not in (x.dtype, torch.float32):
            raise ValueError(f"math in {math_dtype} for a {x.dtype} x")
        return block_vp_quant_cuda(x, fxp, vp, block, axis,
                                   bf16_math=math_dtype == torch.bfloat16)
    return ref.block_vp_quant_ref(x, fxp, vp, block, axis, math_dtype)


def block_vp_matmul(a_m, a_i, b_m, b_i, a_fmt: VPFormat, b_fmt: VPFormat,
                    bk: int = 256, blocks: Optional[Blocks] = None,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Block-VP matmul: a_m (M, K) int8 with a_i (M, K/bk) indices per
    (row, k-tile), b_m (K, N) int8 with b_i (K/bk, N) per (k-tile, col)
    -> (M, N), each tile's int32 product scaled into an f32 sum.

    `bk` is the format's index block, not a free tiling axis: the int32
    contract is proved for it and, as in the reference, a `blocks` whose
    k-tile differs raises on every device.  The card's kernel keeps its
    own (M, N) tiling, so `blocks` is only checked.
    """
    contracts.require_format_serviceable(a_fmt, "block_vp_matmul")
    contracts.require_format_serviceable(b_fmt, "block_vp_matmul")
    contracts.require_int_accum_safe(a_fmt, b_fmt, bk)
    if blocks is not None and blocks[1] != bk:
        raise ValueError(
            f"kernel k-tile {blocks[1]} must equal index block size {bk}")
    if a_m.ndim != 2 or b_m.ndim != 2 or a_m.shape[1] != b_m.shape[0]:
        raise ValueError(f"bad matmul shapes a {tuple(a_m.shape)}, "
                         f"b {tuple(b_m.shape)}")
    M, K = a_m.shape
    N = b_m.shape[1]
    if K % bk:
        raise ValueError(f"K = {K} is not a multiple of the block {bk}")
    if (tuple(a_i.shape) != (M, K // bk)
            or tuple(b_i.shape) != (K // bk, N)):
        raise ValueError(f"index shapes {tuple(a_i.shape)} / "
                         f"{tuple(b_i.shape)}, want {(M, K // bk)} / "
                         f"{(K // bk, N)}")
    if uses_kernel(a_m, a_i, b_m, b_i):
        return block_vp_matmul_cuda(a_m, a_i, b_m, b_i, a_fmt, b_fmt, bk,
                                    out_dtype)
    return ref.block_vp_matmul_ref(a_m, a_i, b_m, b_i, a_fmt, b_fmt, bk,
                                   out_dtype=out_dtype)


def _check_masks(a_act, b_act, M: int, K: int, N: int, blocks: Blocks):
    """Validate optional CSPADE masks against the (bm, bk, bn) tile grid."""
    if (a_act is None) != (b_act is None):
        raise ValueError(
            "CSPADE masks come in pairs: pass both a_act and b_act or neither")
    if a_act is None:
        return
    bm, bk, bn = blocks
    if M % bm or K % bk or N % bn:
        raise ValueError("CSPADE masks require tile-aligned operand shapes")
    want_a, want_b = (M // bm, K // bk), (K // bk, N // bn)
    if tuple(a_act.shape) != want_a or tuple(b_act.shape) != want_b:
        raise ValueError(
            f"CSPADE mask shapes {tuple(a_act.shape)}/{tuple(b_act.shape)} "
            f"do not match the blocks={blocks} tile grid "
            f"(want {want_a}/{want_b}); rebuild the masks on this grid")


def _check_masks_batched(a_act, b_act, G: int, M: int, K: int, N: int,
                         blocks: Blocks):
    """Validate optional batched CSPADE masks against the (G, tile) grid."""
    if (a_act is None) != (b_act is None):
        raise ValueError(
            "CSPADE masks come in pairs: pass both a_act and b_act or neither")
    if a_act is None:
        return
    bm, bk, bn = blocks
    if M % bm or K % bk or N % bn:
        raise ValueError("CSPADE masks require tile-aligned operand shapes")
    want_a = (G, M // bm, K // bk)
    want_b = (G, K // bk, N // bn)
    if tuple(a_act.shape) != want_a or tuple(b_act.shape) != want_b:
        raise ValueError(
            f"batched CSPADE mask shapes {tuple(a_act.shape)}/"
            f"{tuple(b_act.shape)} do not match the blocks={blocks} grid "
            f"(want {want_a}/{want_b}); rebuild the masks on this grid")


def _blocks(blocks: Optional[Blocks], M: int, K: int, N: int) -> Blocks:
    """The tile grid: explicit `blocks`, else the shape-clamped heuristic.
    Only CSPADE masks depend on it; the unmasked math is tile-free."""
    if blocks is not None:
        return tuple(int(b) for b in blocks)
    return autotune.heuristic_blocks(M, K, N)


def _unpack_pair(x_m, x_i, fmt: VPFormat):
    """Either layout -> planes: (words, None) is unpacked to a
    (significand, uint8 index) pair, planes pass through."""
    if x_i is None:
        m, i = unpack_vp(x_m, fmt)
        return m.to(significand_dtype(fmt.M)), i.to(torch.uint8)
    return x_m, x_i


def _require_f32(out_dtype: torch.dtype, what: str) -> None:
    if out_dtype != torch.float32:
        raise ValueError(f"the {what} kernel writes f32, got out_dtype "
                         f"{out_dtype}")


def vp_matmul_batched(a_m, a_i, b_m, b_i, a_fmt: VPFormat, b_fmt: VPFormat,
                      a_act=None, b_act=None,
                      blocks: Optional[Blocks] = None,
                      out_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """(G, M, K) x (G, K, N) VP matmul, one program per batch element.

    Operands are (significand, index) planes or packed words (pass the
    words as `a_m` / `b_m` with `a_i` / `b_i` None); a packed operand
    beside a plane operand is unpacked to planes first.  CSPADE masks
    are per (batch, tile) on the `blocks` grid: a_act (G, M/bm, K/bk),
    b_act (G, K/bk, N/bn).
    """
    G, M, K = a_m.shape
    N = b_m.shape[2]
    blocks = _blocks(blocks, M, K, N)
    _check_masks_batched(a_act, b_act, G, M, K, N, blocks)
    if not uses_kernel(a_m, a_i, b_m, b_i, a_act, b_act):
        if a_i is None and b_i is None:
            return ref.vp_matmul_batched_packed_ref(
                a_m, b_m, a_fmt, b_fmt, a_act=a_act, b_act=b_act,
                tiles=blocks, out_dtype=out_dtype)
        return ref.vp_matmul_batched_ref(
            *_unpack_pair(a_m, a_i, a_fmt), *_unpack_pair(b_m, b_i, b_fmt),
            a_fmt, b_fmt, a_act=a_act, b_act=b_act, tiles=blocks,
            out_dtype=out_dtype)
    _require_f32(out_dtype, "vp_matmul")
    if (a_i is None) != (b_i is None):
        a_m, a_i = _unpack_pair(a_m, a_i, a_fmt)
        b_m, b_i = _unpack_pair(b_m, b_i, b_fmt)
    return vp_matmul_cuda(a_m, a_i, b_m, b_i, a_fmt, b_fmt, a_act, b_act,
                          tiles=blocks)


def vp_quant_matmul_batched(a, b, a_fxp: FXPFormat, a_vp: VPFormat,
                            b_fxp: FXPFormat, b_vp: VPFormat,
                            a_act=None, b_act=None,
                            blocks: Optional[Blocks] = None,
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """Fused quantize + matmul over (G, M, K) x (G, K, N) floats: one
    launch for the whole batch, numerically `vp_quant` then
    `vp_matmul_batched`."""
    contracts.require_quant_safe(a_fxp, a_vp, "vp_quant_matmul_batched")
    contracts.require_quant_safe(b_fxp, b_vp, "vp_quant_matmul_batched")
    G, M, K = a.shape
    N = b.shape[2]
    blocks = _blocks(blocks, M, K, N)
    _check_masks_batched(a_act, b_act, G, M, K, N, blocks)
    if not uses_kernel(a, b, a_act, b_act):
        return ref.vp_quant_matmul_batched_ref(
            a, b, a_fxp, a_vp, b_fxp, b_vp, a_act=a_act, b_act=b_act,
            tiles=blocks, out_dtype=out_dtype)
    _require_f32(out_dtype, "vp_quant_matmul")
    return vp_quant_matmul_cuda(
        a.to(torch.float32), b.to(torch.float32), a_fxp, a_vp, b_fxp, b_vp,
        a_act, b_act, tiles=blocks)


def _one(x):
    """A batch of one (None stays None)."""
    return None if x is None else x[None]


def vp_matmul(a_m, a_i, b_m, b_i, a_fmt: VPFormat, b_fmt: VPFormat,
              a_act=None, b_act=None, blocks: Optional[Blocks] = None,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(M, K) x (K, N) VP matmul; CSPADE masks optional (grid `blocks`):
    `vp_matmul_batched` on a batch of one (on the card, the G = 1 launch
    of the batched kernel)."""
    M, K = a_m.shape
    N = b_m.shape[1]
    blocks = _blocks(blocks, M, K, N)
    _check_masks(a_act, b_act, M, K, N, blocks)
    return vp_matmul_batched(
        a_m[None], _one(a_i), b_m[None], _one(b_i), a_fmt, b_fmt,
        _one(a_act), _one(b_act), blocks, out_dtype)[0]


def _vp_quant_matmul_fwd(a, b, a_fxp, a_vp, b_fxp, b_vp, a_act, b_act,
                         blocks, out_dtype):
    M, K = a.shape
    N = b.shape[1]
    blocks = _blocks(blocks, M, K, N)
    _check_masks(a_act, b_act, M, K, N, blocks)
    return vp_quant_matmul_batched(
        a[None], b[None], a_fxp, a_vp, b_fxp, b_vp, _one(a_act),
        _one(b_act), blocks, out_dtype)[0]


class _VPQuantMatmul(torch.autograd.Function):
    """Counterpart of the reference's `_vp_quant_matmul_vjp`: the
    straight-through estimator takes each quantizer's Jacobian as the
    identity, so da = g qb^T (`vp_matmul_dx` over b's words) and
    db = qa^T g (`vp_matmul_dw` over a's words).  The residuals are the
    QUANTIZED operands as packed words, never float planes."""

    @staticmethod
    def forward(ctx, a, b, a_fxp, a_vp, b_fxp, b_vp, blocks, out_dtype):
        out = _vp_quant_matmul_fwd(a, b, a_fxp, a_vp, b_fxp, b_vp, None,
                                   None, blocks, out_dtype)
        ctx.save_for_backward(vp_quant(a, a_fxp, a_vp, packed=True),
                              vp_quant(b, b_fxp, b_vp, packed=True))
        ctx.formats = (a_vp, b_vp)
        ctx.dtypes = (a.dtype, b.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        a_w, b_w = ctx.saved_tensors
        (a_vp, b_vp), (a_dtype, b_dtype) = ctx.formats, ctx.dtypes
        da = db = None
        if ctx.needs_input_grad[0]:
            da = vp_matmul_dx(g, b_w, b_vp, out_dtype=a_dtype)
        if ctx.needs_input_grad[1]:
            db = vp_matmul_dw(a_w, g, a_vp, out_dtype=b_dtype)
        return da, db, None, None, None, None, None, None


def vp_quant_matmul(a, b, a_fxp: FXPFormat, a_vp: VPFormat,
                    b_fxp: FXPFormat, b_vp: VPFormat,
                    a_act=None, b_act=None, blocks: Optional[Blocks] = None,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fused float -> VP quantize + (M, K) x (K, N) matmul:
    `vp_quant_matmul_batched` on a batch of one.

    Differentiable (unmasked) under the straight-through estimator, with
    both gradients from the packed-word backward kernels; the CSPADE-
    masked call stays forward-only, as in the reference.
    """
    contracts.require_quant_safe(a_fxp, a_vp, "vp_quant_matmul")
    contracts.require_quant_safe(b_fxp, b_vp, "vp_quant_matmul")
    if a_act is None and b_act is None and _wants_grad(a, b):
        return _VPQuantMatmul.apply(a, b, a_fxp, a_vp, b_fxp, b_vp, blocks,
                                    out_dtype)
    return _vp_quant_matmul_fwd(a, b, a_fxp, a_vp, b_fxp, b_vp, a_act,
                                b_act, blocks, out_dtype)


def _vp_dequant_matmul_fwd(x, w, w_fmt, out_dtype):
    if uses_kernel(x, w):
        return vp_dequant_matmul_cuda(x, w, w_fmt, out_dtype)
    return ref.vp_dequant_matmul_ref(x, w, w_fmt, out_dtype=out_dtype)


class _VPDequantMatmul(torch.autograd.Function):
    """Counterpart of the reference's `_vp_dequant_matmul_vjp`: the packed
    words are the residual (`storage_bits` per element, where autograd
    through a dequant would keep the f32 weight plane); dx comes from
    `vp_matmul_dx` over the same words, in x's dtype.  Integer words
    carry no gradient."""

    @staticmethod
    def forward(ctx, x, w, w_fmt, out_dtype):
        ctx.save_for_backward(w)
        ctx.w_fmt, ctx.x_dtype = w_fmt, x.dtype
        return _vp_dequant_matmul_fwd(x, w, w_fmt, out_dtype)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return (vp_matmul_dx(g, w, ctx.w_fmt, out_dtype=ctx.x_dtype),
                None, None, None)


def vp_dequant_matmul(x: torch.Tensor, w: torch.Tensor, w_fmt: VPFormat,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Serving matmul: real x (M, K) @ dequant(w (K, N) packed VP words).

    `out_dtype` defaults to x's dtype.  Differentiable in x (see
    `_VPDequantMatmul`).
    """
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad matmul shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if _wants_grad(x):
        return _VPDequantMatmul.apply(x, w, w_fmt, out_dtype)
    return _vp_dequant_matmul_fwd(x, w, w_fmt, out_dtype)


def vp_matmul_dx(g: torch.Tensor, w: torch.Tensor, w_fmt: VPFormat,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Backward op: g (M, N) @ dequant(w (K, N) packed words)^T -> (M, K).

    The transposed serving matmul, the dx half of every packed-weight
    gradient: the kernel reads the same word plane the forward read, so
    the backward moves `storage_bits` per weight and no f32 weight plane
    or transposed copy exists.
    """
    if g.ndim != 2 or w.ndim != 2 or g.shape[1] != w.shape[1]:
        raise ValueError(f"bad dx shapes g {tuple(g.shape)}, "
                         f"w {tuple(w.shape)}")
    if uses_kernel(g, w):
        return vp_matmul_dx_cuda(g, w, w_fmt, out_dtype)
    return ref.vp_matmul_dx_ref(g, w, w_fmt, out_dtype=out_dtype)


def vp_matmul_dw(a_w: torch.Tensor, g: torch.Tensor, a_fmt: VPFormat,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Backward op: dequant(a_w (M, K) packed words)^T @ g (M, N) ->
    (K, N), contracting over M: the db half of the fused quantize +
    matmul's gradient, over the quantized first operand saved as words.
    """
    if a_w.ndim != 2 or g.ndim != 2 or a_w.shape[0] != g.shape[0]:
        raise ValueError(f"bad dw shapes a {tuple(a_w.shape)}, "
                         f"g {tuple(g.shape)}")
    if uses_kernel(a_w, g):
        return vp_matmul_dw_cuda(a_w, g, a_fmt, out_dtype)
    return ref.vp_matmul_dw_ref(a_w, g, a_fmt, out_dtype=out_dtype)


class _VPQatMatmul(torch.autograd.Function):
    """Counterpart of the reference's `_vp_qat_matmul_vjp`.  Forward:
    quantize the float master weight to one packed word plane, then the
    serving matmul on it.  Residual: (x, packed w_q), never the f32
    weight plane.  Backward (straight-through): dx from `vp_matmul_dx`
    over the same words; dW = x^T g in f32, cast to the master dtype (a
    plain dense contraction outside any kernel, as in the reference)."""

    @staticmethod
    def forward(ctx, x, w, fxp, vp):
        w_q = vp_quant(w.to(torch.float32), fxp, vp, packed=True)
        ctx.save_for_backward(x, w_q)
        ctx.vp, ctx.w_dtype = vp, w.dtype
        return _vp_dequant_matmul_fwd(x, w_q, vp, x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w_q = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = vp_matmul_dx(g, w_q, ctx.vp, out_dtype=x.dtype)
        if ctx.needs_input_grad[1]:
            dw = x.to(torch.float32).t().mm(g.to(torch.float32)).to(
                ctx.w_dtype)
        return dx, dw, None, None


def vp_qat_matmul(x: torch.Tensor, w: torch.Tensor, fxp: FXPFormat,
                  vp: VPFormat) -> torch.Tensor:
    """QAT matmul: x (M, K) @ quantize-then-dequant(w (K, N) float master
    weights), the trainable twin of `vp_dequant_matmul`: the forward runs
    the quant and serving kernels, so training sees the numerics serving
    will run; the backward is straight-through (`_VPQatMatmul`)."""
    contracts.require_quant_safe(fxp, vp, "vp_qat_matmul")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad matmul shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    return _VPQatMatmul.apply(x, w, fxp, vp)


def vp_decode_attention(q, k_w, v_w, k_s, v_s, lengths, fmt: VPFormat,
                        window: Optional[int] = None, rolling: bool = False):
    """Single-token decode attention over a packed VP KV cache.

    q (B, 1, H, dh); k_w / v_w (B, Smax, KV, dh) packed words; k_s / v_s
    (B, Smax, 1, 1) per-position pow2 scales; lengths (B,) valid lengths.
    Only positions in the valid span are read (past `lengths`, outside
    `window`, or past the `rolling` ring's fill level are skipped).
    """
    if not uses_kernel(q, k_w, v_w, k_s, v_s, lengths):
        return ref.vp_decode_attention_ref(
            q, k_w, v_w, k_s, v_s, lengths, fmt, window=window,
            rolling=rolling)
    B, _, H, dh = q.shape
    KV = k_w.shape[2]
    out = vp_decode_attention_cuda(q.reshape(B, KV, H // KV, dh), k_w, v_w,
                                   k_s, v_s, lengths, fmt, window, rolling,
                                   scale=dh ** -0.5)
    return out.reshape(B, 1, H, dh)


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
    if not uses_kernel(q, k, v):
        return ref.flash_prefill_ref(q, k, v, pattern=pattern, window=window)
    return flash_prefill_cuda(
        q, k, v, causal=pattern != "full",
        window=window if pattern == "local" else None,
        scale=_scale_in(q.shape[-1], q.dtype))


@functools.lru_cache(maxsize=64)
def _scale_in(dh: int, dtype: torch.dtype) -> float:
    """dh**-0.5 rounded to `dtype`, the factor the plain path's
    `q * torch.tensor(dh ** -0.5, dtype=q.dtype)` multiplies by."""
    return float(torch.tensor(dh ** -0.5, dtype=dtype))
