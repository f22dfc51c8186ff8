"""The B-VP MVM engine: complex equalization through the VP x VP
kernels (paper Fig. 9c / Fig. 10; port of `repro.mimo.mvm_engine`).

`equalizer.equalize_quantized` models the designs numerically (a
fake-quant einsum); this module runs the same computation through the
kernel ops.  Two execution modes:

  * ``mode="batched"`` (default): realization g runs its own (2U, B) x
    (B, 2) product on the batched kernel: the A operand stacks the W
    re/im planes along rows, the B operand holds [y_re, y_im] as two
    columns, so one launch produces all four real products of the
    paper's 4-RM complex multiplier for every realization (8 n U B
    FLOPs).
  * ``mode="masked"`` (legacy parity oracle): realizations are folded
    into a tall (n U, B) x (B, n) matmul and each row's own realization
    column is selected afterwards (8 n^2 U B FLOPs).  On the card these
    are the G = 1 launches of the same kernels, which `mm_body`
    (`kernels/vp_matmul.py`) runs on their register-tiled body; the
    batched launches run on the warp body.  Both bodies sum each output
    in the same order, so the numbers do not depend on the choice.

Both quantize re/im planes to VP (`ops.vp_quant`, or in registers by the
fused kernel), run the complex MVM as 4 real VP products, and can mute
quiet tiles with CSPADE activity masks (per realization in batched mode).

Fused vs unfused (`fused=None`): the fused kernel is taken when no CSPADE
masks are asked for (their calibration needs the quantized planes), the
output grid is at most 4 tiles per axis, and the operands run on the
kernels: on the card unless `ops.force_backend("ref")` is in force.  The
CPU runs the unfused plain path, as the reference's ref backend does.
The numbers are the same on every path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.formats import FXPFormat, VPFormat
from repro_torch.kernels import autotune, ops, ref
from .equalizer import EqualizerSpec, f32


def _vp_planes(x, gain, fxp: FXPFormat, vp: VPFormat):
    return ops.vp_quant(x * f32(gain, x.device), fxp, vp)


def _decision_tiles(blocks, M: int, K: int, N: int):
    """Tiles of the fused-vs-unfused decision: explicit blocks, else the
    shape-clamped heuristic."""
    return blocks if blocks is not None else autotune.heuristic_blocks(M, K, N)


def _div_tile(sz: int, target: int) -> int:
    """Largest divisor of `sz` that is <= target."""
    t = min(target, sz)
    while sz % t:
        t -= 1
    return t


def _mask_tiles(blocks, M: int, K: int, N: int) -> Tuple[int, int, int]:
    """Tile grid of the CSPADE paths: explicit blocks win; otherwise the
    heuristic snapped down to exact divisors of the operand shape."""
    if blocks is not None:
        return tuple(blocks)
    h = autotune.heuristic_blocks(M, K, N)
    return (_div_tile(M, h[0]), _div_tile(K, h[1]), _div_tile(N, h[2]))


def _pick_fused(fused: Optional[bool], cspade_q, nm: int, nn: int,
                operand: torch.Tensor) -> bool:
    """The fused-vs-unfused policy (see the module docstring)."""
    if fused is not None:
        return fused
    return cspade_q is None and max(nm, nn) <= 4 and ops.uses_kernel(operand)


def _rpad(g, ndim: int, device) -> torch.Tensor:
    """A gain as f32, right-padded with 1s to broadcast over trailing
    dims."""
    g = torch.as_tensor(g, dtype=torch.float32, device=device)
    return g.reshape(tuple(g.shape) + (1,) * (ndim - g.ndim))


def quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """`jnp.quantile(x, q)` (method "linear") over all elements, as the
    reference computes it in f32: position q * (n - 1) in f32, the two
    neighbouring order statistics lo, hi and their interpolation, which
    XLA contracts to fma(hi, w_hi, lo * w_lo) (the f64 sum below rounds
    like that fma).  Returns a 0-dim f32 tensor.  Sorts instead of
    `torch.quantile`, which refuses more than 2^24 elements."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    pos = torch.tensor(q, dtype=torch.float32) * (
        torch.tensor(float(n), dtype=torch.float32) - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    lo = int(torch.clamp(low, 0, n - 1))
    hi = int(torch.clamp(high, 0, n - 1))
    srt = torch.sort(flat).values
    low_part = srt[lo] * lw.to(flat.device)
    return (srt[hi].double() * hw.double().to(flat.device)
            + low_part.double()).to(torch.float32)


def stack_complex_operands(w: torch.Tensor, y: torch.Tensor,
                           w_gain=1.0, y_gain=1.0):
    """Pack a complex MVM batch into the 4-RM batched-kernel operands.

    w (..., U, B) complex, y (..., B) complex; gains are scalars or
    tensors broadcasting over the leading dims (per-subcarrier (S,) for
    (S, n, U, B) operands), applied in f32.  Returns a (..., 2U, B) =
    [W_re; W_im] rows and b (..., B, 2) = [y_re, y_im] columns.
    """
    wg = _rpad(w_gain, w.ndim, w.device)
    yg = _rpad(y_gain, y.ndim, y.device)
    wr = w.real.to(torch.float32) * wg
    wi = w.imag.to(torch.float32) * wg
    yr = y.real.to(torch.float32) * yg
    yi = y.imag.to(torch.float32) * yg
    return torch.cat([wr, wi], dim=-2), torch.stack([yr, yi], dim=-1)


def combine_products(out: torch.Tensor, gain=1.0) -> torch.Tensor:
    """(..., 2U, 2) raw 4-RM products -> complex (..., U) estimates, with
    the w_gain * y_gain product (scalar or over the leading dims) divided
    back out."""
    U = out.shape[-2] // 2
    g = _rpad(gain, out.ndim - 1, out.device)
    re = (out[..., :U, 0] - out[..., U:, 1]) / g     # Wr yr - Wi yi
    im = (out[..., :U, 1] + out[..., U:, 0]) / g     # Wr yi + Wi yr
    return torch.complex(re, im)


def batched_complex_mvm(
    a: torch.Tensor,            # (G, 2U, B) float: stacked [W_re; W_im]
    b: torch.Tensor,            # (G, B, 2) float: [y_re, y_im] columns
    fxp_w: FXPFormat, vp_w: VPFormat,
    fxp_y: FXPFormat, vp_y: VPFormat,
    cspade_threshold_quantile: Optional[float] = None,
    fused: Optional[bool] = None,
    blocks: Optional[tuple] = None,
) -> torch.Tensor:
    """All four real products of G complex MVMs in one batched launch.

    Operands are already AGC-scaled into the formats' ranges.  Returns
    the raw (G, 2U, 2) products; with U = rows / 2:
      out[:, :U, 0] = W_re y_re   out[:, :U, 1] = W_re y_im
      out[:, U:, 0] = W_im y_re   out[:, U:, 1] = W_im y_im
    The mask-free unfused path quantizes to packed VP words.
    """
    G, M, K = a.shape
    N = b.shape[-1]
    dt = _decision_tiles(blocks, M, K, N)
    fused = _pick_fused(fused, cspade_threshold_quantile,
                        -(-M // dt[0]), -(-N // dt[2]), a)

    if fused:
        if cspade_threshold_quantile is not None:
            raise ValueError(
                "fused path has no materialized planes to calibrate masks on")
        return ops.vp_quant_matmul_batched(
            a, b, fxp_w, vp_w, fxp_y, vp_y, blocks=blocks)

    if cspade_threshold_quantile is None:
        a_w = ops.vp_quant(a, fxp_w, vp_w, packed=True)
        b_w = ops.vp_quant(b, fxp_y, vp_y, packed=True)
        return ops.vp_matmul_batched(a_w, None, b_w, None, vp_w, vp_y,
                                     blocks=blocks)

    # CSPADE calibration needs the (m, i) planes, and the masks pin the
    # tile grid: resolve it here and pass it down.
    tiles = _mask_tiles(blocks, M, K, N)
    a_m, a_i = ops.vp_quant(a, fxp_w, vp_w)
    b_m, b_i = ops.vp_quant(b, fxp_y, vp_y)
    q = cspade_threshold_quantile
    ta = quantile_linear(a.abs(), q)
    tb = quantile_linear(b.abs(), q)
    a_act, b_act = ref.cspade_tile_masks_batched(
        ref.vp_dequant_ref(a_m, a_i, vp_w), ref.vp_dequant_ref(b_m, b_i, vp_y),
        *tiles, ta, tb)
    return ops.vp_matmul_batched(a_m, a_i, b_m, b_i, vp_w, vp_y,
                                 a_act=a_act, b_act=b_act, blocks=tiles)


def _equalize_batched(spec: EqualizerSpec, w, y, cspade_threshold_quantile,
                      fused, blocks=None):
    a, b = stack_complex_operands(w, y, spec.w_gain, spec.y_gain)
    out = batched_complex_mvm(
        a, b, spec.w_fxp, spec.w_vp, spec.y_fxp, spec.y_vp,
        cspade_threshold_quantile=cspade_threshold_quantile, fused=fused,
        blocks=blocks)
    return combine_products(out, spec.w_gain * spec.y_gain)   # (n, U)


def _equalize_masked(spec: EqualizerSpec, w, y, cspade_threshold_quantile,
                     fused, blocks=None):
    """Legacy masked-diagonal path, the parity oracle of the batched
    grid: fold realizations into the row axis, run (nU, B) x (B, n),
    select each row's own realization column."""
    n, U, B = w.shape
    fxp_y, vp_y = spec.y_fxp, spec.y_vp
    fxp_w, vp_w = spec.w_fxp, spec.w_vp
    gw, gy = f32(spec.w_gain, w.device), f32(spec.y_gain, w.device)

    wr = w.real.reshape(n * U, B).to(torch.float32)
    wi = w.imag.reshape(n * U, B).to(torch.float32)
    yr = y.real.T.to(torch.float32)   # (B, n)
    yi = y.imag.T.to(torch.float32)

    M, K = wr.shape
    N = yr.shape[1]
    dt = _decision_tiles(blocks, M, K, N)
    fused = _pick_fused(fused, cspade_threshold_quantile,
                        -(-M // dt[0]), -(-N // dt[2]), wr)

    if fused:
        if cspade_threshold_quantile is not None:
            raise ValueError(
                "fused path has no materialized planes to calibrate masks on")

        def mmf(a_f, b_f):
            return ops.vp_quant_matmul(a_f, b_f, fxp_w, vp_w, fxp_y, vp_y,
                                       blocks=blocks)

        wrg, wig, yrg, yig = wr * gw, wi * gw, yr * gy, yi * gy
        rr, ii = mmf(wrg, yrg), mmf(wig, yig)     # (nU, n)
        ri, ir = mmf(wrg, yig), mmf(wig, yrg)
    elif cspade_threshold_quantile is None:
        def words(x, g, fxp, vp):
            return ops.vp_quant(x * g, fxp, vp, packed=True)

        wr_w, wi_w = words(wr, gw, fxp_w, vp_w), words(wi, gw, fxp_w, vp_w)
        yr_w, yi_w = words(yr, gy, fxp_y, vp_y), words(yi, gy, fxp_y, vp_y)

        def mmp(aw, bw):
            return ops.vp_matmul(aw, None, bw, None, vp_w, vp_y,
                                 blocks=blocks)

        rr, ii = mmp(wr_w, yr_w), mmp(wi_w, yi_w)
        ri, ir = mmp(wr_w, yi_w), mmp(wi_w, yr_w)
    else:
        tiles = _mask_tiles(blocks, M, K, N)
        wr_m, wr_i = _vp_planes(wr, spec.w_gain, fxp_w, vp_w)
        wi_m, wi_i = _vp_planes(wi, spec.w_gain, fxp_w, vp_w)
        yr_m, yr_i = _vp_planes(yr, spec.y_gain, fxp_y, vp_y)
        yi_m, yi_i = _vp_planes(yi, spec.y_gain, fxp_y, vp_y)

        q = cspade_threshold_quantile
        ta = quantile_linear(wr.abs() * gw, q)
        tb = quantile_linear(yr.abs() * gy, q)
        wd = ref.vp_dequant_ref(wr_m, wr_i, vp_w) * gw
        yd = ref.vp_dequant_ref(yr_m, yr_i, vp_y) * gy
        a_act, b_act = ref.cspade_tile_masks(wd, yd, *tiles, ta, tb)

        def mm(am, ai, bm_, bi):
            return ops.vp_matmul(am, ai, bm_, bi, vp_w, vp_y, a_act=a_act,
                                 b_act=b_act, blocks=tiles)

        rr, ii = mm(wr_m, wr_i, yr_m, yr_i), mm(wi_m, wi_i, yi_m, yi_i)
        ri, ir = mm(wr_m, wr_i, yi_m, yi_i), mm(wi_m, wi_i, yr_m, yr_i)

    g = f32(spec.w_gain * spec.y_gain, w.device)
    re = (rr - ii) / g
    im = (ri + ir) / g
    rows = torch.arange(n * U, device=w.device)
    cols = rows // U
    return torch.complex(re[rows, cols], im[rows, cols]).reshape(n, U)


def equalize_vp_kernel(
    spec: EqualizerSpec,
    w: torch.Tensor,            # (n, U, B) complex
    y: torch.Tensor,            # (n, B) complex
    cspade_threshold_quantile: Optional[float] = None,
    fused: Optional[bool] = None,
    mode: str = "batched",
    blocks: Optional[tuple] = None,
) -> torch.Tensor:
    """s_hat (n, U) complex through the VP kernel path.

    "batched" runs each realization as its own program of the batched
    kernel; "masked" is the folded (nU, B) x (B, n) matmul with diagonal
    selection.  Mask-free runs agree across modes; with
    `cspade_threshold_quantile` set each mode mutes on its own tile
    geometry.
    """
    if not spec.is_vp:
        raise ValueError(f"{spec.name} is not a VP design")
    if mode == "batched":
        return _equalize_batched(spec, w, y, cspade_threshold_quantile,
                                 fused, blocks)
    if mode == "masked":
        return _equalize_masked(spec, w, y, cspade_threshold_quantile,
                                fused, blocks)
    raise ValueError(f"unknown mode {mode!r} (want 'batched' or 'masked')")


def mvm_flops(n: int, U: int, B: int, mode: str = "batched") -> int:
    """Real-MAC FLOP count of one complex equalization batch: 8 n U B
    batched, 8 n^2 U B masked."""
    if mode == "batched":
        return 8 * n * U * B
    if mode == "masked":
        return 8 * n * n * U * B
    raise ValueError(f"unknown mode {mode!r}")
