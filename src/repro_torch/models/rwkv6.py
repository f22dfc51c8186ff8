"""RWKV6 ("Finch") layer (port of `repro.models.rwkv6`): linear attention
with a data-dependent per-channel decay.

TimeMix: token-shift lerp, then the R/K/V/G projections and the low-rank
data-dependent decay w_t = exp(-exp(w0 + tanh(x W_a) W_b)); per head the
WKV recurrence
  S_t = diag(w_t) S_{t-1} + k_t (x) v_t
  y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
runs chunk by chunk (chunks of 16) so every exponential stays within f32
range: log-decays are clipped to [-LOG_W_MIN, -1e-4], so the largest
positive exponent is 16 * 4 = 64 and exp() stays below 6.3e27.

ChannelMix: token shift, then a squared-ReLU FFN gated by a receptance.
Every projection goes through `qdot`; the decay's low-rank product is an
f32 matmul outside it, as in the reference, taken a row at a time
(`layers.per_row`), as is the one-step recurrence's read of the state,
so that a row's bits do not depend on its batch.  The lerp `x + xx * mu`
promotes a bf16 x to f32 (mu is f32), so in a bf16 model the R/K/V/G and
the channel mix's key and receptance projections take f32 activations,
as the reference's do.

The scans are plain PyTorch (the reference leaves them to XLA outside
any Pallas call).  A decode state {"s", "last_tm", "last_cm"} is updated
IN PLACE (`copy_`): the serving engine reads a prefill's results from the
tensors it handed in, and its CUDA graphs need fixed addresses.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import per_row, qdot, rms_norm, row_sum

CHUNK = 16
LOG_W_MIN = 4.0  # decay clip: log w in [-4, -1e-4]
HEAD_DIM = 64


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor] = None):
    """The x_{t-1} stream; `last` (B, 1, d) carries x_{t-1} across calls
    (zeros without it)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _wkv_chunked(r, k, v, logw, u, s0=None):
    """Chunked WKV6: r / k / v / logw (B, S, H, N), u (H, N) ->
    (y (B, S, H, N) f32, s_final (B, H, N, N) f32).  Chunks of the
    largest divisor of S up to CHUNK; within a chunk a strict-lower
    attention plus the `u` diagonal, across chunks the state."""
    B, S, H, N = r.shape
    Q = min(CHUNK, S)
    while S % Q:       # largest divisor of S <= CHUNK
        Q -= 1
    nc = S // Q
    f32 = torch.float32
    r, k, v, logw = (t.reshape(B, nc, Q, H, N).to(f32)
                     for t in (r, k, v, logw))
    dev = r.device
    tri_strict = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                       device=dev), diagonal=-1)
    eye = torch.eye(Q, dtype=f32, device=dev)
    s = (torch.zeros((B, H, N, N), dtype=f32, device=dev) if s0 is None
         else s0.to(f32))
    ys = []
    for ci in range(nc):
        r_c, k_c, v_c, lw_c = r[:, ci], k[:, ci], v[:, ci], logw[:, ci]
        cum = torch.cumsum(lw_c, dim=1)                  # inclusive
        ecum = cum - lw_c                                # exclusive
        r_dec = r_c * torch.exp(ecum)                    # bounded by |r|
        k_grow = k_c * torch.exp(-cum)                   # by exp(Q * 4)
        y1 = torch.einsum("bqhn,bhnp->bqhp", r_dec, s)
        att = torch.einsum("bqhn,bkhn->bqkh", r_dec, k_grow)
        att = torch.where(tri_strict[None, :, :, None], att, 0.0)
        diag = torch.einsum("bqhn,bqhn->bqh", r_c * u[None, None], k_c)
        att = att + diag[:, :, None, :] * eye[None, :, :, None]
        y2 = torch.einsum("bqkh,bkhp->bqhp", att, v_c)
        dec_all = torch.exp(cum[:, -1])                  # (B, H, N)
        k_rem = k_c * torch.exp(cum[:, -1:] - cum)       # (B, Q, H, N)
        s = s * dec_all[..., None] + torch.einsum("bqhn,bqhp->bhnp",
                                                  k_rem, v_c)
        ys.append(y1 + y2)
    return torch.stack(ys, dim=1).reshape(B, S, H, N), s


def rwkv6_time_mix(x, params, cfg: ModelConfig,
                   state: Optional[dict] = None, train: bool = False
                   ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, d) -> ((B, S, d), state).  With a state {"s", "last_tm",
    ...}: S > 1 runs the chunked scan from "s" (a prefill, or a prompt
    chunk), S = 1 the single-step recurrence; both write the new "s" and
    "last_tm" into the state's tensors."""
    q = cfg.quant
    B, S, d = x.shape
    H, N = d // HEAD_DIM, HEAD_DIM

    last = state["last_tm"][:, None] if state is not None else None
    xx = _token_shift(x, last) - x

    def mix(name):
        return x + xx * params[f"mu_{name}"]

    r = qdot(mix("r"), params["w_r"], q, train).reshape(B, S, H, N)
    k = qdot(mix("k"), params["w_k"], q, train).reshape(B, S, H, N)
    v = qdot(mix("v"), params["w_v"], q, train).reshape(B, S, H, N)
    g = qdot(mix("g"), params["w_g"], q, train)
    # data-dependent decay (low rank), f32 outside `qdot`
    wlora = per_row(lambda m: torch.tanh(m @ params["w_dec_a"])
                    @ params["w_dec_b"], mix("w"))
    logw = -torch.exp(params["w_dec0"] + wlora.to(torch.float32))
    logw = torch.clamp(logw, -LOG_W_MIN, -1e-4).reshape(B, S, H, N)

    if state is None or S > 1:
        s0 = state["s"] if state is not None else None
        y, s_fin = _wkv_chunked(r, k, v, logw, params["u_bonus"], s0=s0)
    else:
        s_prev = state["s"]
        r1, k1, v1 = (t[:, 0].to(torch.float32) for t in (r, k, v))
        lw1 = logw[:, 0]
        bonus = row_sum(r1 * params["u_bonus"][None] * k1)
        read = per_row(lambda r, s: torch.einsum("bhn,bhnp->bhp", r, s),
                       r1, s_prev)
        y = (read + bonus * v1)[:, None]
        s_fin = (s_prev * torch.exp(lw1)[..., None]
                 + torch.einsum("bhn,bhp->bhnp", k1, v1))
    if state is not None:
        state["s"].copy_(s_fin)
        state["last_tm"].copy_(x[:, -1])

    # per-head norm (each head's N channels), then the gate
    y4 = rms_norm(y.reshape(B, S, H, N), params["ln_x"].reshape(H, N))
    y = y4.reshape(B, S, d)
    y = y * F.silu(g.to(torch.float32)).to(x.dtype)
    return qdot(y.to(x.dtype), params["w_o"], q, train), state


def rwkv6_channel_mix(x, params, cfg: ModelConfig,
                      state: Optional[dict] = None, train: bool = False
                      ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, d) -> ((B, S, d), state); writes "last_cm" in place."""
    q = cfg.quant
    last = state["last_cm"][:, None] if state is not None else None
    xx = _token_shift(x, last) - x
    xk = x + xx * params["mu_ck"]
    xr = x + xx * params["mu_cr"]
    kk = qdot(xk, params["w_ck"], q, train)
    kk = torch.square(torch.relu(kk.to(torch.float32))).to(x.dtype)
    rr = torch.sigmoid(
        qdot(xr, params["w_cr"], q, train).to(torch.float32)).to(x.dtype)
    out = rr * qdot(kk, params["w_cv"], q, train)
    if state is not None:
        state["last_cm"].copy_(x[:, -1])
    return out, state
