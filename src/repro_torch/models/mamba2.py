"""Mamba2 (SSD) layer (port of `repro.models.mamba2`): a chunked
state-space-dual scan for training and prefill, the O(1)-state
recurrence for decode.

The block: four separate input projections (z, x, B, C, dt; B and C in
one), a short causal depthwise conv over (x, B, C), a per-head scalar
decay A, SSD with head dim P and state N, the skip D, a gated RMSNorm
and the output projection.  Every projection goes through `qdot`.  The
chunked SSD takes exponentials of non-positive cumulative-decay
differences only, so its factors lie in (0, 1].

The scans and the conv are plain PyTorch (the reference leaves them to
XLA outside any Pallas call).  A decode state {"h", "conv"} is updated
IN PLACE (`copy_`), as in `models.rwkv6`, and the recurrence's read of
the state is taken a row at a time (`layers.per_row`), so that a row's
bits do not depend on its batch.  As in the reference, a
multi-token call with a state (a prefill or a prompt chunk) zero-pads
its conv and ignores the conv history it is given; only a one-token call
reads it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import per_row, qdot, rms_norm

D_CONV = 4  # short-conv width


def mamba2_dims(cfg: ModelConfig):
    """(d_inner, state N, heads H, head dim P, conv channels, in-proj
    width)."""
    di = cfg.d_inner
    n = cfg.ssm_state
    h = cfg.ssm_nheads
    p = cfg.ssm_headdim
    conv_dim = di + 2 * n
    proj_dim = 2 * di + 2 * n + h
    return di, n, h, p, conv_dim, proj_dim


def _causal_conv(x, w, b):
    """Depthwise causal conv: x (B, S, C), w (D_CONV, C), b (C,)."""
    S = x.shape[1]
    pad = F.pad(x, (0, 0, D_CONV - 1, 0))
    out = sum(pad[:, t: t + S, :] * w[t] for t in range(D_CONV))
    return out + b


def _ssd_chunked(xdt, dA, b, c, chunk: int, h0=None):
    """Chunked SSD scan: xdt (B, S, H, P) inputs times dt, dA (B, S, H)
    log-decay increments (<= 0), b / c (B, S, N) (one SSM group) ->
    (y (B, S, H, P) f32, h_final (B, H, P, N) f32).  Chunks of the
    largest divisor of S up to `chunk`."""
    B, S, H, P = xdt.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    while S % Q:       # largest divisor of S <= chunk
        Q -= 1
    nc = S // Q
    f32 = torch.float32
    xdt = xdt.reshape(B, nc, Q, H, P).to(f32)
    dA = dA.reshape(B, nc, Q, H).to(f32)
    b = b.reshape(B, nc, Q, N).to(f32)
    c = c.reshape(B, nc, Q, N).to(f32)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=xdt.device))
    h = (torch.zeros((B, H, P, N), dtype=f32, device=xdt.device)
         if h0 is None else h0.to(f32))
    ys = []
    for ci in range(nc):
        x_c, dA_c, b_c, c_c = xdt[:, ci], dA[:, ci], b[:, ci], c[:, ci]
        cum = torch.cumsum(dA_c, dim=1)                   # (B, Q, H)
        y1 = (torch.einsum("bqn,bhpn->bqhp", c_c, h)
              * torch.exp(cum)[..., None])
        g = torch.einsum("bqn,bkn->bqk", c_c, b_c)        # (B, Q, Q)
        ldec = torch.exp(torch.where(
            tri[None, :, :, None], cum[:, :, None, :] - cum[:, None, :, :],
            -torch.inf))                                  # (B, Q, Q, H)
        y2 = torch.einsum("bqkh,bkhp->bqhp", g[..., None] * ldec, x_c)
        dec_rem = torch.exp(cum[:, -1:, :] - cum)         # (B, Q, H)
        h = (h * torch.exp(cum[:, -1])[:, :, None, None]
             + torch.einsum("bqn,bqhp->bhpn", b_c,
                            x_c * dec_rem[..., None]))
        ys.append(y1 + y2)
    return torch.stack(ys, dim=1).reshape(B, S, H, P), h


def _softplus(x):
    """log(1 + e^x) as `jax.nn.softplus` writes it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba2_block(x, params, cfg: ModelConfig,
                 state: Optional[dict] = None, train: bool = False
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, d) -> ((B, S, d), state).  With a state {"h", "conv"}:
    S > 1 runs the chunked scan from "h" (conv zero-padded), S = 1 the
    single-step recurrence over the rolled conv history; both write the
    new "h" and "conv" into the state's tensors."""
    q = cfg.quant
    B, S, _ = x.shape
    di, n, nh, p, _, _ = mamba2_dims(cfg)

    z = qdot(x, params["w_z"], q, train)
    xin = qdot(x, params["w_x"], q, train)
    bc = qdot(x, params["w_bc"], q, train)
    dt = qdot(x, params["w_dt"], q, train)
    xbc = torch.cat([xin, bc], dim=-1)      # (x, B, C)

    prefill = state is not None and S > 1
    if state is None or prefill:
        new_conv = None
        if prefill:
            tail = xbc[:, -(D_CONV - 1):]
            pad = (D_CONV - 1) - tail.shape[1]
            new_conv = F.pad(tail, (0, 0, pad, 0)) if pad else tail
        xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    else:
        hist = torch.cat([state["conv"], xbc], dim=1)    # (B, D_CONV, C)
        xbc = (torch.einsum("btc,tc->bc", hist.to(torch.float32),
                            params["conv_w"]) + params["conv_b"])[:, None]
        new_conv = hist[:, 1:]
    xbc = F.silu(xbc.to(torch.float32)).to(x.dtype)
    xin, b, c = torch.split(xbc, [di, n, n], dim=-1)

    dt = _softplus(dt.to(torch.float32) + params["dt_bias"])   # (B, S, H)
    a = -torch.exp(params["a_log"].to(torch.float32))          # (H,)
    dA = dt * a                                                # <= 0
    xh = xin.reshape(B, S, nh, p).to(torch.float32)
    xdt = xh * dt[..., None]

    if state is None or prefill:
        h0 = state["h"] if prefill else None
        y, h_fin = _ssd_chunked(xdt, dA, b, c, cfg.ssm_chunk, h0=h0)
    else:
        dec = torch.exp(dA[:, 0])                              # (B, H)
        h_fin = (state["h"] * dec[..., None, None]
                 + torch.einsum("bn,bhp->bhpn", b[:, 0].to(torch.float32),
                                xdt[:, 0]))
        y = per_row(lambda cr, h: torch.einsum("bn,bhpn->bhp", cr, h),
                    c[:, 0].to(torch.float32), h_fin)[:, None]
    if state is not None:
        state["h"].copy_(h_fin)
        state["conv"].copy_(new_conv)

    y = y + xh * params["d_skip"][None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype)
    y = y * F.silu(z.to(torch.float32)).to(x.dtype)
    y = rms_norm(y, params["out_norm"])
    return qdot(y, params["w_out"], q, train), state
