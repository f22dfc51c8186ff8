"""Mixture-of-Experts with top-k token-choice routing and sort-based
dispatch (port of `repro.models.moe`).

Tokens are cut into groups of ~4096 (`_moe_group_count`); each group
sorts its (token, expert) assignments by expert, numbers them within
their expert, drops those past the per-expert capacity C and scatters
the rest into an (E, C, d) buffer.  The three expert products are plain
einsums over the stacked experts, as the reference leaves them to XLA;
a quantized stack is dequantized whole first (`_w`), on the card by one
launch of the packed dequant kernel per stacked weight.

Where the reference's order is not spelled out by its ops, the port
fixes it so that a run gives the same bits every time on the card:
  * top-k breaks ties toward the lower expert, as `jax.lax.top_k` does
    (a stable descending sort; `torch.topk` promises no order);
  * the dispatch sort is stable (`jnp.argsort` is);
  * a token's k weighted expert outputs are summed in a fixed order,
    ascending expert (the order in which the reference's scatter-add
    meets them in the expert-sorted list), not by atomics.
Aux losses: load balance (Switch-style) and router z-loss.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core.quantize import block_vp_dequantize
from repro_torch.kernels import ops
from .layers import canonical_formats, dequant_planes_weight, qdot

NO_QUANT = QuantConfig("none")


def router_probs(x: torch.Tensor, w_router: torch.Tensor, q: QuantConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 router logits (..., E) through an unquantized `qdot`, and
    their softmax."""
    logits = qdot(x.to(torch.float32), w_router, NO_QUANT)
    return logits, torch.softmax(logits, dim=-1)


def _moe_group_count(T: int, target: int = 4096) -> int:
    """Number of dispatch groups: ~`target` tokens each, dividing T."""
    g = max(1, T // target)
    while T % g:
        g -= 1
    return g


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, ties to
    the lower index first (`jax.lax.top_k`'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(Tg: int, k: int, E: int, capacity_factor: float) -> int:
    """Slots per expert and group: the reference's int(max(1, round(.)))
    with Python's round (half to even)."""
    return int(max(1, round(Tg * k / E * capacity_factor)))


def moe_block(x: torch.Tensor, params: Dict, cfg: ModelConfig,
              capacity_factor: float = 1.25, train: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> ((B, S, d), {"load_balance", "router_z"}).

    params: w_router (d, E) f32; w_gate / w_up (E, d, ff) and w_down (E,
    ff, d), float or exported by `quantize_params` with one scale per
    expert.  `train` is accepted for the reference's signature: as
    there, the experts are not fake-quantized."""
    q = cfg.quant
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    T = B * S
    G = _moe_group_count(T)
    Tg = T // G
    xt = x.reshape(G, Tg, d)

    logits, probs = router_probs(xt, params["w_router"], q)   # (G, Tg, E)
    gate_vals, expert_idx = top_k(probs, k)                   # (G, Tg, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # -- aux losses over the full router distribution --------------------
    me = probs.mean(dim=(0, 1))                                # (E,)
    ce = F.one_hot(expert_idx[..., 0], E).to(torch.float32).mean(dim=(0, 1))
    aux = {"load_balance": E * torch.sum(me * ce),
           "router_z": torch.square(torch.logsumexp(logits, dim=-1)).mean()}

    # -- group-local sort-based dispatch with capacity -------------------
    C = capacity(Tg, k, E, capacity_factor)
    dev = x.device
    flat_expert = expert_idx.reshape(G, Tg * k)
    flat_token = torch.arange(Tg, device=dev).repeat_interleave(k)
    flat_gate = gate_vals.reshape(G, Tg * k)
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    se = flat_expert.gather(-1, order)
    stok = flat_token[order]                                   # (G, Tg k)
    sg = flat_gate.gather(-1, order)
    counts = F.one_hot(se, E).sum(dim=1)                       # (G, E)
    starts = torch.cumsum(counts, -1) - counts
    pos = torch.arange(Tg * k, device=dev)[None] - starts.gather(-1, se)
    keep = pos < C
    slot = torch.where(keep, pos, torch.zeros_like(pos))

    gi = torch.arange(G, device=dev)[:, None].expand(G, Tg * k)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    vals = torch.where(keep[..., None], xt.gather(
        1, stok[..., None].expand(G, Tg * k, d)), zero)
    # each kept entry owns its slot; dropped ones add 0 to slot 0, as the
    # reference's .at[].add does
    buf = torch.zeros((G, E, C, d), dtype=x.dtype, device=dev)
    buf.index_put_((gi, se, slot), vals, accumulate=True)

    # -- expert FFNs, each stacked weight dequantized whole and freed -----
    h = buf
    g = torch.einsum("gecd,edf->gecf", h, _w(params["w_gate"], q, h.dtype))
    u = torch.einsum("gecd,edf->gecf", h, _w(params["w_up"], q, h.dtype))
    act = F.silu(g.to(torch.float32)).to(h.dtype) * u
    del g, u
    out_buf = torch.einsum("gecf,efd->gecd", act,
                           _w(params["w_down"], q, h.dtype))

    # -- combine: each token's k outputs, by ascending expert -------------
    gathered = out_buf[gi, se, slot]                           # (G, Tg k, d)
    gathered = torch.where(keep[..., None], gathered, zero)
    contrib = gathered.to(torch.float32) * sg[..., None]
    # back to (token, k) through the inverse permutation; sorted by expert
    # within a token (its entries meet the scatter in that order)
    inv = torch.argsort(order, dim=-1)
    by_token = contrib.gather(1, inv[..., None].expand(G, Tg * k, d))
    by_token = by_token.reshape(G, Tg, k, d)
    rank = torch.argsort(expert_idx, dim=-1)                   # (G, Tg, k)
    by_token = by_token.gather(2, rank[..., None].expand(G, Tg, k, d))
    out = torch.zeros((G, Tg, d), dtype=torch.float32, device=dev)
    for r in range(k):
        out = out + by_token[:, :, r]
    return out.reshape(B, S, d).to(x.dtype), aux


def _w(wq, q: QuantConfig, dtype: torch.dtype) -> torch.Tensor:
    """A stacked expert weight (E, d_in, d_out) as a float tensor for the
    einsums: float weights cast; packed words through `ops.vp_dequant`
    (one launch for the whole stack on the card) times each expert's
    scale; planes and block VP expert by expert (the index layouts are
    per matrix); FXP int8 times its scale.  The products round as the
    reference's (the scales are powers of two)."""
    if not isinstance(wq, dict):
        return wq.to(dtype)
    scale = wq["scale"].to(dtype)
    if "w_packed" in wq:
        _, vp = canonical_formats(q)
        w = wq["w_packed"]
        return ops.vp_dequant(w, None, vp, dtype) * scale.reshape(
            (-1,) + (1,) * (w.ndim - 1))
    m = wq["m"]
    scale = scale.reshape((-1,) + (1,) * (m.ndim - 1))
    one = torch.ones((), dtype=torch.float32, device=m.device)
    if "i_packed" in wq:
        return torch.stack([
            dequant_planes_weight({"m": me, "i_packed": ie, "scale": one}, q,
                                  dtype)
            for me, ie in zip(m, wq["i_packed"])]) * scale
    if "i_blk" in wq:
        _, vp = canonical_formats(q)
        return torch.stack([
            block_vp_dequantize(me, ie, vp, q.block, axis=0, dtype=dtype)
            for me, ie in zip(m, wq["i_blk"])]) * scale
    return m.to(dtype) * scale
