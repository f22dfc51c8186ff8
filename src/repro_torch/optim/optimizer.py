"""AdamW with global-norm clipping and a warmup-cosine schedule (port of
`repro.optim.optimizer`).

The state is a tree shaped like the parameters.  The update is
functional, as in the reference: `apply_updates` returns new parameter
and moment tensors and leaves its inputs as they were.

VP-compressed moments (``OptConfig.moment_codec="vp"``): Adam's mu and
nu are high-dynamic-range tensors, the case the paper's format is for.
With the codec on, each moment leaf is kept between steps as packed VP
words plus one f32 pow2 scale (`core.quantize.vp_pack_tensor`, the
`core.packing` layout the serving kernels read): one int8 word each at
the default M = 6, E = 2, so 2 bytes per parameter for both moments
instead of 8.  Each step decodes to f32,
runs the exact Adam recurrence and re-encodes; no error feedback is
carried (the EMA contracts the stored error).  nu is stored as sqrt(nu):
nu spans the square of the gradient's range, so small coordinates would
flush to zero while their mu survives and mhat / (sqrt(0) + eps) would
blow up; sqrt(nu) has mu's range, so both flush together.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.formats import FXPFormat, VPFormat, default_vp_format
from repro_torch.core.quantize import vp_pack_tensor, vp_unpack_tensor
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    # Moment storage: None = f32 tensors; "vp" = packed VP words + a
    # per-leaf pow2 scale between steps (module docstring).
    moment_codec: Optional[str] = None
    moment_M: int = 6              # VP significand bits (incl. sign)
    moment_E: int = 2              # VP exponent-index bits
    moment_W: int = 12             # FXP proxy grid width

    def __post_init__(self):
        if self.moment_codec not in (None, "vp"):
            raise ValueError(
                f"unknown moment codec {self.moment_codec!r}; "
                f"pick None or 'vp'")

    def moment_formats(self) -> Tuple[FXPFormat, VPFormat]:
        fxp = FXPFormat(self.moment_W, self.moment_W - 1)
        return fxp, default_vp_format(fxp, self.moment_M, self.moment_E)


class OptState(NamedTuple):
    step: torch.Tensor             # int32 scalar on the parameters' device
    mu: Any
    nu: Any


def is_packed_moment(leaf) -> bool:
    """A packed moment leaf is the dict {"w": packed words, "s": scale}."""
    return isinstance(leaf, dict) and set(leaf) == {"w", "s"}


def encode_moment(x: torch.Tensor, fxp: FXPFormat, vp: VPFormat) -> dict:
    """f32 moment -> {"w": packed words, "s": pow2 scale}."""
    w, s = vp_pack_tensor(x, fxp, vp)
    return {"w": w, "s": s}


def decode_moment(leaf, vp: VPFormat) -> torch.Tensor:
    """Packed moment leaf (or a plain f32 tensor) -> f32 tensor."""
    if is_packed_moment(leaf):
        return vp_unpack_tensor(leaf["w"], leaf["s"], vp, torch.float32)
    return leaf.to(torch.float32)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at `step` (f32): linear warmup, then cosine decay to
    `min_lr_frac` of the peak."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(params, cfg: Optional[OptConfig] = None) -> OptState:
    """Zero state on the parameters' device.  With moment_codec="vp" the
    moments start as packed zero words (scale 1.0), so the state never
    holds f32 moment tensors."""
    device = tree_leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=device)
    if cfg is not None and cfg.moment_codec == "vp":
        fxp, vp = cfg.moment_formats()

        def zero_moment(p):
            return encode_moment(torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), fxp, vp)

        return OptState(step, tree_map(zero_moment, params),
                        tree_map(zero_moment, params))

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(step, tree_map(zeros, params), tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: OptConfig):
    """One AdamW step -> (new_params, new_state, {"grad_norm", "lr"}).

    The Adam recurrence runs in f32; with moment_codec="vp" the moments
    are decoded on entry and re-encoded after the parameter delta was
    taken from the exact f32 moments.  Only matrices decay.
    """
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    step_f = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** step_f
    bc2 = 1 - cfg.b2 ** step_f
    packed = cfg.moment_codec == "vp"
    if packed:
        m_fxp, m_vp = cfg.moment_formats()

    def upd(p, g, m, v):
        if packed:
            m = decode_moment(m, m_vp)
            v = torch.square(decode_moment(v, m_vp))  # stored as sqrt(nu)
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
        if packed:
            m = encode_moment(m, m_fxp, m_vp)
            v = encode_moment(torch.sqrt(v), m_fxp, m_vp)
        return new_p, m, v

    results = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads),
        tree_leaves(state.mu, is_packed_moment),
        tree_leaves(state.nu, is_packed_moment))]

    def rebuild(i):
        parts = iter([r[i] for r in results])
        return tree_map(lambda _: next(parts), params)

    return rebuild(0), OptState(step, rebuild(1), rebuild(2)), {
        "grad_norm": gnorm, "lr": lr}
