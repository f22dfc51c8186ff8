"""LoS mmWave massive-MIMO channel generator (port of `repro.mimo.channel`).

Each UE contributes a dominant direct path plus a few weak scattered
clusters (Rician), with half-wavelength ULA steering vectors, so the
channels are approximately sparse in beamspace (the paper's Fig. 7).
Every random function is a draw step (an explicit `torch.Generator`)
followed by a deterministic function of the draws, which the tests feed
with the reference's own draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    B: int = 64                 # BS antennas (ULA, lambda/2 spacing)
    U: int = 8                  # single-antenna UEs
    n_clusters: int = 4         # scattered clusters per UE (LoS: weak)
    rician_k_db: float = 15.0   # LoS-to-scatter power ratio
    sector_deg: float = 60.0    # UE angles uniform in +-sector
    los: bool = True            # LoS vs non-LoS conditions
    angle_spread_deg: float = 7.5   # per-cluster angular spread around UE


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def steering(b: int, sin_theta: torch.Tensor) -> torch.Tensor:
    """ULA steering vector(s) a(theta): exp(j*pi*sin(theta)*[0..B-1])."""
    n = torch.arange(b, dtype=torch.float32, device=sin_theta.device)
    phase = math.pi * sin_theta[..., None] * n
    return torch.polar(torch.ones_like(phase), phase)


def channel_draws(gen: torch.Generator, cfg: ChannelConfig, n: int
                  ) -> Dict[str, torch.Tensor]:
    """The random numbers of `generate_channels`, on the generator's
    device: UE angles in degrees, cluster angle offsets and path gains
    (standard normals), LoS phases in [0, 2 pi)."""
    dev = gen.device
    U, C = cfg.U, cfg.n_clusters

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=gen, device=dev)
        return u * (hi - lo) + lo

    return {
        "angle_deg": uniform((n, U), -cfg.sector_deg, cfg.sector_deg),
        "d_ang": torch.randn((n, U, C), generator=gen, device=dev),
        "g": torch.randn((n, U, C, 2), generator=gen, device=dev),
        "phi": uniform((n, U), 0.0, 2 * math.pi),
    }


def channels_from_draws(cfg: ChannelConfig, angle_deg: torch.Tensor,
                        d_ang: torch.Tensor, g: torch.Tensor,
                        phi: torch.Tensor) -> torch.Tensor:
    """n antenna-domain channel matrices (n, B, U) complex64 from the
    draws of `channel_draws`.

    Columns have unit average per-antenna gain (E[|h_bu|^2] = 1), the
    paper's per-stream SNR convention.  f32 arithmetic in the
    reference's order.
    """
    dev = angle_deg.device
    s = torch.sin(torch.deg2rad(angle_deg.to(torch.float32)))
    spread = torch.deg2rad(_f32(cfg.angle_spread_deg, dev))
    d = d_ang.to(torch.float32) * spread
    s_cl = torch.clamp(s[..., None] + torch.sin(d), -1.0, 1.0)
    k_lin = 10.0 ** (cfg.rician_k_db / 10.0)
    p_los = k_lin / (1.0 + k_lin) if cfg.los else 0.0
    p_cl = 1.0 - p_los
    decay = torch.exp(-torch.arange(cfg.n_clusters, device=dev) / 1.5)
    p_k = p_cl * decay / decay.sum()
    g_cl = g.to(torch.float32) * torch.sqrt(_f32(0.5, dev))
    g_cl = torch.complex(g_cl[..., 0], g_cl[..., 1]) * torch.sqrt(p_k)
    g_los = torch.sqrt(_f32(p_los, dev)) * torch.polar(
        torch.ones_like(phi, dtype=torch.float32), phi.to(torch.float32))
    a_los = steering(cfg.B, s)                  # (n, U, B)
    a_cl = steering(cfg.B, s_cl)                # (n, U, C, B)
    h = g_los[..., None] * a_los + torch.einsum("nuc,nucb->nub", g_cl, a_cl)
    return h.transpose(1, 2).contiguous()       # (n, B, U)


def generate_channels(gen: torch.Generator, cfg: ChannelConfig, n: int
                      ) -> torch.Tensor:
    """n antenna-domain channels (n, B, U) complex64 on gen's device."""
    return channels_from_draws(cfg, **channel_draws(gen, cfg, n))


def awgn_draws(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    """Standard normals (shape + (2,)) for `awgn_from_draws`."""
    return torch.randn(tuple(shape) + (2,), generator=gen, device=gen.device)


def awgn_from_draws(g: torch.Tensor, n0: float) -> torch.Tensor:
    """Complex Gaussian noise with per-entry variance n0 from the draws."""
    g = g.to(torch.float32) * torch.sqrt(_f32(n0 / 2.0, g.device))
    return torch.complex(g[..., 0], g[..., 1])


def awgn(gen: torch.Generator, shape: Tuple[int, ...], n0: float
         ) -> torch.Tensor:
    """Complex Gaussian noise with per-entry variance n0."""
    return awgn_from_draws(awgn_draws(gen, shape), n0)
