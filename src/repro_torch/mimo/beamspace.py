"""Beamspace transforms (paper eq. 3): y = F ybar, H = F Hbar (port of
`repro.mimo.beamspace`).

F is the unitary DFT matrix of size B; mmWave LoS channels become
approximately sparse in beamspace.
"""
from __future__ import annotations

import functools
import math

import torch


@functools.lru_cache(maxsize=8)
def _dft(b: int, device: str) -> torch.Tensor:
    n = torch.arange(b, device=device)
    k = (n[:, None] * n[None, :]).to(torch.float32)
    # The reference's complex64 phase: f32(-2 pi) * k, then / b.
    phase = torch.tensor(-2 * math.pi, dtype=torch.float32) * k / b
    f = torch.polar(torch.ones_like(phase), phase)
    return f / torch.sqrt(torch.tensor(float(b), dtype=torch.float32))


def dft_matrix(b: int, device="cpu") -> torch.Tensor:
    """Unitary DFT matrix F (B x B), complex64."""
    return _dft(b, str(torch.device(device)))


def to_beamspace(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Apply F along the antenna axis ((..., B, U) or (..., B))."""
    f = dft_matrix(x.shape[axis], x.device)
    return torch.tensordot(f, x.movedim(axis, 0), dims=1).movedim(0, axis)


def from_beamspace(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    f = dft_matrix(x.shape[axis], x.device)
    return torch.tensordot(f.mH, x.movedim(axis, 0), dims=1).movedim(0, axis)
