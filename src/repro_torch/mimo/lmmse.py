"""LMMSE preprocessing and equalization (paper Sec. III; port of
`repro.mimo.lmmse`).

Preprocessing: W = (H^H H + (N0/Es) I)^-1 H^H   (per channel realization)
Equalization:  s_hat = W y                       (one MVM per symbol time)
"""
from __future__ import annotations

import torch


def lmmse_matrix(h: torch.Tensor, n0_over_es: float) -> torch.Tensor:
    """W for channel(s) h: (..., B, U) -> (..., U, B).  A batched solve
    outside any kernel, as in the reference."""
    hh = torch.resolve_conj(h.mH)                  # (..., U, B)
    gram = hh @ h                                  # (..., U, U)
    u = gram.shape[-1]
    reg = gram + n0_over_es * torch.eye(u, dtype=gram.dtype,
                                        device=gram.device)
    return torch.linalg.solve(reg, hh)


def equalize(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """s_hat = W y for batched w (..., U, B), y (..., B)."""
    return torch.einsum("...ub,...b->...u", w, y)
