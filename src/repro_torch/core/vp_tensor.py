"""Storage helpers of the two-plane VP layout (port of the helpers of
`repro.core.vp_tensor`; the `VPTensor` container is not ported yet):
the significand plane's type, and the bit packing of the index plane
that the planes KV cache stores."""
from __future__ import annotations

import torch


def significand_dtype(M: int) -> torch.dtype:
    """Significand plane type: int8 for M <= 8, int16 to 16, else int32."""
    if M <= 8:
        return torch.int8
    if M <= 16:
        return torch.int16
    return torch.int32


def pack_indices(i: torch.Tensor, E: int) -> torch.Tensor:
    """Pack E-bit indices along the last axis, 8 // E to a uint8, index j
    of a group at bit j * E.  Requires E in {1, 2, 4, 8} and a last dim
    divisible by 8 // E."""
    if E == 0:
        return torch.zeros(i.shape[:-1] + (0,), dtype=torch.uint8,
                           device=i.device)
    if E not in (1, 2, 4, 8):
        raise ValueError(f"packing supports E in {{1,2,4,8}}, got {E}")
    per = 8 // E
    if i.shape[-1] % per:
        raise ValueError(f"last dim {i.shape[-1]} not divisible by {per}")
    u = i.to(torch.int32).reshape(*i.shape[:-1], i.shape[-1] // per, per)
    shifts = torch.arange(per, dtype=torch.int32, device=i.device) * E
    return (u << shifts).sum(dim=-1).to(torch.uint8)


def unpack_indices(packed: torch.Tensor, E: int, n: int) -> torch.Tensor:
    """Inverse of `pack_indices`; `n` is the unpacked last-dim size."""
    if E == 0:
        return torch.zeros(packed.shape[:-1] + (n,), dtype=torch.uint8,
                           device=packed.device)
    per = 8 // E
    shifts = torch.arange(per, dtype=torch.int32, device=packed.device) * E
    u = (packed.to(torch.int32)[..., :, None] >> shifts) & ((1 << E) - 1)
    return u.reshape(*packed.shape[:-1], packed.shape[-1] * per)[
        ..., :n].to(torch.uint8)
