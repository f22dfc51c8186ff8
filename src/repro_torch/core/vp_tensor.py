"""Storage types of the two-plane VP layout (port of the helper of
`repro.core.vp_tensor`; the `VPTensor` container is not ported yet)."""
from __future__ import annotations

import torch


def significand_dtype(M: int) -> torch.dtype:
    """Significand plane type: int8 for M <= 8, int16 to 16, else int32."""
    if M <= 8:
        return torch.int8
    if M <= 16:
        return torch.int16
    return torch.int32
