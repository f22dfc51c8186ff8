"""The two-plane VP layout (port of `repro.core.vp_tensor`): the
`VPTensor` container, the significand plane's type, and the bit packing
of the index plane that the planes weight and KV layouts store."""
from __future__ import annotations

import dataclasses

import torch

from .convert import scale_table
from .formats import FXPFormat, VPFormat


# Every `significand_dtype(M)` of a format the quantizers serve (M <= 16):
# the significand planes the CUDA kernels read and write.
SIGNIFICAND_DTYPES = (torch.int8, torch.int16)


def significand_dtype(M: int) -> torch.dtype:
    """Significand plane type: int8 for M <= 8, int16 to 16, else int32."""
    if M <= 8:
        return torch.int8
    if M <= 16:
        return torch.int16
    return torch.int32


@dataclasses.dataclass(frozen=True)
class VPTensor:
    """A VP-quantized tensor: significand plane `m`
    (`significand_dtype(fmt.M)`), unpacked uint8 index plane `i`, its
    format, and the FXP grid it was quantized from.  A plain container,
    not a pytree: nothing on the serving path takes it."""

    m: torch.Tensor
    i: torch.Tensor
    fmt: VPFormat
    fxp: FXPFormat

    @property
    def shape(self):
        return self.m.shape

    @property
    def storage_bits_per_element(self) -> int:
        """The significand's container lanes (8, 16 or 32 bits) plus the
        E-bit index, packed 2^E states to an element."""
        sig = torch.empty((), dtype=significand_dtype(self.fmt.M))
        return sig.element_size() * 8 + self.fmt.E

    def to_float(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """m * 2^-f_i, exact in f32."""
        table = scale_table(self.fmt, dtype, self.m.device)
        return self.m.to(dtype) * table[self.i.long()]

    def __repr__(self) -> str:
        return (f"VPTensor(shape={tuple(self.m.shape)}, fmt={self.fmt}, "
                f"fxp={self.fxp})")


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
