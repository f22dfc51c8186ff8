"""Error-feedback gradient compression (port of
`repro.train.compression`).

Each gradient leaf is quantized with a per-leaf scale before the
data-parallel reduction; the quantization residual is carried in the
compressor state and added back the next step (error feedback), which
keeps SGD convergence.

Two codecs (`CompressionConfig.codec`):

  * ``int8``: scale = amax / 127, one int8 per element.
  * ``vp``: the paper's format on gradients, the high-dynamic-range case
    it is for: each leaf becomes packed VP words
    (`core.quantize.vp_pack_tensor`, `storage_bits` bits per element)
    with a per-leaf pow2 scale, so small entries keep M significant
    bits instead of vanishing under one step size.

Both carry f32 error feedback, so the state layout does not depend on
the codec.  The reduction across replicas itself comes with the
distribution slice; here each leaf goes through quantize-dequantize.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.core.formats import FXPFormat, VPFormat, default_vp_format
from repro_torch.core.quantize import vp_pack_tensor, vp_unpack_tensor
from repro_torch.tree import tree_leaves, tree_map, tree_paths


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Gradient codec.  M / E / W apply to codec="vp" only."""
    codec: str = "int8"
    M: int = 7                     # VP significand bits (incl. sign)
    E: int = 2                     # VP exponent-index bits
    W: int = 12                    # FXP proxy grid width

    def __post_init__(self):
        if self.codec not in ("int8", "vp"):
            raise ValueError(
                f"unknown gradient codec {self.codec!r}; "
                f"pick 'int8' or 'vp'")

    def formats(self) -> Tuple[FXPFormat, VPFormat]:
        """The (FXP, VP) pair of the vp codec (the construction of
        `models.layers.canonical_formats`)."""
        fxp = FXPFormat(self.W, self.W - 1)
        return fxp, default_vp_format(fxp, self.M, self.E)


def init_compressor_state(params):
    """Zero f32 error feedback shaped like the parameters."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _compress_leaf_int8(g, err):
    g = g.to(torch.float32) + err
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, g - deq


def _compress_leaf_vp(g, err, fxp: FXPFormat, vp: VPFormat):
    g = g.to(torch.float32) + err
    words, scale = vp_pack_tensor(g, fxp, vp)
    deq = vp_unpack_tensor(words, scale, vp, torch.float32)
    return deq, g - deq


def _check_structs(grads, state) -> None:
    """Raise, naming the leaf paths, when the gradient tree and the state
    differ: pairing gradients with the wrong residuals would corrupt the
    feedback for good."""
    gpaths = [p for p, _ in tree_paths(grads)]
    spaths = [p for p, _ in tree_paths(state)]
    if gpaths == spaths:
        return
    only_g = [p for p in gpaths if p not in set(spaths)]
    only_s = [p for p in spaths if p not in set(gpaths)]
    raise ValueError(
        "compress_decompress: gradient tree and compressor state differ "
        f"in structure. Leaves only in grads: {only_g or 'none'}; leaves "
        f"only in state: {only_s or 'none'}. Rebuild the state with "
        "init_compressor_state(params) after any parameter-tree change.")


@torch.no_grad()
def compress_decompress(grads, state,
                        config: CompressionConfig = CompressionConfig(),
                        ) -> Tuple[Any, Any]:
    """Quantize-dequantize every leaf with error feedback ->
    (decoded grads, new residuals)."""
    if state is None:
        state = init_compressor_state(grads)
    _check_structs(grads, state)
    if config.codec == "vp":
        fxp, vp = config.formats()
        outs = [_compress_leaf_vp(g, e, fxp, vp)
                for g, e in zip(tree_leaves(grads), tree_leaves(state))]
    else:
        outs = [_compress_leaf_int8(g, e)
                for g, e in zip(tree_leaves(grads), tree_leaves(state))]
    deq, err = iter([o[0] for o in outs]), iter([o[1] for o in outs])
    return (tree_map(lambda _: next(deq), grads),
            tree_map(lambda _: next(err), grads))
