"""The port's kernels: CUDA sources (csrc/), their wrappers, the plain
PyTorch versions (ref.py) and the dispatching ops (ops.py).

Nothing is built or loaded at import: a kernel library is compiled by
`build.library` on the first launch, so the CPU tests import every
module without nvcc.
"""
from .ops import block_vp_matmul, vp_dequant

__all__ = ["block_vp_matmul", "vp_dequant"]
