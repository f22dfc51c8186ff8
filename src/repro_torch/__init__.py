"""PyTorch/CUDA port of the VP serving path.

The JAX package `repro` is the reference; this package imports nothing
from it and no JAX.  Layout mirrors `repro`: `configs`, `core` (formats,
FXP grid, FXP->VP conversion, packed words), `kernels` (plain PyTorch
versions in `ref.py`, hand-written CUDA kernels under `csrc/`, dispatch
in `ops.py`), `models` (dense transformer) and `launch` (static serving
CLI).
"""
