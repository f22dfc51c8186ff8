"""PyTorch/CUDA port of the VP serving path and the paper's MIMO
equalizer.

The JAX package `repro` is the reference; this package imports nothing
from it and no JAX.  Layout mirrors `repro`: `configs`, `core` (formats,
FXP grid, FXP->VP conversion, packed words, fake quantization),
`kernels` (plain PyTorch versions in `ref.py`, hand-written CUDA kernels
under `csrc/`, dispatch in `ops.py`), `models` (dense transformer),
`mimo` (the paper's beamspace LMMSE equalizer, narrowband and wideband
OFDM) and `launch` (the static serving and MIMO CLIs).
"""
