"""The paper's application: beamspace LMMSE equalization for mmWave
massive MU-MIMO (Sec. III-V), port of `repro.mimo`.

Random draws and the deterministic functions of them are separate
(`channel_draws` / `channels_from_draws`, ...), so the same numbers can
be fed to this package and to the reference.  `mvm_engine` runs the
equalizer through the VP kernels (`kernels.ops`); `ofdm` folds a
wideband band into one batched launch.
"""
