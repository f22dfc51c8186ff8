"""Build and bind the CUDA kernels: nvcc into shared libraries, ctypes.

Each source under `csrc/` is compiled at first use by `nvcc` for
`sm_90a` into `<repo>/.repro_torch_build/<name>-<hash>.so`, a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), and loaded with `ctypes`.  The hash covers the source, the
shared headers and the flags, so an edit rebuilds and an unchanged tree
reuses what it built.  `build_all` starts one `nvcc` per source, all at
once, and keeps nvcc's report beside each library (`<name>-<hash>.log`),
so `build_log` gives the same report in a process that built the
library and in one that found it built.  Nothing here falls back: a
failed build raises.

The wrappers pass `tensor.data_ptr()` and the current stream as integers
and raise if the launcher returns a CUDA error.  Each launch adds one to
`LAUNCHES[name]`, so a run can show which kernels it went through.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

from repro_torch.core.formats import FXPFormat, VPFormat

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / ".repro_torch_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
VP_MAX_K = 128   # csrc/vp_common.cuh: exponent options, E <= 7
VP_CHAIN_K = 16   # ... held in the struct (more: a table in device memory)
VP_IDX_TAB = 33   # csrc/vp_common.cuh: bit lengths 0..32

# Launches per kernel since the last `reset_launches()`.
LAUNCHES: Dict[str, int] = collections.Counter()
# nvcc's report (`-Xptxas -v`: registers and shared memory per kernel
# instance) by source name: of each source built in this process, and
# of each one `build_log` read from beside its library.
BUILD_LOGS: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float


class VPFmtC(ctypes.Structure):
    """`struct VPFmt` of csrc/vp_common.cuh."""
    _fields_ = [("E", _I), ("K", _I), ("m_lo", _I), ("m_hi", _I),
                ("scale", ctypes.c_float * VP_CHAIN_K), ("wide", _P)]


class QuantFmtC(ctypes.Structure):
    """`struct QuantFmt` of csrc/vp_common.cuh."""
    _fields_ = [("vp", VPFmtC), ("two_f", ctypes.c_float),
                ("raw_lo", ctypes.c_float), ("raw_hi", ctypes.c_float),
                ("shift", _I * VP_CHAIN_K), ("idx_tab", _I * VP_IDX_TAB),
                ("wide_shift", _P)]


# A format of K > VP_CHAIN_K (E 5-7) keeps all its scales and shifts in
# device memory, one table per format and CUDA device, alive with the
# process: its struct carries their addresses.  The wrappers pass the
# device of the launch's tensors; a struct made without one (the
# host-side checks) carries none.  The table is copied to the device
# when the format first launches there, which must not be inside a CUDA
# graph's capture: the engine runs every step eagerly before it
# captures it.
_WIDE_TABLES: Dict[tuple, torch.Tensor] = {}


def _wide_table(key: tuple, values, dtype: torch.dtype,
                device: Optional[torch.device]) -> Optional[int]:
    if device is None or device.type != "cuda":
        return None
    key += (device,)
    t = _WIDE_TABLES.get(key)
    if t is None:
        with torch.cuda.device(device):
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"{key[1:-1]}: the format's table in device memory is "
                    "first needed inside CUDA graph capture; launch the "
                    "format once eagerly on this device first")
            t = _WIDE_TABLES[key] = torch.tensor(values, dtype=dtype,
                                                 device=device)
    return t.data_ptr()


_SIGNATURES = {
    "vp_quant": {
        "vp_quant_packed_launch": [_P, _P, _LL, _I, _P] + [_I] * 3 + [_P],
        "vp_quant_packed_kv_launch": [_P, _P, _P, _I, _I, _I, _I, _P]
                                     + [_I] * 3 + [_P],
        "vp_quant_planes_launch": [_P, _P, _I, _P, _LL, _P] + [_I] * 3
                                  + [_P],
    },
    "vp_dequant_matmul": {
        "vp_dqmm_skinny_launch": [_P] * 3 + [_I] * 9 + [_P, _P],
        "vp_dqmm_tc_launch": [_P] * 4 + [_I] * 8 + [_P, _P],
        "vp_dqmm_cc_launch": [_P, _P, _P] + [_I] * 6 + [_P, _P],
    },
    "vp_attention": {
        "vp_decode_attention_launch": [_P] * 7 + [_I] * 14 + [_F, _P, _P],
        "flash_prefill_launch": [_P] * 4 + [_I] * 10 + [_F, _P],
    },
    "vp_matmul": {
        "vp_matmul_launch":
            [_P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P] + [_I] * 8 + [_P],
    },
    "vp_quant_matmul": {
        "vp_quant_matmul_launch": [_P] * 7 + [_I] * 10 + [_P],
    },
    "vp_bwd_matmul": {
        "vp_matmul_dx_cc_launch": [_P, _P, _P] + [_I] * 6 + [_P, _P],
        "vp_matmul_dw_cc_launch": [_P, _P, _P] + [_I] * 6 + [_P, _P],
        "vp_matmul_dx_tc_launch": [_P] * 4 + [_I] * 8 + [_P, _P],
        "vp_matmul_dw_tc_launch": [_P] * 4 + [_I] * 8 + [_P, _P],
    },
    "vp_block_matmul": {
        "block_vp_matmul_skinny_launch": [_P] * 5 + [_I] * 7 + [_P] * 3,
        "block_vp_matmul_tc_launch": [_P] * 5 + [_I] * 4 + [_P] * 3,
        "block_vp_matmul_dp4a_launch": [_P] * 5 + [_I] * 5 + [_P] * 3,
        "block_vp_matmul_i16_launch": [_P] * 5 + [_I] * 5 + [_P] * 3,
    },
    "vp_block_quant": {
        "vp_block_quant_launch": [_P] * 6 + [_LL, _LL] + [_I] * 12
                                 + [_P, _P],
        "vp_block_amax_launch": [_P] * 4 + [_LL, _LL] + [_I] * 3 + [_P],
    },
    "vp_dequant": {
        "vp_dequant_planes_launch": [_P, _I, _P, _P, _LL, _I, _P] + [_I] * 3
                                    + [_P],
        "vp_dequant_packed_launch": [_P, _I, _P, _LL, _I, _P] + [_I] * 3
                                    + [_P],
    },
    "rms_norm": {
        "rms_norm_launch": [_P, _I, _P, _I, _P, _LL, _I, _I, _F, _I, _P],
    },
}
SOURCES = tuple(_SIGNATURES)

# Element types the kernels take, by their code in csrc/vp_common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype: torch.dtype, what: str) -> int:
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{what}: the CUDA kernels take f32 or bf16, "
                         f"got {dtype}")
    return DTYPE_CODES[dtype]


def reset_launches() -> None:
    LAUNCHES.clear()


# The format structs are built once per format and device (a launch's
# host time counts on decode paths) and only read: the kernels take them
# as const.  `device` is that of the launch's tensors.
@functools.lru_cache(maxsize=None)
def vp_fmt_struct(vp: VPFormat,
                  device: Optional[torch.device] = None) -> VPFmtC:
    if vp.K > VP_MAX_K:
        raise ValueError(f"{vp}: the CUDA kernels take K <= {VP_MAX_K} "
                         f"(E <= 7)")
    s = VPFmtC(E=vp.E, K=vp.K, m_lo=vp.raw_min, m_hi=vp.raw_max)
    scales = [2.0 ** (-fk) for fk in vp.f]
    for k, sk in enumerate(scales[:VP_CHAIN_K]):
        s.scale[k] = sk
    if vp.K > VP_CHAIN_K:
        s.wide = _wide_table(("scale", vp), scales, torch.float32, device)
    return s


@functools.lru_cache(maxsize=None)
def quant_fmt_struct(fxp: FXPFormat, vp: VPFormat,
                     device: Optional[torch.device] = None) -> QuantFmtC:
    """The format pair as the kernels take it, with the exponent-index
    table where the format has one (else zeros: the select chain)."""
    from .vp_quant import index_table, table_ok   # vp_quant imports build

    s = QuantFmtC(vp=vp_fmt_struct(vp, device), two_f=2.0 ** fxp.F,
                  raw_lo=fxp.raw_min, raw_hi=fxp.raw_max)
    shifts = [fxp.F - fk for fk in vp.f]
    for k, sk in enumerate(shifts[:VP_CHAIN_K]):
        s.shift[k] = sk
    if vp.K > VP_CHAIN_K:
        s.wide_shift = _wide_table(("shift", fxp, vp), shifts, torch.int32,
                                   device)
    if table_ok(fxp, vp):
        for L, i in enumerate(index_table(fxp, vp)):
            s.idx_tab[L] = i
    return s


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


@functools.lru_cache(maxsize=None)
def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library (or one built without its report),
    one nvcc each, all started at once.

    Returns {name: nvcc's output} for the sources it compiled (the
    `-Xptxas -v` register and shared-memory report), also kept in
    `BUILD_LOGS` and written beside the library before the library
    itself.  Raises on the first failed compile, after every nvcc has
    ended.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists() and target.with_suffix(".log").exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = BUILD_LOGS[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        log_tmp = tmp.with_suffix(".logtmp")
        log_tmp.write_text(out)
        os.replace(log_tmp, target.with_suffix(".log"))
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def build_log(name: str) -> Optional[str]:
    """nvcc's report of csrc/<name>.cu's current build: from this
    process's compile, else from the file beside the built library;
    None where the library is not built."""
    log = BUILD_LOGS.get(name)
    if log is None:
        try:
            log = BUILD_LOGS[name] = _target(name).with_suffix(
                ".log").read_text()
        except OSError:
            return None
    return log


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        lib.vp_error_string.argtypes = [_I]
        lib.vp_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        msg = lib.vp_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
