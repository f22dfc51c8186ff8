"""Shared-memory and launch-limit model of the tuned kernel bodies, checked
against one Hopper card (the counterpart of `repro.analysis.vmem`, whose
budget is a TPU core's VMEM).

For a launch plan of the skinny `vp_dequant_matmul` body or the split
`vp_decode_attention` body, `launch_of` gives what one launch asks of an
SM: static and dynamic shared memory, threads and cluster size, computed
from the same plan fields the wrapper passes to the C entry and the
arrays the kernel declares (csrc/vp_dequant_matmul.cu:
vp_dequant_matmul_skinny_kernel, csrc/vp_attention.cu:
vp_decode_attention_split_kernel).  `problems` holds it against the
card's limits: 232,448 bytes of shared memory a block (227 KB, read from
the device where one is present), 48 KB of it static, 1024 threads, a
portable cluster of 8, and registers x threads within the SM's 65,536
registers, with each instance's registers read from the `-Xptxas -v`
report of its build (`build.build_log`, kept beside the library;
unchecked where the library is not built).

Like the reference's model it is a lower bound: what it rejects cannot
launch, what it admits may still fail and lose in `autotune.tune`.  It
admits every plan the heuristic planners produce (tests), and kernels it
does not model are never pruned.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.formats import VPFormat
from repro_torch.core.packing import storage_dtype
from repro_torch.kernels import build
from repro_torch.kernels.vp_attention import DECODE_KERNEL, plan_decode
from repro_torch.kernels.vp_bwd_matmul import TC_MAX_M
from repro_torch.kernels.vp_dequant_matmul import (
    SKINNY_KERNEL, SKINNY_MAX_M, SKINNY_MAX_M_WIDE, plan_skinny)

SMEM_PER_BLOCK = 232_448    # H100: opt-in shared memory a block can use
STATIC_SMEM = 48 * 1024     # ... of which static (__shared__ arrays)
MAX_THREADS = 1024
MAX_CLUSTER = 8             # portable thread-block cluster size
REGS_PER_SM = 65_536
F32 = 4

# csrc/vp_dequant_matmul.cu, skinny body
SK_THREADS = 256
SK_XC = 512                 # rows of x staged at once
SK_COLS = 64                # output columns per block
# csrc/vp_attention.cu, split decode body
DEC_MAX_WARPS = 8

_WT = {1: "int8", 2: "int16", 4: "int32"}
_MANGLED_T = {"a": "int8", "s": "int16", "i": "int32"}


@dataclasses.dataclass(frozen=True)
class Launch:
    """What one launch asks of an SM.  `instance` names the kernel's
    template instance as `parse_build_log` does."""
    instance: str
    static_smem: int
    dynamic_smem: int
    threads: int
    cluster: int


def skinny_launch(mt: int, split: int, w_bytes: int) -> Launch:
    """The skinny body at `mt` rows of x a block, K split over `split`
    blocks of one cluster: the staged x chunk, the block's sums and the
    scale table, all static."""
    static = F32 * (SK_XC * mt + mt * SK_COLS + build.VP_MAX_K)
    return Launch(f"vp_dequant_matmul_skinny_kernel<{mt},{_WT[w_bytes]}>",
                  static, 0, SK_THREADS, split)


def decode_launch(cluster: int, warps: int, rows: int, dh: int,
                  w_bytes: int, lane_bytes: int) -> Launch:
    """The split decode body: `warps` runs a block, `rows` query rows a
    slice (the register tile GT is the power of two at or above it); the
    warps' and the block's partial outputs are dynamic, the scale table
    and the per-warp and per-block softmax maxima and sums static (each
    array in whole 8-byte units, as the build lays them out)."""
    gt = 1 << (max(rows, 1) - 1).bit_length()
    wt = ("int8" if lane_bytes == 8 else "int32" if lane_bytes == 32
          else _WT[w_bytes])
    static = sum(-(-F32 * n // 8) * 8 for n in (
        build.VP_MAX_K, DEC_MAX_WARPS * gt, DEC_MAX_WARPS * gt, gt, gt))
    return Launch(f"vp_decode_attention_split_kernel<{wt},{gt},{lane_bytes}>",
                  static, F32 * (warps + 1) * rows * dh, 32 * warps, cluster)


def launch_of(kernel: str, plan: Sequence[int], shape: Sequence[int],
              formats: Sequence) -> Optional[Launch]:
    """The launch of a cache plan, or None for a kernel not modeled.

    SKINNY_KERNEL: plan (split, k_per), shape (K, N), formats (the
    words' format,): at the most rows a block the body takes for that
    format.  DECODE_KERNEL: plan (cluster, warps), shape (KV, smax, G,
    dh, w_bytes, window, rolling): at the lanes and slices of
    `plan_decode`.
    """
    if kernel == SKINNY_KERNEL:
        fmt = formats[0]
        if not isinstance(fmt, VPFormat):
            return None
        K, N = (int(d) for d in shape[:2])
        max_m = SKINNY_MAX_M if fmt.M <= TC_MAX_M else SKINNY_MAX_M_WIDE
        mt = plan_skinny(max_m, K, N, 1).mt
        w_bytes = torch.empty((), dtype=storage_dtype(fmt)).element_size()
        return skinny_launch(mt, int(plan[0]), w_bytes)
    if kernel == DECODE_KERNEL:
        KV, smax, G, dh, w_bytes = (int(d) for d in shape[:5])
        h = plan_decode(KV, smax, G, dh, w_bytes)
        return decode_launch(int(plan[0]), int(plan[1]), h.rows(G), dh,
                             w_bytes, h.lane_bytes)
    return None


def smem_limit() -> int:
    """Shared memory a block may use: the current card's opt-in limit
    where a card is present, else the H100's."""
    if not torch.cuda.is_available():
        return SMEM_PER_BLOCK
    props = torch.cuda.get_device_properties()
    return int(getattr(props, "shared_memory_per_block_optin",
                       SMEM_PER_BLOCK))


def problems(launch: Launch, limit: Optional[int] = None,
             registers: Optional[int] = None) -> List[str]:
    """Each of the card's limits that `launch` exceeds; [] if none.
    `registers` per thread default to the build log's for the
    instance."""
    limit = smem_limit() if limit is None else limit
    if registers is None:
        registers = build_registers(launch.instance)
    out = []
    if launch.static_smem > STATIC_SMEM:
        out.append(f"{launch.static_smem} bytes of static shared memory > "
                   f"{STATIC_SMEM}")
    if launch.static_smem + launch.dynamic_smem > limit:
        out.append(f"{launch.static_smem + launch.dynamic_smem} bytes of "
                   f"shared memory > {limit}")
    if not 1 <= launch.threads <= MAX_THREADS:
        out.append(f"{launch.threads} threads outside 1..{MAX_THREADS}")
    if not 1 <= launch.cluster <= MAX_CLUSTER:
        out.append(f"a cluster of {launch.cluster} blocks outside "
                   f"1..{MAX_CLUSTER}")
    if registers is not None and registers * launch.threads > REGS_PER_SM:
        out.append(f"{registers} registers x {launch.threads} threads > "
                   f"{REGS_PER_SM}")
    return out


def plan_feasible(kernel: str, plan: Sequence[int], shape: Sequence[int],
                  formats: Sequence) -> Tuple[bool, Optional[Launch]]:
    """(fits, launch); kernels not modeled report (True, None)."""
    launch = launch_of(kernel, plan, shape, formats)
    return (launch is None or not problems(launch)), launch


# ---------------------------------------------------------------------------
# The build's own report
# ---------------------------------------------------------------------------

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def demangle(mangled: str) -> Optional[str]:
    """`name<args>` of a mangled kernel template instance whose name
    starts with `vp_` (int literals and the int8 / int16 / int32 element
    types), or None.  The name is the one whose length prefix matches it:
    an anonymous namespace's own name also holds the source's name."""
    found = None
    for m in re.finditer(r"(\d+)vp_", mangled):
        digits, at = m.group(1), m.end(1)
        for k in range(len(digits)):     # the prefix may follow digits
            name = mangled[at:at + int(digits[k:])]
            rest = mangled[at + len(name):]
            if name.endswith("_kernel") and rest.startswith("I"):
                found = name, rest
        if found:
            break
    if found is None:
        return None
    name, rest = found
    args, s = [], rest[1:]
    while s and s[0] != "E":
        lit = re.match(r"Li(-?\d+)E", s)
        if lit:
            args.append(lit.group(1))
            s = s[lit.end():]
        elif s[0] in _MANGLED_T:
            args.append(_MANGLED_T[s[0]])
            s = s[1:]
        else:
            return None
    return f"{name}<{','.join(args)}>"


@functools.lru_cache(maxsize=64)
def parse_build_log(log: str) -> Dict[str, Tuple[int, int]]:
    """{instance: (registers, static shared memory bytes)} of every
    template instance in an `-Xptxas -v` report."""
    out: Dict[str, Tuple[int, int]] = {}
    current = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = demangle(m.group(1))
            continue
        used = _USED.search(line)
        if used and current:
            smem = _SMEM.search(line)
            out[current] = (int(used.group(1)),
                            int(smem.group(1)) if smem else 0)
            current = None
    return out


# the source each modeled kernel is built from
_SOURCE = {"vp_dequant_matmul_skinny_kernel": "vp_dequant_matmul",
           "vp_decode_attention_split_kernel": "vp_attention"}


def build_registers(instance: str) -> Optional[int]:
    """Registers a thread of `instance`, from its source's build report,
    or None (a kernel not modeled, a library not built)."""
    source = _SOURCE.get(instance.split("<")[0])
    log = build.build_log(source) if source else None
    got = parse_build_log(log).get(instance) if log else None
    return got[0] if got else None
