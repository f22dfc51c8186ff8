#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--json-out FILE]

Run from the root of a checkout.  Phases, each raising on failure:

  1. device  - the card's name and power limit (nvidia-smi), torch/CUDA.
  2. build   - compile the CUDA sources of src/repro_torch/kernels/csrc
               with nvcc for sm_90a (seconds printed).
  3. kernels - every kernel against its plain PyTorch version on the card
               at the full-width model's shapes, with its median time
               over 20 launches (CUDA events, L2 flushed before each),
               the plain version's time, and the library call's time
               where one PyTorch call computes the same function.
     `vp_quant_packed` on its table body (the exponent index in O(1)) and
     on the select chain, bit-identical to the plain version and to each
     other (a weight panel, ties and saturation in int16, int8 and int32
     words, an unaligned ragged slice, the MIMO y format), and its KV
     mode (the KV cache's write in one launch: each position's pow2
     scale, the division, the words) bit-identical to the plain version
     and to torch's scale and division followed by the table body, at
     the serve's decode and prefill writes and at rows past the
     registers, unaligned rows and a format on the select chain; each
     timed (int16, int8, int32 words; the KV mode at decode and
     prefill); no local memory in its SASS.
     `vp_dequant_matmul` on the body its planner picks: the skinny body
     at every decode shape (batch 4: w_up, w_down, q/o, k/v, lm_head),
     the tensor-core body at prefill (512, 1024, 1024) and the four
     train-forward shapes, each timed; ragged and unaligned shapes, int8
     and int32 words and VP(10,[12,8]) (CUDA-core body) checked; each
     split body run twice, bit-identical; HGMMA counted in its SASS; the
     three bodies timed over M = 1..64 (the planner's thresholds); the
     timer's floor and the wrapper's host time per call.
     `vp_decode_attention` on its split body (the span cut over the warps
     of a block and the blocks of a cluster) at the serve's decode shape
     (B 4, Smax 160, KV 8, G 2, dh 64) in the full, window 64 and rolling
     cases, at lengths 1 and smax and across the ring's wrap, f32 and
     bf16 q, and `flash_prefill` causal and local 64 at S = 128 and 100
     on its tensor-core body (bf16) and CUDA-core body (f32, and bf16
     forced): each against its plain version, twice bit-identical, and
     bit-identical with the q scaling it folds in done outside; timed
     beside SDPA (span or band mask), decode swept over valid lengths
     160-4096, prefill over S = 128-2048; local memory and HMMA counted
     in their SASS.
     The vp_block path's `block_vp_matmul`: each of its three bodies
     (skinny, tensor cores, dp4a) bit-identical to its plain version in
     f32 and bf16 at every decode and prefill weight shape and lm_head,
     bk 256 (each timed, beside torch.matmul on the dequantized
     operands), and at ragged shapes of its own and bk 16 (dp4a, the
     block-16 serve's shapes); IGMMA counted in its SASS; the bodies
     timed over M = 1..512 (the planner's threshold).
     Its activation block-quantizer `vp_block_quant` on every body (small:
     one CUDA block or a cluster, at decode; coop: one cooperative launch
     with a grid-wide barrier, at prefill and the layer weights' export;
     two-pass: an amax pass first, at the lm_head export; general: an
     amax pass, then any block that divides the axis) bit-identical to
     its plain version (significands, indices, scale) at the decode,
     prefill and weight-export shapes (lm_head's included), at the
     scale's edge cases on both axes, for formats off the fast path, and
     at blocks 16 and 512 on both axes and ragged blocks (6, 1, a whole
     row or column) on the general body; each path shape timed on every
     body that takes it, the general body at the exports at blocks 16 and
     512, the small body's cluster swept, the amax pass timed alone; no
     local memory in its SASS.  The two dequant kernels behind
     `ops.vp_dequant`, bit-identical in f32 and bf16: packed (1024,
     3072) int16 words (timed beside `words.to(dtype)`, a cast over the
     same bytes) and int8 words, and ragged slices of both at offsets
     that leave the words and the output unaligned; and the MIMO planes
     (1.6e6, 64) int8 + uint8.
     The MIMO path's kernels (two-plane quantize, VP x VP matmul, fused
     quantize + matmul) likewise, at the equalizer's shapes: G = 100,000
     realizations of (16, 64) x (64, 2) (vp_matmul in int16 x int8 words
     and in int8 planes, with and without CSPADE masks, on its batch body,
     `vmm_body`; the fused kernel on its batch body, `qmm_body`), and the
     G = 1 launches of the masked mode at n = 256, (2048, 64) x (64,
     256), on the tile body (`mm_body`).  The planes kernel's table body,
     select chain and first design bit-exact (W panel, y operand, a
     ragged and an unaligned slice) and timed side by side through its C
     entry; vp_matmul's batch body bit-identical to the warp body in all
     three layouts and to the fused kernel, each timed beside the warp
     body; an unaligned slice and a mixed words x planes launch planned
     onto the warp body and refused by the batch body; the fused batch
     body bit-identical to the warp body (with and without masks), to
     quantize -> vp_matmul and to the G = 1 tile body, timed beside the
     warp body (C entry) and torch.bmm; no local memory in any batch
     body's SASS.  The tile body bit-identical to the warp
     body (forced through `body=`) in packed, planes, mixed words x
     planes and fused, unmasked and on CSPADE grids that cut across its
     tiles, at the path shape and two ragged ones; fused equal to
     quantize -> unfused on it; no local memory in its SASS; both bodies
     timed at the path shape beside torch.mm (f32) and swept over G, M
     and N (the planner's bound).
  4. serve   - full-width qwen3-0.6b in bf16 with packed VP weights and
               a packed VP KV cache: random weights from seed 0 exported
               by the quant kernel, batch 4 x 128 prompt tokens, 32
               greedy decode steps (prefill's weight matmuls on the
               tensor-core body, decode's and lm_head on the skinny
               body, prefill attention on the tensor-core body, decode
               attention on the split body, by the per-body counters).  Launch counts of that run, a
               profiler check of one prefill and one decode step (hand
               kernels only, no library GEMM or attention kernel), then
               the same run on the plain path, teacher-forced on the
               kernel path's tokens, in bf16 (held to the plain path's
               own rounding floor, or 2e-2 if larger) and in f32.
     Each KV write is one launch of the quant kernel's KV mode.
     The same in mode vp_block (block 256): every weight matmul through
     `block_vp_matmul` (decode and lm_head on the skinny body, prefill on
     the tensor-core body) on activations block-quantized by the
     `vp_block_quant` kernel, once per distinct activation (4 per layer
     and lm_head's: the small body at decode, coop at prefill), which
     also exports the weights (coop; two-pass for lm_head); the
     embedding table (not a multiple of 256 rows) as packed VP words; f32
     held to the larger of 2e-3 and the plain path's own floor.  Then the
     serve CLI (`launch.serve.main`) at `--quant vp_block --block 16`,
     full depth, batch 4, prompt 16, 2 decode steps: every weight
     exported by the quantizer's general body, every weight matmul on
     `block_vp_matmul`'s dp4a body (exact launch counts).  Then the
     public op `ops.vp_dequant` once on each dequant kernel's shapes.
  4b. engine - the paged continuous-batching engine (`repro_torch.serving`)
               on the same model, bf16, packed VP weights and KV cache:
               8 ragged requests (prompts 64-128, budgets 16-32, numpy
               seed 0) through 4 slots of pages of 16 (capacity 160),
               run-ahead 4, then 1, with the same tokens; every decode
               step one CUDA graph replay per (bucket, steps).  (a) each
               graph's first replay bit-identical to the eager step
               (tokens, logits, pools, lengths); (b) every request's
               logits against the plain path teacher-forced on its
               tokens, bf16 held to max(2e-2, 1.5 x the plain path's f64
               floor), f32 at 4 layers to 2e-3; (c) short runs with
               chunked prefill 32, the planes KV layout, vp_block at 256
               (one slot) and sampling, each held the same way against
               the plain path of its config (chunked prefill for the
               chunked run) and showing its kernels on the engine's path
               (the kernels that ran: the wrappers' counts less the
               captures plus the replays), and those kernels at the
               engine's shapes bit-identical to their plain versions;
               (d) a profile of one prefill unit and of one decode replay
               (hand kernels only, no library GEMM or attention kernel);
               (e) decode ms per step per bucket and kept tokens/s with
               graphs (median of 3 waves) beside the engine without
               graphs and the static path (median of 3) in the same
               call.
  5. mimo    - the paper's B-VP MIMO equalizer (B = 64 antennas, U = 8
               users, 16-QAM, Sec. III-A): narrowband ensembles of
               n = 100,000 channels at 2 dB and 20 dB equalized through
               the kernels (fused default, unfused, CSPADE 0.5; masked
               mode at n = 256), BER of float / A-FXP / B-FXP / B-VP, and
               a wideband band of 64 subcarriers x 1024 realizations in
               one batched launch.  Launch counts of that run, a profiler
               check of the equalize calls (hand kernels only, no library
               GEMM), every kernel-path estimate against the plain path,
               and equalizations per second.  The masked mode's 12 G = 1
               launches run on the tile body; the batched vp_matmul ones
               and the batched and wideband fused ones on the batch body,
               none on the warp body (per-body counters `vp_mm_tile` /
               `vp_mm_warp` / `vp_mm_batch`); the CSPADE calls' planes on
               the table body (`vp_qpl_table`).
  6. train kernels - the backward kernels `vp_matmul_dx` and
               `vp_matmul_dw` (tensor-core body) against their plain
               versions at the full-width training shapes (M = 8 x 128 =
               1024 tokens) and at (2048, 64, 256), the shape of
               `ops.vp_quant_matmul`'s backward, in f32 and bf16, timed
               like phase 3 with `torch.matmul` on the pre-dequantized
               operand as the library yardstick, with TFLOP/s and the share
               of the bound; HGMMA counted in their SASS (cuobjdump); a
               ragged and an unaligned shape and a format with M > 9 (the
               CUDA-core body) checked; the CUDA-core body timed through its
               C entry at the bf16 training shapes beside the tensor-core
               body; an f32 g with +-FLT_MAX elements held against the
               CUDA-core body, and one below 2^-110 measured against it;
               then the autograd backward of `ops.vp_quant_matmul` at
               (2048, 64) x (64, 256) (its forward on the tile body), da
               and db against the plain path.
  7. train   - full-width qwen3-0.6b in bf16 trained through the CLI
               (`launch.train.main`): random weights from seed 0,
               SyntheticLM batch 8 x seq 128, packed QAT, VP gradient
               compression and VP Adam moments, 4 steps.  Per-step loss,
               grad norm, seconds, tokens/s, peak memory; launch counts
               (196 per step of quant, serving matmul and dx: 28 layers x
               7 weights; the forward on the tensor-core body); a profile
               of one step; then one step's loss and
               gradients against the plain path in f32 and in bf16 (held
               to the plain path's own rounding floor, or 2e-2 if larger).
  8. result  - a {"kernels": [...]} line, then the device line last.

Exits non-zero without CUDA, and outside a checkout of the repository.
Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH = "qwen3-0.6b"
BATCH, PROMPT, GEN = 4, 128, 32
REL_LIMIT = 2e-2           # kernel path vs plain path, bf16 over 28 layers
FLOOR_MARGIN = 1.5         # ... or 1.5 x the plain path's own bf16 floor
F32_REL_LIMIT = 2e-3       # f32 end to end: summation order, plus the odd
                           # VP rounding flip in the KV cache (~1e-4)
F32_RTOL = 1e-5            # f32: summation order only
BF16_TOL = 1e-2            # bf16: one rounding of the output (2^-8 rel)
                           # plus the bf16 cast of p in flash prefill; for
                           # the backward kernels two roundings of f32 sums
                           # of one product, at most one bf16 ulp (2^-7 of
                           # the value) apart, plus f32 order
KERNEL_NAMES = {"vp_quant_packed": "vp_quant_packed_",      # every body
                "vp_qp_table": "vp_quant_packed_table_kernel",
                "vp_qp_chain": "vp_quant_packed_chain_kernel",
                "vp_qp_kv": "vp_quant_packed_kv_kernel",
                "vp_dequant_matmul": "vp_dequant_matmul_",   # every body
                "vp_dqmm_skinny": "vp_dequant_matmul_skinny_kernel",
                "vp_dqmm_tc": "vp_dequant_matmul_tc_kernel",
                "vp_dqmm_cuda_core": "vp_dequant_matmul_cc_kernel",
                "vp_dqmm_splitk_reduce": "vp_dqmm_splitk_reduce_kernel",
                "vp_decode_attention": "vp_decode_attention_",  # its body
                "vp_dec_split": "vp_decode_attention_split_kernel",
                "flash_prefill": "flash_prefill_",           # both bodies
                "flash_tc": "flash_prefill_tc_kernel",
                "flash_cuda_core": "flash_prefill_cc_kernel",
                "vp_quant_planes": "vp_quant_planes_",       # every body
                "vp_qpl_table": "vp_quant_planes_table_kernel",
                "vp_qpl_chain": "vp_quant_planes_chain_kernel",
                "vp_matmul": "_kernel<VPLoad",               # both bodies
                "vp_quant_matmul": "_kernel<VPQuantLoad",    # all 3 bodies
                "vp_mm_warp": "vp_mm_warp_kernel",
                "vp_mm_tile": "vp_mm_tile_kernel",
                "vp_mm_batch": "vp_mm_batch_kernel",
                "vp_matmul_dx": "vp_matmul_dx_tc_kernel",
                "vp_matmul_dw": "vp_matmul_dw_tc_kernel",
                "vp_bwd_splitk_reduce": "vp_bwd_splitk_reduce_kernel",
                "vp_bwd_cuda_core": "vp_bwd_mm_kernel",
                "block_vp_matmul": "block_vp_matmul_",       # every body
                "vp_bmm_skinny": "block_vp_matmul_skinny_kernel",
                "vp_bmm_tc": "block_vp_matmul_tc_kernel",
                "vp_bmm_dp4a": "block_vp_matmul_dp4a_kernel",
                "vp_block_quant": "vp_block_quant_",         # every body
                "vp_bq_small": "vp_block_quant_small_kernel",
                "vp_bq_coop": "vp_block_quant_coop_",
                "vp_bq_two_pass": "vp_block_quant_2pass_",
                "vp_bq_general": "vp_block_quant_general_",
                "vp_block_amax": "vp_block_amax_kernel",
                "vp_dequant_planes": "vp_dequant_planes_kernel",
                "vp_dequant_packed": "vp_dequant_packed_kernel"}
MIMO_G = 100_000           # realizations (paper Sec. III-A)
MIMO_SHAPE = (16, 64, 2)   # (2U, B) x (B, 2) per realization
MASKED_N = 256             # masked mode: (n U, B) x (B, n)
WORDS_LAYOUT = (("words", 2), ("words", 1))   # W int16 x y int8 words
WIDEBAND = (64, 1024)      # subcarriers x realizations
MIMO_RTOL = 1e-5           # kernel vs plain estimates, f32 sums
CLI_N = 4096               # realizations per ensemble of the CLI run
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 4
TRAIN_SHAPES = ((1024, 1024, 1024), (1024, 1024, 3072), (1024, 3072, 1024),
                (1024, 1024, 512))   # (M tokens, K, N) of the 7 weights
# vp_dequant_matmul: decode at batch 4 (w_up/w_gate, w_down, q/o, k/v,
# lm_head), prefill (4 x 128 tokens), then the train forward (timed)
DQMM_DECODE = ((4, 1024, 3072), (4, 3072, 1024), (4, 1024, 1024),
               (4, 1024, 512), (4, 1024, 151936))
DQMM_SHAPES = DQMM_DECODE + ((512, 1024, 1024),) + TRAIN_SHAPES
DQMM_SWEEP_M = (1, 4, 8, 16, 32, 64)  # the three bodies side by side, for
DQMM_SWEEP_KN = ((1024, 3072), (3072, 1024))  # the planner's thresholds
GRAD_RTOL = 1e-3           # f32 train step: each weight gradient vs plain
QMM_SHAPE = (2048, 64, 256)          # vp_quant_matmul autograd check
# The G = 1 VP x VP bodies: (M, K, N) -> CSPADE grids (bm, bk, bn) held
# bit-identical warp vs tile (None: unmasked).  The path's grid, one cut
# across the 64 x 64 tile, one mixing loud and muted outputs inside a 4 x
# 4 micro-tile; ragged shapes with grids of their own.
G1_CHECKS = {(2048, 64, 256): (None, (256, 64, 256), (16, 32, 8),
                               (2, 16, 1)),
             (200, 50, 72): (None, (8, 25, 8), (1, 10, 3)),
             (2047, 64, 255): (None, (89, 16, 17), (23, 8, 5))}
# (G, M, N) at K = 64, both bodies timed: mm_body's bounds (G = 1 over
# M and N, and two batched launches of the engine's (16, 64) x (64, 2))
MM_SWEEP = tuple((1, 2048, n) for n in (2, 8, 32, 64, 256)) + (
    (1, 16, 2), (1, 16, 256), (1, 256, 256), (1024, 16, 2), (8192, 16, 2))
BLOCK = 256                # vp_block index block (QuantConfig.block)
# Blocks off the fast quantizer bodies (axis 0 on the general body), and
# the short vp_block serve at block 16: batch, prompt and decode steps
GENERAL_BLOCKS = (16, 512)
BLOCK16_SERVE = (BATCH, 16, 2)
# block_vp_matmul: decode at batch 4 (w_up/w_gate, w_down, q/o, k/v,
# lm_head), then prefill (4 x 128 tokens) at the same weights
BLOCK_SHAPES = ((4, 1024, 3072), (4, 3072, 1024), (4, 1024, 1024),
                (4, 1024, 512), (4, 1024, 151936), (512, 1024, 1024),
                (512, 1024, 3072), (512, 3072, 1024), (512, 1024, 512))
BLOCK_SWEEP_M = (1, 4, 8, 16, 64, 512)   # the bodies side by side, for
BLOCK_SWEEP_KN = ((1024, 3072), (3072, 1024))  # the planner's threshold
DEQUANT_PACKED = (1024, 3072)        # int16 words of one weight panel
DEQUANT_PLANES = (1_600_000, 64)     # the MIMO W planes (row 5's shape)
DEC_SHAPE = (4, 160, 8, 2, 64)       # decode: B, Smax, KV, G, dh of serve
DEC_SWEEP = (160, 1024, 4096)        # decode valid lengths at B = 4
# The engine phase: ragged requests (prompt and budget ranges, numpy seed
# 0) through slots of pages up to the serve's Smax; run-ahead 4, then 1;
# chunked prefill's chunk; repeats of the timed waves; the f32 run's depth
ENGINE_REQS, ENGINE_PROMPT, ENGINE_GEN = 8, (64, 128), (16, 32)
ENGINE_SLOTS, ENGINE_PAGE, ENGINE_CAP = 4, 16, PROMPT + GEN
ENGINE_LOOKAHEAD, ENGINE_CHUNK, ENGINE_REPEATS = (4, 1), 32, 3
ENGINE_F32_LAYERS = 4
ENGINE_FLOOR_REQS = 2      # requests whose plain-path floor is measured
_ENGINE_ROWS = ("vp_quant_packed", "vp_dequant_matmul", "vp_decode_attention",
                "flash_prefill", "vp_quant_planes", "vp_dequant_planes",
                "vp_dequant_packed", "block_vp_matmul", "vp_block_quant")
FLASH_SWEEP = (128, 512, 2048)       # causal bf16 prompts at B = 4
WINDOW = "chip_smoke.window"        # profiler range around the profiled call
LIBRARY_KERNELS = re.compile(
    r"gemm|cublas|cutlass|xmma|sm90_|sm80_|ampere_|flash_fwd|fmha|"
    r"efficient_attention|scaled_dot_product|cudnn", re.IGNORECASE)

# Published dense peaks (NVIDIA data sheets): bytes/s, bf16 and f32 FLOP/s,
# int8 OP/s.
PEAKS = {
    "sxm": dict(bw=3.35e12, bf16=989e12, f32=67e12, int8=1979e12),
    "pcie": dict(bw=2.0e12, bf16=756e12, f32=51e12, int8=1513e12),
}


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description="PyTorch/CUDA port smoke run")
    ap.add_argument("--json-out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()

    import torch

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"[device] {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    peaks = PEAKS["pcie" if "pcie" in kind.lower() else "sxm"]
    print(f"[device] bounds use the {'PCIe' if peaks is PEAKS['pcie'] else 'SXM'}"
          f" peaks: {peaks}")
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: {SRC / 'repro_torch'} not found; "
                         "run from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 plain versions: f32 sums rounded once, as the kernels do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    from repro_torch.kernels import build

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    for name in build.SOURCES:
        build.library(name)
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        usage = sorted({line.split("info    :")[-1].strip()
                        for line in log.splitlines() if "registers" in line})
        spills = {line.strip() for line in log.splitlines()
                  if "spill" in line and "0 bytes spill stores, 0 bytes "
                  "spill loads" not in line}
        print(f"[build] {name}: {'; '.join(usage)}"
              + (f"; SPILLS: {sorted(spills)}" if spills else ""))
    print(f"[build] {len(build.SOURCES)} CUDA sources, "
          f"{len(logs)} compiled, in {build_s:.2f}s")

    record = {"device": {"nvidia_smi": smi, "kind": kind},
              "build_s": build_s, "phase_s": {}}

    def timed(phase, *a):
        t = time.perf_counter()
        out = phase(torch, *a)
        torch.cuda.synchronize()
        record["phase_s"][phase.__name__] = s = time.perf_counter() - t
        print(f"[time] {phase.__name__}: {s:.2f}s")
        return out

    rows = []
    for phase, *extra in (
            (kernel_phase, peaks, record), (block_kernel_phase, peaks, record),
            (mimo_kernel_phase, peaks, record),
            (train_kernel_phase, peaks, record), (serve_phase, record, rows),
            (serve_block_phase, record, rows, smi),
            (serve_block16_phase, record, rows, smi),
            (engine_phase, record, rows, smi), (dequant_phase, record, rows),
            (mimo_phase, record, rows, smi), (train_phase, record, rows, smi)):
        out = timed(phase, *extra)
        if phase.__name__.endswith("kernel_phase"):
            rows += out

    # ---- 8. result --------------------------------------------------------
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(record, indent=1))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# Timing and comparison helpers
# ---------------------------------------------------------------------------

class Timer:
    """Median device time of one call, over `reps` calls after warm-up.

    Before each call the L2 cache is flushed (a 256 MB write, as the
    main path finds its weights cold) and a spin kernel holds the stream,
    so the host's enqueue time does not enter the event span.
    """

    def __init__(self, torch, reps: int = 20, warmup: int = 3):
        self.torch, self.reps, self.warmup = torch, reps, warmup
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        spans = []
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(200_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            spans.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in spans)


def compare(torch, got, want, rtol: float, what: str):
    """(max abs error, max abs error / max|want|); raise past rtol."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    rel = err / scale if scale else err
    if err > rtol * scale + 1e-30:
        raise AssertionError(f"{what}: max abs err {err:.3e} > "
                             f"{rtol:g} * max|plain| {scale:.3e}")
    return err, rel


def bound(peaks, nbytes: float, flops: float, dtype: str):
    """(bound_ms, bound_by): the larger of bytes/bw and flops/peak."""
    t_bytes = nbytes / peaks["bw"] * 1e3
    t_ops = flops / peaks[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _row(name, source, replaces, shape, err, ms, plain_ms, bnd, library_ms):
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": library_ms, "shape": shape}


def _print_line(name, shape, err, rel, ms, plain_ms, bnd, library_ms):
    lib = "null" if library_ms is None else f"{library_ms:.4f}"
    print(f"[kernel] {name} {shape}: max_abs_err {err:.3e} (rel {rel:.3e}) "
          f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib} "
          f"bound_ms {bnd[0]:.4f} ({bnd[1]})")


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------

def kernel_phase(torch, peaks, record):
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels.vp_quant import vp_quant_packed_cuda
    from repro_torch.models.layers import canonical_formats

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = Timer(torch)
    fxp, vp = canonical_formats(QuantConfig(mode="vp"))
    lines, rows = [], []

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # -- vp_quant_packed: its two bodies and the KV mode -----------------------
    rows.append(_quant_packed_row(torch, peaks, timer, gen, randn, fxp, vp,
                                  record))

    # -- vp_dequant_matmul: its three bodies ------------------------------------
    def words(K, N):
        return vp_quant_packed_cuda(
            (randn(K, N) * 0.3).clamp(-0.99, 0.99), fxp, vp)

    rows.append(_dequant_matmul_row(torch, peaks, timer, gen, randn, words,
                                    vp, lines, record))

    # -- vp_decode_attention and flash_prefill: their three bodies --------------
    rows += _attention_rows(torch, peaks, timer, gen, randn, words, vp, lines,
                            record)
    record["kernel_lines"] = [
        dict(name=n, shape=s, ms=m, plain_ms=p, bound_ms=b[0], bound_by=b[1],
             library_ms=lib) for n, s, m, p, b, lib in lines]
    print("kernels: vp_quant_packed, vp_dequant_matmul, "
          "vp_decode_attention (split body), flash_prefill (tensor-core and "
          "CUDA-core bodies)")
    return rows


def _quant_packed_row(torch, peaks, timer, gen, randn, fxp, vp, record):
    """Row 1, `vp_quant_packed`: the table body (the index in O(1)) and
    the select chain, each bit-identical to the plain version and to each
    other on a weight panel, ties and saturation in int16, int8 and int32
    words, an unaligned ragged slice and the MIMO y format; the KV mode
    bit-identical to the plain version (`_kv_scale`, the division and the
    quantizer) and to that arithmetic in torch ops followed by the table
    body, at the serve's decode and prefill writes, in bf16 and f32, with
    all-zero positions, amax 2^k, 2^k (1 + 2^-7) and near 1e-30; 0 local
    memory in the library's SASS; each timed."""
    from repro_torch.core.formats import FXPFormat, VPFormat, default_vp_format
    from repro_torch.core.packing import storage_dtype
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.vp_quant import (
        plan_packed, vp_quant_packed_cuda, vp_quant_scaled_cuda)
    from repro_torch.mimo.equalizer import table1_specs
    from repro_torch.models.attention import kv_cache_formats
    from repro_torch.configs.base import QuantConfig

    f32, bf16 = torch.float32, torch.bfloat16
    local = {op: _sass_counts(build._target("vp_quant"), build._nvcc(), op)
             for op in ("LDL", "STL")}
    bad = {op: {k: v for k, v in c.items() if v} for op, c in local.items()}
    print(f"[kernel] vp_quant SASS: LDL/STL in {len(local['LDL'])} "
          f"instances: {bad}")
    if any(bad.values()):
        raise AssertionError(f"vp_quant: local memory in its SASS {bad}")

    def same(got, want, what):
        if got.dtype != want.dtype or not torch.equal(got, want):
            n = int((got.to(torch.float64) != want.to(torch.float64)).sum())
            raise AssertionError(f"{what}: {n} of {want.numel()} differ")

    ks = torch.randint(-2048, 2048, (4096,), generator=gen, device="cuda")
    ties = (ks.to(torch.float64) + 0.5) * 2.0 ** -fxp.F
    sat = torch.linspace(-8.0, 8.0, 4096, device="cuda", dtype=torch.float64)
    special = torch.cat([ties, sat]).to(f32)
    panel = randn(1024, 3072) * 0.3
    fxp8, vp8 = FXPFormat(12, 11), default_vp_format(FXPFormat(12, 11), 6, 2)
    fxp32, vp32 = FXPFormat(20, 18), VPFormat(16, (18, 14))
    y = table1_specs()[2]
    cases = ((panel, fxp, vp, "panel (1024, 3072) int16"),
             (special, fxp, vp, "ties/saturation int16"),
             (special, fxp8, vp8, "ties/saturation int8"),
             (special * 4, fxp32, vp32, "ties/saturation int32"),
             (special[1:1001], fxp, vp, "unaligned ragged slice"),
             (randn(777) * 200, y.y_fxp, y.y_vp, "MIMO y format int8"))
    for x, f_, v_, what in cases:
        want = ref.vp_quant_packed_ref(x, f_, v_)
        table = vp_quant_packed_cuda(x, f_, v_, body="table")
        same(table, want, f"vp_quant_packed table body {what}")
        same(vp_quant_packed_cuda(x, f_, v_, body="chain"), table,
             f"vp_quant_packed chain vs table body {what}")
    print("[kernel] vp_quant_packed: table and chain bodies bit-identical to "
          "the plain version and to each other: " + "; ".join(
              c[3] for c in cases))

    # -- the KV mode --------------------------------------------------------------
    kf, kv = kv_cache_formats(QuantConfig(mode="vp", quantize_kv_cache=True))
    KVH, dh = 8, 64
    kv_cases = []
    # the serve's decode and prefill writes, a short prompt, rows past the
    # registers' 1024 elements, rows of 21 (unaligned)
    for shape in ((BATCH, 1, KVH, dh), (BATCH, PROMPT, KVH, dh),
                  (BATCH, 5, KVH, dh), (BATCH, 3, 16, 128), (3, 5, 3, 7)):
        for dt in (bf16, f32):
            S = shape[1]
            x = (randn(*shape) * 3).to(dt)
            x[0, 0] = 0                                  # an all-zero position
            if S > 2:
                x[0, 1] = 8.0                            # amax 2^3 exactly
                x[1, 1, 0, 0] = 8.0 * (1 + 2.0 ** -7)    # ... and just above
                x[2, 1] = (x[2, 1] * 1e-31).to(dt)       # amax near 1e-30
            w_k, s_k = vp_quant_scaled_cuda(x, kf, kv)
            w_r, s_r = ref.vp_quant_scaled_ref(x, kf, kv)
            same(w_k, w_r, f"KV mode words {list(shape)} {dt}")
            same(s_k, s_r, f"KV mode scales {list(shape)} {dt}")
            amax = x.to(f32).abs().amax(dim=(-2, -1), keepdim=True)
            s_t = torch.exp2(torch.ceil(torch.log2(torch.clamp(amax,
                                                               min=1e-30))))
            same(s_k, s_t, f"KV mode scales vs torch ops {dt}")
            same(w_k, vp_quant_packed_cuda(x.to(f32) / s_t, kf, kv),
                 f"KV mode vs scale + divide + table body {dt}")
            kv_cases.append((list(shape), dt, x))
    cf, cv = FXPFormat(12, 2), VPFormat(7, (10, 2))     # the select chain
    for shape, dt, x in kv_cases[:4]:
        for w_k, w_r in zip(vp_quant_scaled_cuda(x, cf, cv),
                            ref.vp_quant_scaled_ref(x, cf, cv)):
            same(w_k, w_r, f"KV mode on the select chain {shape} {dt}")
    print(f"[kernel] vp_quant_packed KV mode: words and scales bit-identical "
          f"to the plain version and to torch's scale + divide + the table "
          f"body at {sorted({str(c[0]) for c in kv_cases})}, bf16 and f32, "
          f"with all-zero, 2^3, 2^3 (1 + 2^-7) and ~1e-30 positions; and "
          f"for a format on the select chain")

    # -- timed ---------------------------------------------------------------------
    shapes, main = [], None
    for x, f_, v_, body, what in (
            (panel, fxp, vp, "table", "int16"),
            (panel, fxp, vp, "chain", "int16"),
            (panel, fxp8, vp8, "table", "int8"),
            (panel, fxp32, vp32, "table", "int32")):
        ms = timer(lambda: vp_quant_packed_cuda(x, f_, v_, body=body))
        plain_ms = timer(lambda: ref.vp_quant_packed_ref(x, f_, v_))
        esz = torch.empty((), dtype=storage_dtype(v_)).element_size()
        bnd = bound(peaks, x.numel() * (4 + esz), 0, "f32")
        shape = [*x.shape, f"{what} words", f"{body} body"]
        _print_line("vp_quant_packed", shape, 0.0, 0.0, ms, plain_ms, bnd,
                    None)
        print(f"[kernel]   vp_quant_packed {shape}: grid "
              f"{plan_packed(x.numel())}, {bnd[0] / ms:.1%} of the bound")
        shapes.append(dict(shape=shape, ms=ms, plain_ms=plain_ms,
                           bound_ms=bnd[0], bound_by=bnd[1]))
        if main is None:
            main = _row("vp_quant_packed", "vp_quant.cu",
                        "src/repro/kernels/vp_quant.py:65", shape, 0.0, ms,
                        plain_ms, bnd, None)
    # What one PyTorch elementwise kernel that moves the same bytes takes
    # under this timer (a cast: not the same function, and no library_ms).
    same_bytes_ms = timer(lambda: panel.to(torch.bfloat16))
    print(f"[kernel]   vp_quant_packed [1024, 3072]: a cast moving the same "
          f"bytes (f32 -> bf16, torch) takes {same_bytes_ms:.4f} ms")
    kv_shapes = []
    for shape, dt, x in kv_cases:
        if shape[1:] not in ([1, KVH, dh], [PROMPT, KVH, dh]) or dt != bf16:
            continue
        ms = timer(lambda: vp_quant_scaled_cuda(x, kf, kv))
        plain_ms = timer(lambda: ref.vp_quant_scaled_ref(x, kf, kv))
        n = x.numel()
        bnd = bound(peaks, n * (2 + 2) + n // (KVH * dh) * 4, 0, "f32")
        tag = [*shape, "bf16", "KV mode"]
        _print_line("vp_quant_packed", tag, 0.0, 0.0, ms, plain_ms, bnd,
                    None)
        print(f"[kernel]   vp_quant_packed {tag}: one launch (the plain "
              f"version takes ~10), {bnd[0] / ms:.1%} of the bound")
        kv_shapes.append(dict(shape=tag, ms=ms, plain_ms=plain_ms,
                              bound_ms=bnd[0], bound_by=bnd[1]))
    main["shapes"], main["kv_mode"] = shapes, kv_shapes
    main["same_bytes_cast_ms"] = same_bytes_ms
    record["quant_packed"] = dict(shapes=shapes, kv_mode=kv_shapes,
                                  same_bytes_cast_ms=same_bytes_ms)
    return main


def _identical(torch, got, want, what):
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{what}: not bit-identical")


def _attention_rows(torch, peaks, timer, gen, randn, words, vp, lines,
                    record):
    """The two attention kernels and their three bodies.  Returns their
    rows.

    `vp_decode_attention` (the split body) at serve's decode shape in the
    full, window 64 and rolling cases, at lengths 1 and smax, and across
    the rolling ring's wrap: f32 q within F32_RTOL and bf16 q within
    BF16_TOL of the plain version, two launches bit-identical, the folded
    q scaling bit-identical to the scaling it replaced (the kernel on an
    f32 q pre-scaled by torch at scale 1, cast to q's dtype); timed beside
    SDPA on the pre-dequantized cache with a boolean span mask, and over
    the valid lengths of DEC_SWEEP.  `flash_prefill` causal and local 64 at
    S = 128 and 100: bf16 on the tensor-core body within BF16_TOL, f32 on
    the CUDA-core body within F32_RTOL, and bf16 on the CUDA-core body
    (forced) within BF16_TOL; each bit-identical across launches and to
    the pre-scaled q; timed beside SDPA (causal, or a band mask), and the
    tensor-core body over FLASH_SWEEP.  The SASS of every body: no local
    memory, HMMA in the tensor-core body."""
    import torch.nn.functional as F

    from repro_torch.core.packing import dequant_words
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.vp_attention import (
        flash_body, flash_prefill_cuda, plan_decode, vp_decode_attention_cuda)

    # -- SASS: registers only; the tensor cores in the prefill body ----------
    target = build._target("vp_attention")
    sass = {op: _sass_counts(target, build._nvcc(), op)
            for op in ("LDL", "STL", "HMMA")}
    inst = {}
    for sym in sass["HMMA"]:
        m = (re.search(r"split_kernelI([ais])Li(\d+)E", sym)
             or re.search(r"(tc)_kernelILi(\d+)E", sym)
             or re.search(r"(cc)_kernelI(f|13__nv_bfloat16)E", sym))
        if m:
            name = {"a": "decode int8 G<=", "s": "decode int16 G<=",
                    "i": "decode int32 G<=", "tc": "prefill tc dh ",
                    "cc": "prefill cc "}[m[1]] + m[2].replace(
                        "13__nv_", "")
            inst[name] = {op: sass[op][sym] for op in sass}
    print("[kernel] vp_attention SASS (LDL, STL, HMMA): " + "; ".join(
        f"{k} {v['LDL']}/{v['STL']}/{v['HMMA']}" for k, v in inst.items()))
    spills = {k: v for k, v in inst.items() if v["LDL"] or v["STL"]}
    tc = {k: v for k, v in inst.items() if k.startswith("prefill tc")}
    if spills:
        raise AssertionError(f"attention bodies use local memory: {spills}")
    if len(tc) != 8 or not all(v["HMMA"] for v in tc.values()):
        raise AssertionError(f"tensor-core prefill instances: {tc}")
    record["attention_sass"] = inst

    # -- vp_decode_attention -------------------------------------------------
    B, smax, KV, G, dh = DEC_SHAPE
    H = KV * G
    scales = torch.tensor([2.0 ** -3, 2.0 ** -2, 0.5, 1.0, 2.0],
                          device="cuda")

    def cache(L):
        k_w = words(B * L * KV, dh).reshape(B, L, KV, dh)
        v_w = words(B * L * KV, dh).reshape(B, L, KV, dh)
        k_s, v_s = (scales[torch.randint(0, 5, (B, L, 1, 1), generator=gen,
                                         device="cuda")] for _ in range(2))
        return k_w, v_w, k_s, v_s

    def sdpa_decode(q, k_w, v_w, k_s, v_s, lengths, window, rolling):
        """One SDPA call over the pre-dequantized cache, the span masked."""
        L = k_w.shape[1]
        kd, vd = ((dequant_words(w, vp, torch.float32) * s)
                  .repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
                  for w, s in ((k_w, k_s), (v_w, v_s)))
        pos = torch.arange(L, device="cuda")[None, :]
        ln = lengths.to(torch.int64)[:, None]
        valid = pos < (ln.clamp(max=L) if rolling else ln)
        if window and not rolling:
            valid &= pos >= ln - window
        qt, mask = q.transpose(1, 2), valid[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(qt, kd, vd,
                                                      attn_mask=mask)

    def dec_bound(lens, L, window, rolling):
        valid = 0
        for ln in lens:
            hi = min(ln, L)
            lo = max(ln - window, 0) if window and not rolling else 0
            valid += max(hi - lo, 0)
        nbytes = valid * KV * dh * 2 * 2 + valid * 2 * 4 + 2 * B * H * dh * 4
        return bound(peaks, nbytes, 4 * valid * KV * G * dh, "f32")

    k_w, v_w, k_s, v_s = cache(smax)
    q = randn(B, 1, H, dh)
    plan = plan_decode(KV, smax, G, dh)
    print(f"[kernel] vp_decode_attention split: {plan} ({B * KV * plan.cluster}"
          f" blocks of {plan.warps} warps)")
    cases = {"full": ([160, 150, 129, 100], None, False),
             "window": ([160, 150, 129, 40], 64, False),
             "rolling": ([200, 170, 161, 300], 160, True),
             "edges": ([1, 160, 2, 159], None, False),      # 1 and smax
             "wrap": ([161, 1000, 160, 1], 160, True)}      # the ring wraps
    main_dec = None
    for case, (lens, window, rolling) in cases.items():
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        args = (k_w, v_w, k_s, v_s, lengths, vp, window, rolling)
        for dtype, tol in ((torch.float32, F32_RTOL),
                           (torch.bfloat16, BF16_TOL)):
            qd = q.to(dtype)
            got = ops.vp_decode_attention(qd, *args)
            err, rel = compare(torch, got, ref.vp_decode_attention_ref(
                qd, *args), tol, f"vp_decode_attention {case} {dtype}")
            _identical(torch, ops.vp_decode_attention(qd, *args), got,
                       f"vp_decode_attention {case} {dtype}, two launches")
            pre = qd.reshape(B, KV, G, dh).to(torch.float32) * dh ** -0.5
            _identical(torch, got, vp_decode_attention_cuda(
                pre, *args, scale=1.0).reshape(B, 1, H, dh).to(dtype),
                f"vp_decode_attention {case} {dtype}, folded scale")
        if case not in ("full", "window", "rolling"):
            print(f"[kernel] vp_decode_attention {case} {lens}: within "
                  f"tolerance in f32 (rel {rel:.3e} in bf16), bit-identical "
                  "across launches and to the pre-scaled q")
            continue
        # time the f32 form, as earlier rows did
        err, rel = compare(torch, ops.vp_decode_attention(q, *args),
                           ref.vp_decode_attention_ref(q, *args), F32_RTOL,
                           f"vp_decode_attention {case}")
        ms = timer(lambda: ops.vp_decode_attention(q, *args))
        plain_ms = timer(lambda: ref.vp_decode_attention_ref(q, *args))
        library_ms = timer(sdpa_decode(q, k_w, v_w, k_s, v_s, lengths,
                                       window, rolling))
        bnd = dec_bound(lens, smax, window, rolling)
        shape = [B, smax, KV, G, dh, case]
        _print_line("vp_decode_attention", shape, err, rel, ms, plain_ms, bnd,
                    library_ms)
        lines.append(("vp_decode_attention", shape, ms, plain_ms, bnd,
                      library_ms))
        if main_dec is None:
            main_dec = _row("vp_decode_attention", "vp_attention.cu",
                            "src/repro/kernels/vp_attention.py:155", shape,
                            err, ms, plain_ms, bnd, library_ms)
            main_dec["body"] = "split"
    sweep = []
    for L in DEC_SWEEP:
        ck = cache(L)
        lengths = torch.full((B,), L, dtype=torch.int32, device="cuda")
        args = (*ck, lengths, vp, None, False)
        err, rel = compare(torch, ops.vp_decode_attention(q, *args),
                           ref.vp_decode_attention_ref(q, *args), F32_RTOL,
                           f"vp_decode_attention length {L}")
        ms = timer(lambda: ops.vp_decode_attention(q, *args))
        library_ms = timer(sdpa_decode(q, *ck, lengths, None, False))
        bnd = dec_bound([L] * B, L, None, False)
        sweep.append(dict(length=L, plan=dataclasses.asdict(
            plan_decode(KV, L, G, dh)), ms=ms, bound_ms=bnd[0],
            library_ms=library_ms, max_abs_err=err))
        print(f"[kernel] vp_decode_attention sweep B {B} length {L} "
              f"{plan_decode(KV, L, G, dh)}: ms {ms:.4f} bound_ms "
              f"{bnd[0]:.4f} ({ms / bnd[0]:.1f}x) library_ms (SDPA) "
              f"{library_ms:.4f} (rel err {rel:.2e})")
    record["decode_sweep"] = sweep

    # -- flash_prefill -------------------------------------------------------
    B, H, KV, dh = 4, 16, 8, 64
    G = H // KV

    def sdpa_prefill(qd, kd, vd, window):
        qt = qd.transpose(1, 2)
        kt, vt = (t.repeat_interleave(G, dim=2).transpose(1, 2)
                  for t in (kd, vd))
        if not window:
            return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True)
        S = qd.shape[1]
        qpos = torch.arange(S, device="cuda")[:, None]
        kpos = torch.arange(S, device="cuda")[None, :]
        band = (kpos <= qpos) & (qpos - kpos < window)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=band)

    def fl_bound(S, window):
        qpos = torch.arange(S)[:, None]
        kpos = torch.arange(S)[None, :]
        mask = kpos <= qpos
        if window:
            mask &= qpos - kpos < window
        nbytes = 2 * (2 * B * S * H * dh + 2 * B * S * KV * dh)
        return bound(peaks, nbytes, 4 * B * H * dh * int(mask.sum()), "bf16")

    if flash_body(torch.bfloat16, dh) != "tensor_core":
        raise AssertionError(f"bf16 dh {dh} not planned on the tensor cores")
    main_fl = None
    for S in (128, 100):
        for pattern, window in (("causal", None), ("local", 64)):
            q32, k32, v32 = (randn(B, S, n, dh) for n in (H, KV, KV))
            for dtype, tol, body in (
                    (torch.float32, F32_RTOL, "cuda_core"),
                    (torch.bfloat16, BF16_TOL, "tensor_core"),
                    (torch.bfloat16, BF16_TOL, "cuda_core")):
                qd, kd, vd = (t.to(dtype) for t in (q32, k32, v32))
                scale = torch.tensor(dh ** -0.5, dtype=dtype, device="cuda")
                forced = None if body == flash_body(dtype, dh) else body

                def kern(q_=qd, k_=kd, v_=vd, s_=float(scale), b_=forced):
                    if b_ is None:   # the public op, on the planned body
                        return ops.flash_prefill(q_, k_, v_, pattern, window)
                    return flash_prefill_cuda(q_, k_, v_, True, window, s_,
                                              body=b_)

                got = kern()
                err, rel = compare(torch, got, ref.flash_prefill_ref(
                    qd, kd, vd, pattern, window), tol,
                    f"flash_prefill {S} {pattern} {dtype} {body}")
                _identical(torch, kern(), got, f"flash_prefill {S} {pattern} "
                           f"{dtype} {body}, two launches")
                _identical(torch, flash_prefill_cuda(
                    qd * scale, kd, vd, True, window, 1.0, body=body), got,
                    f"flash_prefill {S} {pattern} {dtype} {body}, folded "
                    "scale")
                if dtype == torch.bfloat16 and body == "tensor_core":
                    tc_kern, tc_err, tc_rel = kern, err, rel
            # time the model's form, bf16: the tensor-core body (planned)
            # beside the CUDA-core body it replaced on the path
            ms, cc_ms = timer(tc_kern), timer(kern)
            plain_ms = timer(lambda: ref.flash_prefill_ref(qd, kd, vd,
                                                           pattern, window))
            library_ms = timer(sdpa_prefill(qd, kd, vd, window))
            bnd = fl_bound(S, window)
            shape = [B, S, H, KV, dh, pattern]
            _print_line("flash_prefill", shape, tc_err, tc_rel, ms, plain_ms,
                        bnd, library_ms)
            print(f"[kernel] flash_prefill {shape}: tensor-core body {ms:.4f}"
                  f" ms ({ms / library_ms:.2f}x SDPA), CUDA-core body "
                  f"{cc_ms:.4f} ms")
            lines.append(("flash_prefill", shape, ms, plain_ms, bnd,
                          library_ms))
            lines.append(("flash_prefill cuda_core", shape, cc_ms, plain_ms,
                          bnd, library_ms))
            if main_fl is None:
                main_fl = _row("flash_prefill", "vp_attention.cu",
                               "src/repro/kernels/vp_attention.py:264", shape,
                               tc_err, ms, plain_ms, bnd, library_ms)
                main_fl.update(body="tensor_core", cuda_core_ms=cc_ms)
    sweep = []
    for S in FLASH_SWEEP:
        qd, kd, vd = (randn(B, S, n, dh).to(torch.bfloat16)
                      for n in (H, KV, KV))
        err, rel = compare(torch, ops.flash_prefill(qd, kd, vd),
                           ref.flash_prefill_ref(qd, kd, vd), BF16_TOL,
                           f"flash_prefill causal S {S}")
        ms = timer(lambda: ops.flash_prefill(qd, kd, vd))
        cc_ms = timer(lambda: flash_prefill_cuda(
            qd, kd, vd, True, None, 0.125, body="cuda_core"))
        library_ms = timer(sdpa_prefill(qd, kd, vd, None))
        bnd = fl_bound(S, None)
        sweep.append(dict(S=S, ms=ms, cuda_core_ms=cc_ms, bound_ms=bnd[0],
                          bound_by=bnd[1], library_ms=library_ms,
                          max_abs_err=err))
        print(f"[kernel] flash_prefill sweep B {B} S {S} causal bf16: "
              f"tensor-core body {ms:.4f} ms ({ms / library_ms:.2f}x SDPA "
              f"{library_ms:.4f}), CUDA-core body {cc_ms:.4f}, bound_ms "
              f"{bnd[0]:.4f} ({bnd[1]}) (rel err {rel:.2e})")
    record["prefill_sweep"] = sweep
    return [main_dec, main_fl]


def _dequant_matmul_row(torch, peaks, timer, gen, randn, words, vp, lines,
                        record):
    """Row 2, `vp_dequant_matmul`, on the body `fwd_body` picks: the
    skinny body at every decode shape, the tensor-core body at prefill and
    the train forward, each against the plain version in f32 (F32_RTOL)
    and bf16 (BF16_TOL) and timed in bf16 beside the plain version and
    `torch.matmul` on the pre-dequantized words.  Then ragged and
    unaligned shapes, int8 and int32 words and a format with M > 9 (the
    CUDA-core body), each body's launches counted; two runs of each split
    body bit-identical; HGMMA in the tensor-core body's SASS; and the
    three bodies timed side by side over M (the planner's thresholds)."""
    from repro_torch.core.formats import VPFormat
    from repro_torch.core.packing import dequant_words, pack_vp
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.vp_bwd_matmul import plan_tiles
    from repro_torch.kernels.vp_dequant_matmul import (
        BODY_COUNTER, fwd_body, plan_skinny, vp_dequant_matmul_cuda)
    from repro_torch.mimo.equalizer import table1_specs

    hgmma = _sass_counts(build._target("vp_dequant_matmul"), build._nvcc())
    tc = {k: v for k, v in hgmma.items() if "_tc_kernel" in k}
    if not tc or min(tc.values()) == 0:
        raise AssertionError(f"tensor-core body without HGMMA: {tc}")
    print(f"[kernel] vp_dequant_matmul SASS: HGMMA in {len(tc)} tensor-core "
          f"kernels, {sum(tc.values())} in all ({min(tc.values())} to "
          f"{max(tc.values())} each); {sum(hgmma.values()) - sum(tc.values())}"
          " elsewhere")
    record["hgmma_dequant_matmul"] = hgmma
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    f32, bf16 = torch.float32, torch.bfloat16

    def check(x32, w, fmt, body, what):
        """Both dtypes on `body`, which must be fwd_body's choice; returns
        the bf16 (err, rel)."""
        M = x32.shape[0]
        build.reset_launches()
        for dtype, tol in ((f32, F32_RTOL), (bf16, BF16_TOL)):
            if fwd_body(M, dtype, fmt) != body:
                raise AssertionError(f"{what} {dtype}: body "
                                     f"{fwd_body(M, dtype, fmt)} != {body}")
            x = x32.to(dtype)
            err = compare(torch, vp_dequant_matmul_cuda(x, w, fmt, dtype),
                          ref.vp_dequant_matmul_ref(x, w, fmt, dtype), tol,
                          f"vp_dequant_matmul {what} {dtype}")
        if build.LAUNCHES[BODY_COUNTER[body]] != 2:
            raise AssertionError(f"{what}: launches {dict(build.LAUNCHES)}")
        return err

    # -- every main-path shape: checked and timed --------------------------------
    main, shapes = None, []
    for (M, K, N) in DQMM_SHAPES:
        w, x32 = words(K, N), randn(M, K)
        body = "skinny" if (M, K, N) in DQMM_DECODE else "tensor_core"
        err, rel = check(x32, w, vp, body, [M, K, N])
        x, w_deq = x32.to(bf16), dequant_words(w, vp).to(bf16)
        ms = timer(lambda: vp_dequant_matmul_cuda(x, w, vp, bf16))
        plain_ms = timer(lambda: ref.vp_dequant_matmul_ref(x, w, vp, bf16))
        library_ms = timer(lambda: torch.matmul(x, w_deq))
        bnd = bound(peaks, 2 * (M * K + K * N + M * N), 2 * M * K * N, "bf16")
        _print_line("vp_dequant_matmul", [M, K, N], err, rel, ms, plain_ms,
                    bnd, library_ms)
        print(f"[kernel]   vp_dequant_matmul {[M, K, N]}: {body} body, "
              f"{bnd[0] / ms:.1%} of the bound, {ms / library_ms:.2f}x "
              f"torch.matmul")
        lines.append(("vp_dequant_matmul", [M, K, N], ms, plain_ms, bnd,
                      library_ms))
        shapes.append(dict(shape=[M, K, N], body=body, ms=ms,
                           plain_ms=plain_ms, bound_ms=bnd[0],
                           bound_by=bnd[1], library_ms=library_ms,
                           max_abs_err=err))
        if main is None:
            main = _row("vp_dequant_matmul", "vp_dequant_matmul.cu",
                        "src/repro/kernels/vp_dequant_matmul.py:50",
                        [M, K, N], err, ms, plain_ms, bnd, library_ms)
        del w, w_deq
    main["shapes"] = shapes
    print(f"[kernel] vp_dequant_matmul: within {F32_RTOL:g} (f32) and "
          f"{BF16_TOL:g} (bf16) of max|plain| at {list(DQMM_SHAPES)}")
    # What the timer reads for an empty kernel (its floor at the decode
    # shapes), and the host's time per call at w_up decode (wrapper and
    # launch; the device needs less, so the host sets the pace).
    floor_ms = timer(lambda: torch.cuda._sleep(1))
    M, K, N = DQMM_DECODE[0]
    x, w = randn(M, K).to(bf16), words(K, N)
    vp_dequant_matmul_cuda(x, w, vp, bf16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        vp_dequant_matmul_cuda(x, w, vp, bf16)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    print(f"[kernel] timer floor (an empty kernel) {floor_ms:.4f} ms; "
          f"vp_dequant_matmul {[M, K, N]} bf16 host time per call "
          f"(wrapper + launch, 200 calls) {host_us:.1f} us")
    main.update(timer_floor_ms=floor_ms, host_us_per_call=host_us)

    # -- checked only: ragged, unaligned, int8 / int32 words, M > 9 ------------
    def rand_words(K, N, fmt):
        m = torch.randint(fmt.raw_min, fmt.raw_max + 1, (K, N), generator=gen,
                          device="cuda")
        i = torch.randint(0, fmt.K, (K, N), generator=gen, device="cuda")
        return pack_vp(m, i, fmt)

    y_vp = table1_specs()[2].y_vp                 # VP(7,[1,-1]), int8
    vp16 = VPFormat(16, (18, 14))                  # int32 words
    vp10 = VPFormat(10, (12, 8))                   # int16, M > 9
    for (M, K, N), fmt, body in (
            ((33, 96, 24), vp, "tensor_core"),
            ((40, 100, 77), vp, "tensor_core"),   # rows not 16-byte aligned
            ((5, 1000, 3000), vp, "tensor_core"),
            ((3, 100, 77), vp, "skinny"),         # rows not 16-byte aligned
            ((40, 512, 200), vp10, "skinny"),     # M in chunks of 16
            ((20, 300, 40), vp, "tensor_core"),
            ((4, 1024, 3072), y_vp, "skinny"),
            ((512, 1024, 1024), y_vp, "tensor_core"),
            ((4, 1024, 1024), vp16, "skinny"),
            ((512, 256, 264), vp16, "cuda_core"),
            ((1024, 1024, 512), vp10, "cuda_core")):
        check(randn(M, K), rand_words(K, N, fmt), fmt, body,
              f"{[M, K, N]} {fmt}")
        print(f"[kernel] vp_dequant_matmul {[M, K, N]} {fmt} ({body} body): "
              "within tolerance (f32 and bf16)")

    # -- the split bodies run twice: bit-identical ---------------------------------
    for (M, K, N), body in (((4, 3072, 1024), "skinny"),
                            ((512, 1024, 1024), "tensor_core")):
        split = (plan_skinny(M, K, N, num_sms).split if body == "skinny"
                 else plan_tiles(M, N, K, num_sms).split)
        if split < 2:
            raise AssertionError(f"{[M, K, N]}: {body} body does not split")
        w, x32 = words(K, N), randn(M, K)
        for dtype in (f32, bf16):
            x = x32.to(dtype)
            a = vp_dequant_matmul_cuda(x, w, vp, dtype)
            b = vp_dequant_matmul_cuda(x, w, vp, dtype)
            if not torch.equal(a, b):
                raise AssertionError(f"{body} body {[M, K, N]} {dtype}: two "
                                     "runs differ")
        print(f"[kernel] vp_dequant_matmul {[M, K, N]} ({body} body, split "
              f"{split}): two runs bit-identical (f32 and bf16)")

    # -- the three bodies over M: the planner's thresholds --------------------
    sweep = []
    for K, N in DQMM_SWEEP_KN:
        w = words(K, N)
        w_deq = dequant_words(w, vp).to(bf16)
        for M in DQMM_SWEEP_M:
            x = randn(M, K).to(bf16)
            t = {b: timer(lambda: vp_dequant_matmul_cuda(x, w, vp, bf16,
                                                         body=b))
                 for b in BODY_COUNTER}
            lib_ms = timer(lambda: torch.matmul(x, w_deq))
            pick = fwd_body(M, bf16, vp)
            print(f"[kernel] vp_dequant_matmul sweep {[M, K, N]} bf16: skinny "
                  f"{t['skinny']:.4f} ms, tensor cores {t['tensor_core']:.4f}"
                  f" ms, CUDA cores {t['cuda_core']:.4f} ms, torch.matmul "
                  f"{lib_ms:.4f} ms; planner: {pick} (M > 9 formats: "
                  f"{fwd_body(M, bf16, vp10)})")
            sweep.append(dict(shape=[M, K, N], skinny_ms=t["skinny"],
                              tensor_core_ms=t["tensor_core"],
                              cuda_core_ms=t["cuda_core"], library_ms=lib_ms,
                              planner=pick))
    record["dqmm_sweep"] = sweep
    return main


# ---------------------------------------------------------------------------
# 3a. the vp_block path's kernel and the dequant kernels
# ---------------------------------------------------------------------------

def _block_operands(torch, gen, M, K, N, fxp, vp, bk=BLOCK):
    """Block-quantized activations (M, K) along k and weights (K, N)
    along the contraction, as `qdot` in mode vp_block makes them."""
    from repro_torch.core.quantize import block_vp_quantize

    x = torch.randn((M, K), generator=gen, device="cuda")
    x = x / x.abs().max().clamp(min=1e-30) * 0.99
    w = (torch.randn((K, N), generator=gen, device="cuda") * 0.3).clamp(
        -0.99, 0.99)
    return (*block_vp_quantize(x, fxp, vp, bk, axis=-1),
            *block_vp_quantize(w, fxp, vp, bk, axis=0))


def _block_matmul_row(torch, peaks, timer, gen, fxp, vp, lines, record):
    """Row 12, `block_vp_matmul`: each of its three bodies bit-identical
    to the plain version (f32 and bf16 out) at every main-path shape and
    at ragged shapes of its own, and timed at every main-path shape
    beside the plain version and `torch.matmul` on the pre-dequantized
    operands; IGMMA in the tensor-core body's SASS; the bodies over M
    (the planner's threshold)."""
    from repro_torch.core.quantize import block_vp_dequantize
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.vp_block_matmul import (
        BODY_COUNTER, block_body, block_vp_matmul_cuda, plan_skinny)

    igmma = _sass_counts(build._target("vp_block_matmul"), build._nvcc(),
                         "IGMMA")
    tc = {k: v for k, v in igmma.items() if "_tc_kernel" in k}
    if not tc or min(tc.values()) == 0:
        raise AssertionError(f"block_vp_matmul tensor-core body without "
                             f"IGMMA: {igmma}")
    print(f"[kernel] block_vp_matmul SASS: IGMMA {sum(tc.values())} in the "
          f"tensor-core kernel, {sum(igmma.values()) - sum(tc.values())} "
          "elsewhere")
    record["igmma_block_matmul"] = igmma
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    f32, bf16 = torch.float32, torch.bfloat16

    def check(ops_in, bk, body, what):
        """`body` (f32 and bf16 out) bit-identical to the plain version,
        one launch counted on it each."""
        build.reset_launches()
        for dt in (f32, bf16):
            got = block_vp_matmul_cuda(*ops_in, vp, vp, bk, dt, body=body)
            want = ref.block_vp_matmul_ref(*ops_in, vp, vp, bk, dt)
            if got.dtype != want.dtype or not torch.equal(got, want):
                n = int((got.float() != want.float()).sum())
                raise AssertionError(f"block_vp_matmul {what} {body} body "
                                     f"{dt}: {n} of {got.numel()} values "
                                     "differ from the plain version")
        if build.LAUNCHES[BODY_COUNTER[body]] != 2:
            raise AssertionError(f"{what}: launches {dict(build.LAUNCHES)}")

    # -- ragged shapes, each on the body the planner gives it ----------------
    for (M, K, N), bk, body in (
            ((3, 256, 144), BLOCK, "skinny"),
            ((1, 512, 64), BLOCK, "skinny"),
            ((8, 2048, 48), BLOCK, "skinny"),
            ((4, 768, 64), BLOCK, "skinny"),        # 3 tiles in 2 runs
            ((6, 3072, 1040), BLOCK, "skinny"),     # a part column block
            ((130, 512, 80), BLOCK, "tensor_core"),
            ((17, 1024, 3072), BLOCK, "tensor_core"),
            ((200, 768, 208), BLOCK, "tensor_core"),
            ((3, 256, 131), BLOCK, "dp4a"),         # N % 16 != 0
            ((3, 256, 131), 64, "dp4a"),
            ((33, 192, 40), 64, "dp4a"),             # bk other than 256
            ((BATCH, 1024, 3072), 16, "dp4a"),       # the block-16 serve:
            ((BATCH, 3072, 1024), 16, "dp4a"),       # decode and prefill
            ((BATCH * 16, 1024, 1024), 16, "dp4a")):
        if block_body(M, K, N, bk) != body:
            raise AssertionError(f"{[M, K, N]} bk {bk}: planner picks "
                                 f"{block_body(M, K, N, bk)}, not {body}")
        check(_block_operands(torch, gen, M, K, N, fxp, vp, bk), bk, body,
              f"{[M, K, N]} bk {bk}")
    print("[kernel] block_vp_matmul ragged shapes and bk 16 at the block-16 "
          "serve's shapes: each body bit-identical to the plain version (f32 "
          "and bf16)")

    # -- every main-path shape: every body checked and timed -----------------
    main, shapes = None, []
    for (M, K, N) in BLOCK_SHAPES:
        ops_in = _block_operands(torch, gen, M, K, N, fxp, vp)
        pick = block_body(M, K, N, BLOCK)
        want_pick = "skinny" if M == BATCH else "tensor_core"
        if pick != want_pick:
            raise AssertionError(f"{[M, K, N]}: planner picks {pick}")
        plain_ms = timer(lambda: ref.block_vp_matmul_ref(*ops_in, vp, vp,
                                                         BLOCK))
        a32 = block_vp_dequantize(ops_in[0], ops_in[1], vp, BLOCK, axis=-1)
        b32 = block_vp_dequantize(ops_in[2], ops_in[3], vp, BLOCK, axis=0)
        a16, b16 = a32.to(bf16), b32.to(bf16)
        library_ms = timer(lambda: torch.matmul(a16, b16))
        library_f32_ms = timer(lambda: torch.matmul(a32, b32))
        nk = K // BLOCK
        nbytes = M * K + M * nk + K * N + nk * N + M * N * 4
        bnd = bound(peaks, nbytes, 2 * M * K * N, "int8")
        body_ms = {}
        for body in BODY_COUNTER:
            check(ops_in, BLOCK, body, [M, K, N])
            body_ms[body] = timer(lambda: block_vp_matmul_cuda(
                *ops_in, vp, vp, BLOCK, f32, body=body))
        ms = body_ms[pick]
        shape = [M, K, N, BLOCK]
        _print_line("block_vp_matmul", shape, 0.0, 0.0, ms, plain_ms, bnd,
                    library_ms)
        sp = plan_skinny(M, K, N, num_sms)
        split = f"{sp.split} block(s) x {sp.tile_groups} tile group(s)"
        print(f"[kernel]   block_vp_matmul {shape}: {pick} body; skinny "
              f"{body_ms['skinny']:.4f} ms ({split}), tensor cores "
              f"{body_ms['tensor_core']:.4f} ms, dp4a {body_ms['dp4a']:.4f}"
              f" ms; torch.matmul bf16 {library_ms:.4f} ms, f32 "
              f"{library_f32_ms:.4f} ms; {ms / library_ms:.2f}x bf16, "
              f"{bnd[0] / ms:.1%} of the bound")
        lines.append(("block_vp_matmul", shape, ms, plain_ms, bnd,
                      library_ms, library_f32_ms))
        shapes.append(dict(shape=shape, body=pick, ms=ms, body_ms=body_ms,
                           split=split, plain_ms=plain_ms, bound_ms=bnd[0],
                           bound_by=bnd[1], library_ms=library_ms,
                           library_f32_ms=library_f32_ms))
        if main is None:
            main = _row("block_vp_matmul", "vp_block_matmul.cu",
                        "src/repro/kernels/vp_block_matmul.py:52", shape,
                        0.0, ms, plain_ms, bnd, library_ms)
        del ops_in, a32, b32, a16, b16
    main["shapes"] = shapes
    print(f"[kernel] block_vp_matmul: every body bit-identical to the plain "
          f"version (f32 and bf16) at {list(BLOCK_SHAPES)}, bk {BLOCK}")

    # -- the bodies over M: the planner's threshold --------------------------
    sweep = []
    for K, N in BLOCK_SWEEP_KN:
        for M in BLOCK_SWEEP_M:
            ops_in = _block_operands(torch, gen, M, K, N, fxp, vp)
            t = {b: timer(lambda: block_vp_matmul_cuda(
                *ops_in, vp, vp, BLOCK, f32, body=b)) for b in BODY_COUNTER}
            a16 = block_vp_dequantize(ops_in[0], ops_in[1], vp, BLOCK,
                                      axis=-1).to(bf16)
            b16 = block_vp_dequantize(ops_in[2], ops_in[3], vp, BLOCK,
                                      axis=0).to(bf16)
            lib_ms = timer(lambda: torch.matmul(a16, b16))
            pick = block_body(M, K, N, BLOCK)
            print(f"[kernel] block_vp_matmul sweep {[M, K, N]}: skinny "
                  f"{t['skinny']:.4f} ms, tensor cores {t['tensor_core']:.4f}"
                  f" ms, dp4a {t['dp4a']:.4f} ms, torch.matmul bf16 "
                  f"{lib_ms:.4f} ms; planner: {pick}")
            sweep.append(dict(shape=[M, K, N], skinny_ms=t["skinny"],
                              tensor_core_ms=t["tensor_core"],
                              dp4a_ms=t["dp4a"], library_ms=lib_ms,
                              planner=pick))
    record["block_sweep"] = sweep
    return main


def _block_quant_row(torch, peaks, timer, gen, fxp, vp, record):
    """Row 15, the activation block-quantizer (`ops.block_vp_quant`'s
    kernel): every body (small in one block and in clusters of 2-8, coop,
    two-pass) bit-identical to the plain version (significands, indices
    and scale) at the decode, prefill and export shapes, blocks 256 and
    64, f32 and bf16 math, and at the scale's edge cases; a format without
    an index table (the select chain) and one past the fast raw path; 0
    local memory in its SASS; each path shape timed on the body `plan`
    picks beside the others, the small body's cluster swept, and the
    two-pass body's amax pass timed alone against the byte bound."""
    from repro_torch.core.formats import FXPFormat, VPFormat, default_vp_format
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.vp_block_quant import (
        BODIES, block_amax_cuda, block_vp_quant_cuda, plan)

    f32, bf16 = torch.float32, torch.bfloat16
    local = {op: _sass_counts(build._target("vp_block_quant"), build._nvcc(),
                              op) for op in ("LDL", "STL")}
    bad = {op: {k: v for k, v in c.items() if v} for op, c in local.items()}
    print(f"[kernel] vp_block_quant SASS: LDL/STL in {len(local['LDL'])} "
          f"instances: {bad}")
    if any(bad.values()):
        raise AssertionError(f"vp_block_quant: local memory in its SASS {bad}")

    def bodies(R, C, block, axis):
        """(body, cluster) pairs that can run this tensor: the planner's
        first."""
        out = [(plan(R, C, block, axis).body, None)]
        for body in BODIES:
            try:
                plan(R, C, block, axis, body=body)
            except ValueError:
                continue
            if (body, None) not in out:
                out.append((body, None))
        if out[0][0] == "small":
            out += [("small", k) for k in (1, 2, 4, 8)]
        return out

    def check(x, block, axis, mdt, what, f_=fxp, v_=vp, which=None):
        for body, cl in which or bodies(*x.shape, block, axis):
            got = block_vp_quant_cuda(x, f_, v_, block, axis, mdt == bf16,
                                      body=body, cluster=cl)
            want = ref.block_vp_quant_ref(x, f_, v_, block, axis, mdt)
            for g, w, part in zip(got, want, ("significands", "indices",
                                              "scale")):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    n = int((g.float() != w.float()).sum())
                    raise AssertionError(
                        f"vp_block_quant {what} {part} ({body} body, cluster "
                        f"{cl}): {n} of {g.numel()} differ from the plain "
                        f"version (scale {float(got[2])!r} vs "
                        f"{float(want[2])!r})")

    # -- the path's shapes: activations (f32 math) and weights (their own) --
    cases = []
    for (R, C), axis, dt, mdt in (
            ((BATCH, 1024), -1, bf16, f32), ((BATCH, 3072), -1, bf16, f32),
            ((BATCH, 1024), -1, f32, f32),
            ((BATCH * PROMPT, 1024), -1, bf16, f32),
            ((BATCH * PROMPT, 3072), -1, bf16, f32),
            ((BATCH * PROMPT, 3072), -1, f32, f32),
            ((1024, 3072), 0, bf16, bf16), ((3072, 1024), 0, bf16, bf16),
            ((1024, 151936), 0, bf16, bf16), ((1024, 3072), 0, f32, f32),
            ((512, 1000), 0, bf16, bf16)):
        x = (torch.randn((R, C), generator=gen, device="cuda") *
             (0.02 if axis == 0 else 3.0)).to(dt)
        for block in (BLOCK, 64):
            which = ([(plan(R, C, block, axis).body, None)]
                     if R * C > 4e6 else None)
            check(x, block, axis, mdt, f"{[R, C]} axis {axis} {dt} "
                  f"block {block}", which=which)
        cases.append(((R, C), axis, dt, mdt, x))
    # -- the scale's edge cases ----------------------------------------------
    big = [2.0 ** k * (1 + 2.0 ** -23) for k in (-20, 5, 20, 60, 100, 126)]
    edges = {
        "all zero": torch.zeros(BATCH, 1024, device="cuda"),
        "a zero block": torch.cat([torch.zeros(BATCH, 256, device="cuda"),
                                   torch.randn(BATCH, 768, device="cuda")],
                                  1),
        "saturating": torch.randn(BATCH, 1024, device="cuda") * 1e3,
        "bf16 log2 rounds down (amax 16.125)": torch.full(
            (BATCH, 1024), 16.125, device="cuda"),
    }
    for v in big:
        x = torch.randn(BATCH, 1024, generator=gen, device="cuda") * 0.5 * v
        x[0, 0] = v
        edges[f"amax just above 2^{round(math.log2(v))}"] = x
    for what, x in edges.items():
        for dt in (f32, bf16):
            for block in (BLOCK, 64):
                check(x.to(dt), block, -1, dt, f"{what} {dt} block {block}")
            check(x.to(dt).reshape(256, -1), 256, 0, dt,
                  f"{what} {dt} axis 0")
            for block in GENERAL_BLOCKS:
                check(x.to(dt).reshape(512, -1), block, 0, dt,
                      f"{what} {dt} axis 0 block {block}")
    # -- formats off the fast path: the select chain; |raw| past 2^22 --------
    chain = (FXPFormat(12, 2), VPFormat(7, (10, 2)))      # s_0 = -8
    wide = (FXPFormat(24, 20), default_vp_format(FXPFormat(24, 20), 7, 2))
    for (f_, v_), what in ((chain, "select chain"), (wide, "W = 24")):
        for (R, C), axis, dt, mdt in (((BATCH, 1024), -1, bf16, f32),
                                      ((BATCH * PROMPT, 1024), -1, f32, f32),
                                      ((1024, 3072), 0, bf16, bf16)):
            x = (torch.randn((R, C), generator=gen, device="cuda")
                 * 3).to(dt)
            check(x, BLOCK, axis, mdt, f"{what} {[R, C]} axis {axis}", f_,
                  v_)
    # -- blocks off the fast bodies: the general body, on both axes ---------
    general = []
    for (R, C), axis, dt, mdt, blocks in (
            ((BATCH, 1024), -1, bf16, f32, GENERAL_BLOCKS),
            ((BATCH * PROMPT, 3072), -1, f32, f32, GENERAL_BLOCKS),
            ((1024, 3072), 0, bf16, bf16, GENERAL_BLOCKS),
            ((3072, 1024), 0, f32, f32, GENERAL_BLOCKS),
            ((512, 1000), 0, bf16, bf16, GENERAL_BLOCKS),
            ((1024, 151936), 0, bf16, bf16, (16,)),   # lm_head at block 16
            ((151936, 1024), 0, bf16, bf16, (16,)),   # the embedding
            ((6, 1026), -1, f32, f32, (6, 1, 1026)),
            ((6, 1026), -1, bf16, bf16, (6, 1, 1026)),   # rows, bf16 math
            ((96, 1000), 0, bf16, bf16, (6, 1, 96)),
            ((18, 70), 0, f32, f32, (6, 1, 18))):     # a ragged tile edge
        x = (torch.randn((R, C), generator=gen, device="cuda") *
             (0.02 if axis == 0 else 3.0)).to(dt)
        for block in blocks:
            which = ([(plan(R, C, block, axis).body, None)]
                     if R * C > 4e6 else None)
            check(x, block, axis, mdt, f"{[R, C]} axis {axis} {dt} block "
                  f"{block}", which=which)
            general.append(((R, C), axis, dt, mdt, block, x))
    print(f"[kernel] vp_block_quant: every body bit-identical to the plain "
          f"version (significands, indices, scale) at "
          f"{[c[0] for c in cases]}, blocks {BLOCK} and 64, at the scale's "
          f"edge cases {sorted(edges)} (f32 and bf16, both axes; axis 0 "
          f"also at blocks {GENERAL_BLOCKS}), for a format on the select "
          f"chain and one with W = 24; the general body (every other block "
          f"that divides the axis) at "
          f"{sorted({(c[0], c[1], c[4]) for c in general})}")

    # -- timed: the path's shapes on every body that takes them --------------
    main, shapes = None, []
    for (R, C), axis, dt, mdt, x in cases:
        if dt != bf16 or (R, C) in ((3072, 1024), (512, 1000)):
            continue
        bf = mdt == bf16
        n = R * C
        nbytes = n * x.element_size() + n + n // BLOCK + 4
        bnd = bound(peaks, nbytes, 0, "f32")
        plain_ms = timer(lambda: ref.block_vp_quant_ref(x, fxp, vp, BLOCK,
                                                        axis, mdt))
        shape = [R, C, "axis", axis, "bf16"]
        cast_ms = timer(lambda: x.to(torch.int8))
        print(f"[kernel]   vp_block_quant {shape}: a cast moving about the "
              f"same bytes (bf16 -> int8, torch) takes {cast_ms:.4f} ms")
        shapes.append(dict(shape=shape, body="same-bytes cast", ms=cast_ms))
        for body, cl in bodies(R, C, BLOCK, axis):
            if n > 4e6 and body != "two_pass":
                continue
            pl = plan(R, C, BLOCK, axis, body=body, cluster=cl)
            ms = timer(lambda: block_vp_quant_cuda(x, fxp, vp, BLOCK, axis,
                                                   bf, body=body,
                                                   cluster=cl))
            picked = cl is None and body == plan(R, C, BLOCK, axis).body
            launches = 2 if pl.amax_blocks else 1
            tag = f"{body} body" + (f", cluster {pl.grid}"
                                    if body == "small" else "")
            if picked:
                _print_line("vp_block_quant", shape, 0.0, 0.0, ms, plain_ms,
                            bnd, None)
            print(f"[kernel]   vp_block_quant {shape} {tag}"
                  f"{' (planned)' if picked else ''}: {ms:.4f} ms in "
                  f"{launches} launch(es), grid {pl.grid} x {pl.threads}, "
                  f"{bnd[0] / ms:.1%} of the bound")
            shapes.append(dict(shape=shape, body=body, grid=pl.grid,
                               planned=picked, ms=ms, plain_ms=plain_ms,
                               bound_ms=bnd[0], bound_by=bnd[1],
                               launches_per_call=launches))
            if picked and main is None:
                main = _row("vp_block_quant", "vp_block_quant.cu",
                            "src/repro/core/quantize.py:164", shape, 0.0, ms,
                            plain_ms, bnd, None)
        if n > 4e6:   # the two-pass body's amax pass alone
            ms = timer(lambda: block_amax_cuda(x, bf))
            abnd = bound(peaks, n * x.element_size(), 0, "f32")
            print(f"[kernel]   vp_block_amax {shape} alone: {ms:.4f} ms, "
                  f"{abnd[0] / ms:.1%} of the byte bound {abnd[0]:.4f}")
            if abnd[0] / ms < 0.8:
                print("[kernel]   (below 80 % of the bandwidth)")
            shapes.append(dict(shape=shape, body="amax pass", ms=ms,
                               bound_ms=abnd[0], bound_by=abnd[1]))
    # -- the general body timed: the weight exports at blocks 16 and 512 ----
    for (R, C), axis, dt, mdt, block, x in general:
        if axis != 0 or dt != bf16 or (R, C) not in (
                (1024, 3072), (1024, 151936), (151936, 1024)):
            continue
        n = R * C
        bnd = bound(peaks, n * x.element_size() + n + n // block + 4, 0,
                    "f32")
        ms = timer(lambda: block_vp_quant_cuda(x, fxp, vp, block, axis,
                                               mdt == bf16))
        amax_ms = timer(lambda: block_amax_cuda(x, mdt == bf16))
        shape = [R, C, "axis", axis, "bf16", "block", block]
        print(f"[kernel]   vp_block_quant {shape} general body (planned): "
              f"{ms:.4f} ms in 2 launches (amax pass alone {amax_ms:.4f}), "
              f"{bnd[0] / ms:.1%} of the bound {bnd[0]:.4f}")
        shapes.append(dict(shape=shape, body="general", planned=True, ms=ms,
                           amax_ms=amax_ms, bound_ms=bnd[0], bound_by=bnd[1],
                           launches_per_call=2))
    main["shapes"] = shapes
    record["block_quant"] = shapes
    return main


def block_kernel_phase(torch, peaks, record):
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.formats import FXPFormat, default_vp_format
    from repro_torch.kernels import ref
    from repro_torch.kernels.vp_dequant import (
        vp_dequant_packed_cuda, vp_dequant_planes_cuda)
    from repro_torch.kernels.vp_quant import (
        vp_quant_packed_cuda, vp_quant_planes_cuda)
    from repro_torch.mimo.equalizer import table1_specs
    from repro_torch.models.layers import canonical_formats

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    timer = Timer(torch)
    fxp, vp = canonical_formats(QuantConfig(mode="vp_block"))
    lines, rows = [], []

    def identical(got, want, what):
        if got.dtype != want.dtype or not torch.equal(got, want):
            n = int((got.float() != want.float()).sum())
            raise AssertionError(f"{what}: {n} of {got.numel()} values differ "
                                 "from the plain version")

    # -- block_vp_matmul: its three bodies; the activation quantizer -------
    rows.append(_block_matmul_row(torch, peaks, timer, gen, fxp, vp, lines,
                                  record))
    rows.append(_block_quant_row(torch, peaks, timer, gen, fxp, vp, record))

    # -- vp_dequant_packed / vp_dequant_planes: bit-identical ----------------
    R, C = DEQUANT_PACKED
    words = vp_quant_packed_cuda(
        (torch.randn((R, C), generator=gen, device="cuda") * 0.3).clamp(
            -0.99, 0.99), fxp, vp)
    main_pk, casts = None, {}
    for dt, esz in ((torch.float32, 4), (torch.bfloat16, 2)):
        def kern():
            return vp_dequant_packed_cuda(words, vp, dt)

        def plain():
            return ref.vp_dequant_packed_ref(words, vp, dt)

        identical(kern(), plain(), f"vp_dequant_packed {dt}")
        ms, plain_ms = timer(kern), timer(plain)
        # a yardstick, not the function: a cast moves the same bytes
        casts[str(dt)] = cast_ms = timer(lambda: words.to(dt))
        bnd = bound(peaks, R * C * (2 + esz), 0, "f32")
        shape = [R, C, "int16", str(dt).split(".")[-1]]
        _print_line("vp_dequant_packed", shape, 0.0, 0.0, ms, plain_ms, bnd,
                    None)
        print(f"[kernel] vp_dequant_packed {shape}: {ms:.4f} ms "
              f"({bnd[0] / ms:.1%} of the bound {bnd[0]:.4f}; aim <= "
              f"{2 * bnd[0]:.4f}); words.to({dt}) {cast_ms:.4f} ms")
        lines.append(("vp_dequant_packed", shape, ms, plain_ms, bnd, None,
                      None))
        if main_pk is None:
            main_pk = _row("vp_dequant_packed", "vp_dequant.cu",
                           "src/repro/kernels/vp_dequant.py:52", shape, 0.0,
                           ms, plain_ms, bnd, None)
    main_pk["cast_ms"] = casts
    fxp6 = FXPFormat(12, 11)
    vp6 = default_vp_format(fxp6, 6, 2)          # int8 words
    words6 = vp_quant_packed_cuda(
        (torch.randn((R, C), generator=gen, device="cuda") * 0.3).clamp(
            -0.99, 0.99), fxp6, vp6)
    # whole tensors, then ragged and unaligned slices: the head (up to 15
    # words before the first 16-byte boundary), the vector steps and the
    # tail, and stores one by one where out + head is not aligned
    flat16, flat8 = words.reshape(-1), words6.reshape(-1)
    pieces = [(words6, vp6, "int8 words")]
    for lo, n in ((0, 1), (0, 7), (0, 1003), (1, 5), (3, 100_003),
                  (7, 4099), (5, 8 * 4096 + 3)):
        pieces.append((flat16[lo:lo + n], vp, f"int16 words [{lo}:+{n}]"))
    for lo, n in ((0, 15), (1, 17), (9, 100_001), (15, 16 * 4096 + 5)):
        pieces.append((flat8[lo:lo + n], vp6, f"int8 words [{lo}:+{n}]"))
    for w_, v_, what in pieces:
        for dt in (torch.float32, torch.bfloat16):
            identical(vp_dequant_packed_cuda(w_, v_, dt),
                      ref.vp_dequant_packed_ref(w_, v_, dt),
                      f"vp_dequant_packed {what} {dt}")
    wv, wf = table1_specs()[2].w_vp, table1_specs()[2].w_fxp
    R, C = DEQUANT_PLANES
    m, i = vp_quant_planes_cuda(
        torch.randn((R, C), generator=gen, device="cuda") * 0.05, wf, wv)
    for dt in (torch.bfloat16, torch.float32):     # the f32 line is timed
        identical(vp_dequant_planes_cuda(m, i, wv, dt),
                  ref.vp_dequant_ref(m, i, wv, dt),
                  f"vp_dequant_planes {dt}")
    ms = timer(lambda: vp_dequant_planes_cuda(m, i, wv, torch.float32))
    plain_ms = timer(lambda: ref.vp_dequant_ref(m, i, wv, torch.float32))
    bnd = bound(peaks, R * C * (1 + 1 + 4), 0, "f32")
    shape = [R, C, "int8+uint8", "float32"]
    _print_line("vp_dequant_planes", shape, 0.0, 0.0, ms, plain_ms, bnd, None)
    lines.append(("vp_dequant_planes", shape, ms, plain_ms, bnd, None, None))
    rows += [_row("vp_dequant_planes", "vp_dequant.cu",
                  "src/repro/kernels/vp_dequant.py:31", shape, 0.0, ms,
                  plain_ms, bnd, None), main_pk]
    print(f"[kernel] vp_dequant_packed (int16 and int8 words, whole and "
          f"{len(pieces) - 1} ragged or unaligned slices; f32, bf16) and "
          f"vp_dequant_planes (int8; f32, bf16): bit-identical to their "
          f"plain versions")
    record["block_kernel_lines"] = [
        dict(name=n, shape=s, ms=m_, plain_ms=p, bound_ms=b[0],
             bound_by=b[1], library_ms=lib, library_f32_ms=lib32)
        for n, s, m_, p, b, lib, lib32 in lines]
    print("kernels: block_vp_matmul, vp_block_quant, vp_dequant_packed, "
          "vp_dequant_planes")
    return rows


# ---------------------------------------------------------------------------
# 4. serve
# ---------------------------------------------------------------------------

def _weight_shapes(cfg):
    """(K, N) of a layer's 7 weights: q, k, v, o, gate, up, down."""
    d, dh, ff = cfg.d_model, cfg.head_dim, cfg.d_ff
    q, kv = cfg.n_heads * dh, cfg.n_kv_heads * dh
    return ((d, q), (d, kv), (d, kv), (q, d), (d, ff), (d, ff), (ff, d))


def _dqmm_counts(torch, cfg, M: int):
    """The launches `vp_dequant_matmul` makes in one pass over the layers'
    weights at M tokens: the body `fwd_body` picks and, on the tensor-core
    body, the split reductions `plan_tiles` plans."""
    from repro_torch.kernels.vp_bwd_matmul import plan_tiles
    from repro_torch.kernels.vp_dequant_matmul import BODY_COUNTER, fwd_body
    from repro_torch.models.layers import canonical_formats

    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    body = fwd_body(M, getattr(torch, cfg.dtype),
                    canonical_formats(cfg.quant)[1])
    n = cfg.n_layers * 7
    out = {"vp_dequant_matmul": n, BODY_COUNTER[body]: n}
    if body == "tensor_core":
        red = sum(plan_tiles(M, N, K, num_sms).split > 1
                  for K, N in _weight_shapes(cfg))
        if red:
            out["vp_dqmm_splitk_reduce"] = cfg.n_layers * red
    return out


def _attention_counts(torch, cfg, prefill: bool):
    """Attention launches of one pass over the layers: prefill on the body
    `flash_body` picks for the model's dtype (the tensor cores in bf16),
    decode on the split body."""
    from repro_torch.kernels.vp_attention import BODY_COUNTER, flash_body

    L = cfg.n_layers
    if not prefill:
        return {"vp_decode_attention": L, "vp_dec_split": L}
    body = flash_body(getattr(torch, cfg.dtype), cfg.head_dim)
    return {"flash_prefill": L, BODY_COUNTER[body]: L}


def _add(*counts):
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def _qp(n: int, body: str):
    """n `vp_quant_packed` launches on `body` (table, chain or kv)."""
    from repro_torch.kernels.vp_quant import BODY_COUNTER

    return {"vp_quant_packed": n, BODY_COUNTER[body]: n}


def serve_phase(torch, record, rows):
    """Mode vp: packed VP weights through `vp_dequant_matmul`: prefill's
    weight matmuls (M = 4 x 128) on the tensor-core body, every decode
    matmul and `lm_head` (M = 4) on the skinny body."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import QuantConfig

    quant = QuantConfig(mode="vp", quantize_kv_cache=True)
    cfg = registry.get_config(ARCH, quant)
    L = cfg.n_layers
    head = {"vp_dequant_matmul": 1, "vp_dqmm_skinny": 1}     # lm_head
    prefill = _add(_dqmm_counts(torch, cfg, BATCH * PROMPT), head,
                   _qp(2 * L, "kv"), _attention_counts(torch, cfg, True))
    decode = _add(_dqmm_counts(torch, cfg, BATCH), head,
                  _qp(2 * L, "kv"), _attention_counts(torch, cfg, False))
    if prefill.get("vp_dqmm_tc") != 7 * L or decode.get(
            "vp_dqmm_skinny") != 7 * L + 1 or prefill.get(
            "flash_tc") != L or decode.get("vp_dec_split") != L:
        raise AssertionError(f"planned bodies: prefill {prefill}, decode "
                             f"{decode}")
    expect = _add(prefill, *[decode] * GEN, _qp(7 * L + 2, "table"))
    out = _serve(torch, quant, expect, {"prefill": prefill,
                                        "decode step": decode},
                 requantizes=False)
    got = out["launches"]
    print(f"[serve vp] attention bodies: flash_prefill {got['flash_prefill']}"
          f" ({got.get('flash_tc', 0)} tensor-core, "
          f"{got.get('flash_cuda_core', 0)} CUDA-core), vp_decode_attention "
          f"{got['vp_decode_attention']} ({got.get('vp_dec_split', 0)} split)")
    for row in rows:
        if row["name"] in expect:
            row["launches"] = got[row["name"]]
        if row["name"] == "flash_prefill":
            row["body_launches"] = {"tensor_core": got.get("flash_tc", 0),
                                    "cuda_core": got.get("flash_cuda_core",
                                                         0)}
        elif row["name"] == "vp_decode_attention":
            row["body_launches"] = {"split": got.get("vp_dec_split", 0)}
    record["serve"] = out


def serve_block_phase(torch, record, rows, smi):
    """Mode vp_block: every weight matmul through `block_vp_matmul` (the
    skinny body at decode and for `lm_head`, the tensor-core body for
    prefill's layer weights), its activations block-quantized by the
    `vp_block_quant` kernel, which also exports every weight whose d_in
    is a multiple of the block; the embedding table (vocab 151936 = 593.5
    blocks of 256) falls back to packed VP words, exported by the quant
    kernel."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels.vp_block_matmul import BODY_COUNTER
    from repro_torch.kernels.vp_block_quant import BODY_COUNTER as BQ_BODY

    quant = QuantConfig(mode="vp_block", block=BLOCK, quantize_kv_cache=True)
    cfg = registry.get_config(ARCH, quant)
    L = cfg.n_layers
    export, prefill, decode = _block_serve_counts(torch, cfg, BLOCK, BATCH,
                                                  PROMPT)
    if (prefill.get("vp_bmm_tc") != 7 * L
            or prefill.get("flash_tc") != L
            or decode.get("vp_dec_split") != L
            or prefill.get("vp_bmm_skinny") != 1
            or decode.get("vp_bmm_skinny") != 7 * L + 1
            or decode.get("vp_block_quant") != 4 * L + 1
            or decode.get("vp_bq_small") != 4 * L + 1
            or prefill.get("vp_bq_coop") != 4 * L
            or "vp_block_amax" in prefill or "vp_block_amax" in decode):
        raise AssertionError(f"planned bodies: prefill {prefill}, decode "
                             f"{decode}")
    if export.get("vp_block_amax") != 1:
        raise AssertionError(f"planned export: {export}")
    expect = _add(export, prefill, *[decode] * GEN)
    out = _serve(torch, quant, expect, {"prefill": prefill,
                                        "decode step": decode},
                 requantizes=True)
    got = out["launches"]
    print(f"[serve vp_block] block_vp_matmul bodies: skinny "
          f"{got.get('vp_bmm_skinny', 0)}, tensor cores "
          f"{got.get('vp_bmm_tc', 0)}, dp4a {got.get('vp_bmm_dp4a', 0)}; "
          f"vp_block_quant {got.get('vp_block_quant', 0)} calls "
          f"(small {got.get('vp_bq_small', 0)}, coop "
          f"{got.get('vp_bq_coop', 0)}, two-pass "
          f"{got.get('vp_bq_two_pass', 0)}; "
          f"{got.get('vp_block_amax', 0)} with an amax pass); "
          f"flash_prefill on the tensor cores {got.get('flash_tc', 0)}, "
          f"vp_decode_attention split {got.get('vp_dec_split', 0)}")
    for row in rows:
        if row["name"] == "block_vp_matmul":
            row["launches"] = got["block_vp_matmul"]
            row["body_launches"] = {b: got.get(c, 0)
                                    for b, c in BODY_COUNTER.items()}
        elif row["name"] == "vp_block_quant":
            row["launches"] = got["vp_block_quant"]
            row["amax_launches"] = got.get("vp_block_amax", 0)
            row["body_launches"] = {b: got.get(c, 0)
                                    for b, c in BQ_BODY.items()}
        elif row["name"] in expect:
            row["block_serve_launches"] = got[row["name"]]
    print(f"[serve vp_block] {smi}")
    record["serve_vp_block"] = out


def _block_serve_counts(torch, cfg, block: int, batch: int, prompt: int):
    """The launches of the vp_block serve at index block `block`, batch x
    prompt tokens: (export, prefill, one decode step).  The export
    block-quantizes every weight whose contraction dim the block divides
    (the embedding's vocab rows included) and packs the rest; a pass runs
    7 L + 1 weight matmuls (`lm_head` reads the last position only: batch
    rows) on the activations of 4 L + 1 quantizer calls (q, k and v share
    theirs, and gate and up)."""
    from repro_torch.kernels.vp_block_matmul import BODY_COUNTER, block_body
    from repro_torch.kernels.vp_block_quant import BODY_COUNTER as BQ_BODY
    from repro_torch.kernels.vp_block_quant import plan

    L = cfg.n_layers
    head = (cfg.d_model, cfg.vocab)

    def quantizes(R, C, axis):
        """The launches of one `vp_block_quant` call."""
        p = plan(R, C, block, axis)
        out = {"vp_block_quant": 1, BQ_BODY[p.body]: 1}
        if p.amax_blocks:
            out["vp_block_amax"] = 1
        return out

    def matmuls(M):
        counts = {}
        for m, K, N in ([(M, K, N) for K, N in _weight_shapes(cfg)] * L
                        + [(batch, *head)]):
            counts = _add(counts, {"block_vp_matmul": 1,
                                   BODY_COUNTER[block_body(m, K, N, block)]: 1})
        w = _weight_shapes(cfg)         # inputs of q/k/v, o, gate/up, down
        acts = [(M, w[i][0]) for i in (0, 3, 4, 6)] * L + [
            (batch, cfg.d_model)]
        return _add(counts, *[quantizes(m, K, -1) for m, K in acts])

    prefill = _add(matmuls(batch * prompt), _qp(2 * L, "kv"),
                   _attention_counts(torch, cfg, True))
    decode = _add(matmuls(batch), _qp(2 * L, "kv"),
                  _attention_counts(torch, cfg, False))
    weights = list(_weight_shapes(cfg)) * L + [head, (cfg.vocab,
                                                      cfg.d_model)]
    export = _add(*[quantizes(K, N, 0) if K % block == 0 else
                    _qp(1, "table") for K, N in weights])
    return export, prefill, decode


def serve_block16_phase(torch, record, rows, smi):
    """`--quant vp_block --block 16` through the serve CLI
    (`launch.serve.main`), full width and short (BLOCK16_SERVE): every
    weight, the embedding and `lm_head` included, exported by the
    quantizer's general body (axis 0 at block 16), the activations on its
    small and coop bodies, every weight matmul on `block_vp_matmul`'s dp4a
    body (bk 16); the CLI raises on non-finite logits.  Then the export
    against the plain export, and the logits against the plain path."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.launch.serve import run_static
    from repro_torch.models.model import init_params, quantize_params

    B, S, steps = BLOCK16_SERVE
    block = GENERAL_BLOCKS[0]
    cfg = registry.get_config(ARCH, QuantConfig(
        mode="vp_block", block=block, quantize_kv_cache=True))
    L = cfg.n_layers
    export, prefill, decode = _block_serve_counts(torch, cfg, block, B, S)
    if (export.get("vp_bq_general") != 7 * L + 2
            or prefill.get("vp_bmm_dp4a") != 7 * L + 1
            or decode.get("vp_bmm_dp4a") != 7 * L + 1):
        raise AssertionError(f"planned block-16 serve: export {export}, "
                             f"prefill {prefill}, decode {decode}")
    expect = _add(export, prefill, *[decode] * steps)
    torch.cuda.synchronize()
    build.reset_launches()
    # -- the main path: the serve CLI at block 16 ----------------------------
    report = serve.main(["--arch", ARCH, "--quant", "vp_block", "--block",
                         str(block), "--kv-quant", "--batch", str(B),
                         "--prompt-len", str(S), "--gen", str(steps)])
    counts = dict(build.LAUNCHES)
    # -------------------------------------------------------------------------
    print(f"[serve vp_block 16] {cfg.name} at block {block}, batch {B}, "
          f"prompt {S}, {steps} decode steps (the full depth, {L} layers): "
          f"export {report['export_s']:.3f}s, prefill "
          f"{report['prefill_s']:.4f}s, decode {report['decode_s']:.4f}s; "
          f"launches {counts}; {smi}")
    if counts != expect:
        raise AssertionError(f"block-16 serve launch counts {counts} != "
                             f"expected {expect}")
    for row in rows:
        if row["name"] in ("vp_block_quant", "block_vp_matmul"):
            row["block16_launches"] = counts[row["name"]]

    # -- the same model against the plain path -------------------------------
    # The export bit for bit (every weight on the general body), then the
    # CLI's prompts teacher-forced on the kernel path's tokens, held as in
    # `_serve` to max(REL_LIMIT, FLOOR_MARGIN x the plain path's floor).
    raw = init_params(cfg, seed=0, device="cuda")
    qp = quantize_params(raw, cfg)
    with ops.force_backend("ref"):
        want = quantize_params(raw, cfg)
    del raw
    got, exp = tree.tree_paths(qp), tree.tree_paths(want)
    if [k for k, _ in got] != [k for k, _ in exp]:
        raise AssertionError("block-16 export: the trees differ")
    for (path, g), (_, w) in zip(got, exp):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"block-16 export {path} differs from the "
                                 "plain export")
    leaves = len(got)
    del want, got, exp
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)).astype(np.int64)).cuda()
    tokens, logits = run_static(qp, cfg, prompts, steps)
    rels, agree = _rel_diffs(torch, logits, _plain_logits(
        torch, cfg, qp, prompts, tokens))
    floor, _ = _rel_diffs(torch, _plain_logits(
        torch, cfg, qp, prompts, tokens, f64_matmul=True,
        f64_attention=True), _plain_logits(torch, cfg, qp, prompts, tokens))
    limit = max(REL_LIMIT, FLOOR_MARGIN * max(floor))
    print(f"[serve vp_block 16] export bit-identical to the plain export "
          f"({leaves} tensors); bf16 kernel vs plain, teacher-forced: max "
          f"|logit diff| / max|logit| {max(rels):.3e} over {len(rels)} steps "
          f"(plain-path floor {max(floor):.3e}; limit {limit:.3e}); "
          f"greedy-token agreement {agree:.4f}")
    if max(rels) > limit:
        raise AssertionError(f"block-16 serve differs from the plain path by "
                             f"{max(rels):.3e} > {limit:.3e}")
    record["serve_vp_block16"] = dict(
        report, launches=counts, bf16_rel_logit_diff=rels,
        bf16_plain_floor=floor, bf16_limit=limit, bf16_token_agreement=agree)


def _serve(torch, quant, expect, passes, requantizes: bool):
    """Serve full-width qwen3-0.6b in `quant`'s mode: export, prefill
    BATCH x PROMPT, GEN greedy steps; launch counts (== `expect`), a
    profile of one prefill and one decode step (hand kernels only, as
    many of each as `passes` says: the KV quantizer, the weight matmul
    kernel and attention; no library GEMM or attention kernel), and the
    plain path teacher-forced on the kernel path's tokens in bf16 and f32.

    bf16 is held to max(REL_LIMIT, FLOOR_MARGIN x the plain path's own
    floor: its run with f64-summed matmuls against itself); f32 to
    F32_REL_LIMIT.  A mode that `requantizes` its activations (vp_block)
    turns a one-ulp difference into a one-step flip of a significand, or
    of a whole block's exponent, so there the floor run sums attention
    in f64 too (its matmuls are exact in f32: block-VP terms on a few
    pow2 grids), and f32 is held to the larger of F32_REL_LIMIT and the
    same margin over the f32 floor."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.kernels import build
    from repro_torch.launch.serve import run_static
    from repro_torch.models.layers import weight_bytes
    from repro_torch.models.model import (
        decode_step, init_cache, init_params, prefill, quantize_params)

    cfg = registry.get_config(ARCH, quant)
    L, tag = cfg.n_layers, f"[serve {quant.mode}]"
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)).cuda()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    # -- the main path: export, prefill, decode --------------------------------
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams = quantize_params(params, cfg)
    del params
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    report = {}
    tokens, logits = run_static(qparams, cfg, prompts, GEN, report)
    counts = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # -------------------------------------------------------------------------
    words = weight_bytes(qparams)
    layout = {k: sorted(qparams[k]) for k in ("embed", "lm_head")}
    print(f"{tag} {cfg.name}: {L} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}, {cfg.dtype}; exported weights {words / 1e9:.3f} GB; "
          f"layouts {layout}")
    print(f"{tag} init {init_s:.3f}s, export {export_s:.3f}s, prefill "
          f"{BATCH}x{PROMPT} {report['prefill_s']:.4f}s, decode {GEN} steps "
          f"{report['decode_s']:.4f}s ({report['tokens_per_s']:.1f} tok/s, "
          f"{report['decode_s'] / GEN * 1e3:.3f} ms/step), peak memory "
          f"{peak / 1e9:.3f} GB")
    print(f"{tag} launches on the main path: {counts}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != expected {expect}")
    for lg in logits:
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError("non-finite logits on the kernel path")

    # -- profiler: one prefill and one decode step --------------------------
    empty, caches = init_cache(cfg, BATCH, PROMPT + GEN), {}

    def prefill_once():  # rewrites slots [0, PROMPT) of the same buffers
        caches["after"] = prefill(qparams, prompts, empty, cfg)[1]

    names, seen = _profile_kernels(torch, [
        ("prefill", prefill_once, passes["prefill"]),
        ("decode step", lambda: decode_step(qparams, tokens[:, :1],
                                            caches["after"], cfg),
         passes["decode step"])])
    library = sorted({n for n in names if LIBRARY_KERNELS.search(n)
                      and not any(v in n for v in KERNEL_NAMES.values())})
    print(f"[profile] {len(names)} device kernels in one prefill + one "
          f"decode step; hand kernels {seen}")
    if library:
        raise AssertionError(f"library kernels on the path: {library}")
    print("[profile] no library GEMM or attention kernel")

    # -- the plain path, teacher-forced on the kernel path's tokens ----------
    # bf16: two plain runs that differ only in the matmul's summation
    # precision (f32 vs f64) set the rounding floor of this 28-layer
    # random-weight model; the kernel path is held to the larger of
    # REL_LIMIT and 1.5 times that floor, measured here on the same tokens.
    plain = _plain_logits(torch, cfg, qparams, prompts, tokens)
    rels, agree = _rel_diffs(torch, logits, plain)
    floor, _ = _rel_diffs(torch, _plain_logits(
        torch, cfg, qparams, prompts, tokens, f64_matmul=True,
        f64_attention=requantizes), plain)
    limit = max(REL_LIMIT, FLOOR_MARGIN * max(floor))
    print(f"{tag} bf16 kernel vs plain, per step (prefill first): "
          + " ".join(f"{r:.2e}" for r in rels))
    print(f"{tag} bf16 plain (f64 sums) vs plain, per step: "
          + " ".join(f"{r:.2e}" for r in floor))
    print(f"{tag} bf16 kernel path vs plain path: max |logit diff| / "
          f"max|logit| = {max(rels):.3e} over {len(rels)} steps; plain-path "
          f"floor {max(floor):.3e}; limit {limit:.3e}; greedy-token "
          f"agreement {agree:.4f}")
    if max(rels) > limit:
        raise AssertionError(f"bf16 kernel path differs from the plain path "
                             f"by {max(rels):.3e} > {limit:.3e}")
    del qparams, logits, plain

    # f32: the same model and tokens with no bf16 rounding in the way.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    qp32 = quantize_params(init_params(cfg32, seed=0, device="cuda"), cfg32)
    tok32, lg32 = run_static(qp32, cfg32, prompts, GEN)
    plain32 = _plain_logits(torch, cfg32, qp32, prompts, tok32)
    rels32, agree32 = _rel_diffs(torch, lg32, plain32)
    floor32, limit32 = None, F32_REL_LIMIT
    if requantizes:
        floor32, _ = _rel_diffs(torch, _plain_logits(
            torch, cfg32, qp32, prompts, tok32, f64_matmul=True,
            f64_attention=True), plain32)
        limit32 = max(F32_REL_LIMIT, FLOOR_MARGIN * max(floor32))
        print(f"{tag} f32 plain (f64 sums) vs plain, per step: "
              + " ".join(f"{r:.2e}" for r in floor32))
    print(f"{tag} f32 kernel vs plain, per step (prefill first): "
          + " ".join(f"{r:.2e}" for r in rels32))
    print(f"{tag} f32 kernel path vs plain path: max {max(rels32):.3e} "
          + (f"(plain-path floor {max(floor32):.3e}; " if requantizes
             else "(")
          + f"limit {limit32:.3e}); greedy-token agreement {agree32:.4f}")
    if max(rels32) > limit32:
        raise AssertionError(f"f32 kernel path differs from the plain path "
                             f"by {max(rels32):.3e} > {limit32:.3e}")
    return dict(
        init_s=init_s, export_s=export_s, **report, peak_bytes=peak,
        weight_bytes=words, layouts=layout, launches=counts, profiled=seen,
        bf16_rel_logit_diff=rels, bf16_plain_floor=floor, bf16_limit=limit,
        bf16_token_agreement=agree, f32_rel_logit_diff=rels32,
        f32_plain_floor=floor32, f32_limit=limit32,
        f32_token_agreement=agree32)


# ---------------------------------------------------------------------------
# 4b. the continuous-batching engine
# ---------------------------------------------------------------------------

def _engine_requests(cfg, n: int):
    """n requests from numpy seed 0: (prompt of ENGINE_PROMPT tokens,
    ragged, generation budget in ENGINE_GEN, ragged)."""
    import numpy as np

    rng = np.random.default_rng(0)
    lens = rng.integers(ENGINE_PROMPT[0], ENGINE_PROMPT[1] + 1, n)
    gens = rng.integers(ENGINE_GEN[0], ENGINE_GEN[1] + 1, n)
    return [([int(t) for t in rng.integers(0, cfg.vocab, int(s))], int(g))
            for s, g in zip(lens, gens)]


def _engine(cfg, params, **kw):
    from repro_torch.serving import ServingEngine, VirtualClock

    kw.setdefault("max_slots", ENGINE_SLOTS)
    kw.setdefault("capacity", ENGINE_CAP)
    kw.setdefault("page_size", ENGINE_PAGE)
    return ServingEngine(params, cfg, clock=VirtualClock(), check_graphs=True,
                         check_finite=True, on_nonfinite="raise", **kw)


def _engine_wave(torch, eng, reqs, logits=None):
    """Submit `reqs` at time 0 and serve them -> (records, wall s,
    [(decode call wall s, steps, (bucket, steps))], kernels that ran).

    `logits` (a dict) collects each request's logits, by rid: the
    prefill's, then every decode step's (the engine's finite screen sees
    them; run-ahead past the budget included).  The kernels that ran are
    the wrappers' counts less the launches recorded into graphs plus
    those of every replay (`ModelRunner`)."""
    from repro_torch.kernels import build

    runner = eng.runner
    screen, decode = eng._screen, runner.decode_batch
    calls = []

    def spy_screen(phase, run, lg):
        if logits is not None and phase in ("prefill", "decode"):
            logits.setdefault(run.req.rid, []).append(lg.reshape(
                -1, lg.shape[-1]))
        return screen(phase, run, lg)

    def spy_decode(params, slot_tokens, key, steps=1, **kw):
        t = time.perf_counter()
        out = decode(params, slot_tokens, key, steps, **kw)
        bucket = min(1 << (len(slot_tokens) - 1).bit_length(),
                     eng.kv.max_slots)
        calls.append((time.perf_counter() - t, steps, (bucket, steps)))
        return out

    eng._screen, runner.decode_batch = spy_screen, spy_decode
    launches = collections.Counter(build.LAUNCHES)
    captured = collections.Counter(runner.captured)
    replayed = collections.Counter(runner.replayed)
    try:
        rids = [eng.submit(prompt, gen, 0.0).rid for prompt, gen in reqs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = [r for r in eng.run() if r["rid"] in rids]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del eng._screen, runner.decode_batch
    ran = (collections.Counter(build.LAUNCHES) - launches) \
        - (runner.captured - captured) + (runner.replayed - replayed)
    bad = [r["rid"] for r, (_, gen) in zip(recs, reqs)
           if r["outcome"] != "ok" or len(r["tokens"]) != gen]
    if len(recs) != len(reqs) or bad:
        raise AssertionError(f"engine requests {bad} did not complete")
    return recs, wall, calls, dict(ran)


def _decode_rates(recs, calls):
    """Decode time per step of each (bucket, steps) and over the wave, and
    decode tokens/s counting only the tokens kept (each request's tokens
    after its prefill's; run-ahead past a budget is dropped)."""
    dec_s = sum(c[0] for c in calls)
    per = collections.defaultdict(lambda: [0.0, 0])
    for wall, steps, bucket in calls:
        per[bucket][0] += wall
        per[bucket][1] += steps
    return dict(
        decode_s=dec_s, decode_calls=len(calls),
        decode_ms_per_step=dec_s / sum(c[1] for c in calls) * 1e3,
        bucket_ms_per_step={f"{b}x{n}": t / k * 1e3
                            for (b, n), (t, k) in sorted(per.items())},
        decode_tok_s=sum(len(r["tokens"]) - 1 for r in recs) / dec_s)


def _check_graph_log(runner, tag):
    """Every captured bucket held its first replay bit-identical to the
    eager step (`check_graphs`); print the buckets."""
    log = runner.graph_log
    if not log or not all(e["identical"] for e in log):
        raise AssertionError(f"{tag}: graph checks {log}")
    print(f"{tag} {len(log)} decode graphs, each replay bit-identical "
          f"(tokens, logits, pools, lengths) to the eager step: buckets (slots, "
          f"steps) {[e['bucket'] for e in log]}; hand kernels per replay "
          + "; ".join(f"{e['bucket']}: " + str(sum(
              v for k, v in e["launches"].items() if k in _ENGINE_ROWS))
              for e in log))


def _engine_plain(torch, cfg, params, reqs, recs, logits, floor=0,
                  chunk=None, f64_attention=False):
    """Per request, max|engine logit - plain logit| / max|plain logit| over
    its steps, the plain path (`_plain_logits` at B = 1, max_len =
    ENGINE_CAP, the prompt whole or in chunks of `chunk`) teacher-forced
    on the engine's tokens -> (rels, floors): for the first `floor`
    requests also the plain path's own floor, the same run with its
    matmuls (and with `f64_attention` its attention, where the path
    requantizes activations) summed in f64 against the f32-summed one."""
    import numpy as np

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    rels, floors = [], []
    for i, ((prompt, _), rec) in enumerate(zip(reqs, recs)):
        toks = rec["tokens"]
        args = (torch, cfg, params, torch.tensor([prompt], device="cuda"),
                torch.tensor([toks[:-1]], dtype=torch.int32, device="cuda"))
        want = torch.cat(_plain_logits(*args, max_len=ENGINE_CAP,
                                       chunk=chunk))
        got = torch.from_numpy(np.concatenate(
            logits[rec["rid"]])[:len(toks)]).cuda()
        rels.append(rel(got, want))
        if i < floor:
            floors.append(rel(torch.cat(_plain_logits(
                *args, f64_matmul=True, f64_attention=f64_attention,
                max_len=ENGINE_CAP, chunk=chunk)), want))
    return rels, floors


def _engine_shapes(torch, cfg, block_cfg, block_params, prompt_len):
    """The side runs' kernels at the shapes the engine gives them, each
    bit-identical to its plain version on the same inputs (bf16, numpy
    seed 0): the planes KV write of a prompt and of a decode step at
    buckets 1 and 2 (`vp_quant_planes`), the planes cache read at those
    buckets (`vp_dequant_planes`), a chunked prefill's read of the packed
    history (`vp_dequant_packed`), and the vp_block linear
    (`vp_block_quant`, then `block_vp_matmul`) of every layer-0 weight
    and lm_head at buckets 1 and 2."""
    import dataclasses as dc

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.attention import (dequantize_kv,
                                              dequantize_kv_packed,
                                              quantize_kv)
    from repro_torch.models.layers import qdot

    rng = np.random.default_rng(0)
    KV, dh, dt = cfg.n_kv_heads, cfg.head_dim, torch.bfloat16
    q, qb = cfg.quant, block_cfg.quant
    planes = dc.replace(q, kv_layout="planes")

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", dt)

    cases = [(f"planes write {(1, prompt_len, KV, dh)}",
              lambda x: quantize_kv(x, planes, "planes"),
              randn(1, prompt_len, KV, dh))]
    for Bp in (1, 2):
        with ops.force_backend("ref"):
            mis = quantize_kv(randn(Bp, ENGINE_CAP, KV, dh), planes, "planes")
        cases += [(f"planes write {(Bp, 1, KV, dh)}",
                   lambda x: quantize_kv(x, planes, "planes"),
                   randn(Bp, 1, KV, dh)),
                  (f"planes read {(Bp, ENGINE_CAP, KV, dh)}",
                   lambda t: dequantize_kv(*t, planes, dt), mis)]
    with ops.force_backend("ref"):
        ws = quantize_kv(randn(1, ENGINE_CAP, KV, dh), q)
    cases.append((f"packed history read {(1, ENGINE_CAP, KV, dh)}",
                  lambda t: dequantize_kv_packed(*t, q, dt), ws))
    layer = block_params["layers"][0]
    weights = {**{k: w for k, w in layer["attn"].items()
                  if isinstance(w, dict)},
               **layer["mlp"], "lm_head": block_params["lm_head"]}
    for name, w in weights.items():
        if "i_blk" not in w:
            continue
        for M in (1, 2):
            cases.append((f"vp_block {name} at M {M}",
                          lambda x, w=w: qdot(x, w, qb),
                          randn(M, w["m"].shape[0])))
    for what, fn, x in cases:
        got = fn(x)
        with ops.force_backend("ref"):
            want = fn(x)
        got, want = ((t,) if torch.is_tensor(t) else t for t in (got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"[engine] {what}: kernel differs from its "
                                 "plain version")
    return [c[0] for c in cases]


def _engine_counts(ran):
    return {k: ran.get(k, 0) for k in _ENGINE_ROWS if ran.get(k, 0)}


def engine_phase(torch, record, rows, smi):
    """The paged continuous-batching engine (`repro_torch.serving`) on
    full-width qwen3-0.6b, bf16, packed VP weights and KV cache:
    ENGINE_REQS ragged requests (numpy seed 0) through ENGINE_SLOTS slots
    of ENGINE_PAGE-position pages, capacity ENGINE_CAP, every decode step
    one CUDA graph replay per (bucket, steps), run-ahead 4 then 1, which
    must give the same tokens (a row's bits do not depend on its bucket).

    (a) each captured bucket's first replay bit-identical to the eager
    step on the same inputs and state; (b) every request's logits against
    the plain path teacher-forced on its tokens (bf16: max(REL_LIMIT,
    FLOOR_MARGIN x the plain path's f64-summed floor); f32 at
    ENGINE_F32_LAYERS layers: F32_REL_LIMIT); (c) short runs with
    chunked prefill, the planes KV layout, vp_block at block 256 (one
    slot: its per-tensor activation scale couples co-batched requests)
    and sampling, each showing its kernels on the engine's path and held
    as in (b) against the plain path of its config, and those kernels at
    the engine's shapes bit-identical to their plain versions
    (`_engine_shapes`); (d) a profile of one decode replay (hand kernels
    only) and of one prefill unit; (e) decode ms per step, per bucket
    and over the wave, and kept tokens/s, graphs against the static path
    and the engine without graphs, medians of ENGINE_REPEATS."""
    import dataclasses as dc

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.configs.base import QuantConfig
    from repro_torch.launch.serve import run_static
    from repro_torch.models.model import init_params, quantize_params

    tag = "[engine]"
    laps, t_lap = {}, [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        laps[what] = now - t_lap[0]
        t_lap[0] = now
        print(f"[time] engine {what}: {laps[what]:.2f}s")

    quant = QuantConfig(mode="vp", quantize_kv_cache=True)
    cfg = registry.get_config(ARCH, quant)
    params = quantize_params(init_params(cfg, seed=0, device="cuda"), cfg)
    reqs = _engine_requests(cfg, ENGINE_REQS)
    print(f"{tag} {cfg.name}, {cfg.dtype}, packed VP weights and KV cache; "
          f"{ENGINE_REQS} requests, prompts {[len(p) for p, _ in reqs]}, "
          f"budgets {[g for _, g in reqs]}; {ENGINE_SLOTS} slots, pages of "
          f"{ENGINE_PAGE}, capacity {ENGINE_CAP}; {smi}")

    # -- the main path: run-ahead 4, then 1 ----------------------------------
    ran_all = collections.Counter()
    logits = {}
    eng = _engine(cfg, params, decode_lookahead=ENGINE_LOOKAHEAD[0])
    recs, wall, calls, ran = _engine_wave(torch, eng, reqs, logits)
    ran_all.update(ran)
    _check_graph_log(eng.runner, f"{tag} run-ahead {ENGINE_LOOKAHEAD[0]}:")
    print(f"{tag} run-ahead {ENGINE_LOOKAHEAD[0]}: {wall:.3f}s (graphs "
          f"captured and checked on the way), {len(calls)} decode calls, "
          f"{eng.runner.replays} replays; kernels that ran "
          f"{_engine_counts(ran)}")
    eng1 = _engine(cfg, params, decode_lookahead=ENGINE_LOOKAHEAD[1])
    recs1, wall1, calls1, ran1 = _engine_wave(torch, eng1, reqs)
    ran_all.update(ran1)
    _check_graph_log(eng1.runner, f"{tag} run-ahead {ENGINE_LOOKAHEAD[1]}:")
    differ = [r0["rid"] for r0, r1 in zip(recs, recs1)
              if r0["tokens"] != r1["tokens"]]
    print(f"{tag} run-ahead {ENGINE_LOOKAHEAD[1]}: {wall1:.3f}s, "
          f"{len(calls1)} decode calls; tokens "
          + (f"differ from run-ahead {ENGINE_LOOKAHEAD[0]} in requests "
             f"{differ}" if differ else
             f"identical to run-ahead {ENGINE_LOOKAHEAD[0]}"))
    if differ:
        raise AssertionError(f"{tag} run-ahead changed the tokens of "
                             f"requests {differ}")
    for name in ("vp_dequant_matmul", "flash_prefill", "vp_decode_attention",
                 "vp_quant_packed"):
        if not ran.get(name):
            raise AssertionError(f"{tag} {name} did not run: {ran}")

    lap("runs at run-ahead 4 and 1")

    # -- (b) every request against the plain path ---------------------------
    rels, floor = _engine_plain(torch, cfg, params, reqs, recs, logits,
                                floor=ENGINE_FLOOR_REQS)
    limit = max(REL_LIMIT, FLOOR_MARGIN * max(floor))
    print(f"{tag} bf16 engine vs plain, per request (teacher-forced): "
          + " ".join(f"{r:.2e}" for r in rels) + f"; plain-path floor "
          f"{max(floor):.3e} (first {ENGINE_FLOOR_REQS} requests); limit "
          f"{limit:.3e}")
    if max(rels) > limit:
        raise AssertionError(f"{tag} engine logits differ from the plain "
                             f"path by {max(rels):.3e} > {limit:.3e}")
    cfg32 = dc.replace(cfg, dtype="float32", n_layers=ENGINE_F32_LAYERS)
    p32 = quantize_params(init_params(cfg32, seed=0, device="cuda"), cfg32)
    reqs32 = reqs[:ENGINE_SLOTS]
    lg32 = {}
    eng32 = _engine(cfg32, p32, decode_lookahead=ENGINE_LOOKAHEAD[0])
    recs32, _, _, ran32 = _engine_wave(torch, eng32, reqs32, lg32)
    ran_all.update(ran32)
    _check_graph_log(eng32.runner, f"{tag} f32, {ENGINE_F32_LAYERS} layers:")
    rels32, _ = _engine_plain(torch, cfg32, p32, reqs32, recs32, lg32)
    print(f"{tag} f32 ({ENGINE_F32_LAYERS} layers) engine vs plain, per "
          "request: " + " ".join(f"{r:.2e}" for r in rels32)
          + f"; limit {F32_REL_LIMIT:g}")
    if max(rels32) > F32_REL_LIMIT:
        raise AssertionError(f"{tag} f32 engine logits differ from the plain "
                             f"path by {max(rels32):.3e}")
    del p32, eng32, lg32
    lap("plain-path checks (bf16, f32)")

    # -- (c) chunked prefill, planes KV, vp_block, sampling -------------------
    short = [(p, 4) for p, _ in reqs[:2]]
    side = {}
    for what, q, kw, want in (
            (f"chunked prefill {ENGINE_CHUNK}", quant,
             dict(prefill_chunk=ENGINE_CHUNK), ("vp_dequant_packed",)),
            ("planes KV", dc.replace(quant, kv_layout="planes"), {},
             ("vp_quant_planes", "vp_dequant_planes")),
            (f"vp_block {BLOCK} at one slot", QuantConfig(
                mode="vp_block", block=BLOCK, quantize_kv_cache=True),
             dict(max_slots=1), ("block_vp_matmul", "vp_block_quant")),
            ("sampling at temperature 0.8 (noise drawn into each graph's "
             "input)", quant, dict(temperature=0.8), ())):
        c = registry.get_config(ARCH, q)
        own = q.mode != quant.mode    # the KV layout leaves the weights
        p = quantize_params(init_params(c, seed=0, device="cuda"), c) \
            if own else params
        e = _engine(c, p, decode_lookahead=ENGINE_LOOKAHEAD[0], **kw)
        lg = {}
        recs_s, w, _, r = _engine_wave(torch, e, short, lg)
        ran_all.update(r)
        _check_graph_log(e.runner, f"{tag} {what}:")
        missing = [k for k in want if not r.get(k)]
        if missing:
            raise AssertionError(f"{tag} {what}: {missing} did not run")
        # the vp_block path's own floor, as the serve phase measures it;
        # the others share (b)'s weights and limit
        rels_s, floor_s = _engine_plain(torch, c, p, short, recs_s, lg,
                                        floor=int(own),
                                        chunk=kw.get("prefill_chunk"),
                                        f64_attention=own)
        limit_s = max(REL_LIMIT, FLOOR_MARGIN * max(floor_s)) \
            if floor_s else limit
        print(f"{tag} {what}: 2 requests x 4 tokens in {w:.3f}s; kernels "
              f"that ran {_engine_counts(r)}; vs plain, per request: "
              + " ".join(f"{x:.2e}" for x in rels_s) + f" (limit "
              f"{limit_s:.3e}" + (f", plain-path floor {floor_s[0]:.3e})"
                                  if floor_s else ")"))
        if max(rels_s) > limit_s:
            raise AssertionError(f"{tag} {what}: logits differ from the "
                                 f"plain path by {max(rels_s):.3e} > "
                                 f"{limit_s:.3e}")
        side[what] = dict(kernels=_engine_counts(r), rel_logit_diff=rels_s,
                          plain_floor=floor_s, limit=limit_s)
        if "block" in what:
            block_cfg, block_params = c, p
        del p, e
    shapes = _engine_shapes(torch, cfg, block_cfg, block_params,
                            len(short[0][0]))
    del block_params
    print(f"{tag} at the engine's shapes, bit-identical to the plain "
          f"versions: {'; '.join(shapes)}")
    lap("chunked, planes, vp_block and sampling runs")

    # -- (e) decode per step, graphs against eager and the static path -------
    eng.check_finite = False      # no logits copied to the host
    waves = []
    for _ in range(ENGINE_REPEATS):
        recs_w, w, calls_w, _ = _engine_wave(torch, eng, reqs)
        waves.append(dict(_decode_rates(recs_w, calls_w), wall_s=w,
                          tok_s=sum(len(r["tokens"]) for r in recs_w) / w))
    graphs, eng.runner.use_graphs = eng.runner.use_graphs, False
    recs_e, w_e, calls_e, _ = _engine_wave(torch, eng, reqs)
    eng.runner.use_graphs = graphs
    eager = dict(_decode_rates(recs_e, calls_e), wall_s=w_e)
    full = f"{ENGINE_SLOTS}x{ENGINE_LOOKAHEAD[0]}"   # the full bucket
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)).cuda()
    static = []
    for _ in range(ENGINE_REPEATS):
        rep = {}
        run_static(params, cfg, prompts, GEN, rep)
        static.append(dict(decode_ms_per_step=rep["decode_s"] / GEN * 1e3,
                           tok_s=rep["tokens_per_s"]))

    lap("timed waves and the static path")

    def med(xs, k):
        return statistics.median(x[k] for x in xs)

    for w in waves:
        w["full_bucket_ms_per_step"] = w["bucket_ms_per_step"][full]
    print(f"{tag} graphs, {ENGINE_REPEATS} waves of {ENGINE_REQS} requests: "
          f"decode at bucket {full} {med(waves, 'full_bucket_ms_per_step'):.3f}"
          " ms/step (median; " + ", ".join(
              f"{w['full_bucket_ms_per_step']:.3f}" for w in waves)
          + "), per bucket " + str(waves[0]["bucket_ms_per_step"])
          + f" (first wave); {med(waves, 'decode_ms_per_step'):.3f} ms/step "
          f"over the wave, {med(waves, 'decode_tok_s'):.1f} decode tok/s "
          f"(tokens kept), {med(waves, 'tok_s'):.1f} tok/s end to end "
          f"(prefill included, wave wall {med(waves, 'wall_s'):.3f}s)")
    print(f"{tag} without graphs, one wave: decode at bucket {full} "
          f"{eager['bucket_ms_per_step'][full]:.3f} ms/step, per bucket "
          f"{eager['bucket_ms_per_step']}, {eager['decode_tok_s']:.1f} decode "
          "tok/s (tokens kept)")
    print(f"{tag} static path, batch {BATCH} x prompt {PROMPT}, {GEN} "
          f"steps: decode {med(static, 'decode_ms_per_step'):.3f} ms/step "
          "(median; " + ", ".join(f"{s['decode_ms_per_step']:.3f}"
                                  for s in static)
          + f"), {med(static, 'tok_s'):.1f} tok/s; {smi}")

    # -- (d) profiles: one decode replay, one prefill unit --------------------
    # Four requests fill the four slots; the first step is a prefill unit
    # alone, and once all four have prefilled a step is one decode replay.
    for prompt, gen in reqs[:ENGINE_SLOTS]:
        eng.submit(prompt, ENGINE_GEN[1], 0.0)
    sched = eng.scheduler
    sched.admit(eng.clock.now())
    _, pf_kernels = _profile(torch, "engine prefill unit",
                             lambda: eng._prefill_unit(sched.next_prefill()))
    while sched.next_prefill() is not None:
        eng.step()
    bucket = (ENGINE_SLOTS, eng._lookahead(sched.decoding()))
    want = dict(eng.runner._graphs[bucket].launches)
    names, seen = _profile_kernels(torch, [("engine decode replay", eng.step,
                                            want)])
    library = sorted({n for n in names if LIBRARY_KERNELS.search(n)
                      and not any(v in n for v in KERNEL_NAMES.values())})
    if library:
        raise AssertionError(f"{tag} library kernels in a decode replay: "
                             f"{library}")
    print(f"{tag} one decode replay at bucket {bucket}: {len(names)} device "
          f"kernels, hand kernels {({k: v for k, v in seen.items() if v})}; "
          "no library GEMM or attention kernel")
    eng.run()
    eng.kv.check_conservation()
    lap("profiles")

    for row in rows:
        if ran_all.get(row["name"]):
            row["engine_launches"] = ran_all[row["name"]]
    record["engine"] = dict(
        requests=[(len(p), g) for p, g in reqs], launches=dict(ran_all),
        graphs=[dict(e, bucket=list(e["bucket"]))
                for e in eng.runner.graph_log],
        lookahead_tokens_differ=differ, bf16_rel_logit_diff=rels,
        bf16_plain_floor=floor, bf16_limit=limit, f32_rel_logit_diff=rels32,
        short_runs=side, engine_shapes=shapes, waves=waves, eager_wave=eager, static=static,
        decode_replay_kernels=len(names), profiled=seen,
        prefill_unit_kernels=len(pf_kernels), laps=laps)


def dequant_phase(torch, record, rows):
    """The public op `ops.vp_dequant` on the card: the packed words of
    one weight panel into f32 and bf16, and the MIMO W planes into f32,
    each once, checked against the op's plain path."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import build, ops
    from repro_torch.mimo.equalizer import table1_specs
    from repro_torch.models.layers import canonical_formats

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    fxp, vp = canonical_formats(QuantConfig(mode="vp"))
    wf, wv = table1_specs()[2].w_fxp, table1_specs()[2].w_vp
    words = ops.vp_quant((torch.randn(DEQUANT_PACKED, generator=gen,
                                      device="cuda") * 0.3).clamp(-0.99, 0.99),
                         fxp, vp, packed=True)
    m, i = ops.vp_quant(torch.randn(DEQUANT_PLANES, generator=gen,
                                    device="cuda") * 0.05, wf, wv)
    calls = {"packed f32": lambda: ops.vp_dequant(words, None, vp),
             "packed bf16": lambda: ops.vp_dequant(words, None, vp,
                                                   torch.bfloat16),
             "planes f32": lambda: ops.vp_dequant(m, i, wv)}
    torch.cuda.synchronize()
    build.reset_launches()
    # -- the path: the public op, once per call --------------------------------
    outs = {what: fn() for what, fn in calls.items()}
    counts = dict(build.LAUNCHES)
    # -------------------------------------------------------------------------
    expect = {"vp_dequant_packed": 2, "vp_dequant_planes": 1}
    print(f"[dequant] ops.vp_dequant launches: {counts}")
    if counts != expect:
        raise AssertionError(f"vp_dequant launch counts {counts} != {expect}")
    with ops.force_backend("ref"):
        for what, fn in calls.items():
            want = fn()
            if outs[what].dtype != want.dtype or not torch.equal(outs[what],
                                                                 want):
                raise AssertionError(f"ops.vp_dequant {what} differs from "
                                     "its plain path")
    print(f"[dequant] ops.vp_dequant packed {list(DEQUANT_PACKED)} (f32, "
          f"bf16) and planes {list(DEQUANT_PLANES)} (f32): bit-identical to "
          "the plain path")
    for row in rows:
        if row["name"] in expect:
            row["launches"] = counts[row["name"]]
    record["dequant"] = dict(launches=counts)


# ---------------------------------------------------------------------------
# 3b. the MIMO path's kernels
# ---------------------------------------------------------------------------

def _mimo_operands(torch, gen, G, M, K, N):
    """AGC-scaled stand-ins for the equalizer's operands: heavy-tailed W
    rows inside FXP(12,11) and y columns filling FXP(9,1), with exact
    ties and saturating values in the first realizations."""
    def t2(*shape):
        z = torch.randn(shape, generator=gen, device="cuda")
        c = torch.randn(shape, generator=gen, device="cuda")
        return z / torch.sqrt(0.5 * (c * c + torch.randn(
            shape, generator=gen, device="cuda") ** 2))
    a = (t2(G, M, K) * 0.01).clamp(-1.2, 1.2)
    b = (t2(G, K, N) * 8.0).clamp(-160.0, 160.0)
    ks = torch.randint(-2048, 2048, (min(G, 64), M, K), generator=gen,
                       device="cuda")
    a[:ks.shape[0]] = ((ks.double() + 0.5) * 2.0 ** -11).float()
    kb = torch.randint(-256, 256, (min(G, 64), K, N), generator=gen,
                       device="cuda")
    b[:kb.shape[0]] = ((kb.double() + 0.5) * 0.5).float()
    return a.contiguous(), b.contiguous()


def mimo_kernel_phase(torch, peaks, record):
    import ctypes

    from repro_torch.core.packing import unpack_vp
    from repro_torch.core.vp_tensor import significand_dtype
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.vp_matmul import (
        layout_of, qmm_body, vmm_body, vp_matmul_cuda)
    from repro_torch.kernels.vp_quant import (
        plan_packed, vp_quant_packed_cuda, vp_quant_planes_cuda)
    from repro_torch.kernels.vp_quant_matmul import vp_quant_matmul_cuda
    from repro_torch.mimo.equalizer import table1_specs

    bvp = table1_specs()[2]
    wf, wv, yf, yv = bvp.w_fxp, bvp.w_vp, bvp.y_fxp, bvp.y_vp
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    timer = Timer(torch)
    lines, rows = [], []
    G, (M, K, N) = MIMO_G, MIMO_SHAPE
    a, b = _mimo_operands(torch, gen, G, M, K, N)
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    # -- vp_quant_planes: every body bit-exact; timed beside the first design -
    qlib = build.library("vp_quant")

    def planes_c(x, f_, v_, code, out=None):
        """The planes launcher on body `code` (1: the select chain, 2: the
        first design, kept for this comparison), through its C entry, not
        counted: (m, i), or a launch into `out` for the timer."""
        m, i = out or (torch.empty(x.shape, dtype=significand_dtype(v_.M),
                                   device="cuda"),
                       torch.empty(x.shape, dtype=torch.uint8, device="cuda"))
        blocks, threads = plan_packed(x.numel(), num_sms)
        build.check(qlib, qlib.vp_quant_planes_launch(
            x.data_ptr(), m.data_ptr(), m.element_size(), i.data_ptr(),
            x.numel(), ctypes.byref(build.quant_fmt_struct(f_, v_)), code,
            blocks, threads, stream), "vp_quant_planes")
        return m, i

    planes = {}
    flat = a.reshape(-1)
    for x, f_, v_, what in ((a, wf, wv, "W"), (b, yf, yv, "y"),
                            (flat[:-5], wf, wv, "W ragged"),
                            (flat[3:-5], wf, wv, "W unaligned")):
        want = ref.vp_quant_ref(x, f_, v_)
        for body, got in (("table", vp_quant_planes_cuda(x, f_, v_)),
                          ("chain", planes_c(x, f_, v_, 1)),
                          ("first design", planes_c(x, f_, v_, 2))):
            for g_, w_, part in zip(got, want, ("significand", "index")):
                if g_.dtype != w_.dtype or not torch.equal(g_, w_):
                    n = int((g_.to(torch.int32) != w_.to(torch.int32)).sum())
                    raise AssertionError(f"vp_quant_planes {what} {body} "
                                         f"body {part}: {n} values differ")
            if body == "table" and what in ("W", "y"):
                planes[what] = got
    del flat
    panel = a.reshape(G * M, K)
    ms = timer(lambda: vp_quant_planes_cuda(panel, wf, wv))
    out = (torch.empty(panel.shape, dtype=torch.int8, device="cuda"),
           torch.empty(panel.shape, dtype=torch.uint8, device="cuda"))
    chain_ms = timer(lambda: planes_c(panel, wf, wv, 1, out))
    first_ms = timer(lambda: planes_c(panel, wf, wv, 2, out))
    del out
    plain_ms = timer(lambda: ref.vp_quant_ref(panel, wf, wv))
    bnd = bound(peaks, panel.numel() * (4 + 1 + 1), 0, "f32")
    shape = list(panel.shape)
    _print_line("vp_quant_planes", shape, 0.0, 0.0, ms, plain_ms, bnd, None)
    print(f"[kernel] vp_quant_planes {shape}: table body {ms:.4f} ms "
          f"({bnd[0] / ms:.1%} of the bound; aim <= 0.25, at least "
          f"{2 * bnd[0]:.4f}), select chain {chain_ms:.4f} ms, first design "
          f"{first_ms:.4f} ms ({bnd[0] / first_ms:.1%})")
    lines.append(("vp_quant_planes", shape, ms, plain_ms, bnd, None))
    rows.append(dict(_row("vp_quant_planes", "vp_quant.cu",
                          "src/repro/kernels/vp_quant.py:40", shape, 0.0, ms,
                          plain_ms, bnd, None), body="table",
                     chain_ms=chain_ms, first_design_ms=first_ms))
    print(f"[kernel] vp_quant_planes: table, chain and first-design bodies "
          f"bit-exact on the W panel {shape} (also a ragged and an unaligned "
          f"slice of it) and the y operand {[G, K, N]}, ties and saturation "
          f"included")

    # -- vp_matmul / vp_quant_matmul at G = 100,000 ---------------------------
    words = {"W": vp_quant_packed_cuda(a, wf, wv),
             "y": vp_quant_packed_cuda(b, yf, yv)}
    for what, w in words.items():
        fmt = wv if what == "W" else yv
        m, i = planes[what]
        um, ui = unpack_vp(w, fmt)
        if not (torch.equal(um, m.to(torch.int32))
                and torch.equal(ui, i.to(torch.int32))):
            raise AssertionError(f"packed {what} words disagree with planes")
    a_deq = ref.vp_dequant_ref(*planes["W"], wv)
    b_deq = ref.vp_dequant_ref(*planes["y"], yv)
    tiles = MIMO_SHAPE
    a_act = (torch.rand((G, 1, 1), generator=gen, device="cuda") < 0.5).int()
    b_act = (torch.rand((G, 1, 1), generator=gen, device="cuda") < 0.5).int()
    mask_bytes = 4 * (a_act.numel() + b_act.numel())
    flops = 2 * G * M * K * N
    if qmm_body(G, M, K, N) != "batch":
        raise AssertionError(f"qmm_body picks {qmm_body(G, M, K, N)} at the "
                             "MIMO shape")
    fused = vp_quant_matmul_cuda(a, b, wf, wv, yf, yv)
    cases = {
        "planes": (lambda body=None: vp_matmul_cuda(
                       *planes["W"], *planes["y"], wv, yv, body=body),
                   lambda: ref.vp_matmul_batched_ref(
                       *planes["W"], *planes["y"], wv, yv),
                   G * (M * K * 2 + K * N * 2 + M * N * 4)),
        "packed": (lambda body=None: vp_matmul_cuda(
                       words["W"], None, words["y"], None, wv, yv, body=body),
                   lambda: ref.vp_matmul_batched_packed_ref(
                       words["W"], words["y"], wv, yv),
                   G * (M * K * 2 + K * N + M * N * 4)),
        "planes+masks": (
            lambda body=None: vp_matmul_cuda(
                *planes["W"], *planes["y"], wv, yv, a_act, b_act, tiles,
                body=body),
            lambda: ref.vp_matmul_batched_ref(
                *planes["W"], *planes["y"], wv, yv, a_act, b_act, tiles),
            G * (M * K * 2 + K * N * 2 + M * N * 4) + mask_bytes),
    }
    library_ms = timer(lambda: torch.bmm(a_deq, b_deq))
    main_mm, mm_times = None, {}
    for case, (kern, plain, nbytes) in cases.items():
        operands = ((words["W"], None), (words["y"], None)) \
            if case == "packed" else (planes["W"], planes["y"])
        body = vmm_body(G, M, K, N, tuple(layout_of(*x) for x in operands),
                        True)
        if body != "batch":
            raise AssertionError(f"vmm_body picks {body} for vp_matmul "
                                 f"{case} at the MIMO shape")
        out = kern()
        err, rel = compare(torch, out, plain(), MIMO_RTOL,
                           f"vp_matmul {case}")
        if case != "planes+masks" and not torch.equal(out, fused):
            raise AssertionError(f"fused kernel differs from quant -> "
                                 f"vp_matmul ({case}) on the card")
        if not torch.equal(out, kern("warp")):
            raise AssertionError(f"vp_matmul {case}: the batch body differs "
                                 "from the warp body")
        ms, warp_ms = timer(kern), timer(lambda: kern("warp"))
        plain_ms = timer(plain)
        bnd = bound(peaks, nbytes, flops, "f32")
        shape = [G, M, K, N, case]
        _print_line("vp_matmul", shape, err, rel, ms, plain_ms, bnd,
                    library_ms)
        print(f"[kernel] vp_matmul {shape}: batch body {ms:.4f} ms "
              f"({bnd[0] / ms:.1%} of the bound {bnd[0]:.4f}; aim <= "
              f"{2 * bnd[0]:.4f}), warp body {warp_ms:.4f} ms "
              f"({bnd[0] / warp_ms:.1%}); torch.bmm {library_ms:.4f} ms; "
              f"bit-identical to the warp body")
        lines.append(("vp_matmul", shape, ms, plain_ms, bnd, library_ms))
        mm_times[case] = dict(batch_ms=ms, warp_ms=warp_ms, bound_ms=bnd[0])
        if case == "packed":
            main_mm = dict(_row("vp_matmul", "vp_matmul.cu",
                                "src/repro/kernels/vp_matmul.py:82", shape,
                                err, ms, plain_ms, bnd, library_ms),
                           body="batch", warp_ms=warp_ms)
    rows.append(main_mm)
    record["vp_matmul_batch"] = mm_times
    print("[kernel] vp_quant_matmul: bit-identical to vp_quant -> vp_matmul "
          "on the card (planes and packed words)")

    # -- launches the batch body refuses: the planner keeps them on the warp
    # body, and forcing the batch body raises --------------------------------
    g8 = 64
    shifted = words["W"].reshape(-1)[1:1 + g8 * M * K]   # 2 bytes past
    refused = {   # (operands, the batch body's result on the same values)
        "unaligned W slice": (
            ((shifted.view(g8, M, K), None), (words["y"][:g8], None)),
            vp_matmul_cuda(shifted.clone().view(g8, M, K), None,
                           words["y"][:g8], None, wv, yv, body="batch")),
        "mixed words x planes": (
            ((words["W"][:g8], None), tuple(p[:g8] for p in planes["y"])),
            fused[:g8]),
    }
    for what, ((wa, wb), want) in refused.items():
        layout = (layout_of(*wa), layout_of(*wb))
        aligned = all(t.data_ptr() % 16 == 0 for t in (*wa, *wb)
                      if t is not None)
        body = vmm_body(g8, M, K, N, layout, aligned)
        if body != "warp":
            raise AssertionError(f"vmm_body picks {body} for the {what}")
        before = dict(build.LAUNCHES)
        got = vp_matmul_cuda(*wa, *wb, wv, yv)
        if _delta(before, build.LAUNCHES).get("vp_mm_warp") != 1:
            raise AssertionError(f"the {what} did not run on the warp body")
        if not torch.equal(got, want):
            raise AssertionError(f"vp_matmul {what}: the warp body differs "
                                 "from the batch body on the same values")
        try:
            vp_matmul_cuda(*wa, *wb, wv, yv, body="batch")
        except RuntimeError as e:
            if "invalid argument" not in str(e):
                raise
        else:
            raise AssertionError(f"the batch body took the {what}")
    torch.cuda.synchronize()
    print(f"[kernel] vp_matmul: {sorted(refused)} planned onto the warp body "
          "(equal to the batch body on the same values); the batch body "
          "refuses both")

    # -- vp_quant_matmul: the batch body against the warp and tile bodies ---
    local = {}
    for lib in ("vp_quant_matmul", "vp_matmul"):
        for op in ("LDL", "STL"):
            got = {k: v for k, v in _sass_counts(
                build._target(lib), build._nvcc(), op).items()
                if "vp_mm_batch_kernel" in k}
            if len(got) != (1 if lib == "vp_quant_matmul" else 2):
                raise AssertionError(f"{lib}: batch kernels in the SASS "
                                     f"{sorted(got)}")
            local[f"{lib} {op}"] = sum(got.values())
    print(f"[kernel] vp_mm_batch_kernel SASS (vp_quant_matmul's instance, "
          f"vp_matmul's words and planes instances): local loads / stores "
          f"{local}")
    if any(local.values()):
        raise AssertionError(f"the batch body spills to local memory: {local}")
    for gi in (0, 1, 63, G - 1):      # ties and saturation in the first 64
        one = vp_quant_matmul_cuda(a[gi:gi + 1], b[gi:gi + 1], wf, wv, yf, yv,
                                   body="tile")
        if not torch.equal(one, fused[gi:gi + 1]):
            raise AssertionError(f"batch body differs from the G = 1 tile "
                                 f"body at realization {gi}")
    main_fu = None
    for case, masks in (("", ()), ("masks", (a_act, b_act, tiles))):
        def kern():
            return vp_quant_matmul_cuda(a, b, wf, wv, yf, yv, *masks)

        def plain():
            return ref.vp_quant_matmul_batched_ref(a, b, wf, wv, yf, yv,
                                                   *masks)
        out = kern()
        err, rel = compare(torch, out, plain(), MIMO_RTOL,
                           f"vp_quant_matmul {case}")
        if not torch.equal(out, vp_quant_matmul_cuda(
                a, b, wf, wv, yf, yv, *masks, body="warp")):
            raise AssertionError(f"batch body differs from the warp body "
                                 f"({case or 'no masks'})")
        if masks and not torch.equal(out, cases["planes+masks"][0]()):
            raise AssertionError("masked fused kernel differs from quant -> "
                                 "masked vp_matmul on the card")
        ms, plain_ms = timer(kern), timer(plain)
        nbytes = G * (M * K + K * N + M * N) * 4 + (mask_bytes if masks
                                                    else 0)
        bnd = bound(peaks, nbytes, flops, "f32")
        shape = [G, M, K, N] + ([case] if case else [])
        _print_line("vp_quant_matmul", shape, err, rel, ms, plain_ms, bnd,
                    library_ms)
        lines.append(("vp_quant_matmul", shape, ms, plain_ms, bnd,
                      library_ms))
        if main_fu is None:
            main_fu = dict(_row("vp_quant_matmul", "vp_quant_matmul.cu",
                                "src/repro/kernels/vp_quant_matmul.py:106",
                                shape, err, ms, plain_ms, bnd, library_ms),
                           body="batch")
    # The batch body beside the warp body (the first design), through the
    # C entry (not counted), unmasked.
    mlib = build.library("vp_quant_matmul")
    qa, qb = build.quant_fmt_struct(wf, wv), build.quant_fmt_struct(yf, yv)
    out = torch.empty((G, M, N), dtype=torch.float32, device="cuda")

    def fused_c(code):
        return mlib.vp_quant_matmul_launch(
            a.data_ptr(), ctypes.byref(qa), b.data_ptr(), ctypes.byref(qb),
            out.data_ptr(), None, None, G, M, K, N, 0, 0, 0, code, 1, 1,
            stream)

    variants = {}
    for what, code in (("warp body", 0), ("batch body", 2)):
        build.check(mlib, fused_c(code), f"vp_quant_matmul {what}")
        if not torch.equal(out, fused):
            raise AssertionError(f"vp_quant_matmul {what} differs from the "
                                 "planned body")
        variants[what] = timer(lambda: fused_c(code))
    del out
    ms = main_fu["ms"]
    print(f"[kernel] vp_quant_matmul {[G, M, K, N]}: batch body {ms:.4f} ms "
          f"({main_fu['bound_ms'] / ms:.1%} of the bound "
          f"{main_fu['bound_ms']:.4f}; aim <= {2 * main_fu['bound_ms']:.4f})"
          f"; " + ", ".join(f"{k} {v:.4f} ms" for k, v in variants.items())
          + f"; torch.bmm {library_ms:.4f} ms ({library_ms / ms:.2f}x the "
          f"batch body, {library_ms / variants['warp body']:.2f}x the warp "
          f"body); bit-identical to the warp body, to quantize -> vp_matmul "
          f"(with and without masks) and to the G = 1 tile body")
    main_fu.update(warp_ms=variants["warp body"])
    rows.append(main_fu)
    del a_deq, b_deq, planes, words, fused

    # -- the G = 1 launches of the masked mode: (2048, 64) x (64, 256) -------
    rows += _g1_kernels(torch, peaks, timer, gen, bvp, lines, record)
    record["mimo_kernel_lines"] = [
        dict(name=n, shape=s, ms=m, plain_ms=p, bound_ms=b[0], bound_by=b[1],
             library_ms=lib) for n, s, m, p, b, lib in lines]
    print("kernels: vp_quant_planes, vp_matmul, vp_quant_matmul")
    return rows


def _mm_layouts(torch, gen, bvp, G, M, K, N, grid):
    """G products (M, K) x (K, N) on the MIMO operands: ({layout:
    fn(body) -> (G, M, N)}, {layout: its plain version}, fn() -> the
    first product's dequantized operands) for packed, planes and mixed
    words x planes through `vp_matmul_cuda` and fused through
    `vp_quant_matmul_cuda`, all with CSPADE flags on `grid` (about half
    the tiles loud) where it is not None."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.vp_matmul import vp_matmul_cuda
    from repro_torch.kernels.vp_quant import (
        vp_quant_packed_cuda, vp_quant_planes_cuda)
    from repro_torch.kernels.vp_quant_matmul import vp_quant_matmul_cuda

    wf, wv, yf, yv = bvp.w_fxp, bvp.w_vp, bvp.y_fxp, bvp.y_vp
    a, b = _mimo_operands(torch, gen, G, M, K, N)
    pa, pb = vp_quant_planes_cuda(a, wf, wv), vp_quant_planes_cuda(b, yf, yv)
    wa, wb = vp_quant_packed_cuda(a, wf, wv), vp_quant_packed_cuda(b, yf, yv)
    masks = ()
    if grid is not None:
        bm, bk, bn = grid
        masks = tuple((torch.rand(shape, generator=gen, device="cuda")
                       < 0.5).int() for shape in
                      ((G, M // bm, K // bk), (G, K // bk, N // bn))) + (grid,)
    fns = {"packed": lambda body: vp_matmul_cuda(
               wa, None, wb, None, wv, yv, *masks, body=body),
           "planes": lambda body: vp_matmul_cuda(
               *pa, *pb, wv, yv, *masks, body=body),
           "mixed": lambda body: vp_matmul_cuda(
               wa, None, *pb, wv, yv, *masks, body=body),
           "fused": lambda body: vp_quant_matmul_cuda(
               a, b, wf, wv, yf, yv, *masks, body=body)}
    planes = lambda: ref.vp_matmul_batched_ref(  # noqa: E731
        *pa, *pb, wv, yv, *masks)
    plains = {"packed": lambda: ref.vp_matmul_batched_packed_ref(
                  wa, wb, wv, yv, *masks),
              "planes": planes, "mixed": planes,
              "fused": lambda: ref.vp_quant_matmul_batched_ref(
                  a, b, wf, wv, yf, yv, *masks)}
    deq = lambda: (ref.vp_dequant_ref(*pa, wv)[0],  # noqa: E731
                   ref.vp_dequant_ref(*pb, yv)[0])
    return fns, plains, deq


def _g1_kernels(torch, peaks, timer, gen, bvp, lines, record):
    """The G = 1 launches of `vp_matmul` and `vp_quant_matmul` (the TPU
    kernels `vp_matmul_pallas` and `vp_quant_matmul_pallas`): the tile
    body bit-identical to the warp body, fused equal to quantize ->
    unfused on it, both within MIMO_RTOL of the plain version, at every
    shape and grid of G1_CHECKS; its SASS free of local memory; the path
    shape timed on the planner's body and on each body, beside torch.mm;
    both bodies swept over MM_SWEEP.  Returns the two kernels' rows."""
    from repro_torch.kernels import build
    from repro_torch.kernels.vp_matmul import mm_body, qmm_body, vmm_body

    K = MIMO_SHAPE[1]
    Mm, Nm = MASKED_N * 8, MASKED_N
    if mm_body(1, Mm, K, Nm) != "tile":
        raise AssertionError(f"mm_body picks {mm_body(1, Mm, K, Nm)} at the "
                             "masked mode's shape")

    # -- the tile body's SASS: its 4 x 4 micro-tile stays in registers ------
    local = {}
    for lib in ("vp_matmul", "vp_quant_matmul"):
        for op in ("LDL", "STL"):
            got = _sass_counts(build._target(lib), build._nvcc(), op)
            tile = {k: v for k, v in got.items() if "vp_mm_tile_kernel" in k}
            if len(tile) != 1:
                raise AssertionError(f"{lib}: tile kernels in the SASS {tile}")
            local[f"{lib} {op}"] = sum(tile.values())
    print(f"[kernel] vp_mm_tile_kernel SASS: local loads / stores {local}")
    if any(local.values()):
        raise AssertionError(f"the tile body spills to local memory: {local}")

    # -- bit identity: tile body == warp body, fused == quantize -> unfused --
    checked = 0
    for (M, Kc, N), grids in G1_CHECKS.items():
        for grid in grids:
            fns, plains, _ = _mm_layouts(torch, gen, bvp, 1, M, Kc, N, grid)
            plain = plains["planes"]()
            outs = {}
            for layout, fn in fns.items():
                tile, warp = fn("tile"), fn("warp")
                what = f"G = 1 {layout} {[M, Kc, N]} grid {grid}"
                if not torch.equal(tile, warp):
                    n = int((tile != warp).sum())
                    raise AssertionError(f"{what}: tile body differs from the "
                                         f"warp body in {n} outputs")
                compare(torch, tile, plain, MIMO_RTOL, what)
                outs[layout] = tile
                checked += 1
            for layout in ("packed", "mixed", "fused"):
                if not torch.equal(outs[layout], outs["planes"]):
                    raise AssertionError(
                        f"G = 1 {[M, Kc, N]} grid {grid}: {layout} differs "
                        "from planes (quantize -> unfused) on the tile body")
    print(f"[kernel] vp_mm G = 1: tile body bit-identical to the warp body "
          f"in {checked} cases (packed, planes, mixed, fused; shapes and "
          f"grids {G1_CHECKS}); fused == quantize -> unfused on it; each "
          f"within {MIMO_RTOL:g} of the plain version")

    # -- the path shape, timed: planner's body (tile) and the warp body ------
    fns, plains, deq = _mm_layouts(torch, gen, bvp, 1, Mm, K, Nm, None)
    mfns, mplains, _ = _mm_layouts(torch, gen, bvp, 1, Mm, K, Nm,
                                   (256, 64, 256))
    a_deq, b_deq = deq()
    library_ms = timer(lambda: torch.mm(a_deq, b_deq))
    out_bytes, flops1 = Mm * Nm * 4, 2 * Mm * K * Nm
    mask_bytes = 4 * (Mm // 256 + Nm // 256)
    rows, times = [], {}
    for case, fn, plain, nbytes in (
            ("packed", fns["packed"], plains["packed"],
             Mm * K * 2 + K * Nm + out_bytes),
            ("planes+masks", mfns["planes"], mplains["planes"],
             Mm * K * 2 + K * Nm * 2 + out_bytes + mask_bytes),
            ("fused", fns["fused"], plains["fused"],
             (Mm * K + K * Nm) * 4 + out_bytes)):
        out = fn(None)
        err, rel = compare(torch, out, plain(), MIMO_RTOL,
                           f"G = 1 {case} {[Mm, K, Nm]}")
        ms, warp_ms = timer(lambda: fn(None)), timer(lambda: fn("warp"))
        plain_ms = timer(plain)
        bnd = bound(peaks, nbytes, flops1, "f32")
        name = "vp_quant_matmul" if case == "fused" else "vp_matmul"
        shape = [1, Mm, K, Nm, case]
        _print_line(name, shape, err, rel, ms, plain_ms, bnd, library_ms)
        print(f"[kernel] {name} {shape}: tile body {ms:.4f} ms, warp body "
              f"{warp_ms:.4f} ms, torch.mm (f32) {library_ms:.4f} ms: tile "
              f"{ms / library_ms:.2f}x torch.mm")
        lines.append((name, shape, ms, plain_ms, bnd, library_ms))
        times[case] = dict(tile_ms=ms, warp_ms=warp_ms, library_ms=library_ms,
                           bound_ms=bnd[0])
        if case != "planes+masks":      # the unbatched TPU kernels' rows
            rows.append(dict(_row(
                name, f"{name}.cu", "src/repro/kernels/" + (
                    "vp_quant_matmul.py:157" if case == "fused"
                    else "vp_matmul.py:143"), shape, err, ms, plain_ms, bnd,
                library_ms), g1=True, body=mm_body(1, Mm, K, Nm),
                warp_ms=warp_ms))

    # -- the planner's bounds: both bodies over G, M and N ------------------
    sweep = []
    for G, M, N in MM_SWEEP:
        fns, _, _ = _mm_layouts(torch, gen, bvp, G, M, K, N, None)
        t = {f"{layout} {body}": timer(lambda: fns[layout](body))
             for layout in ("packed", "fused") for body in ("warp", "tile")}
        if qmm_body(G, M, K, N) == "batch":
            t["fused batch"] = timer(lambda: fns["fused"]("batch"))
        planner = vmm_body(G, M, K, N, WORDS_LAYOUT, True)
        if planner == "batch":
            t["packed batch"] = timer(lambda: fns["packed"]("batch"))
        sweep.append(dict(G=G, M=M, K=K, N=N, planner=planner,
                          fused_planner=qmm_body(G, M, K, N), **t))
        print(f"[sweep] vp_mm {[G, M, K, N]}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
              + f" ms; vmm_body (packed) picks {planner}, qmm_body "
              f"{qmm_body(G, M, K, N)}")
    record["g1_bodies"] = dict(checked=checked, local_memory=local,
                               times=times, sweep=sweep)
    return rows


# ---------------------------------------------------------------------------
# 5. mimo
# ---------------------------------------------------------------------------

def _delta(before, after):
    """Launches per kernel between two readings of the counters."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _timed(torch, fn):
    """(fn(), host seconds) around work that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mimo_phase(torch, record, rows, smi):
    from repro_torch.kernels import build, ops
    from repro_torch.mimo.channel import ChannelConfig
    from repro_torch.mimo.equalizer import equalize_quantized, table1_specs
    from repro_torch.mimo.mvm_engine import equalize_vp_kernel
    from repro_torch.mimo.ofdm import (
        OFDMConfig, WidebandCalibrator, equalize_wideband,
        make_wideband_ensemble, wideband_ber, wideband_nmse)
    from repro_torch.mimo.sim import (
        ber_float, bit_error_rate, calibrate_specs, make_ensemble)

    cfg = ChannelConfig()
    n = MIMO_G
    variants = {"fused": {}, "unfused": dict(fused=False),
                "cspade": dict(cspade_threshold_quantile=0.5)}
    masked = {"masked": dict(mode="masked"),
              "masked-fused": dict(mode="masked", fused=True),
              "masked-cspade": dict(mode="masked",
                                    cspade_threshold_quantile=0.5)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    ens, specs, outs, secs, wide = {}, {}, {}, {}, {}

    torch.cuda.synchronize()
    build.reset_launches()
    # -- the main path: ensembles, equalization through the kernels ----------
    for snr in (2.0, 20.0):
        e = ens[snr] = make_ensemble(gen, cfg, n, snr)
        specs[snr] = calibrate_specs(table1_specs(), e)
        bvp = specs[snr][2]
        for name, kw in variants.items():
            outs[snr, name], secs[snr, name] = _timed(
                torch, lambda: equalize_vp_kernel(bvp, e.w_beam, e.y_beam,
                                                  **kw))
        if snr == 2.0:
            before = dict(build.LAUNCHES)
            for name, kw in masked.items():
                outs[snr, name], secs[snr, name] = _timed(
                    torch, lambda: equalize_vp_kernel(
                        bvp, e.w_beam[:MASKED_N], e.y_beam[:MASKED_N], **kw))
            masked_launches = _delta(before, build.LAUNCHES)
    S, nw = WIDEBAND
    wens = make_wideband_ensemble(gen, cfg, OFDMConfig(n_subcarriers=S), nw,
                                  20.0)
    wspecs = WidebandCalibrator(table1_specs()[2]).specs_for(wens)
    before = dict(build.LAUNCHES)
    wide["s_hat"], wide["s"] = _timed(torch, lambda: equalize_wideband(
        wspecs, wens.w_beam, wens.y_beam, how="flat"))
    wide_launches = _delta(before, build.LAUNCHES)
    counts = dict(build.LAUNCHES)
    # -------------------------------------------------------------------------
    # the masked mode's 12 G = 1 launches on the tile body; the batched
    # vp_matmul launches (4: unfused words, CSPADE planes with masks) and
    # the batched and wideband vp_quant_matmul launches (3) on the batch
    # body, none on the warp body; every planes launch (the CSPADE calls')
    # on the table body
    expect = {"vp_quant_matmul": 2 + 4 + 1, **_qp(2 * 2 + 4, "table"),
              "vp_matmul": 2 + 2 + 4 + 4, "vp_quant_planes": 2 * 2 + 4,
              "vp_qpl_table": 2 * 2 + 4, "vp_mm_tile": 4 + 4 + 4,
              "vp_mm_batch": 4 + 3}
    print(f"[mimo] launches on the MIMO path: {counts}; of which the "
          f"masked mode's G = 1 launches: {masked_launches}")
    if counts != expect:
        raise AssertionError(f"MIMO launch counts {counts} != {expect}")
    if masked_launches.get("vp_mm_tile") != 12 or "vp_mm_warp" in \
            masked_launches:
        raise AssertionError(f"masked mode's G = 1 launches "
                             f"{masked_launches}: not all 12 on the tile body")
    if wide_launches != {"vp_quant_matmul": 1, "vp_mm_batch": 1}:
        raise AssertionError(f"wideband band took {wide_launches}, not one "
                             "fused launch on the batch body")
    for row in rows:     # G = 1 launches to the unbatched kernels' rows
        name = row["name"]
        if name == "vp_quant_planes":
            row["launches"] = counts[name]
            row["body_launches"] = {"table": counts.get("vp_qpl_table", 0),
                                    "chain": counts.get("vp_qpl_chain", 0)}
        elif name in ("vp_matmul", "vp_quant_matmul"):
            g1 = masked_launches.get(name, 0)
            row["launches"] = g1 if row.get("g1") else counts[name] - g1
            if not row.get("g1"):    # both batched rows: the batch body
                row["body_launches"] = {"batch": row["launches"]}
        elif name in counts:
            row["mimo_launches"] = counts[name]

    # -- kernel path vs plain path, estimates and BER -------------------------
    errs = {}
    for (snr, name), got in outs.items():
        e = ens[snr]
        kw = {**variants, **masked}[name]
        sl = slice(0, MASKED_N) if name.startswith("masked") else slice(None)
        if got.shape != (e.w_beam[sl].shape[0], cfg.U):
            raise AssertionError(f"{name}: shape {tuple(got.shape)}")
        with ops.force_backend("ref"):
            want = equalize_vp_kernel(specs[snr][2], e.w_beam[sl],
                                      e.y_beam[sl], **kw)
        err, rel = compare(torch, torch.view_as_real(got),
                           torch.view_as_real(want), MIMO_RTOL,
                           f"equalize {name} {snr} dB")
        errs[f"{name}@{snr:g}dB"] = rel
    print("[mimo] kernel path vs plain path, max|diff| / max|plain|: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    bers = {}
    for snr in (2.0, 20.0):
        e = ens[snr]
        b = bers[snr] = {"float": ber_float(e, True)}
        for spec in specs[snr]:
            w, y = ((e.w_beam, e.y_beam) if spec.beamspace
                    else (e.w_ant, e.y_ant))
            b[spec.name] = bit_error_rate(equalize_quantized(spec, w, y),
                                          e.bits)
        b["B-VP kernel"] = bit_error_rate(outs[snr, "fused"], e.bits)
        print(f"[mimo] BER at {snr:g} dB, n = {n}: "
              + ", ".join(f"{k} {v:.6f}" for k, v in b.items()))
        if abs(b["B-VP kernel"] - b["B-VP"]) > 1e-5:
            raise AssertionError(
                f"B-VP BER through the kernels {b['B-VP kernel']} != the "
                f"fake-quant model's {b['B-VP']} at {snr:g} dB")
    with ops.force_backend("ref"):
        w_plain = equalize_wideband(wspecs, wens.w_beam, wens.y_beam)
    _, w_rel = compare(torch, torch.view_as_real(wide["s_hat"]),
                       torch.view_as_real(w_plain), MIMO_RTOL, "wideband")
    wnmse = wideband_nmse(wide["s_hat"], wens.s)
    wber = wideband_ber(wide["s_hat"], wens.bits)
    print(f"[mimo] wideband S = {S} x n = {nw}: one vp_quant_matmul launch "
          f"of G = {S * nw}; kernel vs plain {w_rel:.2e}; NMSE {wnmse:.3e}, "
          f"BER {wber:.6f}")

    # -- profiler: the default equalize call and the wideband call ----------
    e, bvp = ens[2.0], specs[2.0][2]
    names, seen = _profile_kernels(torch, [
        ("narrowband equalize (fused, n = 100000)",
         lambda: equalize_vp_kernel(bvp, e.w_beam, e.y_beam),
         {"vp_quant_matmul": 1, "vp_mm_batch": 1}),
        ("narrowband equalize (unfused)",
         lambda: equalize_vp_kernel(bvp, e.w_beam, e.y_beam, fused=False),
         {**_qp(2, "table"), "vp_matmul": 1, "vp_mm_batch": 1}),
        (f"wideband equalize (S = {S}, n = {nw})",
         lambda: equalize_wideband(wspecs, wens.w_beam, wens.y_beam),
         {"vp_quant_matmul": 1, "vp_mm_batch": 1})])
    library = sorted({nm for nm in names if LIBRARY_KERNELS.search(nm)
                      and not any(v in nm for v in KERNEL_NAMES.values())})
    print(f"[profile] equalize calls: hand kernels {seen}")
    if library:
        raise AssertionError(f"library kernels in the equalize calls: "
                             f"{library}")
    print("[profile] no library GEMM in the equalize calls")

    rates = {f"{name}@{snr:g}dB": (n if not name.startswith("masked")
                                   else MASKED_N) / t
             for (snr, name), t in secs.items()}
    rates["wideband"] = S * nw / wide["s"]
    print(f"[mimo] equalizations/s in the counted run (host clock around "
          f"each call, first call of each variant included; {smi}): "
          + ", ".join(f"{k} {v:.0f}" for k, v in rates.items()))
    steady = {}
    for name, fn, count in (
            ("fused", lambda: equalize_vp_kernel(bvp, e.w_beam, e.y_beam), n),
            ("unfused", lambda: equalize_vp_kernel(bvp, e.w_beam, e.y_beam,
                                                   fused=False), n),
            ("cspade", lambda: equalize_vp_kernel(
                bvp, e.w_beam, e.y_beam, cspade_threshold_quantile=0.5), n),
            ("wideband", lambda: equalize_wideband(wspecs, wens.w_beam,
                                                   wens.y_beam), S * nw)):
        t = statistics.median(_timed(torch, fn)[1] for _ in range(5))
        steady[name] = count / t
    print(f"[mimo] equalizations/s, median of 5 warm calls ({smi}): "
          + ", ".join(f"{k} {v:.0f}" for k, v in steady.items()))
    # -- the CLI a user runs, on the card (outside the counted run) --------
    from repro_torch.launch import equalize as equalize_cli
    cli = equalize_cli.main(["--n", str(CLI_N)])
    if not (cli["device"].startswith("cuda")
            and abs(cli["ber"]["B-VP kernel"] - cli["ber"]["B-VP"]) <= 1e-3
            and all(0.0 <= v < 0.05 for v in cli["ber"].values())):
        raise AssertionError(f"equalize CLI on the card: {cli['ber']}")
    print(f"[mimo] CLI python -m repro_torch.launch.equalize --n {CLI_N} on "
          f"{cli['device']}: BER {cli['ber']}, bit gap {cli['bit_gap']:.3f}")
    record["mimo"] = dict(n=n, launches=counts,
                          masked_launches=masked_launches, rel_err=errs, ber={
        f"{k:g}dB": v for k, v in bers.items()}, wideband=dict(
        S=S, n=nw, rel_err=w_rel, nmse=wnmse, ber=wber),
        equalize_s={f"{nm}@{snr:g}dB": t for (snr, nm), t in secs.items()},
        equalizations_per_s=rates, equalizations_per_s_warm=steady,
        profiled=seen)


# ---------------------------------------------------------------------------
# 6. the training path's kernels
# ---------------------------------------------------------------------------

def _sass_counts(lib_path: Path, nvcc: str, opcode: str = "HGMMA"):
    """{kernel symbol: count of `opcode` in its SASS} from the cuobjdump
    beside `nvcc` (the toolkit that built the library)."""
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    if not cuobjdump.exists():
        raise RuntimeError(f"no cuobjdump beside {nvcc}: cannot show the "
                           "tensor cores in the SASS")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and opcode in line:
            counts[name] += 1
    return counts


def train_kernel_phase(torch, peaks, record):
    import ctypes

    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.formats import FXPFormat, default_vp_format
    from repro_torch.core.packing import dequant_words
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.vp_bwd_matmul import (
        bwd_body, plan_tiles, vp_matmul_dw_cuda, vp_matmul_dx_cuda)
    from repro_torch.kernels.vp_quant import vp_quant_packed_cuda
    from repro_torch.mimo.equalizer import table1_specs
    from repro_torch.models.layers import canonical_formats

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    timer = Timer(torch)
    fxp, vp = canonical_formats(QuantConfig(mode="vp"))
    bvp = table1_specs()[2]
    lines, main = [], {}

    # -- the tensor cores in the SASS of the tensor-core body ----------------
    hgmma = _sass_counts(build._target("vp_bwd_matmul"), build._nvcc())
    tc = {k: v for k, v in hgmma.items() if "_tc_kernel" in k}
    if not tc or min(tc.values()) == 0:
        raise AssertionError(f"tensor-core body without HGMMA: {tc}")
    print(f"[kernel] vp_bwd_matmul SASS: HGMMA in {len(tc)} tensor-core "
          f"kernels, {sum(tc.values())} in all ({min(tc.values())} to "
          f"{max(tc.values())} each); {sum(hgmma.values()) - sum(tc.values())}"
          " elsewhere")
    record["hgmma"] = hgmma

    def words(R, C, f_=fxp, v_=vp):
        x = torch.randn((R, C), generator=gen, device="cuda") * 0.3
        return vp_quant_packed_cuda(x.clamp(-0.99, 0.99), f_, v_)

    def cases(dtype, w, w_vp, a, a_vp, g):
        return {"vp_matmul_dx": (
                    lambda: vp_matmul_dx_cuda(g, w, w_vp, dtype),
                    lambda: ref.vp_matmul_dx_ref(g, w, w_vp, dtype)),
                "vp_matmul_dw": (
                    lambda: vp_matmul_dw_cuda(a, g, a_vp, dtype),
                    lambda: ref.vp_matmul_dw_ref(a, g, a_vp, dtype))}

    # -- vp_matmul_dx / vp_matmul_dw at the training shapes and QMM_SHAPE ----
    # An f32 g runs as three bf16 terms on the tensor cores, so its bound is
    # 3 x 2MKN at the bf16 rate (or its bytes); bf16 g: 2MKN.
    for (M, K, N) in TRAIN_SHAPES + (QMM_SHAPE,):
        # At QMM_SHAPE the backward of ops.vp_quant_matmul's words: dx over
        # b's (the y format, int8), dw over a's (the w format, int16).
        qmm = (M, K, N) == QMM_SHAPE
        w_vp, a_vp = (bvp.y_vp, bvp.w_vp) if qmm else (vp, vp)
        w = words(K, N, bvp.y_fxp, w_vp) if qmm else words(K, N)
        a = words(M, K, bvp.w_fxp, a_vp) if qmm else words(M, K)
        w_deq, a_deq = dequant_words(w, w_vp), dequant_words(a, a_vp)
        g32 = torch.randn((M, N), generator=gen, device="cuda")
        for dtype, tol, peak in ((torch.float32, F32_RTOL, "f32"),
                                 (torch.bfloat16, BF16_TOL, "bf16")):
            g = g32.to(dtype)
            wd, ad = w_deq.to(dtype), a_deq.to(dtype)
            esz = g.element_size()
            libs = {"vp_matmul_dx": (lambda: torch.matmul(g, wd.t()),
                                     M * N * esz + K * N * w.element_size()
                                     + M * K * esz),
                    "vp_matmul_dw": (lambda: torch.matmul(ad.t(), g),
                                     M * K * a.element_size() + M * N * esz
                                     + K * N * esz)}
            for name, (kern, plain) in cases(dtype, w, w_vp, a, a_vp,
                                             g).items():
                what = f"{name} {[M, K, N]} {peak}"
                err, rel = compare(torch, kern(), plain(), tol, what)
                lib, nbytes = libs[name]
                ms, plain_ms, library_ms = timer(kern), timer(plain), \
                    timer(lib)
                flops = 2 * M * K * N * (3 if dtype == torch.float32 else 1)
                bnd = bound(peaks, nbytes, flops, "bf16")
                shape = [M, K, N, peak]
                _print_line(name, shape, err, rel, ms, plain_ms, bnd,
                            library_ms)
                tflops = 2 * M * K * N / ms / 1e9
                print(f"[kernel]   {name} {shape}: {tflops:.1f} TFLOP/s "
                      f"(2MKN), {bnd[0] / ms:.1%} of the bound, "
                      f"{ms / library_ms:.2f}x torch.matmul")
                lines.append((name, shape, ms, plain_ms, bnd, library_ms))
                if (name, shape) in (
                        ("vp_matmul_dx", [1024, 1024, 3072, "bf16"]),
                        ("vp_matmul_dw", list(QMM_SHAPE) + ["f32"])):
                    main[name] = _row(
                        name, "vp_bwd_matmul.cu",
                        "src/repro/kernels/vp_bwd_matmul.py:"
                        + ("58" if name == "vp_matmul_dx" else "108"),
                        shape, err, ms, plain_ms, bnd, library_ms)
                    main[name]["tflops"] = tflops
        del w, a, w_deq, a_deq
    print(f"[kernel] vp_matmul_dx / vp_matmul_dw: within {F32_RTOL:g} (f32) "
          f"and {BF16_TOL:g} (bf16) of max|plain| at "
          f"{list(TRAIN_SHAPES + (QMM_SHAPE,))}")

    # -- checked only: a ragged shape and a format for the CUDA-core body ----
    fxp10 = FXPFormat(14, 12)
    vp10 = default_vp_format(fxp10, 10, 1)   # VP(10,[12,8]), int16 words
    for (M, K, N), f_, v_, body in (((1000, 1000, 3000), fxp, vp,
                                     "tensor_core"),
                                    ((37, 45, 29), bvp.y_fxp, bvp.y_vp,
                                     "tensor_core"),
                                    ((1024, 1024, 512), fxp10, vp10,
                                     "cuda_core")):
        w, a = words(K, N, f_, v_), words(M, K, f_, v_)
        g32 = torch.randn((M, N), generator=gen, device="cuda")
        for dtype, tol in ((torch.float32, F32_RTOL),
                           (torch.bfloat16, BF16_TOL)):
            if bwd_body(dtype, v_) != body:
                raise AssertionError(f"{v_} {dtype}: body "
                                     f"{bwd_body(dtype, v_)} != {body}")
            build.reset_launches()
            for name, (kern, plain) in cases(dtype, w, v_, a, v_,
                                             g32.to(dtype)).items():
                compare(torch, kern(), plain(), tol,
                        f"{name} {[M, K, N]} {v_} {dtype}")
            cc = build.LAUNCHES["vp_bwd_cuda_core"]
            if cc != (2 if body == "cuda_core" else 0):
                raise AssertionError(f"{v_}: {cc} CUDA-core launches")
        print(f"[kernel] vp_matmul_dx / vp_matmul_dw {[M, K, N]} {v_} "
              f"({body} body): within tolerance (f32 and bf16)")

    # -- the CUDA-core body through its C entry, in the same run --------------
    lib = build.library("vp_bwd_matmul")
    f_c = build.vp_fmt_struct(vp)
    stream = torch.cuda.current_stream().cuda_stream
    cuda_core = {}
    for (M, K, N) in TRAIN_SHAPES:
        w, a = words(K, N), words(M, K)
        g = torch.randn((M, N), generator=gen, device="cuda").to(
            torch.bfloat16)
        out_dx = torch.empty((M, K), dtype=torch.bfloat16, device="cuda")
        out_dw = torch.empty((K, N), dtype=torch.bfloat16, device="cuda")
        runs = {
            "vp_matmul_dx": (lambda: lib.vp_matmul_dx_cc_launch(
                g.data_ptr(), w.data_ptr(), out_dx.data_ptr(), M, K, N, 1, 2,
                1, ctypes.byref(f_c), stream),
                lambda: vp_matmul_dx_cuda(g, w, vp, torch.bfloat16)),
            "vp_matmul_dw": (lambda: lib.vp_matmul_dw_cc_launch(
                a.data_ptr(), g.data_ptr(), out_dw.data_ptr(), M, K, N, 1, 2,
                1, ctypes.byref(f_c), stream),
                lambda: vp_matmul_dw_cuda(a, g, vp, torch.bfloat16))}
        for name, (cc_run, tc_run) in runs.items():
            build.check(lib, cc_run(), f"{name} (CUDA-core body)")
            cc_ms, tc_ms = timer(cc_run), timer(tc_run)
            cuda_core[f"{name} {[M, K, N]}"] = (cc_ms, tc_ms)
            print(f"[kernel] {name} {[M, K, N, 'bf16']}: CUDA-core body "
                  f"{cc_ms:.4f} ms, tensor-core body {tc_ms:.4f} ms "
                  f"({cc_ms / tc_ms:.1f}x)")
            if (M, K, N) == (1024, 1024, 3072):
                main[name]["cuda_core_ms"] = cc_ms
                main[name]["cuda_core_shape"] = [M, K, N, "bf16"]
    record["cuda_core_vs_tensor_core"] = cuda_core

    # -- the f32 split at the ends of f32's range, against the CUDA cores ------
    # +-FLT_MAX: one per row and column of g (dx and dw stay finite); the
    # truncating split is exact there.  |g| < 2^-110: its lo term falls
    # into bf16's subnormals, so the error is measured and recorded.
    Me, Ke, Ne = 256, 320, 192
    w, a = words(Ke, Ne), words(Me, Ke)
    base = torch.randn((Me, Ne), generator=gen, device="cuda").clamp(-4, 4)
    big = base.clone()
    d = torch.arange(min(Me, Ne), device="cuda")
    big[d, d] = torch.finfo(torch.float32).max * (1.0 - 2.0 * (d % 2))
    ends = {}
    for what, g in (("+-FLT_MAX", big), ("|g| < 2^-110", base * 2.0 ** -112)):
        cc = {"vp_matmul_dx": torch.empty((Me, Ke), device="cuda"),
              "vp_matmul_dw": torch.empty((Ke, Ne), device="cuda")}
        build.check(lib, lib.vp_matmul_dx_cc_launch(
            g.data_ptr(), w.data_ptr(), cc["vp_matmul_dx"].data_ptr(), Me, Ke,
            Ne, 0, 2, 0, ctypes.byref(f_c), stream), "vp_matmul_dx (CUDA cores)")
        build.check(lib, lib.vp_matmul_dw_cc_launch(
            a.data_ptr(), g.data_ptr(), cc["vp_matmul_dw"].data_ptr(), Me, Ke,
            Ne, 0, 2, 0, ctypes.byref(f_c), stream), "vp_matmul_dw (CUDA cores)")
        for name, got in (("vp_matmul_dx", vp_matmul_dx_cuda(g, w, vp,
                                                              torch.float32)),
                          ("vp_matmul_dw", vp_matmul_dw_cuda(a, g, vp,
                                                              torch.float32))):
            want = cc[name]
            if not (bool(torch.isfinite(want).all())
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(f"{name} f32 g {what}: non-finite output")
            if what == "+-FLT_MAX":
                err, rel = compare(torch, got, want, F32_RTOL,
                                   f"{name} f32 g {what} vs CUDA cores")
            else:
                err = float((got.double() - want.double()).abs().max())
                rel = err / float(want.abs().max())
            ends[f"{name} {what}"] = dict(max_abs_err=err, rel=rel)
            print(f"[kernel] {name} {[Me, Ke, Ne]} f32 g {what}: tensor-core "
                  f"body vs CUDA-core body, max abs err {err:.3e} (rel "
                  f"{rel:.3e})")
    record["split_ends"] = ends

    # -- the autograd backward of ops.vp_quant_matmul -------------------------
    Mq, Kq, Nq = QMM_SHAPE
    a, b = _mimo_operands(torch, gen, 1, Mq, Kq, Nq)
    a, b = a[0], b[0]
    gq = torch.randn((Mq, Nq), generator=gen, device="cuda")

    def qmm_grads():
        ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
        out = ops.vp_quant_matmul(ta, tb, bvp.w_fxp, bvp.w_vp, bvp.y_fxp,
                                  bvp.y_vp)
        out.backward(gq)
        return out.detach(), ta.grad, tb.grad

    torch.cuda.synchronize()
    build.reset_launches()
    # -- the path: one forward and backward through the public op --------------
    got = qmm_grads()
    qmm_counts = dict(build.LAUNCHES)
    # -------------------------------------------------------------------------
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = sum(plan_tiles(R, C, S, num_sms).split > 1
                 for R, C, S in ((Mq, Kq, Nq), (Kq, Nq, Mq)))
    want_counts = {"vp_quant_matmul": 1, "vp_mm_tile": 1, **_qp(2, "table"),
                   "vp_matmul_dx": 1, "vp_matmul_dw": 1}
    if splits:
        want_counts["vp_bwd_splitk_reduce"] = splits
    if qmm_counts != want_counts:
        raise AssertionError(f"vp_quant_matmul autograd launches {qmm_counts}"
                             f" != {want_counts}")
    with ops.force_backend("ref"):
        want = qmm_grads()
    errs = [compare(torch, x, y, F32_RTOL, f"vp_quant_matmul autograd {what}")
            [1] for x, y, what in zip(got, want, ("out", "da", "db"))]
    print(f"[kernel] vp_quant_matmul autograd at {[Mq, Kq]} x {[Kq, Nq]}: "
          f"launches {qmm_counts}; out, da, db vs plain path (rel) "
          + ", ".join(f"{e:.2e}" for e in errs))
    for name in ("vp_matmul_dx", "vp_matmul_dw"):
        main[name]["qmm_grad_launches"] = qmm_counts[name]
    main["vp_matmul_dw"]["launches"] = qmm_counts["vp_matmul_dw"]
    record["train_kernel_lines"] = [
        dict(name=n, shape=s, ms=m, plain_ms=p, bound_ms=b[0], bound_by=b[1],
             library_ms=lib) for n, s, m, p, b, lib in lines]
    record["qmm_grad"] = dict(launches=qmm_counts, rel_err=errs)
    print("kernels: vp_matmul_dx, vp_matmul_dw")
    return [main["vp_matmul_dx"], main["vp_matmul_dw"]]


# ---------------------------------------------------------------------------
# 7. train
# ---------------------------------------------------------------------------

def _train_grads(torch, params, batch, cfg, plain=False, f64=False):
    """(loss, {path: grad}) of one step's value_and_grad, on the kernel
    path or the plain path (`f64`: plain matmuls summed in f64)."""
    from repro_torch.kernels import ops
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.tree import tree_paths

    with contextlib.ExitStack() as stack:
        if plain:
            stack.enter_context(ops.force_backend("ref"))
        if f64:
            stack.enter_context(_f64_matmuls(torch))
        loss, _, grads = value_and_grad(params, batch, cfg)
    return float(loss), dict(tree_paths(grads))


def _grad_diffs(torch, got, want):
    """(relative loss difference, {path: max|dg| / max|g_plain|})."""
    (lk, gk), (lp, gp) = got, want
    rels = {p: float((gk[p].float() - gp[p].float()).abs().max()
                     / gp[p].float().abs().max().clamp(min=1e-30))
            for p in gp}
    return abs(lk - lp) / abs(lp), rels


def train_phase(torch, record, rows, smi):
    from repro_torch.configs import registry
    from repro_torch.configs.base import QuantConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.launch import train as train_cli
    from repro_torch.models.model import init_params, stack_layers
    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    from repro_torch.train.compression import (
        CompressionConfig, init_compressor_state)
    from repro_torch.train.train_step import make_train_step

    qat = QuantConfig(mode="vp", qat_mode="packed")
    cfg = registry.get_config(ARCH, qat)
    L = cfg.n_layers
    torch.cuda.synchronize()
    build.reset_launches()
    # -- the main path: the training CLI, 4 steps -----------------------------
    report = train_cli.main([
        "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH), "--seq",
        str(TRAIN_SEQ), "--qat", "packed", "--compress-grads", "--grad-codec",
        "vp", "--compress-moments", "--log-every", "1"])
    counts = dict(build.LAUNCHES)
    # -------------------------------------------------------------------------
    steps = report["steps"]
    for s in steps:
        print(f"[train] step {s['step']}: loss {s['loss']:.6f}, grad norm "
              f"{s['grad_norm']:.4f}, {s['seconds']:.4f} s, "
              f"{s['tokens_per_s']:.1f} tokens/s")
    warm = steps[1:]
    s_step = statistics.median(s["seconds"] for s in warm)
    print(f"[train] {cfg.name} {cfg.dtype}, {L} layers, batch {TRAIN_BATCH} "
          f"x seq {TRAIN_SEQ}: median {s_step:.4f} s/step over steps 2-"
          f"{TRAIN_STEPS} ({TRAIN_BATCH * TRAIN_SEQ / s_step:.1f} tokens/s), "
          f"peak memory {report['peak_bytes'] / 1e9:.3f} GB ({smi})")
    per_step = 7 * L
    # the forward at M = 8 x 128 tokens on the tensor-core body
    fwd = _dqmm_counts(torch, cfg, TRAIN_BATCH * TRAIN_SEQ)
    if fwd.get("vp_dqmm_tc") != per_step:
        raise AssertionError(f"planned train forward: {fwd}")
    step = _add(fwd, _qp(per_step, "table"), {"vp_matmul_dx": per_step})
    expect = {k: v * TRAIN_STEPS for k, v in step.items()}
    print(f"[train] launches in {TRAIN_STEPS} steps: {counts} "
          f"(per step: {step})")
    if counts != expect:
        raise AssertionError(f"train launch counts {counts} != {expect}")
    losses = [s["loss"] for s in steps]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    for row in rows:
        if row["name"] == "vp_matmul_dx":
            row["launches"] = counts["vp_matmul_dx"]
        if row["name"] in counts:
            row["train_launches"] = counts[row["name"]]

    # -- profiler: one train step ----------------------------------------------
    data = SyntheticLM(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH),
                       device="cuda")
    batch = data.batch_at(0)
    params = stack_layers(init_params(cfg, seed=0, device="cuda"))
    opt_cfg = OptConfig(warmup_steps=0, total_steps=TRAIN_STEPS,
                        moment_codec="vp")
    step_fn = make_train_step(cfg, opt_cfg,
                              compress_grads=CompressionConfig(codec="vp"))
    opt, cmp = init_opt_state(params, opt_cfg), init_compressor_state(params)
    step_fn(params, opt, batch, cmp)                      # warm-up
    _, seen = _profile_kernels(torch, [
        ("train step", lambda: step_fn(params, opt, batch, cmp),
         step)])
    print(f"[profile] train step: hand kernels {seen}")
    del params, opt, cmp, step_fn

    # -- one step's loss and gradients: kernel path vs plain path ------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = stack_layers(init_params(cfg32, seed=0, device="cuda"))
    loss_rel32, g32 = _grad_diffs(torch, _train_grads(torch, p32, batch,
                                                      cfg32),
                                  _train_grads(torch, p32, batch, cfg32,
                                               plain=True))
    worst = max(g32, key=g32.get)
    print(f"[train] f32 kernel vs plain path, one step: loss rel diff "
          f"{loss_rel32:.3e} (limit {F32_RTOL:g}); max gradient diff / "
          f"max|plain grad| {g32[worst]:.3e} at {worst} (limit {GRAD_RTOL:g})")
    if loss_rel32 > F32_RTOL or g32[worst] > GRAD_RTOL:
        raise AssertionError(f"f32 train step: loss {loss_rel32:.3e}, "
                             f"gradients {g32}")
    del p32
    p16 = stack_layers(init_params(cfg, seed=0, device="cuda"))
    plain = _train_grads(torch, p16, batch, cfg, plain=True)
    loss_rel, g16 = _grad_diffs(torch, _train_grads(torch, p16, batch, cfg),
                                plain)
    floor_loss, floor_g = _grad_diffs(torch, _train_grads(
        torch, p16, batch, cfg, plain=True, f64=True), plain)
    floor = max(floor_loss, max(floor_g.values()))
    limit = max(REL_LIMIT, FLOOR_MARGIN * floor)
    worst16 = max(g16, key=g16.get)
    print(f"[train] bf16 kernel vs plain path, one step: loss rel diff "
          f"{loss_rel:.3e}, max gradient diff / max|plain grad| "
          f"{g16[worst16]:.3e} at {worst16}; plain-path floor (f64-summed "
          f"matmuls vs plain) loss {floor_loss:.3e}, gradients "
          f"{max(floor_g.values()):.3e}; limit {limit:.3e}")
    if max(loss_rel, g16[worst16]) > limit:
        raise AssertionError(f"bf16 train step differs from the plain path "
                             f"by {max(loss_rel, g16[worst16]):.3e} > "
                             f"{limit:.3e}")
    record["train"] = dict(
        steps=steps, seconds_per_step=s_step,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / s_step,
        peak_bytes=report["peak_bytes"], launches=counts, profiled=seen,
        f32_loss_rel=loss_rel32, f32_grad_rel=g32, bf16_loss_rel=loss_rel,
        bf16_grad_rel=g16, bf16_floor_loss=floor_loss, bf16_floor_grad=floor_g,
        bf16_limit=limit)


def _profile_kernels(torch, runs, attempts: int = 3):
    """Profile each (what, fn, want) of `runs` (`_profile`) and count the
    hand kernels in its trace, which must equal `want` (kernels absent
    from it: 0).  Returns (device kernel names, hand-kernel counts) over
    all runs.  Should the profiler still drop device events of a window
    (`_profile`), a run whose trace disagrees is profiled again, up to
    `attempts` times; a path that launches other kernels than `want`
    fails every attempt."""
    names, total = [], dict.fromkeys(KERNEL_NAMES, 0)
    for what, fn, want in runs:
        full = {k: want.get(k, 0) for k in KERNEL_NAMES}
        for attempt in range(1, attempts + 1):
            got = [n for n, _ in _profile(torch, what, fn)[1]]
            seen = {k: sum(v in n for n in got)
                    for k, v in KERNEL_NAMES.items()}
            if seen == full:
                break
            print(f"[profile] {what}, attempt {attempt}: the trace holds hand "
                  f"kernels {seen}, expected {full}")
        else:
            raise AssertionError(f"{what}: profiled launches {seen} != "
                                 f"expected {full} in {attempts} attempts")
        names += got
        total = {k: total[k] + seen[k] for k in total}
    return names, total


def _profile(torch, what, fn):
    """Run fn() once under torch.profiler; print its wall time (profiler
    on), device busy time, idle share and the kernels taking the most
    device time.  Returns (fn's result, [(kernel name, device us)]).

    After the long serve windows the profiler loses the first device
    records of a new window (the short MIMO windows lost their hand
    kernels that way).  A burst of tiny kernels at the
    window's head takes that loss; only the device events that start
    inside the `WINDOW` range around fn() are kept."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        head = torch.ones(16, device="cuda")
        for _ in range(64):
            head.neg_()
        torch.cuda.synchronize()
        with record_function(WINDOW):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    start = min(e.time_range.start for e in events
                if e.name == WINDOW
                and e.device_type == torch.autograd.DeviceType.CPU)
    kernels = [(e.name, e.time_range.elapsed_us()) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name != WINDOW and e.time_range.start >= start]
    busy = sum(us for _, us in kernels)
    by_name = {}
    for name, us in kernels:   # a hand kernel under its most specific name
        hits = [k for k, v in KERNEL_NAMES.items() if v in name]
        key = (max(hits, key=lambda k: len(KERNEL_NAMES[k])) if hits
               else name.split("<")[0].split("(")[0][-60:])
        by_name[key] = by_name.get(key, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile] {what}: wall {wall_us / 1e3:.3f} ms (profiler on), "
          f"device busy {busy / 1e3:.3f} ms in {len(kernels)} kernels, idle "
          f"share {max(0.0, 1 - busy / wall_us):.3f}; top: "
          + "; ".join(f"{k} {us / 1e3:.3f} ms ({us / busy:.1%})"
                      for k, us in top))
    hand = [(k, by_name[k]) for k in KERNEL_NAMES if k in by_name]
    if hand:
        print(f"[profile] {what}: hand-kernel device time "
              + "; ".join(f"{k} {us / 1e3:.3f} ms ({us / busy:.1%})"
                          for k, us in hand))
    return out, kernels


@contextlib.contextmanager
def _f64_matmuls(torch):
    """Inside: the plain serving matmul, its dx and the block-VP matmul
    sum in f64 instead of f32 (swapped into `ref`), to measure the plain
    path's own rounding floor."""
    from repro_torch.core.packing import dequant_words
    from repro_torch.kernels import ref

    def matmul64(x, w, fmt, out_dtype=torch.float32):
        return (x.double() @ dequant_words(w, fmt).double()).to(out_dtype)

    def dx64(g, w, fmt, out_dtype=torch.float32):
        return (g.double() @ dequant_words(w, fmt).double().t()).to(out_dtype)

    def block64(a_m, a_i, b_m, b_i, a_fmt, b_fmt, bk,
                out_dtype=torch.float32):
        lut_a = torch.tensor([2.0 ** -f for f in a_fmt.f],
                             dtype=torch.float64, device=a_m.device)
        lut_b = torch.tensor([2.0 ** -f for f in b_fmt.f],
                             dtype=torch.float64, device=a_m.device)
        out = 0.0
        for t in range(a_m.shape[1] // bk):
            acc = a_m[:, t * bk:(t + 1) * bk].double() @ \
                b_m[t * bk:(t + 1) * bk].double()
            out = out + (acc * lut_a[a_i[:, t].long()][:, None]
                         * lut_b[b_i[t].long()][None, :])
        return out.to(out_dtype)

    names = ("vp_dequant_matmul_ref", "vp_matmul_dx_ref",
             "block_vp_matmul_ref")
    saved = [getattr(ref, n) for n in names]
    for n, fn in zip(names, (matmul64, dx64, block64)):
        setattr(ref, n, fn)
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(ref, n, fn)


@contextlib.contextmanager
def _f64_attention(torch):
    """Inside: the plain prefill and decode attention sum in f64 instead
    of f32 (swapped into `ref`), with the same masks, the same cast of
    the probabilities to v's dtype before PV, and the result cast back."""
    from repro_torch.kernels import ref

    def valid_decode(cache_len, Smax, window, rolling, device):
        pos = torch.arange(Smax, device=device)[None, :]
        length = cache_len.to(torch.int64)[:, None]
        if rolling:
            return pos < torch.clamp(length, max=Smax)
        valid = pos < length
        if window:
            valid &= pos >= length - window
        return valid

    def decode64(q, k_cache, v_cache, cache_len, window=None, rolling=False):
        B, _, H, dh = q.shape
        Smax, KV = k_cache.shape[1], k_cache.shape[2]
        qr = q.reshape(B, KV, H // KV, dh).double() * dh ** -0.5
        s = torch.einsum("bkgd,bksd->bkgs", qr,
                         k_cache.transpose(1, 2).double())
        valid = valid_decode(cache_len, Smax, window, rolling, q.device)
        s = torch.where(valid[:, None, None, :], s, ref.NEG_INF)
        out = torch.einsum("bkgs,bksd->bkgd", torch.softmax(s, dim=-1),
                           v_cache.transpose(1, 2).double())
        return out.reshape(B, 1, H, dh).to(q.dtype)

    def prefill64(q, k, v, pattern="causal", window=None):
        B, Sq, H, dh = q.shape
        Sk, KV = k.shape[1], k.shape[2]
        qr = q.reshape(B, Sq, KV, H // KV, dh).double() * dh ** -0.5
        s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.double())
        if pattern in ("causal", "local"):
            q_pos = torch.arange(Sq, device=q.device)[:, None]
            k_pos = torch.arange(Sk, device=q.device)[None, :]
            mask = k_pos <= q_pos
            if pattern == "local" and window:
                mask &= q_pos - k_pos < window
            s = torch.where(mask, s, ref.NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).double(),
                          v.double())
        out = (pv / p.sum(dim=-1)[..., None]).permute(0, 3, 1, 2, 4)
        return out.reshape(B, Sq, H, dh).to(q.dtype)

    saved = ref.decode_attention_ref, ref.flash_prefill_ref
    ref.decode_attention_ref, ref.flash_prefill_ref = decode64, prefill64
    try:
        yield
    finally:
        ref.decode_attention_ref, ref.flash_prefill_ref = saved


def _plain_logits(torch, cfg, params, prompts, tokens, f64_matmul=False,
                  f64_attention=False, max_len=PROMPT + GEN, chunk=None):
    """Logits of prefill + one decode step per column of `tokens` on the
    plain path (teacher-forced), over a cache of `max_len` positions; the
    prompt whole, or in `chunk`-token chunked prefills (each attending to
    the quantized history).  `f64_matmul` sums the plain matmuls in f64
    instead of f32, and `f64_attention` the plain attention, to measure
    the path's own rounding floor."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import decode_step, init_cache, prefill

    with contextlib.ExitStack() as stack:
        stack.enter_context(ops.force_backend("ref"))
        if f64_matmul:
            stack.enter_context(_f64_matmuls(torch))
        if f64_attention:
            stack.enter_context(_f64_attention(torch))
        caches = init_cache(cfg, prompts.shape[0], max_len)
        if chunk:
            for lo in range(0, prompts.shape[1], chunk):
                lg, caches = prefill(params, prompts[:, lo:lo + chunk],
                                     caches, cfg, chunked=True)
        else:
            lg, caches = prefill(params, prompts, caches, cfg)
        out = [lg]
        for i in range(tokens.shape[1]):
            lg, caches = decode_step(params, tokens[:, i:i + 1], caches, cfg)
            out.append(lg)
    return out


def _rel_diffs(torch, got, want):
    """Per step max|got - want| / max|want|, and the greedy agreement."""
    rels = [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]
    agree = statistics.mean(
        float((g.argmax(-1) == w.argmax(-1)).float().mean())
        for g, w in zip(got, want))
    return rels, agree


if __name__ == "__main__":
    main()
