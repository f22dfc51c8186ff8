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
  4c. dense  - the rest of the dense path (`dense_phase`), bf16, random
               weights from seed 0, each run's logits teacher-forced
               against its plain path at the serve limits: qwen2-0.5b
               (QKV bias, G = 7) at full width and depth through the
               serve CLI, `--quant vp --kv-quant`, batch 4 x 128, 32
               steps (exact launch counts, a profile of one prefill and
               one decode step; the CLI run's own logits are the ones
               held), the same in f32, then short CLI runs (batch 4,
               prompt 16, 2 steps) at `--quant vp_block` (only w_down
               tiles at 256), `--layout planes` (the planes quantizer at
               export, the planes dequant on every weight), `--M 6
               --E 2 --kv-quant` (int8 weight and KV words, decode
               attention at G = 7 split over two slices) and `--layout
               planes --kv-layout planes --M 10 --E 2 --kv-quant` (int16
               significands in weights and KV cache);
               gemma3-27b at full width over 7 layers (5 local + 1
               global, then a local tail), batch 2 x 1152 (past the
               1024 window), 16 steps, prefill on the tensor-core body
               at dh 168 (no CUDA-core prefill launch), then through the
               engine with global layers paged
               and local layers on dense rings (3 requests of 1040-1152
               tokens, 2 slots, run-ahead 4 and 1 with the same tokens,
               each graph's first replay bit-identical to its eager
               step); stablelm-12b at full width over 4 layers, batch 4
               x 128, 8 steps (prefill on the tensor-core body at dh
               160).
               After each run its kernels at its own shapes against
               their plain versions (`_dense_shapes`): the packed matmul
               of every layer-0 weight at decode and prefill M and of
               lm_head within BF16_TOL; vp_block and planes matmuls, the
               KV write in int8 and int16 words and the planes export
               bit for bit.  Then the kernels at these shapes, timed as
               in phase 3 beside bound, plain version and SDPA: decode
               attention at G = 7 (int8: the G slices bit-identical to G
               4 and G 3 launches; int16), at dh 168 on a rolling ring of
               1024 (int8 on 8-byte lanes; int16) and at dh 160; the
               tensor-core prefill at dh 168 (causal, local 1024) and dh
               160 beside the CUDA-core body it replaced there (slower,
               or the phase fails), with its LDL / STL counts; the
               planes dequant at qwen2's w_down panel in int8 and int16
               significands, bit for bit.
  3b. wide  - the formats past the canonical kernels' first widths
               (`wide_kernel_phase`), each kernel bit-identical to its
               plain version (float sums within tolerance), timed, its
               new instances free of local memory in the SASS: int32
               packed words (VP(13, E 4), VP(16, E 1), VP(10, E 7))
               through the quantizer's table and chain bodies, the KV
               mode, both dequants (int32 in 16-byte vectors, ragged and
               unaligned slices), `vp_dequant_matmul`'s bodies, and
               decode attention at stablelm's dh 160 (G 4) and gemma3's
               dh 168 ring (32-byte lanes), qwen3-moe's G 8 and
               mixtral's G 6 (a row's bits independent of G); E 5 and E
               7 (32 and 128 exponents) through the same kernels; int16
               block-VP significands (M 10 E 2, M 12 E 3) through
               `vp_block_quant` on its small, coop, two-pass and general
               bodies and `block_vp_matmul`'s int16 body at blocks 16 and
               256.
  4d. formats - the serve CLI at those formats (`formats_phase`), f32,
               batch 4, prompt 16, 4 steps, greedy tokens equal to the
               plain path's on the card: `--quant vp --kv-quant --M 13
               --E 4` on qwen2 (full), stablelm (4 layers) and gemma3 (7
               layers), and through the engine with `--prefill-chunk 32`
               over the int32 cache; `--quant vp_block --block 16
               --kv-quant` at `--M 10 --E 2` and `--M 12 --E 3`; `--quant
               vp --kv-quant --M 7 --E 5` and `--E 7`.
  4e. moe    - qwen3-moe-30b-a3b over 8 layers and mixtral-8x22b over 2
               at full width through the static serve CLI (`moe_phase`),
               bf16, `--quant vp --kv-quant`, batch 4, prompt 128, 16
               steps: tokens/s and launch counts by kernel, every stacked
               expert weight dequantized by one `vp_dequant_packed`
               launch a layer and pass, a second run's tokens equal.
  4f. ssm    - the SSM and hybrid families and the engine's MoE rows
               (`ssm_phase`): the kernels at rwkv6-3b's and zamba2-7b's
               shapes (`vp_dequant_matmul` with f32 activations, N 112 /
               128, K 7168, vocab 65536 / 32000; decode attention at G 1,
               dh 112 in int16 and int8 words; the tensor-core prefill at
               dh 112; the KV write, bit for bit) against their plain
               versions, timed, and a one-token block's rows bit-identical
               alone and in a batch of 4; both models whole at full width
               through the static serve CLI (bf16, batch 4 x 128, 16
               steps), then in f32 at a cut (rwkv6 4 layers, zamba2 9)
               against the plain path's tokens; both through the engine
               (6 ragged requests, run-ahead 4 and 1 with the same tokens,
               zamba2 also in chunks of 32; f32 at the cut against the
               plain path, whole and chunked); qwen3-moe (8 layers) and
               mixtral (2) through the engine (each graph's first replay
               bit-identical to its eager step); one packed-QAT train step
               with VP gradients and moments and remat on each family at
               the cut.
  4g. encdec / vlm - the encoder-decoder and VLM families
               (`encdec_vlm_phase`): the kernels at whisper-tiny's and
               internvl2-1b's shapes against their plain versions, timed
               (`flash_prefill` at pattern "full", its first card
               launches: whisper's encoder at S 1500 and its cross
               prefill at Sq 128 / Sk 1500, bf16 on the tensor cores and
               f32 on the CUDA cores; causal at 256 patches + 128 tokens,
               G 7; the tensor-core `vp_dequant_matmul` at M 6000 and
               `patch_proj`; the skinny body on the unaligned lm_head rows
               of vocab 51865 and 151655; decode at G 1, dh 64); both
               models whole at full width through the static serve CLI
               (bf16, batch 4 x 128, 16 steps: exact prefill, decode and
               KV-write launches, a second run's tokens equal, a profile
               of the encode, prefill and one decode step), then in f32
               (internvl2 at 4 layers) against the plain path's tokens;
               internvl2 through the engine, text-only (run-ahead 4 and
               1, the same tokens); one packed-QAT train step on each
               (whisper whole, internvl2 at 4 layers), and one f32 step's
               loss and gradients against the plain path.
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
  5b. search - the paper's Sec. II-D exponent-list search on the card
               (`search_phase`): every subcarrier of a wideband band of
               64 subcarriers x 16 realizations through
               `WidebandCalibrator.search_vp_format`, each candidate list
               one launch of the planes quantize kernel and one of the
               planes dequant kernel (exact counts, no plain version
               run), against the same search on the CPU on the same
               arrays: the same formats, NMSE within 1e-12; seconds per
               subcarrier; `search_min_M` at E 2 and E 3 and one forced
               greedy search (lists padded with repeated exponents)
               against the CPU; both kernels timed at the search's tile;
               the Fig. 11 cost-model ratios of `launch.equalize`.
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
  7b. remat  - stablelm-12b at full width over 4 layers, bf16, packed
               QAT, one training step's loss and gradients with
               remat="full" and "none" (`remat_phase`): loss bit-identical,
               gradient max diff 0, the peak device memory of each (lower
               with remat, or the phase fails).
  7c. mesh   - distribution (`repro_torch.parallel`, `launch.mesh`;
               `mesh_phase`): (a) world size 1 over NCCL in this
               process, the engine at mesh (data, model) = (1, 1) on the
               engine phase's requests, its decode graphs capturing the
               NCCL collectives, each first replay bit-identical to its
               eager step, the unsharded engine's tokens; (b) gloo ranks
               spawned on cuda:0 (collectives staged through host
               memory: every figure labelled "gloo via host, one
               card"): qwen3-0.6b through `sharded_forward_fns` at tp 2,
               4 x 128 and 32 greedy steps, logits and tokens
               bit-identical to this process's unsharded kernel run; the
               engine on qwen3-0.6b cut to 4 layers at (1, 2) and (2, 2)
               (eager, and saying so) with the unsharded engine's tokens
               and equal pools on every rank;
               qwen3-moe cut to 2 layers, expert parallel at tp 2, the
               unsharded tokens; (c) the op-level modes at tp 2: column,
               gather and ring at (4, 1024, 3072) and gemma3's prefill
               w_up (2304, 5376, 21504), vp_block's column shard through
               `qdot` at (4, 1024, 3072), seq and heads decode attention
               and heads flash prefill bit-identical to the unsharded
               kernel, dx psum / ring within 1e-5 relative and dw bit
               for bit at (1024, 1024, 3072) bf16 and f32,
               `dp_compress_reduce` at dp 2 in both codecs, the shard
               launch counters; (d) the wideband equalizer sharded over
               subcarriers bit-identical to the flat path.
  7d. tune   - the measured plan cache (`tune_phase`, a cache file of
               its own): the serve CLI with `--tune-decode` on qwen3-0.6b
               at full width, bf16, `--quant vp --kv-quant`, batch 4 x
               128, 32 steps, tuning the skinny `vp_dequant_matmul`
               body's split of K over every weight panel (one plan for
               every decode batch) and the split decode body's (cluster,
               warps) over the cache geometry; a second run makes no new
               entry; every entry timed under the heuristic's plan and
               the tuned one (the tuned no slower beyond the timer's
               spread), held against the plain version, and a skinny
               row's bits the same at M 1 to 4 under its tuned plan; an
               f32 run on the tuned cache gives the plain path's greedy
               tokens; the engine on it the same tokens at run-ahead 4
               and 1, each graph's first replay bit-identical to its
               eager step; `analysis/smem.py`'s static shared memory and
               register check against the build's report; one oversized
               plan (a cluster of 16) refused by the model and by the C
               entry.
  8. result  - a {"kernels": [...]} line, then the device line last.

Every phase runs with `REPRO_TORCH_AUTOTUNE_CACHE` pointed at a fresh
temporary file, so none reads a plan cache left on the machine, and every
phase but `tune_phase` launches on the heuristic plans.

Exits non-zero without CUDA, and outside a checkout of the repository.
Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
                "vp_dequant_packed": "vp_dequant_packed_kernel",
                "rms_norm": "rms_norm_kernel"}
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
# Formats past the canonical kernels' first designs (faults 7-9): int32
# words (M + E > 16), E 5-7 (32-128 exponents), and int16 block-VP
# significands at the blocks the int32 contract admits (M 9-12 at 256)
WIDE = {"M13E4": (13, 4), "M16E1": (16, 1), "M7E5": (7, 5),
        "M7E7": (7, 7), "M10E7": (10, 7)}
BLOCK_WIDE = {"M10E2": (10, 2), "M12E3": (12, 3)}
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
                "vp_dequant_packed", "block_vp_matmul", "vp_block_quant",
                "rms_norm")
FLASH_SWEEP = (128, 512, 2048)       # causal bf16 prompts at B = 4
# The dense phase: gemma3 at 7 layers (one period of 5 local + 1 global,
# then a local tail; the 62-layer words alone would be ~59 GB beside ~59
# GB of bf16 masters) serving (batch, prompt past the 1024 window,
# steps), then through the engine (requests, prompt range, budget range;
# slots, capacity); stablelm at 4 layers of 40 (the run's time)
GEMMA_LAYERS, GEMMA_SERVE = 7, (2, 1152, 16)
GEMMA_ENGINE_REQS = (3, (1040, 1152), (8, 16))
GEMMA_ENGINE_SLOTS, GEMMA_ENGINE_CAP = 2, 1184
STABLELM_LAYERS, STABLELM_SERVE = 4, (4, 128, 8)
# Training with remat: stablelm at 4 layers, one step on (batch, seq)
REMAT_BATCH = (4, 512)
# The MoE family at full width, cut in depth (48 layers of qwen3-moe are
# ~58 GB of int16 expert words, beside bf16 masters; mixtral's 56, ~4.8
# GB of words each): layers served, then (batch, prompt, decode steps)
MOE_LAYERS = {"qwen3-moe-30b-a3b": 8, "mixtral-8x22b": 2}
MOE_SERVE = (4, 128, 16)
# The SSM and hybrid families (rwkv6-3b, zamba2-7b) at full width and
# depth: static serve (batch, prompt, decode steps); the f32 runs against
# the plain path and the train step at a cut (rwkv6 4 layers; zamba2 one
# repetition of 6 mamba layers and the shared block, then the tail of 3);
# the engine's requests (count, prompt range, budget range, numpy seed
# 0), slots, capacity and prefill chunk, also for the MoE engine rows;
# the projections' shapes (arch, weight, K, N, activation dtype: rwkv6's
# lerp hands its R/K/V/G and channel-mix projections f32); zamba2's
# shared block's decode (B, smax, KV, G, dh) and prefill (B, S, H)
SSM_ARCHS = ("rwkv6-3b", "zamba2-7b")
SSM_SERVE = (4, 128, 16)
SSM_F32_LAYERS = {"rwkv6-3b": 4, "zamba2-7b": 9}
SSM_ENGINE_REQS = (6, (40, 96), (8, 16))
SSM_ENGINE_SLOTS, SSM_ENGINE_CAP, SSM_ENGINE_CHUNK = 4, 112, 32
SSM_TRAIN = (2, 256)
SSM_DQMM = (("rwkv6-3b", "w_r", 2560, 2560, "f32"),
            ("rwkv6-3b", "w_ck", 2560, 8960, "f32"),
            ("rwkv6-3b", "w_o", 2560, 2560, "bf16"),
            ("rwkv6-3b", "w_cv", 8960, 2560, "bf16"),
            ("rwkv6-3b", "lm_head", 2560, 65536, "bf16"),
            ("zamba2-7b", "w_z", 3584, 7168, "bf16"),
            ("zamba2-7b", "w_bc", 3584, 128, "bf16"),
            ("zamba2-7b", "w_dt", 3584, 112, "bf16"),
            ("zamba2-7b", "w_out", 7168, 3584, "bf16"),
            ("zamba2-7b", "wq", 3584, 3584, "bf16"),
            ("zamba2-7b", "w_up", 3584, 14336, "bf16"),
            ("zamba2-7b", "w_down", 14336, 3584, "bf16"),
            ("zamba2-7b", "lm_head", 3584, 32000, "bf16"))
SSM_DEC_SHAPE = (4, 144, 32, 1, 112)
SSM_PREFILL_SHAPE = (4, 128, 32)
# The encoder-decoder and VLM families (whisper-tiny: 4 + 4 layers, d 384,
# 6 heads of 64, 1500 frames, vocab 51865; internvl2-1b: 24 layers, d 896,
# 14 / 2 heads of 64, 256 patches, vocab 151655) whole at full width:
# static serve (batch, prompt, decode steps); internvl2's f32 run and
# train step at ED_CUT layers (whisper whole); the train batch (batch,
# seq); the kernel shapes of these paths: flash prefill (B, Sq, Sk, H,
# KV, dh, pattern): whisper's encoder, its cross-attention prefill,
# internvl2's causal prefill of 256 patches + 128 tokens; the f32 case
# (CUDA-core body); vp_dequant_matmul (M, K, N, weight): whisper's encoder
# and cross K/V at M = 4 x 1500 frames, internvl2's patch projection at 4
# x 256 patches, both lm_heads at decode (odd vocabularies: int16 rows
# not 16-byte aligned); whisper's decoder self-attention decode (B, smax,
# KV, G, dh)
ED_ARCHS = ("whisper-tiny", "internvl2-1b")
ED_SERVE = (4, 128, 16)
ED_CUT = 4
ED_TRAIN = (2, 128)
ED_FLASH = ((4, 1500, 1500, 6, 6, 64, "full"),
            (4, 128, 1500, 6, 6, 64, "full"),
            (4, 384, 384, 14, 2, 64, "causal"))
ED_FLASH_F32 = (4, 1500, 1500, 6, 6, 64, "full")
ED_DQMM = ((6000, 384, 384, "whisper encoder wq / wk / wv / wo, cross wk / wv"),
           (6000, 384, 1536, "whisper encoder w_in"),
           (6000, 1536, 384, "whisper encoder w_out"),
           (1024, 896, 896, "internvl2 patch_proj"),
           (4, 384, 51865, "whisper lm_head"),
           (4, 896, 151655, "internvl2 lm_head"))
ED_DEC_SHAPE = (4, 144, 6, 1, 64)
# The Sec. II-D search on the card: a wideband band (subcarriers,
# realizations); search_min_M's (E, NMSE target), met at M <= 5 at E 3
# (the exhaustive branch has no candidate past it on FXP(12, 11)); the
# (M, E) of the forced greedy search; formats equal, NMSE within SEARCH_RTOL
SEARCH_BAND = (64, 16)
SEARCH_MIN_M = ((2, 1e-4), (3, 1e-2))
SEARCH_GREEDY = (5, 3)
SEARCH_RTOL = 1e-12
# --tune-decode on the serve run; a tuned plan may read up to TUNE_NOISE
# (factor, ms) over the heuristic's in the Timer, first as timed, then
# both re-timed in TUNE_TURNS turns: one plan timed twice in one call read
# -1.5 % to +0.8 % apart at these shapes (H100 80GB HBM3, 700 W, PERF.md
# §6), and 0.0005 ms is a CUDA event's resolution; the plan cache's
# environment variable
TUNE_ARGV = ["--arch", ARCH, "--quant", "vp", "--kv-quant", "--batch",
             str(BATCH), "--prompt-len", str(PROMPT), "--gen", str(GEN)]
TUNE_NOISE = (1.05, 0.0005)
TUNE_TURNS = 3
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
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
    # no phase reads a plan cache left on the machine; tune_phase keeps
    # its own
    with isolated_plan_cache():
        for phase, *extra in (
                (kernel_phase, peaks, record),
                (block_kernel_phase, peaks, record),
                (wide_kernel_phase, peaks, record),
                (mimo_kernel_phase, peaks, record),
                (train_kernel_phase, peaks, record),
                (serve_phase, record, rows),
                (serve_block_phase, record, rows, smi),
                (serve_block16_phase, record, rows, smi),
                (engine_phase, record, rows, smi),
                (dense_phase, record, rows, smi, peaks),
                (formats_phase, record, rows, smi),
                (moe_phase, record, rows, smi),
                (ssm_phase, record, rows, smi, peaks),
                (encdec_vlm_phase, record, rows, smi, peaks),
                (dequant_phase, record, rows),
                (mimo_phase, record, rows, smi),
                (search_phase, record, rows, peaks),
                (train_phase, record, rows, smi),
                (remat_phase, record, rows, smi),
                (mesh_phase, record, rows, smi),
                (tune_phase, record, rows, smi, peaks)):
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

    # -- rms_norm: every norm of the path ---------------------------------------
    rows.append(_rms_norm_row(torch, peaks, timer, randn, lines))
    record["kernel_lines"] = [
        dict(name=n, shape=s, ms=m, plain_ms=p, bound_ms=b[0], bound_by=b[1],
             library_ms=lib) for n, s, m, p, b, lib in lines]
    print("kernels: vp_quant_packed, vp_dequant_matmul, "
          "vp_decode_attention (split body), flash_prefill (tensor-core and "
          "CUDA-core bodies), rms_norm")
    return rows


def _rms_norm_row(torch, peaks, timer, randn, lines):
    """Row 16, `rms_norm`, at the norms' shapes on the main paths (the
    serve's decode and prefill ln1 / ln2 and q_norm / k_norm, zamba2's
    ln and gated out_norm, rwkv6's per-head ln_x with its (H, N) gamma),
    x in bf16 and f32 and gamma in f32 and bf16: bit for bit the plain
    version (the kernel's summation order, IEEE-rounded steps); each row
    of a launch
    bit-identical to the same row launched alone and among 512 rows (a
    row's bits do not depend on the number of rows); the serve's shapes
    timed beside the plain version and `F.rms_norm` (its weight
    1 + gamma made beforehand)."""
    import torch.nn.functional as F

    from repro_torch.kernels import build, ref
    from repro_torch.kernels.rms_norm import rms_norm_cuda

    f32, bf16 = torch.float32, torch.bfloat16
    shapes = (((4, 1, 1024), (1024,)), ((4, 1, 16, 128), (128,)),
              ((4, 128, 1024), (1024,)), ((4, 1, 3584), (3584,)),
              ((4, 1, 7168), (7168,)), ((4, 128, 40, 64), (40, 64)))
    build.reset_launches()
    checks = 0
    for xs, gs in shapes:
        for xdt in (bf16, f32):
            for gdt in (f32, bf16):
                x = randn(*xs, dtype=xdt) * 3
                g = (randn(*gs) * 0.1).to(gdt)
                got = rms_norm_cuda(x, g)
                _identical(torch, got, ref.rms_norm_ref(x, g),
                           f"rms_norm {list(xs)} {xdt} gamma {gdt}")
                _identical(torch, rms_norm_cuda(x, g), got,
                           f"rms_norm {list(xs)}, two launches")
                checks += 2
    # a row's bits at 1, 4 and 512 rows (and across a row count that
    # leaves the last block part empty)
    for D in (1024, 3584, 128):
        g = randn(D) * 0.1
        x = randn(512, D, dtype=bf16) * 3
        whole = rms_norm_cuda(x, g)
        for lo, n in ((0, 1), (3, 1), (0, 4), (5, 13), (500, 12)):
            _identical(torch, rms_norm_cuda(x[lo:lo + n], g),
                       whole[lo:lo + n], f"rms_norm D {D} rows {lo}+{n}")
            checks += 1
    if build.LAUNCHES["rms_norm"] != checks + 3:
        raise AssertionError(f"rms_norm launches {dict(build.LAUNCHES)}")
    print(f"[kernel] rms_norm: bit-identical to the plain version at "
          f"{[list(xs) for xs, _ in shapes]}; every row bit-identical at 1, "
          "4, 13 and 512 rows")

    row = None
    for xs, gs in shapes[:3]:
        x, g = randn(*xs, dtype=bf16) * 3, randn(*gs) * 0.1
        err, rel = compare(torch, rms_norm_cuda(x, g), ref.rms_norm_ref(x, g),
                           BF16_TOL, f"rms_norm {list(xs)}")
        ms = timer(lambda: rms_norm_cuda(x, g))
        plain_ms = timer(lambda: ref.rms_norm_ref(x, g))
        library_ms = None
        if hasattr(F, "rms_norm"):
            w1 = (1.0 + g).to(bf16)
            library_ms = timer(lambda: F.rms_norm(x, gs, w1, 1e-6))
        bnd = bound(peaks, 2 * x.numel() * 2 + g.numel() * 4, 4 * x.numel(),
                    "f32")
        _print_line("rms_norm", list(xs), err, rel, ms, plain_ms, bnd,
                    library_ms)
        lines.append(("rms_norm", list(xs), ms, plain_ms, bnd, library_ms))
        if row is None:
            row = _row("rms_norm", "rms_norm.cu",
                       "src/repro/models/layers.py:245", list(xs), err, ms,
                       plain_ms, bnd, library_ms)
    return row


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
        TC_DHS, flash_body, flash_prefill_cuda, plan_decode,
        vp_decode_attention_cuda)

    # -- SASS: registers only; the tensor cores in the prefill body ----------
    target = build._target("vp_attention")
    sass = {op: _sass_counts(target, build._nvcc(), op)
            for op in ("LDL", "STL", "HMMA")}
    inst = {}
    for sym in sass["HMMA"]:
        m = (re.search(r"split_kernelI([ais])Li(\d+)ELi(8|32)E", sym)
             or re.search(r"split_kernelI([ais])Li(\d+)E", sym)
             or re.search(r"(tc)_kernelILi(\d+)E", sym)
             or re.search(r"(cc)_kernelI(f|13__nv_bfloat16)E", sym))
        if m:
            name = {"a": "decode int8 G<=", "s": "decode int16 G<=",
                    "i": "decode int32 G<=", "tc": "prefill tc dh ",
                    "cc": "prefill cc "}[m[1]] + m[2].replace(
                        "13__nv_", "") + (f" {m[3]}-byte" if m.re.groups == 3
                                          else "")
            inst[name] = {op: sass[op][sym] for op in sass}
    print("[kernel] vp_attention SASS (LDL, STL, HMMA): " + "; ".join(
        f"{k} {v['LDL']}/{v['STL']}/{v['HMMA']}" for k, v in inst.items()))
    spills = {k: v for k, v in inst.items() if v["LDL"] or v["STL"]}
    tc = {k: v for k, v in inst.items() if k.startswith("prefill tc")}
    if spills:
        raise AssertionError(f"attention bodies use local memory: {spills}")
    if len(tc) != len(TC_DHS) or not all(v["HMMA"] for v in tc.values()):
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
    # the bodies of int8 significands (int16 ones: wide_kernel_phase)
    INT8_BODIES = ("skinny", "tensor_core", "dp4a")

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
        for body in INT8_BODIES:
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
                *ops_in, vp, vp, BLOCK, f32, body=b)) for b in INT8_BODIES}
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
    cast_ms = timer(lambda: m.to(torch.float32))   # a yardstick
    bnd = bound(peaks, R * C * (1 + 1 + 4), 0, "f32")
    shape = [R, C, "int8+uint8", "float32"]
    _print_line("vp_dequant_planes", shape, 0.0, 0.0, ms, plain_ms, bnd, None)
    print(f"[kernel] vp_dequant_planes {shape}: {ms:.4f} ms ({bnd[0] / ms:.1%}"
          f" of the bound; the first design 0.3495 ms); m.to(float32) "
          f"{cast_ms:.4f} ms")
    lines.append(("vp_dequant_planes", shape, ms, plain_ms, bnd, None, None))
    main_pl = _row("vp_dequant_planes", "vp_dequant.cu",
                   "src/repro/kernels/vp_dequant.py:31", shape, 0.0, ms,
                   plain_ms, bnd, None)
    main_pl.update(cast_ms=cast_ms,
                   grids=_planes_grids(torch, timer, m, i, wv))
    rows += [main_pl, main_pk]
    # int8 and int16 significands (VP(10, E 2)), whole and in ragged and
    # unaligned slices: the head, the steps and the tail, the index plane
    # at its own offset (the steps then read it one byte at a time) and
    # the output unaligned (stored one by one)
    vp10 = default_vp_format(fxp6, 10, 2)
    m10, i10 = vp_quant_planes_cuda(
        (torch.randn((R // 100, C), generator=gen, device="cuda") * 0.3
         ).clamp(-0.99, 0.99), fxp6, vp10)
    if m10.dtype != torch.int16:
        raise AssertionError(f"VP(10) planes are {m10.dtype}")
    planes = [(m10, i10, vp10, "int16 whole")]
    for (mm, ii, v_, kind) in ((m.reshape(-1), i.reshape(-1), wv, "int8"),
                               (m10.reshape(-1), i10.reshape(-1), vp10,
                                "int16")):
        for lo_m, lo_i, n in ((0, 0, 1), (0, 0, 15), (3, 3, 1003),
                              (5, 0, 4099), (0, 7, 16 * 4096 + 5),
                              (9, 9, 100_003), (1, 2, 33)):
            planes.append((mm[lo_m:lo_m + n], ii[lo_i:lo_i + n], v_,
                           f"{kind} [{lo_m}:+{n}], indices [{lo_i}:+{n}]"))
    for m_, i_, v_, what in planes:
        for dt in (torch.float32, torch.bfloat16):
            identical(vp_dequant_planes_cuda(m_, i_, v_, dt),
                      ref.vp_dequant_ref(m_, i_, v_, dt),
                      f"vp_dequant_planes {what} {dt}")
    print(f"[kernel] vp_dequant_packed (int16 and int8 words, whole and "
          f"{len(pieces) - 1} ragged or unaligned slices; f32, bf16) and "
          f"vp_dequant_planes (int8 and int16 significands, whole and "
          f"{len(planes) - 1} ragged or unaligned slices; f32, bf16): "
          f"bit-identical to their plain versions")
    record["block_kernel_lines"] = [
        dict(name=n, shape=s, ms=m_, plain_ms=p, bound_ms=b[0],
             bound_by=b[1], library_ms=lib, library_f32_ms=lib32)
        for n, s, m_, p, b, lib, lib32 in lines]
    print("kernels: block_vp_matmul, vp_block_quant, vp_dequant_packed, "
          "vp_dequant_planes")
    return rows


def _planes_grids(torch, timer, m, i, vp):
    """The planes kernel on its planned grid (`plan_planes`: one step a
    thread) beside a one-wave grid of the same blocks looping over the
    steps (`plan_packed`'s), at m's shape in f32 and bf16, each checked
    bit for bit against the plain version: {dtype: (blocks, ms) x 2}."""
    import ctypes

    from repro_torch.kernels import build, ref
    from repro_torch.kernels.vp_dequant import (
        plan_packed, plan_planes, planes_vec, split_packed)

    lib = build.library("vp_dequant")
    fmt = build.vp_fmt_struct(vp, m.device)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        o = torch.empty(m.shape, dtype=dt, device="cuda")
        mb = m.element_size()
        head, steps, _ = split_packed(m.numel(), m.data_ptr() % 16, mb,
                                      planes_vec(mb, o.element_size()) * mb)

        def launch(blocks, threads):
            err = lib.vp_dequant_planes_launch(
                m.data_ptr(), mb, i.data_ptr(), o.data_ptr(), m.numel(),
                build.dtype_code(dt, "dtype"), ctypes.byref(fmt), head,
                blocks, threads, torch.cuda.current_stream().cuda_stream)
            build.check(lib, err, "vp_dequant_planes")
            return o

        times = {}
        for what, (blocks, threads) in (("planned", plan_planes(steps)),
                                         ("one wave", plan_packed(steps,
                                                                  sms))):
            _identical(torch, launch(blocks, threads),
                       ref.vp_dequant_ref(m, i, vp, dt),
                       f"vp_dequant_planes {what} grid {dt}")
            times[what] = (blocks, timer(lambda: launch(blocks, threads)))
        print(f"[kernel] vp_dequant_planes {list(m.shape)} {dt} grids: "
              + ", ".join(f"{k} {b} blocks {t:.4f} ms"
                          for k, (b, t) in times.items()))
        out[str(dt)] = times
    return out


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


def _norm_counts(cfg):
    """The `rms_norm` launches of one forward pass: ln1 and ln2 of each
    layer (rwkv6's also ln_x; a Mamba2 layer's ln and gated out_norm),
    q_norm and k_norm where the config has them, and the final norm."""
    from repro_torch.models.model import layer_plan

    per = {"rwkv": 3, "mamba": 2}
    return {"rms_norm": 1 + sum(
        per.get(spec.pattern, 2 + 2 * bool(cfg.qk_norm))
        for spec in layer_plan(cfg))}


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
                   _qp(2 * L, "kv"), _attention_counts(torch, cfg, True),
                   _norm_counts(cfg))
    decode = _add(_dqmm_counts(torch, cfg, BATCH), head,
                  _qp(2 * L, "kv"), _attention_counts(torch, cfg, False),
                  _norm_counts(cfg))
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
                   _attention_counts(torch, cfg, True), _norm_counts(cfg))
    decode = _add(matmuls(batch), _qp(2 * L, "kv"),
                  _attention_counts(torch, cfg, False), _norm_counts(cfg))
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
                  chunk=None, f64_attention=False, max_len=ENGINE_CAP):
    """Per request, max|engine logit - plain logit| / max|plain logit| over
    its steps, the plain path (`_plain_logits` at B = 1, `max_len` (the
    engine's capacity), the prompt whole or in chunks of `chunk`) teacher-forced
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
        want = torch.cat(_plain_logits(*args, max_len=max_len, chunk=chunk))
        got = torch.from_numpy(np.concatenate(
            logits[rec["rid"]])[:len(toks)]).cuda()
        rels.append(rel(got, want))
        if i < floor:
            floors.append(rel(torch.cat(_plain_logits(
                *args, f64_matmul=True, f64_attention=f64_attention,
                max_len=max_len, chunk=chunk)), want))
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
    record["engine_tokens"] = {r["rid"]: r["tokens"] for r in recs}
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


# ---------------------------------------------------------------------------
# 4c. the rest of the dense path: qwen2, gemma3, stablelm
# ---------------------------------------------------------------------------

def _dense_cfg(arch, quant, layers=None):
    from repro_torch.configs import registry

    cfg = registry.get_config(arch, quant)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _dense_check(torch, tag, cfg, params, prompts, tokens, logits,
                 requantizes=False):
    """The kernel path's logits against the plain path teacher-forced on
    its tokens, held as `_serve` holds them: bf16 to max(REL_LIMIT,
    FLOOR_MARGIN x the plain path's f64-summed floor), f32 to
    F32_REL_LIMIT (or that margin over the f32 floor where the path
    requantizes activations).  `requantizes` also sums the floor run's
    attention in f64: the vp_block path, and the planes weights, whose
    plain matmul (a torch matmul on both paths) `_f64_matmuls` does not
    reach."""
    max_len = prompts.shape[1] + tokens.shape[1]
    plain = _plain_logits(torch, cfg, params, prompts, tokens,
                          max_len=max_len)
    rels, agree = _rel_diffs(torch, logits, plain)
    floor, _ = _rel_diffs(torch, _plain_logits(
        torch, cfg, params, prompts, tokens, f64_matmul=True,
        f64_attention=requantizes, max_len=max_len), plain)
    if cfg.dtype == "bfloat16":
        limit = max(REL_LIMIT, FLOOR_MARGIN * max(floor))
    else:
        limit = max(F32_REL_LIMIT, FLOOR_MARGIN * max(floor)) \
            if requantizes else F32_REL_LIMIT
    print(f"{tag} {cfg.dtype} kernel vs plain, teacher-forced, per step: "
          + " ".join(f"{r:.2e}" for r in rels) + f"; max {max(rels):.3e}, "
          f"plain-path floor {max(floor):.3e}, limit {limit:.3e}, "
          f"greedy-token agreement {agree:.4f}")
    if max(rels) > limit:
        raise AssertionError(f"{tag} {cfg.dtype} kernel path differs from "
                             f"the plain path by {max(rels):.3e} > "
                             f"{limit:.3e}")
    return dict(rel_logit_diff=rels, plain_floor=floor, limit=limit,
                token_agreement=agree)


def _dense_static(torch, tag, cfg, B, S, steps, layout="packed",
                  requantizes=False):
    """Serve `cfg` on the static path: random weights from seed 0,
    export, prefill B x S prompt tokens (numpy seed 0), `steps` greedy
    decode steps; launch counts, timings and peak memory of that run,
    then its logits against the plain path (`_dense_check`)."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.launch.serve import run_static
    from repro_torch.models.layers import weight_bytes
    from repro_torch.models.model import init_params, quantize_params

    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)).astype(np.int64)).cuda()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    # -- the main path: export, prefill, decode --------------------------------
    t0 = time.perf_counter()
    qp = quantize_params(init_params(cfg, seed=0, device="cuda"), cfg,
                         layout=layout)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    report = {}
    tokens, logits = run_static(qp, cfg, prompts, steps, report)
    counts = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # -------------------------------------------------------------------------
    print(f"{tag} {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, {layout} weights "
          f"{weight_bytes(qp) / 1e9:.3f} GB; init + export {export_s:.3f}s, "
          f"prefill {B}x{S} {report['prefill_s']:.4f}s, decode {steps} steps "
          f"{report['decode_s']:.4f}s ({report['decode_s'] / steps * 1e3:.3f}"
          f" ms/step, {report['tokens_per_s']:.1f} tok/s), peak memory "
          f"{peak / 1e9:.3f} GB")
    print(f"{tag} launches: {counts}")
    for lg in logits:
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{tag} non-finite logits")
    check = _dense_check(torch, tag, cfg, qp, prompts, tokens, logits,
                         requantizes)
    return dict(report, export_s=export_s, peak_bytes=peak,
                weight_bytes=weight_bytes(qp), launches=counts,
                **check), qp


def _dense_cli(torch, tag, argv, requantizes=False, passes=None):
    """One run of the serve CLI (`launch.serve.main`): its launch counts,
    report and peak memory, and its own model, prompts, tokens and
    logits (taken from the `run_static` call the CLI makes), those
    logits against the plain path.  With `passes` ({"prefill": counts,
    "decode step": counts}), a profile of one prefill and one decode step
    of that model first (hand kernels only, those counts of each; no
    library GEMM or attention kernel).  Returns (result, the CLI's
    exported params, its config)."""
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    run, seen = serve.run_static, {}

    def held(params, cfg, prompts, gen, *args, **kw):
        tokens, logits = run(params, cfg, prompts, gen, *args, **kw)
        seen.update(params=params, cfg=cfg, prompts=prompts, tokens=tokens,
                    logits=logits)
        return tokens, logits

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    serve.run_static = held
    try:
        # -- the main path: the serve CLI -----------------------------------
        report = serve.main(argv)
        counts = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        # -------------------------------------------------------------------
    finally:
        serve.run_static = run
    qp, cfg, prompts, tokens, logits = (seen[k] for k in (
        "params", "cfg", "prompts", "tokens", "logits"))
    B, S, steps = report["batch"], report["prompt_len"], report["gen"]
    print(f"{tag} serve {' '.join(argv)}: export {report['export_s']:.3f}s, "
          f"prefill {B}x{S} {report['prefill_s']:.4f}s, decode {steps} steps "
          f"{report['decode_s']:.4f}s ({report['decode_s'] / steps * 1e3:.3f}"
          f" ms/step, {report['tokens_per_s']:.1f} tok/s), weights "
          f"{report['weight_bytes'] / 1e9:.3f} GB, peak memory "
          f"{peak / 1e9:.3f} GB")
    print(f"{tag} launches: {counts}")
    if tokens.tolist() != report["tokens"]:
        raise AssertionError(f"{tag} the report's tokens are not the run's")
    profiled = None
    if passes is not None:
        from repro_torch.models.model import decode_step, init_cache, prefill

        empty, caches = init_cache(cfg, B, S + steps), {}

        def prefill_once():
            caches["after"] = prefill(qp, prompts, empty, cfg)[1]

        names, profiled = _profile_kernels(torch, [
            ("prefill", prefill_once, passes["prefill"]),
            ("decode step", lambda: decode_step(qp, tokens[:, :1],
                                                caches["after"], cfg),
             passes["decode step"])])
        library = sorted({n for n in names if LIBRARY_KERNELS.search(n)
                          and not any(v in n for v in KERNEL_NAMES.values())})
        if library:
            raise AssertionError(f"{tag} library kernels on the path: "
                                 f"{library}")
        print(f"{tag} profiled: {len(names)} device kernels in one prefill "
              f"+ one decode step, hand kernels {profiled}; no library GEMM "
              "or attention kernel")
    check = _dense_check(torch, tag, cfg, qp, prompts, tokens, logits,
                         requantizes)
    return dict(report, peak_bytes=peak, launches=counts, profiled=profiled,
                **check), qp, cfg


def _dense_shapes(torch, tag, cfg, params, B, S, record):
    """The kernels of one dense run at the shapes its config gives them,
    each against its plain version on the same inputs (bf16, numpy seed
    0): `qdot` of the run's own layer-0 weights (attention, and the MLP
    where the layer has one) at decode M = B and prefill M = B * S, and
    of its lm_head at M = B (packed words:
    `vp_dequant_matmul` within BF16_TOL; planes: the planes dequant, then
    the same torch matmul; vp_block: `vp_block_quant`, then
    `block_vp_matmul`; these two bit for bit); the KV write
    (`vp_quant_scaled`) of a decode step (B, 1, KV, dh) and of the prompt
    (B, S, KV, dh) in int16 (M 7) and int8 (M 6) words, bit for bit; with
    planes weights, the planes export (`vp_quant_planes`) of every
    distinct layer-0 weight shape and lm_head's, bit for bit."""
    import dataclasses as dc

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.attention import quantize_kv
    from repro_torch.models.layers import qdot, quantize_weight

    rng = np.random.default_rng(0)
    q, dt = cfg.quant, torch.bfloat16
    KV, dh = cfg.n_kv_heads, cfg.head_dim

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", dt)

    layer = params["layers"][0]
    weights = {**{k: w for k, w in layer["attn"].items()
                  if isinstance(w, dict)},
               **layer.get("mlp", {}), "lm_head": params["lm_head"]}
    cases = []   # (what, fn, input, exact)
    for name, w in weights.items():
        kind = ("block" if "i_blk" in w else "planes" if "i_packed" in w
                else "packed")
        d_in = w["m" if kind != "packed" else "w_packed"].shape[0]
        for M in sorted({B} if name == "lm_head" else {B, B * S}):
            cases.append((f"{kind} {name} ({d_in} in) at M {M}",
                          lambda x, w=w: qdot(x, w, q), randn(M, d_in),
                          kind != "packed"))
    for M in (7, 6):
        qm = dc.replace(q, M=M, E=2)
        for shape in ((B, 1, KV, dh), (B, S, KV, dh)):
            cases.append((f"KV write {shape} M {M}",
                          lambda x, qm=qm: quantize_kv(x, qm), randn(*shape),
                          True))
    if any("i_packed" in w for w in weights.values()):
        shapes = {tuple(w["m"].shape) for w in weights.values()}
        for shape in sorted(shapes):
            cases.append((f"planes export {shape}",
                          lambda x: quantize_weight(x, q, "planes"),
                          randn(*shape), True))
    worst = 0.0
    for what, fn, x, exact in cases:
        got = fn(x)
        with ops.force_backend("ref"):
            want = fn(x)
        if exact:
            got, want = ((t,) if torch.is_tensor(t) else
                         tuple(t.values()) if isinstance(t, dict) else t
                         for t in (got, want))
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{tag} {what}: kernel differs from its "
                                     "plain version")
        else:
            worst = max(worst, compare(torch, got, want, BF16_TOL,
                                       f"{tag} {what}")[1])
        del got, want
    n_tol = sum(1 for c in cases if not c[3])
    print(f"{tag} shapes: {len(cases) - n_tol} bit-identical to their plain "
          f"versions, {n_tol} packed matmuls within BF16_TOL (max rel "
          f"{worst:.3e}): " + "; ".join(c[0] for c in cases))
    record.setdefault("dense_shapes", {})[tag] = dict(
        cases=[c[0] for c in cases], packed_max_rel=worst)


def _exact(tag, counts, expect):
    if counts != expect:
        raise AssertionError(f"{tag} launch counts {counts} != expected "
                             f"{expect}")


def _need(tag, counts, want):
    """Each kernel (counter) of `want` ran at least that many times."""
    short = {k: (counts.get(k, 0), n) for k, n in want.items()
             if counts.get(k, 0) < n}
    if short:
        raise AssertionError(f"{tag} kernels that ran fewer times than the "
                             f"path needs (ran, need): {short}")


def _no_cuda_core_prefill(tag, counts):
    """A bf16 run's prefill went through the tensor-core body alone."""
    if counts.get("flash_cuda_core", 0):
        raise AssertionError(f"{tag}: {counts['flash_cuda_core']} bf16 "
                             "prefill launches on the CUDA-core body")


def _dense_kernel_rows(torch, peaks, record, rows):
    """The kernels at the new configs' shapes, timed as phase 3 times
    them (median of 20, L2 flushed) beside their bound, their plain
    version and SDPA, each held against its plain version: decode
    attention at qwen2's (B 4, smax 160, KV 2, G 7, dh 64) in int8 words
    (G split over 2 slices: bit-identical to the rows launched as G 4 and
    G 3) and int16, gemma3's local ring (B 2, smax 1024 rolling, KV 16, G
    2, dh 168) in int8 (8-byte lanes) and int16, stablelm's (B 4, smax
    160, KV 8, G 4, dh 160); the prefill at gemma3's (B 2, S 1152, H 32,
    KV 16, dh 168) causal and local 1024 and stablelm's (B 4, S 128, H
    32, KV 8, dh 160), planned on the tensor-core body, which must beat
    its plain version and the CUDA-core body (timed beside it), bit-
    identical across launches and to a pre-scaled q, its SASS counts
    printed; `vp_dequant_matmul` at each family's w_up (qwen2 896 x
    4864, stablelm 5120 x 13824, gemma3 5376 x 21504) at decode M = B
    (skinny body) and prefill M = B x S (tensor-core body), within
    BF16_TOL, beside `torch.matmul` on the dequantized weight; the planes
    dequant at qwen2's w_down panel (4864, 896) in int8 and int16
    significands, bit for bit, timed beside m.to(bf16)."""
    import torch.nn.functional as F

    from repro_torch.core.formats import FXPFormat, default_vp_format
    from repro_torch.core.packing import dequant_words
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.vp_attention import (
        flash_body, flash_prefill_cuda, plan_decode)
    from repro_torch.kernels.vp_dequant_matmul import fwd_body

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    timer = Timer(torch)
    fxp = FXPFormat(12, 11)
    fmts = {2: default_vp_format(fxp, 7, 2), 1: default_vp_format(fxp, 6, 2)}
    by_name = {r["name"]: r for r in rows}
    out = []

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def add(name, entry):
        by_name[name].setdefault("dense_shapes", []).append(entry)
        out.append(dict(entry, name=name))

    # -- decode attention ---------------------------------------------------
    scales = torch.tensor([2.0 ** -3, 2.0 ** -2, 0.5, 1.0, 2.0],
                          device="cuda")
    for B, smax, KV, G, dh, lens, window, rolling, w_bytes in (
            (4, 160, 2, 7, 64, [160, 150, 129, 100], None, False, 1),
            (4, 160, 2, 7, 64, [160, 150, 129, 100], None, False, 2),
            (2, 1024, 16, 2, 168, [1168, 1100], 1024, True, 1),
            (2, 1024, 16, 2, 168, [1168, 1100], 1024, True, 2),
            (4, 160, 8, 4, 160, [160, 150, 129, 100], None, False, 2)):
        vp, H = fmts[w_bytes], KV * G
        k_w, v_w = (ops.vp_quant((randn(B, smax, KV, dh) * 0.3).clamp(
            -0.99, 0.99), fxp, vp, packed=True) for _ in range(2))
        k_s, v_s = (scales[torch.randint(0, 5, (B, smax, 1, 1), generator=gen,
                                         device="cuda")] for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = randn(B, 1, H, dh)
        args = (k_w, v_w, k_s, v_s, lengths, vp, window, rolling)
        plan = plan_decode(KV, smax, G, dh, w_bytes)
        what = f"vp_decode_attention {[B, smax, KV, G, dh]} int{8 * w_bytes}"
        got = ops.vp_decode_attention(q, *args)
        err, rel = compare(torch, got, ref.vp_decode_attention_ref(q, *args),
                           F32_RTOL, what)
        qb = q.to(torch.bfloat16)
        compare(torch, ops.vp_decode_attention(qb, *args),
                ref.vp_decode_attention_ref(qb, *args), BF16_TOL,
                f"{what} bf16")
        _identical(torch, ops.vp_decode_attention(q, *args), got,
                   f"{what}, two launches")
        if plan.slices > 1:   # each row's bits, sliced or launched alone
            rows4 = q.reshape(B, 1, KV, G, dh)
            parts = []
            for lo, hi in ((0, 4), (4, G)):
                sub = rows4[:, :, :, lo:hi].reshape(B, 1, KV * (hi - lo), dh)
                parts.append(ops.vp_decode_attention(
                    sub.contiguous(), *args).reshape(B, 1, KV, hi - lo, dh))
            _identical(torch, torch.cat(parts, 3).reshape(B, 1, H, dh), got,
                       f"{what}: the G slices against G 4 and G 3 launches")
        ms = timer(lambda: ops.vp_decode_attention(q, *args))
        plain_ms = timer(lambda: ref.vp_decode_attention_ref(q, *args))
        kd, vd = ((dequant_words(w, vp, torch.float32) * s)
                  .repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
                  for w, s in ((k_w, k_s), (v_w, v_s)))
        pos = torch.arange(smax, device="cuda")[None, :]
        ln = lengths.to(torch.int64)[:, None]
        mask = (pos < (ln.clamp(max=smax) if rolling else ln))[:, None, None]
        qt = q.transpose(1, 2)
        library_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, kd, vd, attn_mask=mask))
        valid = sum(min(n, smax) for n in lens)
        bnd = bound(peaks, valid * KV * dh * w_bytes * 2 + valid * 2 * 4
                    + 2 * B * H * dh * 4, 4 * valid * KV * G * dh, "f32")
        shape = [B, smax, KV, G, dh, f"int{8 * w_bytes}",
                 "rolling" if rolling else "full"]
        _print_line("vp_decode_attention", shape, err, rel, ms, plain_ms, bnd,
                    library_ms)
        print(f"[dense kernel] {what}: {plan}")
        add("vp_decode_attention", dict(
            shape=shape, plan=dataclasses.asdict(plan), ms=ms,
            plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
            library_ms=library_ms, max_abs_err=err))

    # -- the tensor-core prefill body at dh 168 and 160 -----------------------
    sass = {int(k.rsplit(" ", 1)[-1]): v for k, v in
            record["attention_sass"].items() if k.startswith("prefill tc")}
    for B, S, H, KV, dh, window in ((2, 1152, 32, 16, 168, None),
                                    (2, 1152, 32, 16, 168, 1024),
                                    (4, 128, 32, 8, 160, None)):
        G = H // KV
        if flash_body(torch.bfloat16, dh) != "tensor_core":
            raise AssertionError(f"bf16 dh {dh} not planned on the tensor "
                                 "cores")
        qd, kd, vd = (randn(B, S, n, dh, dtype=torch.bfloat16)
                      for n in (H, KV, KV))
        pattern = "local" if window else "causal"
        what = f"flash_prefill {[B, S, H, KV, dh, pattern]}"
        scale = torch.tensor(dh ** -0.5, dtype=torch.bfloat16, device="cuda")
        got = ops.flash_prefill(qd, kd, vd, pattern, window)
        err, rel = compare(torch, got, ref.flash_prefill_ref(
            qd, kd, vd, pattern, window), BF16_TOL, what)
        _identical(torch, ops.flash_prefill(qd, kd, vd, pattern, window), got,
                   f"{what}, two launches")
        _identical(torch, flash_prefill_cuda(qd * scale, kd, vd, True, window,
                                             1.0, body="tensor_core"), got,
                   f"{what}, folded scale")
        compare(torch, flash_prefill_cuda(qd, kd, vd, True, window,
                                          float(scale), body="cuda_core"),
                ref.flash_prefill_ref(qd, kd, vd, pattern, window), BF16_TOL,
                f"{what} CUDA-core body")
        ms = timer(lambda: ops.flash_prefill(qd, kd, vd, pattern, window))
        cc_ms = timer(lambda: flash_prefill_cuda(
            qd, kd, vd, True, window, float(scale), body="cuda_core"))
        plain_ms = timer(lambda: ref.flash_prefill_ref(qd, kd, vd, pattern,
                                                       window))
        qt = qd.transpose(1, 2)
        kt, vt = (t.repeat_interleave(G, dim=2).transpose(1, 2)
                  for t in (kd, vd))
        qpos = torch.arange(S, device="cuda")[:, None]
        kpos = torch.arange(S, device="cuda")[None, :]
        band = kpos <= qpos
        if window:
            band &= qpos - kpos < window
            library_ms = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band))
        else:
            library_ms = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
        bnd = bound(peaks, 2 * (2 * B * S * H * dh + 2 * B * S * KV * dh),
                    4 * B * H * dh * int(band.sum()), "bf16")
        shape = [B, S, H, KV, dh, pattern]
        _print_line("flash_prefill", shape, err, rel, ms, plain_ms, bnd,
                    library_ms)
        print(f"[dense kernel] {what}: tensor-core body {ms:.4f} ms "
              f"({ms / library_ms:.2f}x SDPA, {plain_ms / ms:.1f}x faster "
              f"than plain), CUDA-core body {cc_ms:.4f} ms; dh {dh} SASS "
              f"LDL {sass[dh]['LDL']}, STL {sass[dh]['STL']}, HMMA "
              f"{sass[dh]['HMMA']}")
        if not ms < min(plain_ms, cc_ms):
            raise AssertionError(f"{what}: the tensor-core body ({ms:.4f} "
                                 f"ms) is not faster than plain "
                                 f"({plain_ms:.4f}) and the CUDA-core body "
                                 f"({cc_ms:.4f})")
        add("flash_prefill", dict(shape=shape, body="tensor_core", ms=ms,
                                  cuda_core_ms=cc_ms, plain_ms=plain_ms,
                                  bound_ms=bnd[0], bound_by=bnd[1],
                                  library_ms=library_ms, max_abs_err=err,
                                  ldl=sass[dh]["LDL"], stl=sass[dh]["STL"]))

    # -- vp_dequant_matmul at each family's w_up: decode and prefill M ------
    for family, B, S, K, N in (("qwen2", 4, 128, 896, 4864),
                               ("stablelm", 4, 128, 5120, 13824),
                               ("gemma3", 2, 1152, 5376, 21504)):
        vp = fmts[2]
        w = ops.vp_quant((randn(K, N) * 0.3).clamp(-0.99, 0.99), fxp, vp,
                         packed=True)
        w_deq = dequant_words(w, vp).to(torch.bfloat16)
        for M in (B, B * S):
            x = randn(M, K, dtype=torch.bfloat16)
            body = fwd_body(M, torch.bfloat16, vp)
            what = f"vp_dequant_matmul {family} w_up {[M, K, N]}"
            err, rel = compare(torch, ops.vp_dequant_matmul(x, w, vp),
                               ref.vp_dequant_matmul_ref(x, w, vp,
                                                         torch.bfloat16),
                               BF16_TOL, what)
            ms = timer(lambda: ops.vp_dequant_matmul(x, w, vp))
            plain_ms = timer(lambda: ref.vp_dequant_matmul_ref(
                x, w, vp, torch.bfloat16))
            library_ms = timer(lambda: torch.matmul(x, w_deq))
            bnd = bound(peaks, 2 * (M * K + K * N + M * N), 2 * M * K * N,
                        "bf16")
            _print_line("vp_dequant_matmul", [M, K, N], err, rel, ms,
                        plain_ms, bnd, library_ms)
            print(f"[dense kernel] {what}: {body} body, {bnd[0] / ms:.1%} of "
                  f"the bound, {ms / library_ms:.2f}x torch.matmul")
            add("vp_dequant_matmul", dict(
                shape=[M, K, N], family=family, body=body, ms=ms,
                plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=library_ms, max_abs_err=err))
        del w, w_deq

    # -- the planes dequant at a weight panel, int8 and int16 significands ---
    K, N = 4864, 896
    for vp in (fmts[2], default_vp_format(fxp, 10, 2)):
        m, i = ops.vp_quant((randn(K, N) * 0.3).clamp(-0.99, 0.99), fxp, vp)
        kind = {torch.int8: "int8", torch.int16: "int16"}[m.dtype]
        for dtype in (torch.float32, torch.bfloat16):
            got = ops.vp_dequant(m, i, vp, dtype)
            _identical(torch, got, ref.vp_dequant_ref(m, i, vp, dtype),
                       f"vp_dequant planes {(K, N)} {kind} {dtype}")
        ms = timer(lambda: ops.vp_dequant(m, i, vp, torch.bfloat16))
        plain_ms = timer(lambda: ref.vp_dequant_ref(m, i, vp,
                                                    torch.bfloat16))
        cast_ms = timer(lambda: m.to(torch.bfloat16))   # a yardstick
        bnd = bound(peaks, K * N * (m.element_size() + 1 + 2), 0, "bf16")
        shape = [K, N, f"{kind} + uint8 -> bf16"]
        _print_line("vp_dequant_planes", shape, 0.0, 0.0, ms, plain_ms, bnd,
                    None)
        print(f"[dense kernel] vp_dequant_planes {shape}: {ms:.4f} ms, "
              f"{bnd[0] / ms:.1%} of the bound (aim >= 50 %; the first "
              f"design, int8: 0.0246 ms); m.to(bf16) {cast_ms:.4f} ms")
        add("vp_dequant_planes", dict(shape=shape, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bnd[0], bound_by=bnd[1],
                                      library_ms=None, cast_ms=cast_ms,
                                      max_abs_err=0.0))
    record["dense_kernels"] = out


def dense_phase(torch, record, rows, smi, peaks):
    """The rest of the dense path in bf16, random weights from seed 0,
    each run's logits teacher-forced against its plain path at the serve
    limits (bf16: max(REL_LIMIT, FLOOR_MARGIN x the plain path's f64
    floor); f32: F32_REL_LIMIT):

    - qwen2-0.5b (QKV bias, G = 7) at full width and depth through the
      serve CLI: `--quant vp --kv-quant`, batch 4, prompt 128, 32 steps
      (exact launch counts), and f32 the same way; then short CLI runs
      (batch 4, prompt 16, 2 steps): `--quant vp_block` (only w_down
      tiles at 256: 24 block weights, 146 packed), `--layout planes` (the
      planes quantizer at export, the planes dequant on every weight),
      `--M 6 --E 2 --kv-quant` (int8 weight and KV words; decode
      attention at G = 7 on the G-split body) and `--layout planes
      --kv-layout planes --M 10 --E 2 --kv-quant` (int16 significands);
    - gemma3-27b at full width over 7 layers (one period of 5 local + 1
      global, then a local tail: both scanned groups): batch 2, prompt
      1152 (past the 1024-token window: the band mask in prefill, the
      ring in decode), 16 steps; prefill on the tensor-core body at dh
      168, no CUDA-core prefill launch;
      then the engine with global layers paged and local layers on dense
      rings, run-ahead 4 and 1 (the same tokens), every graph's first
      replay bit-identical to its eager step, logits against plain;
    - stablelm-12b at full width over 4 layers: batch 4, prompt 128, 8
      steps, prefill on the tensor-core body at dh 160;
    - after each bf16 run but the engine's, its kernels at its own shapes
      against their plain versions (`_dense_shapes`);
    - the kernels at these shapes, timed (`_dense_kernel_rows`)."""
    from repro_torch import tree
    from repro_torch.configs.base import QuantConfig
    from repro_torch.models.model import layer_plan

    tag = "[dense]"
    laps, t_lap = {}, [time.perf_counter()]
    launches = collections.Counter()

    def lap(what):
        now = time.perf_counter()
        laps[what] = now - t_lap[0]
        t_lap[0] = now
        print(f"[time] dense {what}: {laps[what]:.2f}s")

    out = {}
    vp_kv = QuantConfig(mode="vp", quantize_kv_cache=True)

    # -- qwen2-0.5b, full width and depth, through the CLI ----------------------
    arch = "qwen2-0.5b"
    cfg = _dense_cfg(arch, vp_kv)
    L = cfg.n_layers
    if (cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, cfg.qkv_bias) != (
            7, 64, True):
        raise AssertionError(f"{arch}: {cfg}")
    head = {"vp_dequant_matmul": 1, "vp_dqmm_skinny": 1}
    prefill = _add(_dqmm_counts(torch, cfg, BATCH * PROMPT), head,
                   _qp(2 * L, "kv"), _attention_counts(torch, cfg, True),
                   _norm_counts(cfg))
    decode = _add(_dqmm_counts(torch, cfg, BATCH), head, _qp(2 * L, "kv"),
                  _attention_counts(torch, cfg, False), _norm_counts(cfg))
    expect = _add(prefill, *[decode] * GEN, _qp(7 * L + 2, "table"))
    argv = ["--arch", arch, "--quant", "vp", "--kv-quant", "--batch",
            str(BATCH), "--prompt-len", str(PROMPT), "--gen", str(GEN)]
    res, qp, _ = _dense_cli(torch, f"{tag} {arch}", argv,
                            passes={"prefill": prefill, "decode step": decode})
    _exact(f"{tag} {arch}", res["launches"], expect)
    launches.update(res["launches"])
    out[arch] = res
    _dense_shapes(torch, f"{tag} {arch}", cfg, qp, BATCH, PROMPT, record)
    del qp
    lap(f"{arch} vp, full depth")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    out[f"{arch} f32"], _ = _dense_static(torch, f"{tag} {arch} f32", cfg32,
                                          BATCH, PROMPT, GEN)
    launches.update(out[f"{arch} f32"]["launches"])
    lap(f"{arch} f32")

    short = ["--batch", str(BATCH), "--prompt-len", "16", "--gen", "2"]
    for what, extra, need, requant in (
            ("vp_block", ["--quant", "vp_block", "--kv-quant"],
             {"block_vp_matmul": 3 * L, "vp_block_quant": 3 * L + L,
              "vp_dequant_matmul": 3 * 6 * L + 3}, True),
            ("planes", ["--quant", "vp", "--kv-quant", "--layout", "planes"],
             {"vp_quant_planes": 7 * L + 2,
              "vp_dequant_planes": 3 * (7 * L + 1) + 3}, True),
            ("M6 E2", ["--quant", "vp", "--kv-quant", "--M", "6", "--E", "2"],
             {"vp_decode_attention": 2 * L,
              "vp_dequant_matmul": 3 * (7 * L + 1)}, False),
            ("M10 E2 planes", ["--quant", "vp", "--kv-quant", "--layout",
                               "planes", "--kv-layout", "planes", "--M",
                               "10", "--E", "2"],
             {"vp_quant_planes": 7 * L + 2 + 3 * 2 * L,   # export, KV writes
              "vp_dequant_planes": 3 * (7 * L + 1) + 3 + 2 * 2 * L}, True)):
        res, qp, c = _dense_cli(torch, f"{tag} {arch} {what}",
                                ["--arch", arch, *extra, *short], requant)
        _need(f"{tag} {arch} {what}", res["launches"], need)
        if what == "vp_block":
            kinds = collections.Counter(
                {"i_blk": "block", "w_packed": "packed"}[path.rsplit("/")[-1]]
                for path, _ in tree.tree_paths(qp)
                if path.endswith(("/i_blk", "/w_packed")))
            print(f"{tag} {arch} vp_block at {BLOCK}: {dict(kinds)} weights")
            if kinds != {"block": L, "packed": 6 * L + 2}:
                raise AssertionError(f"{tag} vp_block weights {kinds}")
        if what == "M6 E2":
            w = qp["layers"][0]["attn"]["wq"]["w_packed"]
            if w.dtype != torch.int8:
                raise AssertionError(f"{tag} M6 E2 words are {w.dtype}")
        if what == "M10 E2 planes":   # int16 significands on the card
            m = qp["layers"][0]["attn"]["wq"]["m"]
            if m.dtype != torch.int16 or res["launches"].get(
                    "vp_dequant_matmul", 0):
                raise AssertionError(f"{tag} M10 planes are {m.dtype}, "
                                     f"launches {res['launches']}")
        launches.update(res["launches"])
        out[f"{arch} {what}"] = res
        _dense_shapes(torch, f"{tag} {arch} {what}", c, qp, BATCH, 16, record)
        del qp
    lap(f"{arch} short runs (vp_block, planes, M6 E2, M10 E2 planes)")

    # -- gemma3-27b at full width, 7 layers ------------------------------------
    arch = "gemma3-27b"
    cfg = _dense_cfg(arch, vp_kv, layers=GEMMA_LAYERS)
    pats = [s.pattern for s in layer_plan(cfg)]
    if pats != ["local"] * 5 + ["global", "local"] or cfg.head_dim != 168:
        raise AssertionError(f"{arch}: layers {pats}, dh {cfg.head_dim}")
    B, S, steps = GEMMA_SERVE
    res, qp = _dense_static(torch, f"{tag} {arch} ({GEMMA_LAYERS} layers)",
                            cfg, B, S, steps)
    _need(f"{tag} {arch}", res["launches"], {
        "flash_tc": GEMMA_LAYERS, "vp_dec_split": GEMMA_LAYERS * steps,
        "vp_dequant_matmul": (7 * GEMMA_LAYERS + 1) * (steps + 1)})
    _no_cuda_core_prefill(f"{tag} {arch}", res["launches"])
    print(f"{tag} {arch} prefill {B}x{S}: {res['prefill_s']:.4f}s on the "
          f"tensor-core body (PR 24, on the CUDA-core body: 0.1253 s)")
    launches.update(res["launches"])
    out[arch] = res
    _dense_shapes(torch, f"{tag} {arch}", cfg, qp, B, S, record)
    lap(f"{arch} static")
    out[f"{arch} engine"] = _dense_engine(torch, tag, cfg, qp, launches)
    del qp
    lap(f"{arch} engine")

    # -- stablelm-12b at full width, 4 layers -----------------------------------
    arch = "stablelm-12b"
    cfg = _dense_cfg(arch, vp_kv, layers=STABLELM_LAYERS)
    B, S, steps = STABLELM_SERVE
    res, qp = _dense_static(torch, f"{tag} {arch} ({STABLELM_LAYERS} layers)",
                            cfg, B, S, steps)
    _need(f"{tag} {arch}", res["launches"], {
        "flash_tc": STABLELM_LAYERS, "vp_dec_split": STABLELM_LAYERS * steps})
    _no_cuda_core_prefill(f"{tag} {arch}", res["launches"])
    launches.update(res["launches"])
    out[arch] = res
    _dense_shapes(torch, f"{tag} {arch}", cfg, qp, B, S, record)
    del qp
    lap(f"{arch} static")

    _dense_kernel_rows(torch, peaks, record, rows)
    lap("kernel rows")
    for row in rows:
        if launches.get(row["name"]):
            row["dense_launches"] = launches[row["name"]]
    record["dense"] = dict(out, launches=dict(launches), laps=laps)
    print(f"{tag} launches over the phase's runs: {dict(launches)}; {smi}")


def _dense_engine(torch, tag, cfg, params, launches):
    """gemma3 through the engine: GEMMA_ENGINE_REQS requests (numpy seed
    0), global layers PAGED, local layers DENSE rings; run-ahead 4, then
    1 (the same tokens); each graph's first replay bit-identical to its
    eager step; every request's logits against the plain path."""
    import numpy as np

    from repro_torch.serving.page_cache import DENSE, PAGED

    n, (lo, hi), (g_lo, g_hi) = GEMMA_ENGINE_REQS
    rng = np.random.default_rng(0)
    reqs = [([int(t) for t in rng.integers(0, cfg.vocab, int(s))], int(g))
            for s, g in zip(rng.integers(lo, hi + 1, n),
                            rng.integers(g_lo, g_hi + 1, n))]
    kw = dict(max_slots=GEMMA_ENGINE_SLOTS, capacity=GEMMA_ENGINE_CAP,
              page_size=ENGINE_PAGE)
    logits, recs, waves = {}, [], []
    for ahead in ENGINE_LOOKAHEAD:
        eng = _engine(cfg, params, decode_lookahead=ahead, **kw)
        kinds = sorted({(s.pattern, s.kind, s.buf_len) for s in eng.kv.specs})
        if kinds != [("global", PAGED, GEMMA_ENGINE_CAP),
                     ("local", DENSE, cfg.local_window)]:
            raise AssertionError(f"{tag} engine cache plan {kinds}")
        torch.cuda.reset_peak_memory_stats()
        r, wall, calls, ran = _engine_wave(
            torch, eng, reqs, logits if ahead == ENGINE_LOOKAHEAD[0] else None)
        peak = torch.cuda.max_memory_allocated()
        _check_graph_log(eng.runner, f"{tag} gemma3 engine, run-ahead {ahead}:")
        launches.update(ran)
        recs.append(r)
        waves.append(dict(_decode_rates(r, calls), wall_s=wall,
                          peak_bytes=peak, kernels=_engine_counts(ran)))
        print(f"{tag} gemma3 engine, run-ahead {ahead}: {len(reqs)} requests "
              f"(prompts {[len(p) for p, _ in reqs]}, budgets "
              f"{[g for _, g in reqs]}) in {wall:.3f}s, "
              f"{waves[-1]['decode_ms_per_step']:.3f} ms per decode step "
              f"(graph captures and checks included), prefill and host "
              f"{wall - waves[-1]['decode_s']:.3f}s, peak memory "
              f"{peak / 1e9:.3f} GB; cache plan {kinds}; kernels that ran "
              f"{_engine_counts(ran)}")
        _need(f"{tag} gemma3 engine", ran, {"vp_decode_attention": 1,
                                            "flash_prefill": 1})
        del eng
    differ = [a["rid"] for a, b in zip(*recs) if a["tokens"] != b["tokens"]]
    if differ:
        raise AssertionError(f"{tag} gemma3 engine: run-ahead changed the "
                             f"tokens of requests {differ}")
    rels, floor = _engine_plain(torch, cfg, params, reqs, recs[0], logits,
                                floor=1, max_len=GEMMA_ENGINE_CAP)
    limit = max(REL_LIMIT, FLOOR_MARGIN * max(floor))
    print(f"{tag} gemma3 engine: tokens identical at run-ahead "
          f"{ENGINE_LOOKAHEAD}; bf16 vs plain per request "
          + " ".join(f"{x:.2e}" for x in rels) + f" (floor {floor[0]:.3e}, "
          f"limit {limit:.3e})")
    if max(rels) > limit:
        raise AssertionError(f"{tag} gemma3 engine logits differ from the "
                             f"plain path by {max(rels):.3e} > {limit:.3e}")
    return dict(requests=[(len(p), g) for p, g in reqs], waves=waves,
                rel_logit_diff=rels, plain_floor=floor, limit=limit)


# ---------------------------------------------------------------------------
# 3b. the formats of faults 7-9 (int32 words, int16 vp_block, E 5-7)
# ---------------------------------------------------------------------------

def wide_kernel_phase(torch, peaks, record):
    """Every kernel a wide format reaches, bit-identical to its plain
    version (float sums within tolerance) and timed: int32 packed words
    (VP(13, E 4), VP(16, E 1), VP(10, E 7)) through the quantizer, the
    packed dequant (4 words a 16-byte load) and decode attention at dh
    160 (stablelm, G 4) and 168 (gemma3's rolling ring, G 2) on 32-byte
    lanes; int16 block-VP significands (M 10 E 2, M 12 E 3) through
    `vp_block_quant` on every body and `block_vp_matmul`'s int16 body
    at blocks 16 and 256; E 5 and E 7 (32 and 128 exponents) through
    quantize (table and chain bodies), the KV mode, both dequants,
    `vp_dequant_matmul` (skinny, tensor-core, CUDA-core bodies) and
    decode.  Local memory counted in the new instances' SASS."""
    from repro_torch.core.formats import FXPFormat, default_vp_format
    from repro_torch.core.packing import storage_dtype
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.vp_attention import (plan_decode,
                                                  vp_decode_attention_cuda)
    from repro_torch.kernels.vp_block_matmul import block_vp_matmul_cuda
    from repro_torch.kernels.vp_block_quant import block_vp_quant_cuda
    from repro_torch.kernels.vp_dequant import (vp_dequant_packed_cuda,
                                                vp_dequant_planes_cuda)
    from repro_torch.kernels.vp_dequant_matmul import (fwd_body,
                                                       vp_dequant_matmul_cuda)
    from repro_torch.kernels.vp_quant import (vp_quant_packed_cuda,
                                              vp_quant_planes_cuda)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    timer = Timer(torch)
    fxp = FXPFormat(12, 11)
    f32, bf16 = torch.float32, torch.bfloat16
    fmts = {k: default_vp_format(fxp, M, E) for k, (M, E) in WIDE.items()}
    out = {"sass": {}, "rows": []}

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def line(name, shape, ms, plain_ms, bnd, err=0.0):
        print(f"[wide] {name} {shape}: max_abs_err {err:.3e} ms {ms:.4f} "
              f"plain_ms {plain_ms:.4f} bound_ms {bnd[0]:.4f} ({bnd[1]})")
        out["rows"].append(dict(name=name, shape=shape, ms=ms,
                                plain_ms=plain_ms, bound_ms=bnd[0],
                                bound_by=bnd[1], max_abs_err=err))

    # -- SASS: local memory in the instances this slice adds -----------------
    for lib, pat in (("vp_attention", r"split_kernelIiLi\d+ELi32E"),
                     ("vp_dequant", r"packed_kernelIi"),
                     ("vp_block_matmul", r"i16_kernel"),
                     ("vp_block_quant", r"."), ("vp_quant", r".")):
        counts = {op: _sass_counts(build._target(lib), build._nvcc(), op)
                  for op in ("LDL", "STL")}
        inst = {k: (counts["LDL"][k], counts["STL"][k])
                for k in counts["LDL"] if re.search(pat, k)}
        bad = {k: v for k, v in inst.items() if v != (0, 0)}
        print(f"[wide] {lib} SASS: {len(inst)} instances matching {pat!r}, "
              f"LDL/STL in {bad or 'none'}")
        if not inst or bad:
            raise AssertionError(f"{lib}: local memory or no instance: {bad}")
        out["sass"][lib] = len(inst)

    # -- quantize: table and chain bodies, planes, KV mode ----------------------
    R, C = DEQUANT_PACKED
    x = (randn(R, C) * 0.4).clamp(-0.999, 0.999)
    edge = torch.tensor([0.0, 2 ** -11, -2 ** -11, 0.999, -1.0, 2 ** -20,
                         1e-9, 0.5, -0.25, 2 ** -11 * 3], device="cuda")
    for key, vp in fmts.items():
        want = ref.vp_quant_packed_ref(x, fxp, vp)
        for body in ("table", "chain"):
            got = vp_quant_packed_cuda(x, fxp, vp, body=body)
            _identical(torch, got, want, f"vp_quant_packed {key} {body}")
            _identical(torch, vp_quant_packed_cuda(edge, fxp, vp, body=body),
                       ref.vp_quant_packed_ref(edge, fxp, vp),
                       f"vp_quant_packed {key} {body} edges")
        wb = torch.empty((), dtype=storage_dtype(vp)).element_size()
        ms = timer(lambda: vp_quant_packed_cuda(x, fxp, vp))
        pms = timer(lambda: ref.vp_quant_packed_ref(x, fxp, vp))
        line(f"vp_quant_packed {key} ({wb}-byte words)", (R, C), ms, pms,
             bound(peaks, R * C * (4 + wb), 0, "f32"))
        m, i = vp_quant_planes_cuda(x, fxp, vp)
        wm, wi = ref.vp_quant_ref(x, fxp, vp)
        _identical(torch, m, wm, f"vp_quant_planes {key} m")
        _identical(torch, i, wi, f"vp_quant_planes {key} i")
        kv = randn(4, 16, 8, 64, dtype=bf16)
        gw, gs = ops.vp_quant_scaled(kv, fxp, vp)
        ww, ws = ref.vp_quant_scaled_ref(kv, fxp, vp)
        _identical(torch, gw, ww, f"vp_quant_scaled {key} words")
        _identical(torch, gs, ws, f"vp_quant_scaled {key} scales")

        # -- both dequants --------------------------------------------------
        w = want
        for dt in (f32, bf16):
            got = vp_dequant_packed_cuda(w, vp, dt)
            _identical(torch, got, ref.vp_dequant_packed_ref(w, vp, dt),
                       f"vp_dequant_packed {key} {dt}")
            for lo, n in ((1, 1000), (3, 4099), (5, 7)):   # unaligned slices
                sl = w.reshape(-1)[lo:lo + n]
                _identical(torch, vp_dequant_packed_cuda(sl, vp, dt),
                           ref.vp_dequant_packed_ref(sl, vp, dt),
                           f"vp_dequant_packed {key} {dt} slice {lo}")
            _identical(torch, vp_dequant_planes_cuda(m, i, vp, dt),
                       ref.vp_dequant_ref(m, i, vp, dt),
                       f"vp_dequant_planes {key} {dt}")
        ms = timer(lambda: vp_dequant_packed_cuda(w, vp, bf16))
        pms = timer(lambda: ref.vp_dequant_packed_ref(w, vp, bf16))
        line(f"vp_dequant_packed {key} -> bf16", (R, C), ms, pms,
             bound(peaks, R * C * (wb + 2), 0, "f32"))

        # -- vp_dequant_matmul on every body its planner gives this format ----
        for M, K, N in ((4, 1024, 3072), (512, 1024, 1024), (33, 200, 72)):
            wk = vp_quant_packed_cuda((randn(K, N) * 0.3).clamp(-.99, .99),
                                      fxp, vp)
            for dt, tol in ((f32, F32_RTOL), (bf16, BF16_TOL)):
                xx = randn(M, K, dtype=dt)
                got = vp_dequant_matmul_cuda(xx, wk, vp, dt)
                err, _ = compare(torch, got, ref.vp_dequant_matmul_ref(
                    xx, wk, vp, out_dtype=dt), tol,
                    f"vp_dequant_matmul {key} {(M, K, N)} {dt} "
                    f"({fwd_body(M, dt, vp)})")
            if (M, K, N) == (4, 1024, 3072):
                xx = randn(M, K, dtype=bf16)
                ms = timer(lambda: vp_dequant_matmul_cuda(xx, wk, vp, bf16))
                pms = timer(lambda: ref.vp_dequant_matmul_ref(
                    xx, wk, vp, out_dtype=bf16))
                line(f"vp_dequant_matmul {key} "
                     f"{fwd_body(M, bf16, vp)}", (M, K, N), ms, pms,
                     bound(peaks, K * N * wb + M * (K + N) * 2,
                           2 * M * K * N, "bf16"), err)

    # -- decode attention: int32 rows at dh 160 / 168, E 5-7 at dh 64 ----------
    cases = [("M13E4", (4, 160, 8, 4, 160), [160, 150, 129, 100], None,
              False),
             ("M13E4", (2, 1024, 16, 2, 168), [1200, 700], 1024, True),
             ("M10E7", (2, 1024, 16, 2, 168), [1025, 1024], 1024, True),
             ("M16E1", (4, 160, 8, 4, 160), [1, 160, 77, 3], None, False),
             ("M13E4", (4, 160, 4, 8, 64), [160, 33, 1, 99], None, False),
             ("M13E4", (4, 160, 8, 6, 128), [160, 150, 129, 100], 64, False),
             ("M7E5", (4, 160, 8, 2, 64), [160, 150, 129, 100], None, False),
             ("M7E7", (4, 160, 8, 2, 64), [200, 170, 161, 300], 160, True)]
    for key, (B, L, KV, G, dh), lens, window, rolling in cases:
        vp = fmts[key]
        H = KV * G
        k_w, v_w = (vp_quant_packed_cuda(
            (randn(B, L, KV, dh) * 0.3).clamp(-.99, .99), fxp, vp)
            for _ in range(2))
        pick = torch.tensor([2.0 ** -3, 0.5, 1.0, 2.0], device="cuda")
        k_s, v_s = (pick[torch.randint(0, 4, (B, L, 1, 1), generator=gen,
                                       device="cuda")] for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        args = (k_w, v_w, k_s, v_s, lengths, vp, window, rolling)
        plan = plan_decode(KV, L, G, dh, k_w.element_size())
        tag = (f"vp_decode_attention {key} B{B} L{L} KV{KV} G{G} dh{dh} "
               f"{'rolling' if rolling else 'window' if window else 'full'}")
        q = randn(B, 1, H, dh)
        for dt, tol in ((f32, F32_RTOL), (bf16, BF16_TOL)):
            qd = q.to(dt)
            got = ops.vp_decode_attention(qd, *args)
            err, _ = compare(torch, got, ref.vp_decode_attention_ref(
                qd, *args), tol, f"{tag} {dt}")
            _identical(torch, ops.vp_decode_attention(qd, *args), got,
                       f"{tag} {dt}, two launches")
        pre = q.reshape(B, KV, G, dh) * dh ** -0.5
        one = vp_decode_attention_cuda(pre[:, :, :1].contiguous(), *args,
                                       scale=1.0)
        _identical(torch, one, vp_decode_attention_cuda(
            pre, *args, scale=1.0)[:, :, :1],
            f"{tag}: a row's bits independent of G")
        ms = timer(lambda: ops.vp_decode_attention(q, *args))
        pms = timer(lambda: ref.vp_decode_attention_ref(q, *args))
        valid = sum(min(n, L) - (max(n - window, 0) if window and not
                                 rolling else 0) for n in lens)
        line(f"{tag} ({plan.lane_bytes}-byte lanes, {plan.slices} slices)",
             (B, L, KV, G, dh), ms, pms,
             bound(peaks, valid * KV * dh * 2 * k_w.element_size()
                   + valid * 8 + 2 * B * H * dh * 4,
                   4 * valid * H * dh, "f32"), err)

    # -- int16 vp_block: the quantizer's bodies and the matmul's int16 body ----
    for key, (M_, E_) in BLOCK_WIDE.items():
        vp = default_vp_format(fxp, M_, E_)
        for (R, C), block, axis, body, dt in (
                ((4, 1024), 16, -1, "small", f32),
                ((4, 3072), 256, -1, "small", f32),
                ((512, 1024), 16, -1, "coop", f32),
                ((512, 3072), 256, -1, "two_pass", f32),
                ((1024, 3072), 16, 0, "general", bf16),
                ((1024, 3072), 256, 0, "coop", bf16),
                ((3072, 1024), 256, 0, "two_pass", bf16),
                ((64, 96), 6, -1, "general", f32)):
            xx = randn(R, C, dtype=dt) * 3
            bf = dt == bf16
            got = block_vp_quant_cuda(xx, fxp, vp, block, axis, bf,
                                      body=body)
            want = ref.block_vp_quant_ref(xx, fxp, vp, block, axis,
                                          math_dtype=dt)
            for g, w, part in zip(got, want, ("m", "i", "s")):
                _identical(torch, g, w, f"vp_block_quant {key} {(R, C)} "
                           f"block {block} axis {axis} {body} {part}")
            if got[0].dtype != torch.int16:
                raise AssertionError(f"vp_block_quant {key}: {got[0].dtype}")
            if (R, C, block) in ((4, 3072, 256), (1024, 3072, 16)):
                ms = timer(lambda: block_vp_quant_cuda(xx, fxp, vp, block,
                                                       axis, bf, body=body))
                pms = timer(lambda: ref.block_vp_quant_ref(
                    xx, fxp, vp, block, axis, math_dtype=dt))
                line(f"vp_block_quant {key} {body} block {block}", (R, C),
                     ms, pms, bound(peaks, R * C * (dt.itemsize + 2), 0,
                                    "f32"))
        for bk in (16, 256):
            for M, K, N in ((4, 1024, 3072), (512, 1024, 1024),
                            (33, 512, 70)):
                a = block_vp_quant_cuda(randn(M, K), fxp, vp, bk, -1, False)
                b = block_vp_quant_cuda(randn(K, N) * 0.05, fxp, vp, bk, 0,
                                        False)
                for dt in (f32, bf16):
                    got = ops.block_vp_matmul(a[0], a[1], b[0], b[1], vp, vp,
                                              bk=bk, out_dtype=dt)
                    _identical(torch, got, ref.block_vp_matmul_ref(
                        a[0], a[1], b[0], b[1], vp, vp, bk, out_dtype=dt),
                        f"block_vp_matmul {key} bk {bk} {(M, K, N)} {dt}")
                if M in (4, 512):
                    ms = timer(lambda: block_vp_matmul_cuda(
                        a[0], a[1], b[0], b[1], vp, vp, bk, f32))
                    pms = timer(lambda: ref.block_vp_matmul_ref(
                        a[0], a[1], b[0], b[1], vp, vp, bk))
                    line(f"block_vp_matmul {key} int16 bk {bk}", (M, K, N),
                         ms, pms, bound(peaks, (M * K + K * N) * 2
                                        + (M + N) * K // bk + M * N * 4,
                                        2 * M * K * N, "f32"))
    record["wide"] = out
    print(f"[wide] {len(out['rows'])} timed rows; every check bit-identical "
          "(float sums within tolerance)")
    return []   # the rows of these kernels come from phases 3 and 4


# ---------------------------------------------------------------------------
# 4d. the formats of faults 7-9 through the serve CLI; remat; MoE
# ---------------------------------------------------------------------------

def _plain_greedy(torch, params, cfg, prompts, steps, **stub):
    """Greedy tokens of the plain path (every op's plain PyTorch version,
    on the card) from the same exported params and prompts (and the same
    frames or patches, `stub`)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_static

    with ops.force_backend("ref"):
        tokens, _ = run_static(params, cfg, prompts, steps, {}, **stub)
    return tokens


def _format_cli(torch, tag, argv, need):
    """One f32 serve CLI run at a wide format: its launch counts (`need`:
    kernels that must have run), then the plain path's greedy tokens from
    the same exported params, equal to the CLI's."""
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    run, seen = serve.run_static, {}

    def held(params, cfg, prompts, gen, *a, **kw):
        seen.update(params=params, cfg=cfg, prompts=prompts, stub=kw)
        return run(params, cfg, prompts, gen, *a, **kw)

    torch.cuda.empty_cache()
    build.reset_launches()
    serve.run_static = held
    try:
        # -- the main path: the serve CLI -----------------------------------
        report = serve.main(argv + ["--dtype", "float32"])
        counts = dict(build.LAUNCHES)
        # -------------------------------------------------------------------
    finally:
        serve.run_static = run
    _need(tag, counts, need)
    plain = _plain_greedy(torch, seen["params"], seen["cfg"],
                          seen["prompts"], report["gen"], **seen["stub"])
    if plain.tolist() != report["tokens"]:
        raise AssertionError(f"{tag} greedy tokens differ from the plain "
                             f"path's: {report['tokens']} vs "
                             f"{plain.tolist()}")
    print(f"{tag} {' '.join(argv)}: f32, {report['layers']} layers, export "
          f"{report['export_s']:.3f}s, prefill {report['prefill_s']:.4f}s, "
          f"decode {report['decode_s'] / report['gen'] * 1e3:.3f} ms/step; "
          f"greedy tokens equal to the plain path's; launches {counts}")
    return dict(report, launches=counts)


def _format_engine(torch, tag, argv, need):
    """The engine through the serve CLI (chunked prefill over the packed
    KV cache), f32: launch counts, then each request's tokens against the
    plain path's greedy generation (`oracle_generate` on the plain ops)."""
    import numpy as np

    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.serving.runner import oracle_generate

    run, seen = serve._run_engine, {}

    def held(args, params, cfg, report):
        seen.update(params=params, cfg=cfg, args=args)
        return run(args, params, cfg, report)

    torch.cuda.empty_cache()
    build.reset_launches()
    serve._run_engine = held
    try:
        # -- the main path: the engine through the serve CLI ------------------
        report = serve.main(argv + ["--dtype", "float32"])
        counts = dict(build.LAUNCHES)
        # -------------------------------------------------------------------
    finally:
        serve._run_engine = run
    _need(tag, counts, need)
    args, params, cfg = seen["args"], seen["params"], seen["cfg"]
    rng = np.random.default_rng(args.seed)
    with ops.force_backend("ref"):
        for i, got in enumerate(report["tokens"]):
            prompt = [int(t) for t in rng.integers(0, cfg.vocab,
                                                   args.prompt_len)]
            want = oracle_generate(params, cfg, prompt, args.gen,
                                   report["capacity"])
            if got != want:
                raise AssertionError(f"{tag} request {i}: {got} vs the "
                                     f"plain path's {want}")
    print(f"{tag} {' '.join(argv)}: f32, {report['n_requests']} requests, "
          f"{report['total_tokens']} tokens, every request's tokens equal "
          f"to the plain path's; launches {counts}")
    return dict(report, launches=counts)


def formats_phase(torch, record, rows, smi):
    """The serve CLI at the formats faults 7-9 opened, each in f32 with
    greedy tokens equal to the plain path's on the card (same exported
    params and prompts), batch 4, prompt 16, 4 steps:

    - `--quant vp --kv-quant --M 13 --E 4` (int32 weight and KV words) on
      qwen2-0.5b (full depth; G 7), stablelm-12b (4 layers; dh 160 on
      32-byte lanes) and gemma3-27b (7 layers; dh 168), and on qwen2
      through the engine with `--prefill-chunk 32` over the int32 cache
      (the packed dequant of the cached words);
    - `--quant vp_block --block 16 --kv-quant` at `--M 10 --E 2` and
      `--M 12 --E 3` on qwen2 (int16 significands: every body of the
      quantizer that the path plans, the int16 matmul body);
    - `--quant vp --kv-quant --M 7 --E 5` and `--E 7` on qwen2 (32 and
      128 exponents)."""
    tag = "[formats]"
    out, launches = {}, collections.Counter()
    short = ["--batch", str(BATCH), "--prompt-len", "16", "--gen", "4"]
    m13 = ["--quant", "vp", "--kv-quant", "--M", "13", "--E", "4"]
    for arch, layers, need in (
            ("qwen2-0.5b", None, {"vp_dec_split": 1, "vp_dqmm_skinny": 1}),
            ("stablelm-12b", STABLELM_LAYERS, {"vp_dec_split": 1}),
            ("gemma3-27b", GEMMA_LAYERS, {"vp_dec_split": 1})):
        extra = ["--layers", str(layers)] if layers else []
        res = _format_cli(torch, f"{tag} {arch} M13 E4",
                          ["--arch", arch, *m13, *extra, *short], need)
        out[f"{arch} M13 E4"] = res
        launches.update(res["launches"])
    res = _format_engine(
        torch, f"{tag} qwen2-0.5b M13 E4 engine",
        ["--arch", "qwen2-0.5b", *m13, "--engine", "--batch", "3",
         "--max-slots", "2", "--page-size", "16", "--prompt-len", "72",
         "--gen", "4", "--prefill-chunk", "32"],
        {"vp_dequant_packed": 1, "vp_dec_split": 1})
    out["qwen2-0.5b M13 E4 engine"] = res
    launches.update(res["launches"])
    for M, E in ((10, 2), (12, 3)):
        res = _format_cli(
            torch, f"{tag} qwen2-0.5b vp_block16 M{M} E{E}",
            ["--arch", "qwen2-0.5b", "--quant", "vp_block", "--block", "16",
             "--kv-quant", "--M", str(M), "--E", str(E), *short],
            {"vp_bmm_i16": 1, "vp_bq_general": 1, "vp_bq_small": 1})
        out[f"qwen2-0.5b vp_block16 M{M} E{E}"] = res
        launches.update(res["launches"])
    for E in (5, 7):
        res = _format_cli(
            torch, f"{tag} qwen2-0.5b M7 E{E}",
            ["--arch", "qwen2-0.5b", "--quant", "vp", "--kv-quant", "--M",
             "7", "--E", str(E), *short],
            {"vp_dec_split": 1, "vp_qp_table": 1, "vp_dqmm_skinny": 1})
        out[f"qwen2-0.5b M7 E{E}"] = res
        launches.update(res["launches"])
    for row in rows:
        if launches.get(row["name"]):
            row["formats_launches"] = launches[row["name"]]
    record["formats"] = dict(out, launches=dict(launches))
    print(f"{tag} launches over the phase's runs: {dict(launches)}; {smi}")


def remat_phase(torch, record, rows, smi):
    """stablelm-12b at full width, 4 layers, bf16: one training step's
    loss and gradients (packed QAT: the quant, `vp_dequant_matmul` and
    `vp_matmul_dx` kernels) with remat="full" and with "none", batch 4 x
    512 tokens; each run's peak device memory (max_memory_allocated after
    a reset, the parameters resident; each run's gradients moved to the
    host before the next), the loss bit-identical and every gradient's
    max difference (0: the recomputation repeats the same kernels)."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import build
    from repro_torch.models.model import init_params, stack_layers
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.tree import tree_paths

    tag = "[remat]"
    cfg = _dense_cfg("stablelm-12b", QuantConfig(mode="vp", qat_mode="packed"),
                     layers=STABLELM_LAYERS)
    params = stack_layers(init_params(cfg, seed=0, device="cuda"), cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, REMAT_BATCH, generator=gen,
                           device="cuda")
    batch = {"tokens": tokens, "labels": tokens.roll(-1, dims=1)}
    value_and_grad(params, batch, cfg)   # warm-up: libraries, tables
    out, grads = {}, {}
    for remat in ("full", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        build.reset_launches()
        t0 = time.perf_counter()
        # -- the main path: one training step's loss and gradients -----------
        loss, _, g = value_and_grad(params, batch, c)
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)
        # -------------------------------------------------------------------
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        _need(f"{tag} remat={remat}", counts, {
            "vp_dequant_matmul": 1, "vp_matmul_dx": 1, "vp_qp_table": 1})
        grads[remat] = {p: t.cpu() for p, t in tree_paths(g)}
        del g
        out[remat] = dict(loss=float(loss), seconds=dt, peak_bytes=peak,
                          resident_bytes=base, launches=counts)
        print(f"{tag} stablelm-12b ({STABLELM_LAYERS} layers, bf16, "
              f"{REMAT_BATCH[0]} x {REMAT_BATCH[1]} tokens) remat={remat}: "
              f"loss {float(loss):.6f}, {dt:.3f}s, peak memory "
              f"{peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} GB above the "
              f"{base / 1e9:.3f} GB resident); launches {counts}")
    diff = max(float((grads["full"][p].float()
                      - grads["none"][p].float()).abs().max())
               for p in grads["none"])
    if out["full"]["loss"] != out["none"]["loss"] or diff != 0.0:
        raise AssertionError(f"{tag} remat changed the step: loss "
                             f"{out['full']['loss']} vs {out['none']['loss']}"
                             f", gradient max diff {diff}")
    if out["full"]["peak_bytes"] >= out["none"]["peak_bytes"]:
        raise AssertionError(f"{tag} remat did not lower the peak: {out}")
    print(f"{tag} loss bit-identical, gradient max diff {diff}; peak "
          f"{out['full']['peak_bytes'] / 1e9:.3f} GB with remat against "
          f"{out['none']['peak_bytes'] / 1e9:.3f} GB without; {smi}")
    record["remat"] = dict(out, grad_max_diff=diff)


def _moe_shapes(torch, tag, cfg, params, B, smax, record):
    """The MoE run's own kernels at the shapes its config gives them,
    each against its plain version on the same inputs: layer 0's stacked
    expert words (w_gate, w_up: (E, d, ff); w_down: (E, ff, d)) through
    `ops.vp_dequant`, one launch over the whole stack as `moe._w` makes
    it, into bf16 and f32 against `ref.vp_dequant_packed_ref`, bit for
    bit; and the decode attention at the run's (B, smax, KV, G, dh) over
    the KV format's words (the config's window, which the run's cache
    never passes) with random per-position scales (seed 1), against
    `ref.vp_decode_attention_ref` in f32 within F32_RTOL and bf16 within
    BF16_TOL, bit-identical over two launches."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.attention import kv_cache_formats

    moe, done = params["layers"][0]["moe"], []
    _, vp = kv_cache_formats(cfg.quant)
    for name in ("w_gate", "w_up", "w_down"):
        w = moe[name]["w_packed"]
        for dt in (torch.bfloat16, torch.float32):
            got = ops.vp_dequant(w, None, vp, dt)
            _identical(torch, got, ref.vp_dequant_packed_ref(w, vp, dt),
                       f"{tag} expert dequant {name} {list(w.shape)} "
                       f"{w.dtype} -> {dt}")
            del got
            done.append(f"{name} {list(w.shape)} -> {str(dt)[6:]}")
    fxp, vp = kv_cache_formats(cfg.quant)
    KV, dh = cfg.n_kv_heads, cfg.head_dim
    G = cfg.n_heads // KV
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    scales = torch.tensor([2.0 ** -3, 2.0 ** -2, 0.5, 1.0, 2.0],
                          device="cuda")
    k_w, v_w = (ops.vp_quant((randn(B, smax, KV, dh) * 0.3).clamp(
        -0.99, 0.99), fxp, vp, packed=True) for _ in range(2))
    k_s, v_s = (scales[torch.randint(0, 5, (B, smax, 1, 1), generator=gen,
                                     device="cuda")] for _ in range(2))
    lens = [smax, smax - 1, smax - 15, smax - smax // 3][:B]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    args = (k_w, v_w, k_s, v_s, lengths, vp, cfg.sliding_window, False)
    what = f"{tag} vp_decode_attention {[B, smax, KV, G, dh]} {k_w.dtype}"
    q = randn(B, 1, KV * G, dh)
    got = ops.vp_decode_attention(q, *args)
    compare(torch, got, ref.vp_decode_attention_ref(q, *args), F32_RTOL,
            what)
    _identical(torch, ops.vp_decode_attention(q, *args), got,
               f"{what}, two launches")
    qb = q.to(torch.bfloat16)
    compare(torch, ops.vp_decode_attention(qb, *args),
            ref.vp_decode_attention_ref(qb, *args), BF16_TOL, f"{what} bf16")
    done.append(f"decode {[B, smax, KV, G, dh]} lengths {lens}")
    print(f"{tag} expert dequant bit-identical to its plain version, decode "
          f"attention within tolerance (f32, bf16): " + "; ".join(done))
    record.setdefault("moe_shapes", {})[tag] = done


def moe_phase(torch, record, rows, smi):
    """The MoE family through the static serve CLI at full width, bf16,
    `--quant vp --kv-quant`, random weights from seed 0: qwen3-moe-30b-a3b
    over MOE_LAYERS[arch] layers (128 experts, top 8, GQA 32 / 4, dh 64)
    and mixtral-8x22b over its cut (8 experts, top 2, GQA 48 / 8, dh 128,
    window 4096), batch 4, prompt 128, 16 steps: tokens/s and launch
    counts by kernel; every stacked expert weight dequantized by one
    `vp_dequant_packed` launch a layer and pass (3 L per prefill and
    decode step); the logits finite; a second run from the same params
    and prompts gives the same tokens.  Then that run's own kernels at
    its shapes against their plain versions (`_moe_shapes`: the expert
    stacks' dequant, the decode attention; `_dense_shapes`: the
    attention weights, lm_head and KV writes), and an f32 run of the
    same CLI (batch 4, prompt 16, 4 steps) whose greedy tokens equal the
    plain path's on the card (`_format_cli`)."""
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    tag = "[moe]"
    out, launches = {}, collections.Counter()
    run, seen = serve.run_static, {}

    def held(params, cfg, prompts, gen, *a, **kw):
        tokens, logits = run(params, cfg, prompts, gen, *a, **kw)
        seen.update(params=params, cfg=cfg, prompts=prompts, logits=logits)
        return tokens, logits

    B, S, steps = MOE_SERVE
    for arch, layers in MOE_LAYERS.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        serve.run_static = held
        try:
            # -- the main path: the serve CLI ----------------------------------
            report = serve.main([
                "--arch", arch, "--layers", str(layers), "--quant", "vp",
                "--kv-quant", "--batch", str(B), "--prompt-len", str(S),
                "--gen", str(steps)])
            counts = dict(build.LAUNCHES)
            # ---------------------------------------------------------------
        finally:
            serve.run_static = run
        peak = torch.cuda.max_memory_allocated()
        want_dq = 3 * layers * (steps + 1)
        if counts.get("vp_dequant_packed") != want_dq:
            raise AssertionError(f"{tag} {arch}: {counts.get('vp_dequant_packed')}"
                                 f" expert dequant launches, want {want_dq}")
        _need(f"{tag} {arch}", counts, {"vp_dec_split": layers * steps,
                                        "flash_tc": layers,
                                        "vp_dqmm_skinny": 1})
        again, _ = run(seen["params"], seen["cfg"], seen["prompts"], steps, {})
        if again.tolist() != report["tokens"]:
            raise AssertionError(f"{tag} {arch}: a second run gave other "
                                 "tokens")
        cfg = seen["cfg"]
        for lg in seen["logits"]:
            if not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"{tag} {arch}: non-finite logits")
        print(f"{tag} {arch}: {layers} of {serve.registry.get_config(arch).n_layers}"
              f" layers at full width (d_model {cfg.d_model}, {cfg.n_experts}"
              f" experts top {cfg.experts_per_token}, {cfg.n_heads} / "
              f"{cfg.n_kv_heads} heads of {cfg.head_dim}, window "
              f"{cfg.sliding_window}), weights {report['weight_bytes'] / 1e9:.3f}"
              f" GB, export {report['export_s']:.3f}s, prefill {B}x{S} "
              f"{report['prefill_s']:.4f}s, decode {steps} steps "
              f"{report['decode_s']:.4f}s ({report['tokens_per_s']:.1f} tok/s)"
              f", peak memory {peak / 1e9:.3f} GB; a second run gave the same"
              f" tokens; launches {counts}")
        _moe_shapes(torch, f"{tag} {arch}", cfg, seen["params"], B,
                    S + steps, record)
        _dense_shapes(torch, f"{tag} {arch}", cfg, seen["params"], B, S,
                      record)
        seen.clear()
        res = _format_cli(
            torch, f"{tag} {arch}",
            ["--arch", arch, "--layers", str(layers), "--quant", "vp",
             "--kv-quant", "--batch", str(B), "--prompt-len", "16", "--gen",
             "4"],
            {"vp_dequant_packed": 3 * layers * 5, "vp_dec_split": layers * 4,
             "vp_dqmm_skinny": 1})
        out[arch] = dict(report, launches=counts, peak_bytes=peak, f32=res)
        launches.update(counts)
    for row in rows:
        if launches.get(row["name"]):
            row["moe_launches"] = launches[row["name"]]
    record["moe"] = dict(out, launches=dict(launches))
    print(f"{tag} launches over the phase's runs: {dict(launches)}; {smi}")


# ---------------------------------------------------------------------------
# 4f. the SSM and hybrid families, and the engine's MoE rows
# ---------------------------------------------------------------------------

def _qdot_row(torch, peaks, timer, randn, w, M, xdt, what):
    """`qdot` of the exported packed weight `w` (K, N) at M rows of x in
    `xdt` (randn) against its plain path (f32 within F32_RTOL, bf16
    within BF16_TOL), two launches bit-identical, timed as the model
    calls it (the kernel, then the scale multiply) beside `torch.matmul`
    on the dequantized weight.  The bound counts an f32 x on the
    tensor-core body as three bf16 terms, 3 x 2MKN at the bf16 rate, and
    the skinny body's f32 x at the f32 rate.  Returns the row's entry."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.packing import dequant_words
    from repro_torch.kernels import ops
    from repro_torch.kernels.vp_dequant_matmul import fwd_body
    from repro_torch.models.layers import canonical_formats, qdot

    q = QuantConfig(mode="vp")
    _, fmt = canonical_formats(q)
    words = w["w_packed"]
    K, N = words.shape
    x = randn(M, K, dtype=xdt)
    w_deq = (dequant_words(words, fmt, torch.float32) * w["scale"]).to(xdt)
    body = fwd_body(M, xdt, fmt)
    f32_x = xdt == torch.float32
    got = qdot(x, w, q)
    with ops.force_backend("ref"):
        want = qdot(x, w, q)
    err, rel = compare(torch, got, want, F32_RTOL if f32_x else BF16_TOL,
                       what)
    _identical(torch, qdot(x, w, q), got, f"{what}, two launches")
    ms = timer(lambda: qdot(x, w, q))
    with ops.force_backend("ref"):
        plain_ms = timer(lambda: qdot(x, w, q))
    library_ms = timer(lambda: torch.matmul(x, w_deq))
    xb = x.element_size()
    terms = 3 if f32_x and body == "tensor_core" else 1
    bnd = bound(peaks, M * K * xb + K * N * words.element_size() + M * N * xb,
                terms * 2 * M * K * N,
                "f32" if f32_x and body != "tensor_core" else "bf16")
    _print_line("vp_dequant_matmul", [M, K, N], err, rel, ms, plain_ms, bnd,
                library_ms)
    print(f"{what}: {body} body, {bnd[0] / ms:.1%} of the bound, "
          f"{ms / library_ms:.2f}x torch.matmul")
    return dict(shape=[M, K, N], x=str(xdt)[6:], body=body, ms=ms,
                plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=library_ms, max_abs_err=err)


def _decode_row(torch, peaks, timer, gen, randn, w_bytes, shape, what):
    """`vp_decode_attention` at (B, smax, KV, G, dh) of `shape` over packed
    words of `w_bytes` (VP(7, E 2) int16, VP(6, E 2) int8) with random
    per-position pow2 scales, lengths smax, smax - 4, smax - 15 and
    smax - smax // 3 (the full pattern): f32 q within F32_RTOL and bf16 q
    within BF16_TOL of the plain version, two launches bit-identical,
    timed beside SDPA on the dequantized cache with a span mask.  Returns
    the row's entry."""
    import torch.nn.functional as F

    from repro_torch.core.formats import FXPFormat, default_vp_format
    from repro_torch.core.packing import dequant_words
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.vp_attention import plan_decode

    fxp = FXPFormat(12, 11)
    vp = default_vp_format(fxp, 7 if w_bytes == 2 else 6, 2)
    B, smax, KV, G, dh = shape
    H = KV * G
    lens = [smax, smax - 4, smax - 15, smax - smax // 3]
    scales = torch.tensor([2.0 ** -3, 2.0 ** -2, 0.5, 1.0, 2.0],
                          device="cuda")
    k_w, v_w = (ops.vp_quant((randn(B, smax, KV, dh) * 0.3).clamp(
        -0.99, 0.99), fxp, vp, packed=True) for _ in range(2))
    k_s, v_s = (scales[torch.randint(0, 5, (B, smax, 1, 1), generator=gen,
                                     device="cuda")] for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    qd = randn(B, 1, H, dh)
    args = (k_w, v_w, k_s, v_s, lengths, vp, None, False)
    got = ops.vp_decode_attention(qd, *args)
    err, rel = compare(torch, got, ref.vp_decode_attention_ref(qd, *args),
                       F32_RTOL, what)
    qb = qd.to(torch.bfloat16)
    compare(torch, ops.vp_decode_attention(qb, *args),
            ref.vp_decode_attention_ref(qb, *args), BF16_TOL, f"{what} bf16")
    _identical(torch, ops.vp_decode_attention(qd, *args), got,
               f"{what}, two launches")
    ms = timer(lambda: ops.vp_decode_attention(qd, *args))
    plain_ms = timer(lambda: ref.vp_decode_attention_ref(qd, *args))
    kd, vd = ((dequant_words(w, vp, torch.float32) * s)
              .transpose(1, 2).contiguous()
              for w, s in ((k_w, k_s), (v_w, v_s)))
    pos = torch.arange(smax, device="cuda")[None, :]
    mask = (pos < lengths.to(torch.int64)[:, None])[:, None, None]
    qt = qd.transpose(1, 2)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kd, vd, attn_mask=mask))
    valid = sum(lens)
    bnd = bound(peaks, valid * KV * dh * w_bytes * 2 + valid * 2 * 4
                + 2 * B * H * dh * 4, 4 * valid * KV * G * dh, "f32")
    row_shape = [B, smax, KV, G, dh, f"int{8 * w_bytes}", "full"]
    _print_line("vp_decode_attention", row_shape, err, rel, ms, plain_ms, bnd,
                library_ms)
    plan = plan_decode(KV, smax, G, dh, w_bytes)
    print(f"{what}: {plan}")
    return dict(shape=row_shape, plan=dataclasses.asdict(plan), ms=ms,
                plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=library_ms, max_abs_err=err)


def _flash_row(torch, peaks, timer, randn, shape, dtype, sass, what):
    """`flash_prefill` at (B, Sq, Sk, H, KV, dh, pattern) of `shape` in
    `dtype` on the body `flash_body` plans (bf16: tensor cores, whose
    SASS entry in `sass` must hold no LDL / STL and some HMMA; f32: CUDA
    cores): within BF16_TOL / F32_RTOL of its plain version, two launches
    bit-identical, timed beside SDPA (causal for "causal", no mask for
    "full"; K / V repeated to H heads first).  Returns the row's entry."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.vp_attention import flash_body

    B, Sq, Sk, H, KV, dh, pattern = shape
    body = flash_body(dtype, dh)
    if body != ("tensor_core" if dtype == torch.bfloat16 else "cuda_core"):
        raise AssertionError(f"{what}: {dtype} dh {dh} planned on {body}")
    qd = randn(B, Sq, H, dh, dtype=dtype)
    kd, vd = (randn(B, Sk, KV, dh, dtype=dtype) for _ in range(2))
    got = ops.flash_prefill(qd, kd, vd, pattern, None)
    err, rel = compare(torch, got, ref.flash_prefill_ref(
        qd, kd, vd, pattern, None),
        BF16_TOL if dtype == torch.bfloat16 else F32_RTOL, what)
    _identical(torch, ops.flash_prefill(qd, kd, vd, pattern, None), got,
               f"{what}, two launches")
    ms = timer(lambda: ops.flash_prefill(qd, kd, vd, pattern, None))
    plain_ms = timer(lambda: ref.flash_prefill_ref(qd, kd, vd, pattern, None))
    qt = qd.transpose(1, 2)
    kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2)
              for t in (kd, vd))
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=pattern == "causal"))
    pairs = Sq * Sk if pattern == "full" else Sq * (Sq + 1) // 2
    bnd = bound(peaks, qd.element_size() * (2 * B * Sq * H * dh
                                            + 2 * B * Sk * KV * dh),
                4 * B * H * dh * pairs,
                "bf16" if dtype == torch.bfloat16 else "f32")
    row_shape = [B, Sq, Sk, H, KV, dh, pattern, str(dtype)[6:]]
    _print_line("flash_prefill", row_shape, err, rel, ms, plain_ms, bnd,
                library_ms)
    entry = dict(shape=row_shape, body=body, ms=ms, plain_ms=plain_ms,
                 bound_ms=bnd[0], bound_by=bnd[1], library_ms=library_ms,
                 max_abs_err=err)
    line = (f"{what}: {body} body {ms:.4f} ms, {ms / library_ms:.2f}x SDPA, "
            f"{bnd[0] / ms:.1%} of the bound")
    if body == "tensor_core":
        tc = sass[f"prefill tc dh {dh}"]
        if tc["LDL"] or tc["STL"] or not tc["HMMA"]:
            raise AssertionError(f"{what}: SASS {tc}")
        entry.update(ldl=tc["LDL"], stl=tc["STL"])
        line += (f", SASS LDL {tc['LDL']}, STL {tc['STL']}, HMMA "
                 f"{tc['HMMA']}")
    print(line)
    return entry


def _ssm_kernel_rows(torch, peaks, record, rows):
    """The kernels at the shapes rwkv6-3b and zamba2-7b give them, timed
    as phase 3 times them beside bound, plain version and library call,
    each held against its plain version: `qdot` of weights exported at
    each projection's shape (`quantize_weight`: the quant kernel, then
    `vp_dequant_matmul`; `_qdot_row`) at decode M = 4 (skinny body) and
    prefill M = 512 (tensor-core body), rwkv6's R/K/V/G and channel-mix
    key and receptance shapes with f32 activations (as its lerp makes
    them) and its output, value and lm_head (vocab 65536) with bf16 ones,
    zamba2's w_z / w_x, w_bc (N 128), w_dt (N 112), w_out (K 7168), the
    shared block's projections and lm_head (vocab 32000); zamba2's shared
    block's decode attention (B 4, smax 144, KV 32, G 1, dh 112) over
    int16 and int8 words (`_decode_row`), and its tensor-core prefill (B
    4, S 128, 32 heads, dh 112; `_flash_row`); the KV write
    (`quantize_kv`, the quantizer's KV mode) at (4, 1 and 128, 32, 112)
    in int16 and int8 words, bit for bit.  Local memory (LDL / STL) of
    the attention instances (phase 4's count) and of
    `vp_dequant_matmul`'s, printed."""
    import dataclasses as dc

    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import build, ops
    from repro_torch.models.attention import quantize_kv
    from repro_torch.models.layers import quantize_weight

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    timer = Timer(torch)
    q = QuantConfig(mode="vp", quantize_kv_cache=True)
    by_name = {r["name"]: r for r in rows}
    out = []

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def add(name, entry):
        by_name[name].setdefault("ssm_shapes", []).append(entry)
        out.append(dict(entry, name=name))

    # -- vp_dequant_matmul through qdot, at each projection's shape ----------
    for arch, name, K, N, xname in SSM_DQMM:
        xdt = {"f32": torch.float32, "bf16": torch.bfloat16}[xname]
        w = quantize_weight((randn(K, N) * 0.02).to(torch.bfloat16), q)
        for M in (4,) if name == "lm_head" else (4, 512):
            add("vp_dequant_matmul", dict(_qdot_row(
                torch, peaks, timer, randn, w, M, xdt,
                f"[ssm kernel] {arch} {name} {[M, K, N]} {xname} x"),
                arch=arch, weight=name))
        del w

    # -- zamba2's shared block: decode attention at G 1, dh 112 --------------
    for w_bytes in (2, 1):
        add("vp_decode_attention", _decode_row(
            torch, peaks, timer, gen, randn, w_bytes, SSM_DEC_SHAPE,
            f"[ssm kernel] vp_decode_attention {list(SSM_DEC_SHAPE)} "
            f"int{8 * w_bytes}"))

    # -- the tensor-core prefill at dh 112 -----------------------------------
    Bp, S, Hp = SSM_PREFILL_SHAPE
    _, _, KV, _, dh = SSM_DEC_SHAPE
    sass = record["attention_sass"]
    add("flash_prefill", _flash_row(
        torch, peaks, timer, randn, (Bp, S, S, Hp, Hp, dh, "causal"),
        torch.bfloat16, sass, f"[ssm kernel] flash_prefill "
        f"{[Bp, S, Hp, Hp, dh, 'causal']}"))
    print("[ssm kernel] decode instances (LDL/STL) "
          + "; ".join(f"{k} {v['LDL']}/{v['STL']}" for k, v in sass.items()
                      if k.startswith("decode")))

    # -- the KV write at (B, S, 32, 112) ---------------------------------------
    for M in (7, 6):
        qm = dc.replace(q, M=M, E=2)
        for S_kv in (1, S):
            x = randn(Bp, S_kv, KV, dh, dtype=torch.bfloat16)
            what = f"KV write {[Bp, S_kv, KV, dh]} M {M}"
            got = quantize_kv(x, qm)
            with ops.force_backend("ref"):
                want = quantize_kv(x, qm)
            for g, w_ in zip(got, want):
                _identical(torch, g, w_, what)
            ms = timer(lambda: quantize_kv(x, qm))
            with ops.force_backend("ref"):
                plain_ms = timer(lambda: quantize_kv(x, qm))
            n = x.numel()
            bnd = bound(peaks, n * 2 + n * got[0].element_size()
                        + Bp * S_kv * 4, 0, "f32")
            _print_line("vp_quant_packed", [Bp, S_kv, KV, dh, f"M {M}"], 0.0,
                        0.0, ms, plain_ms, bnd, None)
            add("vp_quant_packed", dict(
                shape=[Bp, S_kv, KV, dh, f"kv M {M}"], ms=ms,
                plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=None, max_abs_err=0.0))

    # -- a row's bits do not depend on its batch (the engine's buckets) -------
    from repro_torch.configs import registry
    from repro_torch.models import mamba2, rwkv6
    from repro_torch.models.model import init_params, quantize_params

    for arch in SSM_ARCHS:
        cfg = dc.replace(registry.get_config(arch, q), n_layers=1)
        p = quantize_params(init_params(cfg, 0, "cuda"), cfg)["layers"][0]
        d, Bb = cfg.d_model, 4
        x = randn(Bb, 1, d, dtype=torch.bfloat16)
        if arch == "rwkv6-3b":
            state = {"s": randn(Bb, d // 64, 64, 64),
                     "last_tm": randn(Bb, d, dtype=torch.bfloat16),
                     "last_cm": randn(Bb, d, dtype=torch.bfloat16)}

            def block(x, st):
                h, st = rwkv6.rwkv6_time_mix(x, p, cfg, st)
                return h + rwkv6.rwkv6_channel_mix(x, p, cfg, st)[0]
        else:
            _, n, nh, hp, conv_dim, _ = mamba2.mamba2_dims(cfg)
            state = {"h": randn(Bb, nh, hp, n),
                     "conv": randn(Bb, 3, conv_dim, dtype=torch.bfloat16)}

            def block(x, st):
                return mamba2.mamba2_block(x, p, cfg, st)[0]
        full = {k: v.clone() for k, v in state.items()}
        got = block(x, full)
        for i in range(Bb):
            one = {k: v[i:i + 1].clone() for k, v in state.items()}
            _identical(torch, block(x[i:i + 1], one), got[i:i + 1],
                       f"{arch} decode block, row {i} alone vs in a batch "
                       f"of {Bb}")
            for k in one:
                _identical(torch, one[k], full[k][i:i + 1],
                           f"{arch} decode state {k}, row {i}")
        print(f"[ssm kernel] {arch}: a one-token block's output and state "
              f"rows bit-identical alone and in a batch of {Bb}")
        del p

    # -- local memory of vp_dequant_matmul's instances -------------------------
    target = build._target("vp_dequant_matmul")
    local = {op: _sass_counts(target, build._nvcc(), op)
             for op in ("LDL", "STL")}
    inst = {k: (local["LDL"][k], local["STL"][k]) for k in local["LDL"]
            if "kernel" in k}
    print(f"[ssm kernel] vp_dequant_matmul SASS: {len(inst)} instances, "
          f"LDL/STL nonzero in {[k for k, v in inst.items() if any(v)]}")
    record["ssm_kernels"] = dict(
        rows=out, dqmm_local={k: list(v) for k, v in inst.items()})


def _ssm_static(torch, tag, arch, launches):
    """One family through the static serve CLI at full width and depth,
    bf16, `--quant vp --kv-quant`, batch x prompt x steps of SSM_SERVE:
    export, prefill and decode times, tokens/s, peak memory and launches
    by kernel; the logits finite and a second run from the same params
    and prompts with the same tokens; then an f32 run of the CLI at
    SSM_F32_LAYERS (batch 4, prompt 16, 4 steps) whose greedy tokens equal
    the plain path's on the card."""
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models.model import layer_plan

    B, S, steps = SSM_SERVE
    run, seen = serve.run_static, {}

    def held(params, cfg, prompts, gen, *a, **kw):
        tokens, logits = run(params, cfg, prompts, gen, *a, **kw)
        seen.update(params=params, cfg=cfg, prompts=prompts, logits=logits)
        return tokens, logits

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    serve.run_static = held
    try:
        # -- the main path: the serve CLI ------------------------------------
        report = serve.main([
            "--arch", arch, "--quant", "vp", "--kv-quant", "--batch", str(B),
            "--prompt-len", str(S), "--gen", str(steps)])
        counts = dict(build.LAUNCHES)
        # -------------------------------------------------------------------
    finally:
        serve.run_static = run
    peak = torch.cuda.max_memory_allocated()
    cfg = seen["cfg"]
    need = {"vp_dqmm_skinny": 1, "vp_dqmm_tc": 1}
    apps = sum(spec.pattern == "shared_attn" for spec in layer_plan(cfg))
    if apps:
        need.update({"vp_dec_split": apps * steps, "flash_tc": apps,
                     "vp_qp_kv": 2 * apps * (steps + 1)})
    _need(f"{tag} {arch}", counts, need)
    for lg in seen["logits"]:
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{tag} {arch}: non-finite logits")
    again, _ = run(seen["params"], cfg, seen["prompts"], steps, {})
    if again.tolist() != report["tokens"]:
        raise AssertionError(f"{tag} {arch}: a second run gave other tokens")
    print(f"{tag} {arch}: all {cfg.n_layers} layers at full width (d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}"
          + (f", d_inner {cfg.d_inner}, {cfg.ssm_nheads} SSM heads of "
             f"{cfg.ssm_headdim}, state {cfg.ssm_state}, the shared block "
             f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.head_dim}"
             if cfg.family == "hybrid" else "")
          + f"), bf16, weights {report['weight_bytes'] / 1e9:.3f} GB, "
          f"export {report['export_s']:.3f}s, prefill {B}x{S} "
          f"{report['prefill_s']:.4f}s, decode {steps} steps "
          f"{report['decode_s']:.4f}s ({report['decode_s'] / steps * 1e3:.3f}"
          f" ms/step, {report['tokens_per_s']:.1f} tok/s), peak memory "
          f"{peak / 1e9:.3f} GB; a second run gave the same tokens; "
          f"launches {counts}")
    seen.clear()
    launches.update(counts)
    layers = SSM_F32_LAYERS[arch]
    f32 = _format_cli(
        torch, f"{tag} {arch}",
        ["--arch", arch, "--layers", str(layers), "--quant", "vp",
         "--kv-quant", "--batch", "4", "--prompt-len", "16", "--gen", "4"],
        {"vp_dqmm_skinny": 1, "vp_dqmm_tc": 1})
    return dict(report, launches=counts, peak_bytes=peak, f32=f32)


def _family_engine(torch, tag, cfg, params, reqs, cap, launches,
                   chunk=None, lookahead=ENGINE_LOOKAHEAD):
    """`reqs` through the engine (SSM_ENGINE_SLOTS slots, pages of
    ENGINE_PAGE, capacity `cap`, prefill whole or in chunks of `chunk`)
    at each run-ahead of `lookahead`: every graph's first replay
    bit-identical to its eager step, decode ms per step and the kernels
    that ran; the same tokens at each run-ahead, but for an MoE config,
    whose expert capacity is taken over the bucket's rows (padding
    included, as in the reference), so that a request's tokens may
    depend on its bucket: there the agreement is printed."""
    waves, recs = [], []
    for ahead in lookahead:
        eng = _engine(cfg, params, decode_lookahead=ahead,
                      max_slots=SSM_ENGINE_SLOTS, capacity=cap,
                      page_size=ENGINE_PAGE, prefill_chunk=chunk)
        kinds = sorted({(s.pattern, s.kind) for s in eng.kv.specs})
        torch.cuda.reset_peak_memory_stats()
        r, wall, calls, ran = _engine_wave(torch, eng, reqs)
        peak = torch.cuda.max_memory_allocated()
        _check_graph_log(eng.runner, f"{tag} run-ahead {ahead}:")
        eng.kv.check_conservation()
        launches.update(ran)
        recs.append(r)
        waves.append(dict(_decode_rates(r, calls), wall_s=wall,
                          peak_bytes=peak, run_ahead=ahead, chunk=chunk,
                          kernels=_engine_counts(ran)))
        print(f"{tag} run-ahead {ahead}{f', chunks of {chunk}' if chunk else ''}"
              f": {len(reqs)} requests (prompts {[len(p) for p, _ in reqs]},"
              f" budgets {[g for _, g in reqs]}) in {wall:.3f}s, "
              f"{waves[-1]['decode_ms_per_step']:.3f} ms per decode step "
              f"(graph captures and checks included), peak memory "
              f"{peak / 1e9:.3f} GB; cache plan {kinds}; kernels that ran "
              f"{_engine_counts(ran)}")
        _need(tag, ran, {"vp_dequant_matmul": 1})
        del eng
    differ = [a["rid"] for other in recs[1:]
              for a, b in zip(recs[0], other) if a["tokens"] != b["tokens"]]
    if differ and cfg.family != "moe":
        raise AssertionError(f"{tag}: run-ahead changed the tokens of "
                             f"requests {differ}")
    if len(recs) > 1:
        print(f"{tag}: requests whose tokens differ between run-ahead "
              f"{lookahead}: {differ or 'none'}")
    return dict(waves=waves, tokens=[r["tokens"] for r in recs[0]],
                differ_by_run_ahead=differ)


def _plain_engine_tokens(torch, cfg, params, prompt, gen, cap, chunk=None):
    """Greedy tokens of the plain path (plain ops on the card) at B = 1
    over a cache of `cap` positions: `runner.oracle_generate` for a whole
    prompt, else chunked prefills of `chunk` as the engine cuts it, then
    the same greedy decode."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.serving.runner import oracle_generate

    with ops.force_backend("ref"):
        if not chunk:
            return oracle_generate(params, cfg, prompt, gen, cap)
        caches = init_cache(cfg, 1, cap)
        p = torch.tensor([prompt], dtype=torch.int64, device="cuda")
        for lo in range(0, p.shape[1], chunk):
            lg, caches = prefill(params, p[:, lo:lo + chunk], caches, cfg,
                                 chunked=True)
        toks = [int(torch.argmax(lg[0]))]
        for _ in range(gen - 1):
            lg, caches = decode_step(params, torch.tensor(
                [[toks[-1]]], dtype=torch.int32, device="cuda"), caches, cfg)
            toks.append(int(torch.argmax(lg[0])))
    return toks


def ssm_phase(torch, record, rows, smi, peaks):
    """The SSM and hybrid families at full width (`models.rwkv6`,
    `models.mamba2`, the shared block) and the engine's MoE rows:

    (a) the kernels at these families' shapes (`_ssm_kernel_rows`);
    (b) rwkv6-3b and zamba2-7b whole through the static serve CLI, bf16,
        then f32 at their cut against the plain path (`_ssm_static`);
    (c) both through the engine whole, bf16: SSM_ENGINE_REQS ragged
        requests, graphs at run-ahead 4 and 1 with the same tokens, and
        zamba2 with chunked prefill (chunks of SSM_ENGINE_CHUNK); then
        f32 at the cut depth, every request's tokens equal to the plain
        path's greedy tokens (chunked as the engine chunks, zamba2's
        chunks dropping their conv history as the reference's do);
    (d) the engine's MoE rows: qwen3-moe-30b-a3b and mixtral-8x22b at
        MOE_LAYERS, bf16, the same requests at run-ahead 4 and 1 (each
        graph's first replay bit-identical to its eager step; mixtral's
        window keeps dense rings);
    (e) one packed-QAT train step, VP gradients and VP moments, remat
        "full", on rwkv6 at 4 layers and zamba2 at one repetition of its
        group plus the tail (SSM_F32_LAYERS), batch x seq of SSM_TRAIN:
        loss, seconds per step (the second of two), peak memory."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.configs.base import QuantConfig
    from repro_torch.models.model import init_params, quantize_params

    tag = "[ssm]"
    laps, t_lap = {}, [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        laps[what] = now - t_lap[0]
        t_lap[0] = now
        print(f"[time] ssm {what}: {laps[what]:.2f}s")

    _ssm_kernel_rows(torch, peaks, record, rows)
    lap("kernels")
    out, launches = {}, collections.Counter()
    for arch in SSM_ARCHS:
        out[arch] = _ssm_static(torch, tag, arch, launches)
        lap(f"static {arch}")

    n, (lo, hi), (g_lo, g_hi) = SSM_ENGINE_REQS
    rng = np.random.default_rng(0)
    plens = rng.integers(lo, hi + 1, n)
    gens = rng.integers(g_lo, g_hi + 1, n)
    quant = QuantConfig(mode="vp", quantize_kv_cache=True)
    engines = {}
    for arch in SSM_ARCHS + tuple(MOE_LAYERS):
        cfg = registry.get_config(arch, quant)
        if arch in MOE_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=MOE_LAYERS[arch])
        reqs = [([int(t) for t in rng.integers(0, cfg.vocab, int(s))],
                 int(g)) for s, g in zip(plens, gens)]
        torch.cuda.empty_cache()
        params = quantize_params(init_params(cfg, seed=0, device="cuda"), cfg)
        res = {"whole": _family_engine(
            torch, f"{tag} {arch} engine", cfg, params, reqs,
            SSM_ENGINE_CAP, launches)}
        if arch == "zamba2-7b":
            res["chunked"] = _family_engine(
                torch, f"{tag} {arch} engine", cfg, params, reqs,
                SSM_ENGINE_CAP, launches, chunk=SSM_ENGINE_CHUNK,
                lookahead=(4,))
        del params
        gc.collect()
        if arch in SSM_ARCHS:   # f32 at the cut, against the plain path
            c32 = dataclasses.replace(cfg, n_layers=SSM_F32_LAYERS[arch],
                                      dtype="float32")
            p32 = quantize_params(init_params(c32, seed=0, device="cuda"),
                                  c32)
            few = reqs[:3]
            for chunk in ((None, SSM_ENGINE_CHUNK) if arch == "zamba2-7b"
                          else (None,)):
                got = _family_engine(
                    torch, f"{tag} {arch} f32 engine", c32, p32, few,
                    SSM_ENGINE_CAP, launches, chunk=chunk, lookahead=(4,))
                want = [_plain_engine_tokens(torch, c32, p32, p, g,
                                             SSM_ENGINE_CAP, chunk)
                        for p, g in few]
                if got["tokens"] != want:
                    raise AssertionError(
                        f"{tag} {arch} f32 engine (chunks {chunk}): "
                        f"{got['tokens']} vs the plain path's {want}")
                res[f"f32 chunk {chunk}"] = got
            print(f"{tag} {arch} f32 engine at {c32.n_layers} layers: every "
                  "request's tokens equal to the plain path's, whole and "
                  "chunked")
            del p32
        engines[arch] = res
        lap(f"engine {arch}")

    trains = {}
    for arch in SSM_ARCHS:
        cfg = dataclasses.replace(registry.get_config(arch),
                                  n_layers=SSM_F32_LAYERS[arch], remat="full")
        trains[arch] = _family_train(torch, tag, cfg, launches)
        lap(f"train {arch}")
    for row in rows:
        if launches.get(row["name"]):
            row["ssm_launches"] = launches[row["name"]]
    record["ssm"] = dict(static=out, engine=engines, train=trains,
                         launches=dict(launches), laps=laps)
    print(f"{tag} launches over the phase's runs: {dict(launches)}; {smi}")


def _stub_inputs(torch, cfg, B):
    """The zero stub input of a family's training batch, as the train CLI
    adds it: an encoder-decoder's frames, a VLM's patches (f32)."""
    if cfg.family == "encdec":
        return {"frames": torch.zeros((B, cfg.encoder_seq, cfg.d_model),
                                      device="cuda")}
    if cfg.family == "vlm":
        return {"patches": torch.zeros((B, cfg.n_patches, cfg.d_model),
                                       device="cuda")}
    return {}


def _f32_grad_check(torch, tag, cfg, batch):
    """One packed-QAT step's loss and gradients of `cfg` in f32 (its depth)
    on `batch`, on the kernel path against the plain path: the loss
    within F32_RTOL, every gradient within GRAD_RTOL of its max|plain|;
    the global gradient norms of both printed.  Returns the figures."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.models.model import init_params, stack_layers

    c32 = dataclasses.replace(cfg, dtype="float32", quant=QuantConfig(
        mode="vp", qat_mode="packed"))
    gc.collect()
    torch.cuda.empty_cache()
    params = stack_layers(init_params(c32, seed=0, device="cuda"), c32)
    got = _train_grads(torch, params, batch, c32)
    want = _train_grads(torch, params, batch, c32, plain=True)
    loss_rel, rels = _grad_diffs(torch, got, want)
    worst = max(rels, key=rels.get)
    norms = [math.sqrt(sum(float(g.double().pow(2).sum())
                           for g in grads.values())) for _, grads in (got, want)]
    print(f"{tag} {c32.name} f32 train step, {c32.n_layers} layers, kernel "
          f"vs plain path: loss {got[0]:.6f} / {want[0]:.6f} (rel diff "
          f"{loss_rel:.3e}, limit {F32_RTOL:g}); max gradient diff / "
          f"max|plain grad| {rels[worst]:.3e} at {worst} (limit "
          f"{GRAD_RTOL:g}); gradient norms {norms[0]:.6g} / {norms[1]:.6g}")
    if loss_rel > F32_RTOL or rels[worst] > GRAD_RTOL:
        raise AssertionError(f"{tag} {c32.name} f32 train step: loss "
                             f"{loss_rel:.3e}, gradients {rels}")
    return dict(loss=got[0], plain_loss=want[0], loss_rel=loss_rel,
                grad_rel=rels, grad_norms=norms)


def _family_train(torch, tag, cfg, launches, batch=SSM_TRAIN):
    """One packed-QAT step (VP gradients, VP moments) of `cfg` (its
    depth, dtype and remat as given), SyntheticLM batch x seq of `batch`
    with the zero stub input its family takes (an encoder-decoder's
    frames, a VLM's patches, as the train CLI adds them), twice: loss,
    seconds of the second step, peak memory, launches of the quant,
    serving and dx kernels."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.models.model import init_params, stack_layers
    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    from repro_torch.train.compression import (CompressionConfig,
                                               init_compressor_state)
    from repro_torch.train.train_step import make_train_step

    B, S = batch
    gc.collect()   # earlier runs' engines and graphs hold device memory
    torch.cuda.empty_cache()
    params = stack_layers(init_params(cfg, seed=0, device="cuda"), cfg)
    opt_cfg = OptConfig(lr=1e-4, warmup_steps=1, total_steps=4,
                        moment_codec="vp")
    step = make_train_step(cfg, opt_cfg,
                           compress_grads=CompressionConfig(codec="vp"),
                           qat=QuantConfig(mode="vp", qat_mode="packed"))
    opt, cmp = init_opt_state(params, opt_cfg), init_compressor_state(params)
    data = SyntheticLM(DataConfig(cfg.vocab, S, B, seed=0), device="cuda")
    stub = _stub_inputs(torch, cfg, B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(2):
        build.reset_launches()
        t0 = time.perf_counter()
        # -- the main path: one train step --------------------------------------
        params, opt, m, cmp = step(params, opt, {**data.batch_at(i), **stub},
                                   cmp)
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)
        # -------------------------------------------------------------------
        steps.append(dict(loss=float(m["loss"]), seconds=time.perf_counter()
                          - t0, grad_norm=float(m["grad_norm"])))
        if not math.isfinite(steps[-1]["loss"]):
            raise AssertionError(f"{tag} {cfg.name} train: non-finite loss")
    peak = torch.cuda.max_memory_allocated()
    _need(f"{tag} {cfg.name} train", counts, {
        "vp_dequant_matmul": 1, "vp_matmul_dx": 1, "vp_qp_table": 1})
    launches.update(counts)
    print(f"{tag} {cfg.name} train, {cfg.n_layers} layers at full width, "
          f"{cfg.dtype}, remat {cfg.remat}, packed QAT, VP gradients and "
          f"moments, {B} x {S} tokens"
          + (f" + {cfg.n_patches} patches" if "patches" in stub else "")
          + (f", {cfg.encoder_seq} frames" if "frames" in stub else "")
          + f": losses {[s['loss'] for s in steps]}, grad norms "
          f"{[round(s['grad_norm'], 4) for s in steps]}, "
          f"{steps[1]['seconds']:.3f} s/step (first {steps[0]['seconds']:.3f}"
          f" s), peak memory {peak / 1e9:.3f} GB; launches {counts}")
    del params, opt, cmp
    return dict(steps=steps, peak_bytes=peak, launches=counts,
                layers=cfg.n_layers, batch=[B, S])


def _ed_kernel_rows(torch, peaks, record, rows):
    """The kernels at the shapes whisper-tiny and internvl2-1b give them,
    timed as phase 3 times them (median of 20, L2 flushed) beside bound,
    plain version and library call, each held against its plain version
    and bit-identical across two launches: `flash_prefill` at pattern
    "full", the first launches of that pattern on the card (whisper's
    encoder, S 1500, not a multiple of any tile: the last key tile
    masked; its cross-attention prefill, Sq 128 against Sk 1500; bf16 on
    the tensor-core body within BF16_TOL, beside SDPA without a mask; one
    f32 case on the CUDA-core body within F32_RTOL), and causal at
    internvl2's 256 patches + 128 tokens (G 7; `_flash_row`); `qdot` of
    weights exported at each shape of ED_DQMM (`_qdot_row`: the
    tensor-core body at M 6000 and 1024, the skinny body at both lm_heads,
    whose int16 rows of 51865 and 151655 words are not 16-byte aligned,
    in bf16 and f32 x); `vp_decode_attention` at whisper's decoder (G 1,
    dh 64) in int16 and int8 words (`_decode_row`)."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.models.layers import quantize_weight

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    timer = Timer(torch)
    q = QuantConfig(mode="vp")
    by_name = {r["name"]: r for r in rows}
    out = []

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def add(name, entry):
        by_name[name].setdefault("encdec_vlm_shapes", []).append(entry)
        out.append(dict(entry, name=name))

    sass = record["attention_sass"]
    for shape, dtype in ([(c, torch.bfloat16) for c in ED_FLASH]
                         + [(ED_FLASH_F32, torch.float32)]):
        add("flash_prefill", _flash_row(
            torch, peaks, timer, randn, shape, dtype, sass,
            f"[ed kernel] flash_prefill {list(shape)} {str(dtype)[6:]}"))
    for M, K, N, name in ED_DQMM:
        w = quantize_weight((randn(K, N) * 0.02).to(torch.bfloat16), q)
        aligned = "not " if (2 * N) % 16 else ""
        for xdt in ((torch.bfloat16, torch.float32) if M <= 4
                    else (torch.bfloat16,)):
            add("vp_dequant_matmul", dict(_qdot_row(
                torch, peaks, timer, randn, w, M, xdt,
                f"[ed kernel] {name} {[M, K, N]} {str(xdt)[6:]} x"
                + (f" (rows of {N} int16 words: {aligned}16-byte aligned)"
                   if M <= 4 else "")), weight=name))
        del w
    for w_bytes in (2, 1):
        add("vp_decode_attention", _decode_row(
            torch, peaks, timer, gen, randn, w_bytes, ED_DEC_SHAPE,
            f"[ed kernel] vp_decode_attention {list(ED_DEC_SHAPE)} "
            f"int{8 * w_bytes}"))
    record["encdec_vlm_kernels"] = out


def _ed_static(torch, tag, arch, launches, record):
    """One family whole through the static serve CLI at full width, bf16,
    `--quant vp --kv-quant`, batch x prompt x steps of ED_SERVE (whisper:
    its random frames encoded first; internvl2: 256 zero patches
    prefilled before the prompt): encode, prefill and decode times,
    tokens/s, peak memory and launches by kernel, exact where the path
    fixes them (every prefill attention, the encoder's and the cross
    prefill's included, one launch of the tensor-core body per layer, no
    CUDA-core launch; one split decode launch per layer and step; the KV
    writes); the logits finite and a second run from the same params and
    inputs with the same tokens; the run's own decoder weights, lm_head
    and KV writes at its shapes against their plain versions
    (`_dense_shapes`).  Then an f32 run of the CLI (batch 4, prompt 16, 4
    steps; internvl2 at ED_CUT layers) whose greedy tokens equal the
    plain path's on the card."""
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    B, S, steps = ED_SERVE
    run, seen = serve.run_static, {}

    def held(params, cfg, prompts, gen, *a, **kw):
        tokens, logits = run(params, cfg, prompts, gen, *a, **kw)
        seen.update(params=params, cfg=cfg, prompts=prompts, logits=logits,
                    stub=kw)
        return tokens, logits

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    serve.run_static = held
    try:
        # -- the main path: the serve CLI ------------------------------------
        report = serve.main([
            "--arch", arch, "--quant", "vp", "--kv-quant", "--batch", str(B),
            "--prompt-len", str(S), "--gen", str(steps)])
        counts = dict(build.LAUNCHES)
        # -------------------------------------------------------------------
    finally:
        serve.run_static = run
    peak = torch.cuda.max_memory_allocated()
    cfg = seen["cfg"]
    L = cfg.n_layers
    prefills = L + (cfg.encoder_layers + L if cfg.family == "encdec" else 0)
    exact = {"flash_tc": prefills, "vp_dec_split": L * steps,
             "vp_qp_kv": 2 * L * (steps + 1)}
    if {k: counts.get(k, 0) for k in exact} != exact:
        raise AssertionError(f"{tag} {arch}: launches {counts}, want {exact}")
    _need(f"{tag} {arch}", counts, {"vp_dqmm_skinny": 1, "vp_dqmm_tc": 1})
    _no_cuda_core_prefill(f"{tag} {arch}", counts)
    for lg in seen["logits"]:
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{tag} {arch}: non-finite logits")
    again, _ = run(seen["params"], cfg, seen["prompts"], steps, {},
                   **seen["stub"])
    if again.tolist() != report["tokens"]:
        raise AssertionError(f"{tag} {arch}: a second run gave other tokens")
    print(f"{tag} {arch}: all {L} layers at full width (d_model "
          f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}"
          + (f", {cfg.encoder_layers} encoder layers over {cfg.encoder_seq} "
             f"frames: encode {report['encode_s']:.4f}s"
             if cfg.family == "encdec" else
             f", {report['patches']} patches prefilled before the prompt")
          + f"), bf16, weights {report['weight_bytes'] / 1e9:.3f} GB, "
          f"export {report['export_s']:.3f}s, prefill {B}x{S} "
          f"{report['prefill_s']:.4f}s, decode {steps} steps "
          f"{report['decode_s']:.4f}s ({report['decode_s'] / steps * 1e3:.3f}"
          f" ms/step, {report['tokens_per_s']:.1f} tok/s), peak memory "
          f"{peak / 1e9:.3f} GB; a second run gave the same tokens; "
          f"launches {counts}")
    profiled = _ed_profile(torch, f"{tag} {arch}", seen)
    _dense_shapes(torch, f"{tag} {arch}", cfg, seen["params"], B, S, record)
    seen.clear()
    launches.update(counts)
    cut = ["--layers", str(ED_CUT)] if cfg.family == "vlm" else []
    f32 = _format_cli(
        torch, f"{tag} {arch}",
        ["--arch", arch, *cut, "--quant", "vp", "--kv-quant", "--batch", "4",
         "--prompt-len", "16", "--gen", "4"],
        {"vp_dqmm_skinny": 1, "vp_dqmm_tc": 1, "flash_cuda_core": 1,
         "vp_dec_split": 1})
    return dict(report, launches=counts, peak_bytes=peak, f32=f32,
                profiled=profiled)


def _ed_profile(torch, tag, seen):
    """A profile (`_profile`: wall, device busy, idle share, top kernels)
    of the static run's prefill (whisper: of its encoding first) and of
    one decode step after it, from the run's own params and inputs; the
    library kernels in each trace printed (whisper's cross-attention
    decode step is plain PyTorch, as in the reference)."""
    from repro_torch.models.model import (cross_kv, decode_step,
                                          encoder_forward, init_cache,
                                          prefill)

    params, cfg, prompts = seen["params"], seen["cfg"], seen["prompts"]
    frames, patches = seen["stub"].get("frames"), seen["stub"].get("patches")
    B, S = prompts.shape
    P = 0 if patches is None else patches.shape[1]
    caches = init_cache(cfg, B, P + S + 1)
    runs, box = [], {}
    if frames is not None:
        def encode():
            with torch.no_grad():
                box["ckv"] = cross_kv(params, encoder_forward(
                    params, frames, cfg), cfg)
        encode()
        runs.append(("encode", encode))

    def prefill_once():   # rewrites slots [0, P + S) of the same buffers
        box["lg"], box["caches"] = prefill(params, prompts, caches, cfg,
                                           patches=patches,
                                           cross_kv=box.get("ckv"))

    prefill_once()
    tok = torch.argmax(box["lg"], -1).to(torch.int32)[:, None]
    runs += [("prefill", prefill_once),
             ("decode step", lambda: decode_step(
                 params, tok, box["caches"], cfg, cross_kv=box.get("ckv")))]
    out = {}
    for what, fn in runs:
        _, kernels = _profile(torch, f"{tag} {what}", fn)
        busy = sum(us for _, us in kernels)
        library = sorted({n.split("<")[0][:60] for n, _ in kernels
                          if LIBRARY_KERNELS.search(n)
                          and not any(v in n for v in KERNEL_NAMES.values())})
        print(f"{tag} {what}: library kernels in the trace: "
              f"{library or 'none'}")
        out[what] = dict(kernels=len(kernels), busy_ms=busy / 1e3,
                         library=library)
    return out


def encdec_vlm_phase(torch, record, rows, smi, peaks):
    """The encoder-decoder and VLM families at full width (`models.model`'s
    encoder, cross-attention and patch paths):

    (a) the kernels at their shapes (`_ed_kernel_rows`): the flash
        prefill's full pattern and Sq != Sk, the tensor-core matmul at the
        encoder's M 6000, the skinny body on unaligned lm_head rows;
    (b) whisper-tiny (4 + 4 layers, 1500 frames) and internvl2-1b (24
        layers, 256 patches) whole through the static serve CLI, bf16,
        then in f32 (whisper whole, internvl2 at ED_CUT layers) against
        the plain path's tokens (`_ed_static`);
    (c) internvl2 through the engine, text-only as the reference's engine
        serves it, bf16, whole: SSM_ENGINE_REQS ragged requests (numpy
        seed 0), SSM_ENGINE_SLOTS slots, capacity SSM_ENGINE_CAP, graphs
        at run-ahead 4 and 1 with the same tokens, each graph's first
        replay bit-identical to its eager step;
    (d) one packed-QAT train step, VP gradients and VP moments, on
        whisper whole and internvl2 at ED_CUT layers, batch x seq of
        ED_TRAIN with zero frames / patches: loss, seconds per step (the
        second of two), peak memory; then one f32 step's loss and
        gradients there against the plain path (`_f32_grad_check`)."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.configs.base import QuantConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import init_params, quantize_params

    tag = "[ed]"
    laps, t_lap = {}, [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        laps[what] = now - t_lap[0]
        t_lap[0] = now
        print(f"[time] ed {what}: {laps[what]:.2f}s")

    _ed_kernel_rows(torch, peaks, record, rows)
    lap("kernels")
    out, launches = {}, collections.Counter()
    for arch in ED_ARCHS:
        out[arch] = _ed_static(torch, tag, arch, launches, record)
        lap(f"static {arch}")

    n, (lo, hi), (g_lo, g_hi) = SSM_ENGINE_REQS
    rng = np.random.default_rng(0)
    plens = rng.integers(lo, hi + 1, n)
    gens = rng.integers(g_lo, g_hi + 1, n)
    cfg = registry.get_config("internvl2-1b",
                              QuantConfig(mode="vp", quantize_kv_cache=True))
    reqs = [([int(t) for t in rng.integers(0, cfg.vocab, int(s))], int(g))
            for s, g in zip(plens, gens)]
    torch.cuda.empty_cache()
    params = quantize_params(init_params(cfg, seed=0, device="cuda"), cfg)
    engine = _family_engine(torch, f"{tag} internvl2-1b engine", cfg, params,
                            reqs, SSM_ENGINE_CAP, launches)
    del params
    gc.collect()
    lap("engine internvl2-1b")

    trains = {}
    for arch in ED_ARCHS:
        cfg = registry.get_config(arch)
        if cfg.family == "vlm":
            cfg = dataclasses.replace(cfg, n_layers=ED_CUT)
        trains[arch] = _family_train(torch, tag, cfg, launches, ED_TRAIN)
        B, S = ED_TRAIN
        batch = {**SyntheticLM(DataConfig(cfg.vocab, S, B, seed=0),
                               device="cuda").batch_at(0),
                 **_stub_inputs(torch, cfg, B)}
        trains[arch]["f32"] = _f32_grad_check(torch, tag, cfg, batch)
        lap(f"train {arch}")
    for row in rows:
        if launches.get(row["name"]):
            row["encdec_vlm_launches"] = launches[row["name"]]
    record["encdec_vlm"] = dict(static=out, engine=engine, train=trains,
                                launches=dict(launches), laps=laps)
    print(f"{tag} launches over the phase's runs: {dict(launches)}; {smi}")


# ---------------------------------------------------------------------------
# 5b. the Sec. II-D search on the card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def isolated_plan_cache():
    """Point the plan cache (`kernels.autotune`) at a fresh file for the
    block, then drop it and restore the variable: what the block reads is
    what it wrote, and nothing is left behind."""
    from repro_torch.kernels import autotune

    old = os.environ.get(CACHE_ENV)
    with tempfile.TemporaryDirectory() as d:
        os.environ[CACHE_ENV] = os.path.join(d, "autotune.json")
        autotune.clear_cache()
        try:
            yield os.environ[CACHE_ENV]
        finally:
            autotune.clear_cache()
            if old is None:
                os.environ.pop(CACHE_ENV, None)
            else:
                os.environ[CACHE_ENV] = old


def _try(fn, *a, **kw):
    """fn's result, or the type of the ValueError / TypeError it raised."""
    try:
        return fn(*a, **kw)
    except (ValueError, TypeError) as e:
        return type(e)


def _same_search(what, got, want):
    if isinstance(want, type) or want is None:
        if got is not want:
            raise AssertionError(f"{what}: card {got} vs CPU {want}")
        return
    if repr(got[0]) != repr(want[0]) or \
            abs(got[1] - want[1]) > SEARCH_RTOL * abs(want[1]):
        raise AssertionError(f"{what}: card {got} vs CPU {want}")


def search_phase(torch, record, rows, peaks):
    """The paper's Sec. II-D exponent-list search on the card
    (`WidebandCalibrator.search_vp_format`, `core.param_search`): every
    subcarrier of a wideband band (SEARCH_BAND, torch seed 5, 20 dB)
    through the planes quantize kernel and the planes dequant kernel, one
    launch of each per candidate list and no plain version run (the
    counted path); the same search on the CPU (the plain versions) on the
    same arrays: the same formats and each format's NMSE within
    SEARCH_RTOL; `search_min_M` at E 2 and E 3 and one forced greedy
    search (lists padded with repeated exponents) against the CPU; the
    kernels timed at the search's (rows, 64) tile; the Fig. 11 ratios of
    the equalizer CLI."""
    from repro_torch.core import param_search
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch.equalize import fig11
    from repro_torch.mimo.channel import ChannelConfig
    from repro_torch.mimo.equalizer import table1_specs
    from repro_torch.mimo.ofdm import (
        OFDMConfig, WidebandCalibrator, make_wideband_ensemble)

    S, n = SEARCH_BAND
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    w = make_wideband_ensemble(gen, ChannelConfig(), OFDMConfig(S, 4), n,
                               20.0).w_beam
    w_cpu = w.cpu()
    bvp = next(s for s in table1_specs() if s.name == "B-VP")
    fxp, vp = bvp.w_fxp, bvp.w_vp
    cands = len(param_search.candidate_lists(fxp, vp.M, vp.E))
    card, host = WidebandCalibrator(bvp), WidebandCalibrator(bvp)
    plain = collections.Counter()
    real = {name: getattr(ref, name) for name in ("vp_quant_ref",
                                                  "vp_dequant_ref")}

    def counted(name):
        def run(*a, **kw):
            plain[name] += 1
            return real[name](*a, **kw)
        return run

    torch.cuda.synchronize()
    build.reset_launches()
    for name in real:
        setattr(ref, name, counted(name))
    try:
        # -- the path: every subcarrier's search on the card --------------
        t0 = time.perf_counter()
        fmts = [card.search_vp_format(s, w[s]) for s in range(S)]
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        counts = dict(build.LAUNCHES)
        # -----------------------------------------------------------------
    finally:
        for name, fn in real.items():
            setattr(ref, name, fn)
    expect = {"vp_quant_planes": S * cands, "vp_qpl_table": S * cands,
              "vp_dequant_planes": S * cands}
    print(f"[search] {S} subcarriers x {cands} candidate lists of {vp.M}, "
          f"E {vp.E} on {fxp}: launches {counts}, plain versions run "
          f"{dict(plain)}; {card_s:.3f}s, {card_s / S * 1e3:.3f} ms per "
          "subcarrier")
    if counts != expect or plain:
        raise AssertionError(f"search launches {counts} != {expect}, or a "
                             f"plain version ran: {dict(plain)}")
    t0 = time.perf_counter()
    host_fmts = [host.search_vp_format(s, w_cpu[s]) for s in range(S)]
    host_s = time.perf_counter() - t0
    if [repr(f) for f in fmts] != [repr(f) for f in host_fmts]:
        raise AssertionError(f"card formats {fmts} != CPU {host_fmts}")
    worst = 0.0
    for s in range(S):
        xs = WidebandCalibrator.search_samples(w[s])
        xh = WidebandCalibrator.search_samples(w_cpu[s])
        if not torch.equal(xs.cpu(), xh):
            raise AssertionError(f"subcarrier {s}: samples differ")
        a = param_search.vp_nmse(xs, fxp, fmts[s])
        b = param_search.vp_nmse(xh, fxp, fmts[s])
        worst = max(worst, abs(a - b) / b)
    if worst > SEARCH_RTOL:
        raise AssertionError(f"NMSE card vs CPU {worst:.3e} > {SEARCH_RTOL}")
    print(f"[search] formats equal to the CPU's on every subcarrier "
          f"({sorted({repr(f) for f in fmts})}); NMSE card vs CPU within "
          f"{worst:.3e} relative; the CPU's search {host_s:.3f}s")
    xs, xh = (WidebandCalibrator.search_samples(t[0]) for t in (w, w_cpu))
    checks = {}
    for E, target in SEARCH_MIN_M:
        got = _try(param_search.search_min_M, xs, fxp, E, target)
        _same_search(f"search_min_M E {E}", got,
                     _try(param_search.search_min_M, xh, fxp, E, target))
        checks[f"min_M E{E} {target:g}"] = repr(got)
    M, E = SEARCH_GREEDY
    build.reset_launches()
    got = param_search.search_exponent_list(xs, fxp, M, E, max_exhaustive=0)
    greedy = dict(build.LAUNCHES)
    _same_search("greedy search", got, param_search.search_exponent_list(
        xh, fxp, M, E, max_exhaustive=0))
    checks["greedy"] = repr(got)
    print(f"[search] search_min_M and the greedy search (M {M}, E {E}; "
          f"{greedy.get('vp_quant_planes', 0)} candidate lists, padded "
          f"with repeated exponents) equal to the CPU's: {checks}")

    # -- the kernels at the search's tile ----------------------------------
    timer = Timer(torch)
    tile = param_search._prepare(xs, None).tile
    m, i = ops.vp_quant(tile, fxp, fmts[0])
    mh, ih = ref.vp_quant_ref(tile, fxp, fmts[0])
    _identical(torch, m, mh, "search tile planes (significands)")
    _identical(torch, i, ih, "search tile planes (indices)")
    _identical(torch, ops.vp_dequant(m, i, fmts[0]),
               ref.vp_dequant_ref(m, i, fmts[0]), "search tile dequant")
    nel = tile.numel()
    by_name, shapes = {r["name"]: r for r in rows}, []
    for name, fn, plain_fn, nbytes in (
            ("vp_quant_planes", lambda: ops.vp_quant(tile, fxp, fmts[0]),
             lambda: ref.vp_quant_ref(tile, fxp, fmts[0]), nel * (4 + 2)),
            ("vp_dequant_planes", lambda: ops.vp_dequant(m, i, fmts[0]),
             lambda: ref.vp_dequant_ref(m, i, fmts[0]), nel * (2 + 4))):
        ms, plain_ms = timer(fn), timer(plain_fn)
        bnd = bound(peaks, nbytes, 0, "f32")
        _print_line(name, list(tile.shape), 0.0, 0.0, ms, plain_ms, bnd, None)
        shapes.append(dict(name=name, shape=list(tile.shape),
                           launches=counts[name], ms=ms, plain_ms=plain_ms,
                           bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                           max_abs_err=0.0))
        if name in by_name:
            by_name[name].setdefault("search_shapes", []).append(shapes[-1])
    fig = fig11()
    print(f"[search] Fig. 11 (launch.equalize): area B-FXP/A-FXP "
          f"{fig['area_bfxp_afxp']:.2f}, B-VP/B-FXP {fig['area_bvp_bfxp']:.2f};"
          f" power B-VP/B-FXP {fig['power_bvp_bfxp']:.2f} (muting "
          f"{fig['muting_rate']}); FLP/VP CMAC array {fig['flp_vp_cmac']:.2f}")
    record["search"] = dict(
        band=list(SEARCH_BAND), candidates=cands, launches=counts,
        card_s=card_s, ms_per_subcarrier=card_s / S * 1e3, cpu_s=host_s,
        formats=sorted({repr(f) for f in fmts}), nmse_rel=worst,
        checks=checks, fig11=fig, shapes=shapes)


# ---------------------------------------------------------------------------
# 9. the measured plan cache (`--tune-decode`)
# ---------------------------------------------------------------------------

def _tuned_skinny(torch, peaks, timer, gen, K, N, vp, plan):
    """The skinny body on random words (K, N) at the serve's decode rows
    under the heuristic's split and the tuned one: ms at M = 1, 2 and
    BATCH (L2 flushed), the tuned plan within BF16_TOL of the plain
    version, and rows 0..m of an M = m product bit-identical to those of
    the M = BATCH product under the tuned plan (the split fixes a row's
    sums; the rows a block follow M)."""
    from repro_torch.core.packing import dequant_words, storage_dtype
    from repro_torch.kernels import ref
    from repro_torch.kernels.vp_dequant_matmul import (
        plan_skinny, vp_dequant_matmul_cuda)

    bf16 = torch.bfloat16
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    w = torch.randint(-8, 8, (K, N), generator=gen, device="cuda",
                      dtype=torch.int32).to(storage_dtype(vp))
    x = torch.randn((BATCH, K), generator=gen, device="cuda").to(bf16)
    h = plan_skinny(BATCH, K, N, num_sms)
    heur = (h.split, h.k_per)

    def run(m, p):
        return vp_dequant_matmul_cuda(x[:m], w, vp, bf16, body="skinny",
                                      plan=p)

    full = run(BATCH, plan)
    err, rel = compare(torch, full, ref.vp_dequant_matmul_ref(x, w, vp, bf16),
                       BF16_TOL, f"[tune] skinny {[BATCH, K, N]} {plan}")
    for m in range(1, BATCH):
        _identical(torch, run(m, plan), full[:m],
                   f"[tune] skinny {[K, N]} {plan}: rows at M {m} and "
                   f"{BATCH}")
    plans = (("heuristic", heur), ("tuned", plan))
    ms = {name: {m: timer(lambda: run(m, p)) for m in (1, 2, BATCH)}
          for name, p in plans}

    def retime():
        """(heuristic, tuned) ms summed over M, each the median of
        TUNE_TURNS readings taken in turns."""
        got = {name: [] for name, _ in plans}
        for _ in range(TUNE_TURNS):
            for name, p in plans:
                got[name].append(sum(timer(lambda: run(m, p))
                                     for m in (1, 2, BATCH)))
        return tuple(statistics.median(got[name]) for name, _ in plans)
    plain_ms = timer(lambda: ref.vp_dequant_matmul_ref(x, w, vp, bf16))
    w_deq = dequant_words(w, vp, torch.float32).to(bf16)
    library_ms = timer(lambda: torch.matmul(x, w_deq))
    bnd = bound(peaks, BATCH * K * 2 + K * N * w.element_size()
                + BATCH * N * 2, 2 * BATCH * K * N, "bf16")
    return dict(kernel="vp_dqmm_skinny", shape=[BATCH, K, N],
                heuristic=list(heur), tuned=list(plan),
                heuristic_ms=ms["heuristic"], tuned_ms=ms["tuned"],
                ms=ms["tuned"][BATCH], plain_ms=plain_ms, bound_ms=bnd[0],
                bound_by=bnd[1], library_ms=library_ms, max_abs_err=err,
                retime=retime)


def _tuned_decode(torch, peaks, timer, gen, dims, vp, plan):
    """The split decode body at the serve's batch over random cache words
    of a tuned geometry (KV, smax, G, dh, w_bytes, window, rolling) under
    the heuristic's (cluster, warps) and the tuned one: each within
    F32_RTOL (f32 q) and BF16_TOL (bf16 q) of the plain version, both
    timed (L2 flushed)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.vp_attention import (
        plan_decode, vp_decode_attention_cuda)
    from repro_torch.models.layers import canonical_formats
    from repro_torch.configs.base import QuantConfig

    KV, smax, G, dh, w_bytes, window, rolling = dims
    fxp, _ = canonical_formats(QuantConfig(mode="vp"))
    B, H = BATCH, KV * G
    k_w, v_w = (ops.vp_quant((torch.randn(
        (B, smax, KV, dh), generator=gen, device="cuda") * 0.3).clamp(
            -0.99, 0.99), fxp, vp, packed=True) for _ in range(2))
    k_s, v_s = (2.0 ** torch.randint(-3, 2, (B, smax, 1, 1), generator=gen,
                                     device="cuda").float() for _ in range(2))
    lengths = torch.tensor([smax, smax - 4, smax - 15, smax - smax // 3],
                           dtype=torch.int32, device="cuda")[:B]
    h = plan_decode(KV, smax, G, dh, w_bytes)
    heur = (h.cluster, h.warps)
    win = window or None
    out, runs = {}, {}
    for dt, tol in ((torch.float32, F32_RTOL), (torch.bfloat16, BF16_TOL)):
        q = torch.randn((B, 1, H, dh), generator=gen, device="cuda").to(dt)
        want = ref.vp_decode_attention_ref(q, k_w, v_w, k_s, v_s, lengths, vp,
                                           window=win, rolling=bool(rolling))
        for name, p in (("heuristic", heur), ("tuned", plan)):
            def run(q=q, p=p):
                return vp_decode_attention_cuda(
                    q.reshape(B, KV, G, dh), k_w, v_w, k_s, v_s, lengths, vp,
                    win, bool(rolling), dh ** -0.5, plan=p)
            err, _ = compare(torch, run().reshape(B, 1, H, dh), want, tol,
                             f"[tune] decode {list(dims)} {name} {p} {dt}")
            out[(name, dt)] = (err, timer(run))
            runs[(name, dt)] = run
    qd = torch.randn((B, 1, H, dh), generator=gen, device="cuda")
    plain_ms = timer(lambda: ref.vp_decode_attention_ref(
        qd, k_w, v_w, k_s, v_s, lengths, vp, window=win,
        rolling=bool(rolling)))
    valid = int(lengths.sum())
    bnd = bound(peaks, valid * KV * dh * w_bytes * 2 + valid * 2 * 4
                + 2 * B * H * dh * 2, 4 * valid * KV * G * dh, "f32")
    bf = torch.bfloat16

    def retime():
        """(heuristic, tuned) bf16 ms, each the median of TUNE_TURNS
        readings taken in turns."""
        got = {"heuristic": [], "tuned": []}
        for _ in range(TUNE_TURNS):
            for name in got:
                got[name].append(timer(runs[(name, bf)]))
        return tuple(statistics.median(v) for v in got.values())

    return dict(kernel="vp_dec_split", shape=[B] + list(dims),
                heuristic=list(heur), tuned=list(plan),
                heuristic_ms={"bf16": out[("heuristic", bf)][1],
                              "f32": out[("heuristic", torch.float32)][1]},
                tuned_ms={"bf16": out[("tuned", bf)][1],
                          "f32": out[("tuned", torch.float32)][1]},
                ms=out[("tuned", bf)][1], plain_ms=plain_ms, bound_ms=bnd[0],
                bound_by=bnd[1], library_ms=None,
                max_abs_err=out[("tuned", torch.float32)][0], retime=retime)


def _smem_against_build(torch):
    """Each instance of the two tuned bodies in the build report of the
    libraries loaded (`build.build_log`: this process's compile, or the
    report kept beside a library built before): its static shared memory
    equal to `analysis/smem.py`'s and its registers x the body's threads
    within the SM's file."""
    from repro_torch.analysis import smem
    from repro_torch.kernels import build

    logs = {name: build.build_log(name)
            for name in ("vp_dequant_matmul", "vp_attention")}
    missing = [name for name, log in logs.items() if log is None]
    if missing:
        raise AssertionError(f"no build report of {missing}")
    nbytes = {"int8": 1, "int16": 2, "int32": 4}
    seen = {}
    for name, log in logs.items():
        for inst, (regs, static) in smem.parse_build_log(log).items():
            kernel, args = inst[:-1].split("<")
            args = args.split(",")
            if kernel == "vp_dequant_matmul_skinny_kernel":
                model = smem.skinny_launch(int(args[0]), 1, nbytes[args[1]])
            elif kernel == "vp_decode_attention_split_kernel":
                model = smem.decode_launch(1, smem.DEC_MAX_WARPS,
                                           int(args[1]), 64,
                                           nbytes[args[0]], int(args[2]))
            else:
                continue
            if model.instance != inst or model.static_smem != static or \
                    smem.problems(model, registers=regs):
                raise AssertionError(
                    f"{inst}: build {static} bytes static, {regs} registers; "
                    f"the model {model}, {smem.problems(model, registers=regs)}")
            seen[inst] = dict(registers=regs, static_smem=static)
    if sum(k.startswith("vp_dequant") for k in seen) != 15 or \
            not any(k.startswith("vp_decode") for k in seen):
        excerpt = [line for line in logs["vp_attention"].splitlines()
                   if "ptxas" in line][:12]
        raise AssertionError(f"instances in the build report: {sorted(seen)}"
                             f"; its first lines: {excerpt}")
    print(f"[tune] analysis/smem.py against the build report: "
          f"{len(seen)} instances, static shared memory equal, registers x "
          "threads within 65,536: " + "; ".join(
              f"{k} {v['registers']} regs {v['static_smem']} B"
              for k, v in sorted(seen.items())))
    return seen


def _oversized(torch):
    """A skinny split over 16 blocks: the model refuses it (a cluster past
    the portable 8) and the C entry refuses its launch."""
    import ctypes

    from repro_torch.analysis import smem
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import build
    from repro_torch.models.layers import canonical_formats

    _, vp = canonical_formats(QuantConfig(mode="vp"))
    M, K, N, split = BATCH, 1024, 1024, 16
    k_per = K // split
    ok, launch = smem.plan_feasible("vp_dqmm_skinny", (split, k_per), (K, N),
                                    (vp,))
    if ok:
        raise AssertionError(f"the model admits {launch}")
    x = torch.zeros((M, K), dtype=torch.bfloat16, device="cuda")
    w = torch.zeros((K, N), dtype=torch.int16, device="cuda")
    out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
    lib = build.library("vp_dequant_matmul")
    err = lib.vp_dqmm_skinny_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N, 1, 2, 1, 4,
        split, k_per, ctypes.byref(build.vp_fmt_struct(vp, x.device)),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err == 0:
        raise AssertionError("the C entry launched a cluster of 16 blocks")
    msg = lib.vp_error_string(err).decode()
    print(f"[tune] oversized skinny plan (split {split}, k_per {k_per}): the "
          f"model refuses it ({smem.problems(launch)}); its launch through "
          f"the C entry fails with CUDA error {err} ({msg})")
    return dict(plan=[split, k_per], problems=smem.problems(launch),
                cuda_error=err, message=msg)


def tune_phase(torch, record, rows, smi, peaks):
    """`--tune-decode` on the serve CLI (`serving/profile.py`,
    `kernels/autotune.py`, `analysis/smem.py`) with a plan cache of its
    own (`isolated_plan_cache`): full-width qwen3-0.6b, bf16, `--quant vp
    --kv-quant`, batch 4 x 128, 32 steps, tuning the skinny
    `vp_dequant_matmul` body's split over every weight panel and the
    split decode body's (cluster, warps) over the cache geometry, then
    serving (the counted path).  A second run in the same process makes
    no new entry.  Every entry timed under the heuristic's plan and the
    tuned one (Timer), the tuned no slower beyond TUNE_NOISE (re-timed
    in turns before it fails), within
    tolerance of the plain version, and a skinny row's bits the same at
    M 1..4; an f32 run on the tuned cache gives the plain path's greedy
    tokens; the engine on it gives the same tokens at run-ahead 4 and 1,
    each graph's first replay bit-identical to its eager step; the build
    report's static shared memory and registers against the model; one
    oversized plan refused by the model and by the C entry."""
    from pathlib import Path

    from repro_torch.configs import registry
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import autotune, build
    from repro_torch.kernels.vp_attention import plan_decode
    from repro_torch.kernels.vp_dequant_matmul import plan_skinny
    from repro_torch.launch import serve
    from repro_torch.models.layers import canonical_formats
    from repro_torch.models.model import init_params, quantize_params

    _, vp = canonical_formats(QuantConfig(mode="vp"))
    out = {}
    with isolated_plan_cache() as path:
        torch.cuda.empty_cache()
        build.reset_launches()
        # -- the main path: the serve CLI, tuning first ----------------------
        report = serve.main(TUNE_ARGV + ["--tune-decode"])
        counts = dict(build.LAUNCHES)
        # ---------------------------------------------------------------------
        plans = autotune.entries()
        text = Path(path).read_text()
        print(f"[tune] {' '.join(TUNE_ARGV)} --tune-decode: "
              f"{report['tune_decode']['entries']} entries in "
              f"{report['tune_decode']['s']:.2f}s; decode "
              f"{report['decode_s'] / GEN * 1e3:.3f} ms/step; launches "
              f"{counts}")
        _need("[tune]", counts, {"vp_dqmm_skinny": 1, "vp_dec_split": 1,
                                 "vp_qp_kv": 1, "flash_tc": 1})
        if report["tune_decode"]["entries"] != len(plans) or not plans:
            raise AssertionError(f"profile {report['tune_decode']} vs the "
                                 f"cache's {len(plans)} entries")
        again = serve.main(TUNE_ARGV + ["--tune-decode"])
        if autotune.entries() != plans or Path(path).read_text() != text:
            raise AssertionError("a second --tune-decode run changed the "
                                 "cache")
        print(f"[tune] a second run in the process: the same {len(plans)} "
              f"entries, no new one ({again['tune_decode']['s']:.3f}s)")

        timer, gen = Timer(torch), torch.Generator(device="cuda")
        gen.manual_seed(9)
        entries = []
        for key, plan in sorted(plans.items()):
            kernel, dims, fmts, backend, mesh = key.split("|")
            dims = tuple(int(d) for d in dims.split("x"))
            if fmts != repr(vp) or mesh != "mesh=1" or \
                    backend != torch.cuda.get_device_name(0):
                raise AssertionError(f"unexpected key {key}")
            if kernel == "vp_dqmm_skinny":
                e = _tuned_skinny(torch, peaks, timer, gen, *dims, vp, plan)
                heur = sum(e["heuristic_ms"].values())
                tuned = sum(e["tuned_ms"].values())
                sp = plan_skinny(BATCH, *dims, torch.cuda.get_device_properties(0)
                                 .multi_processor_count, None, vp, 0)
                if (sp.split, sp.k_per) != plan:
                    raise AssertionError(f"{key}: the wrapper resolves "
                                         "another split")
            else:
                e = _tuned_decode(torch, peaks, timer, gen, dims, vp, plan)
                heur, tuned = e["heuristic_ms"]["bf16"], e["tuned_ms"]["bf16"]
            e["launches"] = counts.get(kernel, 0)
            entries.append(e)
            print(f"[tune] {kernel} {e['shape']}: heuristic {e['heuristic']} "
                  f"{e['heuristic_ms']} ms, tuned {e['tuned']} "
                  f"{e['tuned_ms']} ms; bound {e['bound_ms']:.4f} "
                  f"({e['bound_by']}), plain {e['plain_ms']:.4f}, library "
                  f"{e['library_ms']}")
            retime = e.pop("retime")
            if tuned > heur * TUNE_NOISE[0] + TUNE_NOISE[1]:
                heur, tuned = e["retimed"] = retime()
                print(f"[tune] {kernel} {e['shape']}: re-timed in "
                      f"{TUNE_TURNS} turns, heuristic {heur:.4f} ms, tuned "
                      f"{tuned:.4f}")
                if tuned > heur * TUNE_NOISE[0] + TUNE_NOISE[1]:
                    raise AssertionError(f"{key}: tuned {tuned:.4f} ms "
                                         f"slower than the heuristic's "
                                         f"{heur:.4f}")
        by_name = {r["name"]: r for r in rows}
        for e in entries:
            name = ("vp_dequant_matmul" if e["kernel"] == "vp_dqmm_skinny"
                    else "vp_decode_attention")
            if name in by_name:
                by_name[name].setdefault("tune_shapes", []).append(e)

        f32 = _format_cli(torch, "[tune]", TUNE_ARGV,
                          {"vp_dqmm_skinny": 1, "vp_dec_split": 1})
        cfg = registry.get_config(ARCH, QuantConfig(
            mode="vp", quantize_kv_cache=True))
        dplan = plan_decode(cfg.n_kv_heads, ENGINE_CAP,
                            cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, 2,
                            None, None, False, vp, 0)
        params = quantize_params(init_params(cfg, seed=0, device="cuda"), cfg)
        reqs = _engine_requests(cfg, ENGINE_REQS)
        tokens = {}
        for la in ENGINE_LOOKAHEAD:
            eng = _engine(cfg, params, decode_lookahead=la)
            recs, wall, calls, ran = _engine_wave(torch, eng, reqs)
            _check_graph_log(eng.runner, f"[tune] engine run-ahead {la}:")
            tokens[la] = [r["tokens"] for r in recs]
            out[f"engine_run_ahead_{la}"] = dict(
                wall_s=wall, launches=ran, **_decode_rates(recs, calls))
            del eng
        if len({str(t) for t in tokens.values()}) != 1:
            raise AssertionError("engine tokens differ between run-ahead "
                                 f"{ENGINE_LOOKAHEAD} on the tuned cache")
        print(f"[tune] engine on the tuned cache (decode plan {dplan}): "
              f"{ENGINE_REQS} requests, the same tokens at run-ahead "
              f"{ENGINE_LOOKAHEAD}")
        del params
        torch.cuda.empty_cache()
    out.update(smem=_smem_against_build(torch), oversized=_oversized(torch))
    record["tune"] = dict(out, launches=counts, plans={
        k: list(v) for k, v in plans.items()}, entries=entries,
        tune_s=report["tune_decode"]["s"],
        decode_ms_per_step=report["decode_s"] / GEN * 1e3,
        f32_tokens_equal=True, f32_launches=f32["launches"])


def dequant_phase(torch, record, rows):
    """The public op `ops.vp_dequant` on the card: the packed words of
    one weight panel into f32 and bf16, the MIMO W planes (int8
    significands) into f32 and the planes of a weight panel in VP(10, E 2)
    (int16 significands) into bf16, each once, checked against the op's
    plain path."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.formats import default_vp_format
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
    vp10 = default_vp_format(fxp, 10, 2)
    m16, i16 = ops.vp_quant((torch.randn(DEQUANT_PACKED, generator=gen,
                                         device="cuda") * 0.3).clamp(
        -0.99, 0.99), fxp, vp10)
    calls = {"packed f32": lambda: ops.vp_dequant(words, None, vp),
             "packed bf16": lambda: ops.vp_dequant(words, None, vp,
                                                   torch.bfloat16),
             "planes f32": lambda: ops.vp_dequant(m, i, wv),
             "planes int16 bf16": lambda: ops.vp_dequant(m16, i16, vp10,
                                                         torch.bfloat16)}
    torch.cuda.synchronize()
    build.reset_launches()
    # -- the path: the public op, once per call --------------------------------
    outs = {what: fn() for what, fn in calls.items()}
    counts = dict(build.LAUNCHES)
    # -------------------------------------------------------------------------
    expect = {"vp_dequant_packed": 2, "vp_dequant_planes": 2}
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
          f"bf16), planes {list(DEQUANT_PLANES)} (int8, f32) and "
          f"{list(DEQUANT_PACKED)} ({m16.dtype}, bf16): bit-identical to the "
          "plain path")
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
            x.numel(), ctypes.byref(build.quant_fmt_struct(f_, v_, m.device)), code,
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
    out = torch.empty((G, M, N), dtype=torch.float32, device="cuda")
    qa = build.quant_fmt_struct(wf, wv, out.device)
    qb = build.quant_fmt_struct(yf, yv, out.device)

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

@functools.lru_cache(maxsize=None)
def _sass(lib_path: Path, nvcc: str) -> str:
    """The SASS of a built library, from the cuobjdump beside `nvcc` (the
    toolkit that built it); dumped once per library and run."""
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    if not cuobjdump.exists():
        raise RuntimeError(f"no cuobjdump beside {nvcc}: cannot show the "
                           "tensor cores in the SASS")
    return subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout


def _sass_counts(lib_path: Path, nvcc: str, opcode: str = "HGMMA"):
    """{kernel symbol: count of `opcode` in its SASS} (`_sass`)."""
    sass = _sass(lib_path, nvcc)
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
    f_c = build.vp_fmt_struct(vp, torch.device("cuda", 0))
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
    step = _add(fwd, _qp(per_step, "table"), {"vp_matmul_dx": per_step},
                _norm_counts(cfg))
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
    params = stack_layers(init_params(cfg, seed=0, device="cuda"), cfg)
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
    f32 = _f32_grad_check(torch, "[train]", cfg, batch)
    p16 = stack_layers(init_params(cfg, seed=0, device="cuda"), cfg)
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
        f32_loss_rel=f32["loss_rel"], f32_grad_rel=f32["grad_rel"],
        bf16_loss_rel=loss_rel,
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


# ---------------------------------------------------------------------------
# 7c. mesh
# ---------------------------------------------------------------------------

# (M, K, N) of the op-level matmul modes: qwen3's decode w_up and gemma3's
# prefill w_up
MESH_DQMM = ((4, 1024, 3072), (2304, 5376, 21504))
MESH_BWD = (1024, 1024, 3072)        # dx / dw (M, K, N)
MESH_MOE_LAYERS = 2                  # qwen3-moe-30b-a3b cut 48 -> 2
MESH_ENGINE_LAYERS = 4               # the gloo engines' qwen3-0.6b, 28 -> 4
MESH_BLOCK = (4, 1024, 3072, 256)    # vp_block column shard: M, K, N, block
MESH_TIMEOUT_S = 180                 # a collective's longest wait
GLOO = "gloo via host, one card"     # the label of every gloo figure


def _greedy(torch, cfg, params, prompts, steps, fns):
    """Prefill `prompts`, then `steps` greedy decode steps through
    `fns` = (prefill(p, t, c), decode(p, t, c)) -> (logits (steps + 1,
    B, V) f32 on the host, tokens (B, steps + 1), prefill s, decode ms
    per step)."""
    from repro_torch.models.model import init_cache

    B, S = prompts.shape
    pre, dec = fns
    caches = init_cache(cfg, B, S + steps, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches = pre(params, prompts, caches)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits, toks = [lg], [torch.argmax(lg, -1)]
    for _ in range(steps):
        lg, caches = dec(params, toks[-1].to(torch.int32)[:, None], caches)
        logits.append(lg)
        toks.append(torch.argmax(lg, -1))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (torch.stack(logits).cpu(), torch.stack(toks, 1).cpu(), t1 - t0,
            (t2 - t1) / max(steps, 1) * 1e3)


def _plain_fns(cfg):
    from repro_torch.models.model import decode_step, prefill

    return (lambda p, t, c: prefill(p, t, c, cfg),
            lambda p, t, c: decode_step(p, t, c, cfg))


def _prompts(torch, cfg, B, S):
    import numpy as np

    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to("cuda")


def _moe_cfg():
    from repro_torch.configs.base import QuantConfig

    return _dense_cfg("qwen3-moe-30b-a3b",
                      QuantConfig(mode="vp", quantize_kv_cache=True),
                      MESH_MOE_LAYERS)


def _mesh_engine_cfg():
    from repro_torch.configs.base import QuantConfig

    return _dense_cfg(ARCH, QuantConfig(mode="vp", quantize_kv_cache=True),
                      MESH_ENGINE_LAYERS)


def _pool_digest(kv) -> str:
    """sha256 of an engine's pools past the dummy page, dense rows and
    lengths."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in ([kv.pools[k][:, 1:] for k in sorted(kv.pools)]
              + [kv.dense[k] for k in sorted(kv.dense)] + [kv.lengths]):
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def _comm_per(before, steps):
    """Collective launches, bytes and their f32 equivalent per step
    since `before` (a `comm.snapshot()`)."""
    from repro_torch.parallel import comm

    now = comm.snapshot()
    out = {}
    for what in ("launches", "bytes", "f32_bytes"):
        d = collections.Counter(now[what])
        d.subtract(before[what])
        out[what] = sum(v for k, v in d.items() if k != "agree") / steps
    return out


def _mesh_engine(torch, cfg, params, reqs, mesh, want, tag):
    """The engine on `mesh` (run-ahead 4) over `reqs`: its tokens must be
    `want`'s -> (records, rates, launches that ran, collectives per
    decode step)."""
    from repro_torch.parallel import comm

    eng = _engine(cfg, params, decode_lookahead=ENGINE_LOOKAHEAD[0],
                  mesh=mesh)
    before = comm.snapshot()
    recs, wall, calls, ran = _engine_wave(torch, eng, reqs)
    rates = _decode_rates(recs, calls)
    steps = sum(c[1] for c in calls)
    per = _comm_per(before, max(steps, 1))
    got = {r["rid"]: r["tokens"] for r in recs}
    differ = [rid for rid in want if got.get(rid) != want[rid]]
    if differ:
        raise AssertionError(f"{tag} tokens differ from the unsharded "
                             f"engine's in requests {differ}")
    return eng, recs, wall, rates, ran, per


# -- the ranks (spawned processes; gloo on cuda:0) ---------------------------

def _mesh_rank(rank, world, run_dir):
    """One gloo rank on cuda:0: run the jobs of `run_dir/job.pt`, save
    their results to `run_dir/rank<i>.pt`."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import datetime

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    # the ranks share the host's cores (gloo stages every collective
    # there): more threads than a rank's share only contend
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    from repro_torch.launch.mesh import init_world

    init_world(rank, world, store=dist.FileStore(
        os.path.join(run_dir, "store"), world), device="cuda",
        backend="gloo", timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    job = torch.load(os.path.join(run_dir, "job.pt"), weights_only=False)
    out = {}
    for name in job["jobs"]:
        t = time.perf_counter()
        out[name] = MESH_JOBS[name](torch, job, world)
        out[name]["s"] = time.perf_counter() - t
    torch.save(out, os.path.join(run_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _ran_since(before):
    from repro_torch.kernels import build

    d = collections.Counter(build.LAUNCHES)
    d.subtract(before)
    return {k: v for k, v in d.items() if v}


def _rank_static(torch, job, world):
    """Full-width qwen3-0.6b through `sharded_forward_fns` at tp 2: the
    logits of the prefill and every greedy step bit-identical to the
    single-process kernel run's (`job["static"]`)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import elastic_mesh
    from repro_torch.models.model import init_params, quantize_params
    from repro_torch.parallel import comm, shard_ops

    cfg = registry.get_config(ARCH, QuantConfig(mode="vp",
                                                quantize_kv_cache=True))
    params = quantize_params(init_params(cfg, seed=0, device="cuda"), cfg)
    mesh = elastic_mesh(1, 1, world)
    local = shard_ops.place_params(params, cfg, mesh)
    del params
    want = torch.load(job["static"], weights_only=False)
    before, c0 = collections.Counter(build.LAUNCHES), comm.snapshot()
    logits, toks, pre_s, dec_ms = _greedy(
        torch, cfg, local, _prompts(torch, cfg, BATCH, PROMPT), GEN,
        shard_ops.sharded_forward_fns(None, cfg, mesh))
    ran = _ran_since(before)
    per = _comm_per(c0, GEN + 1)
    same = [i for i in range(GEN + 1) if torch.equal(logits[i],
                                                      want["logits"][i])]
    diff = float((logits - want["logits"]).abs().max())
    if len(same) != GEN + 1 or not torch.equal(toks, want["tokens"]):
        raise AssertionError(
            f"[mesh] tp {world}: logits of steps "
            f"{[i for i in range(GEN + 1) if i not in same]} differ from "
            f"the single-process run (max abs {diff:.3e}); tokens equal: "
            f"{torch.equal(toks, want['tokens'])}")
    return {"prefill_s": pre_s, "decode_ms": dec_ms, "ran": ran,
            "comm_per_pass": per}


def _rank_moe(torch, job, world):
    """qwen3-moe cut to MESH_MOE_LAYERS layers, expert parallel at tp 2
    (each rank 64 of the 128 experts): the unsharded run's tokens."""
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import elastic_mesh
    from repro_torch.models.model import init_params, quantize_params
    from repro_torch.parallel import shard_ops

    cfg = _moe_cfg()
    params = quantize_params(init_params(cfg, seed=0, device="cuda"), cfg)
    mesh = elastic_mesh(1, 1, world)
    local = shard_ops.place_params(params, cfg, mesh)
    del params
    experts = local["layers"][0]["moe"]["w_gate"]["w_packed"].shape[0]
    want = torch.load(job["moe"], weights_only=False)
    B, S, steps = MOE_SERVE
    before = collections.Counter(build.LAUNCHES)
    logits, toks, pre_s, dec_ms = _greedy(
        torch, cfg, local, _prompts(torch, cfg, B, S), steps,
        shard_ops.sharded_forward_fns(None, cfg, mesh))
    ran = _ran_since(before)
    if not torch.equal(toks, want["tokens"]):
        raise AssertionError(f"[mesh] MoE expert parallel at tp {world}: "
                             f"tokens differ from the unsharded run's")
    return {"experts": experts, "prefill_s": pre_s, "decode_ms": dec_ms,
            "ran": ran, "same_logits": bool(torch.equal(logits, want["logits"])),
            "max_abs": float((logits - want["logits"]).abs().max())}


def _eager_said(eng, calls: int) -> bool:
    """A mesh of gloo groups decodes eagerly and says so: the runner's
    `graphs_off` and `graph_log`, one `eager_decodes` a decode call."""
    off = eng.runner.graphs_off
    return bool(off) and eng.stats["eager_decodes"] == calls and \
        eng.runner.graph_log == [{"bucket": None, "eager": off}]


def _rank_engine(torch, job, world):
    """The engine at mesh `job["engine_mesh"]` on qwen3-0.6b cut to
    MESH_ENGINE_LAYERS layers: the unsharded engine's tokens, eager and
    saying so, the pools equal on every rank."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import elastic_mesh
    from repro_torch.models.model import init_params, quantize_params

    cfg = _mesh_engine_cfg()
    params = quantize_params(init_params(cfg, seed=0, device="cuda"), cfg)
    data, model = job["engine_mesh"]
    mesh = elastic_mesh(1, data, model)
    tag = f"[mesh] engine ({data}, {model})"
    eng, recs, wall, rates, ran, per = _mesh_engine(
        torch, cfg, params, _engine_requests(cfg, ENGINE_REQS), mesh,
        job["engine_tokens"], tag)
    if not _eager_said(eng, rates["decode_calls"]):
        raise AssertionError(f"{tag}: a gloo mesh must decode eagerly and "
                             f"say so: {eng.runner.graph_log}, "
                             f"{dict(eng.stats)}")
    digests = [None] * world
    dist.all_gather_object(digests, _pool_digest(eng.kv))
    if len(set(digests)) != 1:
        raise AssertionError(f"{tag}: the ranks' pools differ")
    return {"wall": wall, "rates": rates, "ran": ran, "comm_per_step": per,
            "eager": eng.runner.graphs_off, "digest": digests[0],
            "stats": dict(eng.stats)}


def _rank_ops(torch, job, world):
    """The op-level modes at tp `world`, each against the unsharded
    kernel on the same inputs: the matmul's column / gather / ring,
    vp_block's column shard through `qdot`, the decode attention's seq /
    heads, flash prefill's heads (bit for
    bit), dx psum / ring (1e-5 relative), dw (bit for bit),
    `dp_compress_reduce` at dp `world` (both codecs)."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import elastic_mesh
    from repro_torch.models.layers import (canonical_formats, qdot,
                                           quantize_weight)
    from repro_torch.parallel import comm, shard_ops
    from repro_torch.train.compression import (
        CompressionConfig, compress_decompress, init_compressor_state)

    fxp, vp = canonical_formats(QuantConfig(mode="vp"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def words(*shape):
        return ops.vp_quant(randn(*shape, dtype=torch.float32), fxp, vp,
                            packed=True)

    def timed(fn, reps=3):
        spans = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            spans.append(time.perf_counter() - t)
        return statistics.median(spans) * 1e3

    out, bad = {"lines": []}, []
    mesh = elastic_mesh(1, 1, world)
    shard_ops.SHARD_LAUNCHES.clear()
    before = collections.Counter(build.LAUNCHES)
    with comm.use_mesh(mesh):
        for M, K, N in MESH_DQMM:
            x, w = randn(M, K), words(K, N)
            full = ops.vp_dequant_matmul(x, w, vp)
            full_ms = timed(lambda: ops.vp_dequant_matmul(x, w, vp))
            w_loc = comm.slab(w, "model", 1).contiguous()
            for mode in shard_ops.MODES:
                c0 = comm.snapshot()
                got = shard_ops.sharded_dequant_matmul(x, w_loc, vp,
                                                       mode=mode)
                per = _comm_per(c0, 1)
                ms = timed(lambda: shard_ops.sharded_dequant_matmul(
                    x, w_loc, vp, mode=mode))
                if not torch.equal(got, full):
                    bad.append(f"{mode} at {(M, K, N)}")
                out["lines"].append(
                    f"{mode} ({M}, {K}, {N}) bf16: bit-identical "
                    f"{torch.equal(got, full)}; {ms:.3f} ms (the unsharded "
                    f"kernel {full_ms:.3f}); {per['bytes']:.0f} collective "
                    f"bytes a rank (f32 equivalent {per['f32_bytes']:.0f})")
            del x, w, w_loc, full, got

        # vp_block's weights: qdot on this rank's column shard, planned as
        # the unsharded launch (`vp_block_matmul.shard_skinny`), gathered
        M, K, N, blk = MESH_BLOCK
        qb = QuantConfig(mode="vp_block", block=blk)
        x = randn(M, K)
        wq = quantize_weight(randn(K, N, dtype=torch.float32), qb)
        full = qdot(x, wq, qb)
        got = qdot(x, shard_ops.place_params({"w": wq}, None, mesh)["w"],
                   shard_ops.tp_quant(qb))
        if not torch.equal(got, full):
            bad.append(f"vp_block column at {(M, K, N)}")
        out["lines"].append(f"vp_block column ({M}, {K}, {N}) block {blk} "
                            f"bf16 (`qdot`): bit-identical "
                            f"{torch.equal(got, full)}")

        B, smax, KV, G, dh = DEC_SHAPE
        q = randn(B, 1, KV * G, dh)
        k_w, v_w = words(B, smax, KV, dh), words(B, smax, KV, dh)
        ones = torch.ones((B, smax, 1, 1), device="cuda")
        lens = torch.tensor([smax, 97, 33, 1][:B], dtype=torch.int32,
                            device="cuda")
        full = ops.vp_decode_attention(q, k_w, v_w, ones, ones, lens, vp)
        for mode, args in (
                ("seq", (q,) + tuple(comm.slab(t, "model", 1)
                                     for t in (k_w, v_w, ones, ones))),
                ("heads", tuple(comm.slab(t, "model", 2)
                                for t in (q, k_w, v_w)) + (ones, ones))):
            got = shard_ops.sharded_decode_attention(*args, lens, vp,
                                                     mode=mode)
            if not torch.equal(got, full):
                bad.append(f"decode attention {mode}")
            out["lines"].append(f"decode attention {mode} {DEC_SHAPE} bf16 "
                                f"q: bit-identical {torch.equal(got, full)}")
        fq, fk, fv = (randn(BATCH, PROMPT, h, 64) for h in (16, 8, 8))
        full = ops.flash_prefill(fq, fk, fv)
        got = shard_ops.sharded_flash_prefill(
            *(comm.slab(t, "model", 2) for t in (fq, fk, fv)))
        if not torch.equal(got, full):
            bad.append("flash prefill heads")
        out["lines"].append(f"flash prefill heads (B {BATCH}, S {PROMPT}, "
                            f"H 16, KV 8, dh 64) bf16: bit-identical "
                            f"{torch.equal(got, full)}")

        M, K, N = MESH_BWD
        w, a_w = words(K, N), words(M, K)
        w_loc = comm.slab(w, "model", 1).contiguous()
        n_loc = N // world
        cols = slice(comm.axis_index("model") * n_loc,
                     (comm.axis_index("model") + 1) * n_loc)
        for dt in (torch.bfloat16, torch.float32):
            g = randn(M, N, dtype=dt)
            dx = ops.vp_matmul_dx(g, w, vp)
            for mode in ("psum", "ring"):
                got = shard_ops.sharded_matmul_dx(g, w_loc, vp, mode=mode)
                rel = float((got - dx).abs().max() / dx.abs().max())
                if rel > 1e-5:
                    bad.append(f"dx {mode} {dt}: {rel:.2e}")
                out["lines"].append(f"dx {mode} {MESH_BWD} {dt}: max rel "
                                    f"{rel:.2e} (limit 1e-5)")
            dw = ops.vp_matmul_dw(a_w, g, vp)[:, cols]
            got = shard_ops.sharded_matmul_dw(a_w, g, vp)
            if not torch.equal(got, dw):
                bad.append(f"dw {dt}")
            out["lines"].append(f"dw {MESH_BWD} {dt}: bit-identical "
                                f"{torch.equal(got, dw)}")
    out["shard_launches"] = {f"{k} {s}": v for (k, s), v in
                             shard_ops.SHARD_LAUNCHES.items()}

    with comm.use_mesh(elastic_mesh(1, world, 1)):
        r = comm.axis_index("data")
        grads = randn(world, 1024, 1024, dtype=torch.float32)
        for codec in ("int8", "vp"):
            cc = CompressionConfig(codec=codec)
            mine = {"w": grads[r:r + 1]}
            red, _ = shard_ops.dp_compress_reduce(
                mine, init_compressor_state(mine), axis="data", config=cc)
            want = sum(compress_decompress(
                {"w": grads[i:i + 1]}, None, cc)[0]["w"]
                for i in range(world)) / world
            err = float((red["w"] - want).abs().max())
            if err > 1e-6 * float(want.abs().max()):
                bad.append(f"dp_compress_reduce {codec}: {err:.2e}")
            out["lines"].append(f"dp_compress_reduce {codec} at dp {world} "
                                f"(1024 x 1024 f32): max abs {err:.2e} "
                                f"against each rank's codec, then the mean")
    out["ran"] = _ran_since(before)
    if bad:
        raise AssertionError(f"[mesh] op level at tp {world}: {bad}")
    return out


def _rank_equalizer(torch, job, world):
    """`equalize_wideband(how="shard_map")` over the ranks (a 1-D "sc"
    mesh) on the WIDEBAND band: bit-identical to `how="flat"`."""
    from repro_torch.kernels import build
    from repro_torch.mimo.channel import ChannelConfig
    from repro_torch.mimo.equalizer import table1_specs
    from repro_torch.mimo.ofdm import (OFDMConfig, WidebandCalibrator,
                                       equalize_wideband,
                                       make_wideband_ensemble)
    from repro_torch.parallel import sharding

    S, n = WIDEBAND
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    ens = make_wideband_ensemble(gen, ChannelConfig(),
                                 OFDMConfig(n_subcarriers=S), n, 20.0)
    specs = WidebandCalibrator(table1_specs()[2]).specs_for(ens)
    mesh = sharding.subcarrier_mesh()
    flat = equalize_wideband(specs, ens.w_beam, ens.y_beam)
    before = collections.Counter(build.LAUNCHES)
    got = equalize_wideband(specs, ens.w_beam, ens.y_beam, how="shard_map",
                            mesh=mesh)
    ran = _ran_since(before)
    if not torch.equal(got, flat) or sharding.UNSHARDED:
        raise AssertionError(f"[mesh] wideband shard_map over {world} ranks "
                             f"differs from flat (or ran unsharded: "
                             f"{dict(sharding.UNSHARDED)})")
    ms = {}
    for how in ("flat", "shard_map"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        equalize_wideband(specs, ens.w_beam, ens.y_beam, how=how, mesh=mesh)
        torch.cuda.synchronize()
        ms[how] = (time.perf_counter() - t) * 1e3
    return {"ms": ms, "ran": ran}


MESH_JOBS = {"static": _rank_static, "moe": _rank_moe,
             "engine": _rank_engine, "ops": _rank_ops,
             "equalizer": _rank_equalizer}


def _spawn(torch, world, job, run_dir):
    """Run `job` on `world` gloo ranks on cuda:0 -> each rank's results."""
    import torch.multiprocessing as mp

    d = os.path.join(run_dir, f"world{world}")
    os.makedirs(d)
    torch.save(job, os.path.join(d, "job.pt"))
    ctx = mp.start_processes(_mesh_rank, args=(world, d), nprocs=world,
                             join=False, start_method="spawn")
    while not ctx.join():
        pass
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _mesh_nccl(torch, record, cfg, params, reqs, want, smi):
    """(a): the engine at mesh (1, 1) over NCCL in this process, its
    decode graphs capturing the collectives -> the kernels that ran."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, smoke_mesh

    tag = "[mesh] NCCL (1, 1)"
    with tempfile.TemporaryDirectory() as d:
        init_world(0, 1, store=dist.FileStore(os.path.join(d, "store"), 1),
                   device="cuda")
        try:
            eng, recs, wall, rates, ran, per = _mesh_engine(
                torch, cfg, params, reqs, smoke_mesh(), want, tag)
            _check_graph_log(eng.runner, f"{tag}:")
            coll = eng.runner.captured_collectives
            if not coll.get("all_gather") or eng.runner.graphs_off:
                raise AssertionError(f"{tag}: the graphs hold no "
                                     f"collective: {dict(coll)}")
            # a second wave replays the graphs captured in the first
            eng.check_finite = False
            recs_w, wall_w, calls_w, ran_w = _engine_wave(torch, eng, reqs)
            if [r["tokens"] for r in sorted(recs_w, key=lambda r: r["rid"])] \
                    != [want[k] for k in sorted(want)]:
                raise AssertionError(f"{tag}: the second wave's tokens "
                                     f"differ from the unsharded engine's")
            warm = _decode_rates(recs_w, calls_w)
            full = f"{ENGINE_SLOTS}x{ENGINE_LOOKAHEAD[0]}"
            print(f"{tag}, world size 1: the unsharded engine's tokens in "
                  f"all {len(recs)} requests, twice; "
                  f"{len(eng.runner.graph_log)} graphs captured "
                  f"{dict(coll)} collectives in all; first wave (captures "
                  f"and checks in it) decode "
                  f"{rates['decode_ms_per_step']:.3f} ms/step, wave "
                  f"{wall:.3f}s; second wave decode "
                  f"{warm['decode_ms_per_step']:.3f} ms/step, at bucket "
                  f"{full} {warm['bucket_ms_per_step'][full]:.3f}, "
                  f"{warm['decode_tok_s']:.1f} kept decode tok/s, wave "
                  f"{wall_w:.3f}s; {per['launches']:.1f} collectives a "
                  f"decode step; {smi}")
            record["mesh_nccl"] = dict(warm, wall=wall_w, first=rates,
                                       collectives=dict(coll))
            return collections.Counter(ran) + collections.Counter(ran_w)
        finally:
            dist.destroy_process_group()


def mesh_phase(torch, record, rows, smi):
    """Distribution (`repro_torch.parallel`, `launch.mesh`) on the one
    card.  (a) World size 1 over NCCL in this process: full-width
    qwen3-0.6b (bf16, packed VP weights and KV cache) through the engine
    at mesh (data, model) = (1, 1) on the engine phase's requests, the
    decode graphs capturing the NCCL collectives, each first replay
    bit-identical to its eager step, the unsharded engine's tokens.
    (b) Gloo ranks spawned on cuda:0, collectives staged through host
    memory (a transport for several ranks on one card, not NVLink: every
    figure is labelled so): the same model through `sharded_forward_fns`
    at tp 2 (4 x 128, 32 greedy steps) with logits and tokens
    bit-identical to this process's unsharded kernel run (each shard
    planned as the unsharded launch); the engine on the model cut to
    MESH_ENGINE_LAYERS layers at (1, 2) and (2, 2), eager (gloo cannot be
    captured; said in `graph_log` and `stats`), with the unsharded
    engine's tokens at that depth and equal pools on every rank; qwen3-moe
    cut to MESH_MOE_LAYERS layers, expert parallel at tp 2, the
    unsharded tokens.  (c) The op-level modes at tp 2 (`_rank_ops`) and
    the shard launch counters.  (d) The wideband equalizer sharded over
    subcarriers, bit-identical to the flat path."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import QuantConfig
    from repro_torch.models.model import init_params, quantize_params

    tag = "[mesh]"
    launches = collections.Counter()
    cfg = registry.get_config(ARCH, QuantConfig(mode="vp",
                                                quantize_kv_cache=True))
    params = quantize_params(init_params(cfg, seed=0, device="cuda"), cfg)
    reqs = _engine_requests(cfg, ENGINE_REQS)
    want = record.get("engine_tokens")
    if want is None:     # the phase alone: the unsharded engine first
        recs, _, _, ran = _engine_wave(torch, _engine(
            cfg, params, decode_lookahead=ENGINE_LOOKAHEAD[0]), reqs)
        want = {r["rid"]: r["tokens"] for r in recs}
    print(f"{tag} {cfg.name}, {cfg.dtype}, packed VP weights and KV cache; "
          f"{smi}")

    # -- (a) NCCL, world size 1, decode graphs ---------------------------------
    launches.update(_mesh_nccl(torch, record, cfg, params, reqs, want, smi))
    gc.collect()
    torch.cuda.empty_cache()

    # -- the unsharded runs the ranks are held against ----------------------
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        logits, toks, pre_s, dec_ms = _greedy(
            torch, cfg, params, _prompts(torch, cfg, BATCH, PROMPT), GEN,
            _plain_fns(cfg))
        torch.save({"logits": logits, "tokens": toks},
                   os.path.join(run_dir, "static.pt"))
        print(f"{tag} single process, unsharded: prefill {pre_s:.4f}s, "
              f"decode {dec_ms:.3f} ms/step ({BATCH} x {PROMPT}, {GEN} "
              f"steps)")
        del params
        mcfg = _moe_cfg()
        mp_ = quantize_params(init_params(mcfg, seed=0, device="cuda"), mcfg)
        B, S, steps = MOE_SERVE
        mlogits, mtoks, mpre, mdec = _greedy(
            torch, mcfg, mp_, _prompts(torch, mcfg, B, S), steps,
            _plain_fns(mcfg))
        torch.save({"logits": mlogits, "tokens": mtoks},
                   os.path.join(run_dir, "moe.pt"))
        del mp_
        ecfg = _mesh_engine_cfg()
        ep = quantize_params(init_params(ecfg, seed=0, device="cuda"), ecfg)
        erecs, ewall, ecalls, _ = _engine_wave(torch, _engine(
            ecfg, ep, decode_lookahead=ENGINE_LOOKAHEAD[0]),
            _engine_requests(ecfg, ENGINE_REQS))
        ewant = {r["rid"]: r["tokens"] for r in erecs}
        erates = _decode_rates(erecs, ecalls)
        del ep
        gc.collect()
        torch.cuda.empty_cache()

        # -- (b) - (d) gloo ranks ----------------------------------------------
        job = {"jobs": ("static", "engine", "moe", "ops", "equalizer"),
               "static": os.path.join(run_dir, "static.pt"),
               "moe": os.path.join(run_dir, "moe.pt"),
               "engine_tokens": ewant, "engine_mesh": (1, 2)}
        t = time.perf_counter()
        two = _spawn(torch, 2, job, run_dir)
        two_s = time.perf_counter() - t
        t = time.perf_counter()
        four = _spawn(torch, 4, dict(job, jobs=("engine",),
                                     engine_mesh=(2, 2)), run_dir)
        four_s = time.perf_counter() - t
    finally:
        import shutil
        shutil.rmtree(run_dir, ignore_errors=True)

    st, mo, eq = two[0]["static"], two[0]["moe"], two[0]["equalizer"]
    print(f"{tag} tp 2 ({GLOO}): logits of the prefill and all {GEN} steps "
          f"and the tokens bit-identical to the single-process run; prefill "
          f"{st['prefill_s']:.4f}s, decode {st['decode_ms']:.3f} ms/step; "
          f"{st['comm_per_pass']['launches']:.1f} collectives, "
          f"{st['comm_per_pass']['bytes']:.0f} bytes a rank a pass (f32 "
          f"equivalent {st['comm_per_pass']['f32_bytes']:.0f}); {smi}")
    print(f"{tag} engine at {MESH_ENGINE_LAYERS} layers, single process, "
          f"unsharded (graphs): {erates['decode_ms_per_step']:.3f} ms/step, "
          f"wave {ewall:.3f}s; {smi}")
    for e, (dm, w) in ((two[0]["engine"], ((1, 2), 2)),
                       (four[0]["engine"], ((2, 2), 4))):
        r = e["rates"]
        print(f"{tag} engine {dm} at {MESH_ENGINE_LAYERS} layers ({GLOO}): "
              f"the unsharded tokens, pools equal on all {w} ranks; decode "
              f"eager ({e['eager']}; "
              f"{e['stats'].get('eager_decodes')} eager decode calls); "
              f"{r['decode_ms_per_step']:.3f} ms/step, "
              f"{r['decode_tok_s']:.1f} kept decode tok/s, wave "
              f"{e['wall']:.3f}s; {e['comm_per_step']['launches']:.1f} "
              f"collectives, {e['comm_per_step']['bytes']:.0f} bytes a rank "
              f"a decode step (f32 equivalent "
              f"{e['comm_per_step']['f32_bytes']:.0f}); {smi}")
    print(f"{tag} MoE {_moe_cfg().name} at {MESH_MOE_LAYERS} layers, expert "
          f"parallel at tp 2 ({mo['experts']} experts a rank; {GLOO}): the "
          f"unsharded tokens; logits bit-identical {mo['same_logits']} (max "
          f"abs {mo['max_abs']:.3e}); prefill {mo['prefill_s']:.4f}s, decode "
          f"{mo['decode_ms']:.3f} ms/step (single process: {mpre:.4f}s, "
          f"{mdec:.3f} ms/step)")
    for line in two[0]["ops"]["lines"]:
        print(f"{tag} ops tp 2 ({GLOO}): {line}")
    print(f"{tag} shard launches, rank 0: {two[0]['ops']['shard_launches']}")
    print(f"{tag} wideband {WIDEBAND} shard_map over 2 ranks: bit-identical "
          f"to flat; flat {eq['ms']['flat']:.3f} ms, shard_map "
          f"{eq['ms']['shard_map']:.3f} ms ({GLOO})")
    print(f"[time] mesh world 2: {two_s:.2f}s (jobs "
          + ", ".join(f"{k} {v['s']:.2f}s" for k, v in two[0].items())
          + f"); world 4: {four_s:.2f}s")
    for res in two + four:
        for v in res.values():
            launches.update(v.get("ran", {}))
    for name in ("vp_dequant_matmul", "vp_dqmm_skinny", "vp_dqmm_tc",
                 "block_vp_matmul", "vp_block_quant", "vp_decode_attention",
                 "flash_prefill", "vp_quant_packed", "vp_qp_kv", "rms_norm",
                 "vp_matmul_dx", "vp_matmul_dw", "vp_dequant_packed",
                 "vp_quant_matmul"):
        if not launches.get(name):
            raise AssertionError(f"{tag} {name} did not run: "
                                 f"{dict(launches)}")
    for row in rows:
        if launches.get(row["name"]):
            row["mesh_launches"] = launches[row["name"]]
    record["mesh"] = {"tp2": st, "moe": mo, "equalizer": eq,
                      "engine": [two[0]["engine"], four[0]["engine"]],
                      "world_s": [two_s, four_s], "launches": dict(launches)}


if __name__ == "__main__":
    main()
