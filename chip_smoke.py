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
  4. serve   - full-width qwen3-0.6b in bf16 with packed VP weights and
               a packed VP KV cache: random weights from seed 0 exported
               by the quant kernel, batch 4 x 128 prompt tokens, 32
               greedy decode steps.  Launch counts of that run, a
               profiler check of one prefill and one decode step (hand
               kernels only, no library GEMM or attention kernel), then
               the same run on the plain path, teacher-forced on the
               kernel path's tokens, in bf16 (held to the plain path's
               own rounding floor, or 2e-2 if larger) and in f32.
  5. result  - a {"kernels": [...]} line, then the device line last.

Exits non-zero without CUDA, and outside a checkout of the repository.
Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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
                           # plus the bf16 cast of p in flash prefill
KERNEL_NAMES = {"vp_quant_packed": "vp_quant_packed_kernel",
                "vp_dequant_matmul": "vp_dequant_matmul_kernel",
                "vp_decode_attention": "vp_decode_attention_kernel",
                "flash_prefill": "flash_prefill_kernel"}
LIBRARY_KERNELS = re.compile(
    r"gemm|cublas|cutlass|xmma|sm90_|sm80_|ampere_|flash_fwd|fmha|"
    r"efficient_attention|scaled_dot_product|cudnn", re.IGNORECASE)

# Published dense peaks (NVIDIA data sheets): bytes/s, bf16 and f32 FLOP/s.
PEAKS = {
    "sxm": dict(bw=3.35e12, bf16=989e12, f32=67e12),
    "pcie": dict(bw=2.0e12, bf16=756e12, f32=51e12),
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
              "build_s": build_s}
    rows = kernel_phase(torch, peaks, record)
    serve_phase(torch, record, rows)

    # ---- 5. result --------------------------------------------------------
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
    import torch.nn.functional as F

    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.formats import FXPFormat, default_vp_format
    from repro_torch.core.packing import dequant_words
    from repro_torch.kernels import ref
    from repro_torch.kernels.vp_attention import (
        flash_prefill_cuda, vp_decode_attention_cuda)
    from repro_torch.kernels.vp_dequant_matmul import vp_dequant_matmul_cuda
    from repro_torch.kernels.vp_quant import vp_quant_packed_cuda
    from repro_torch.models.layers import canonical_formats

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = Timer(torch)
    fxp, vp = canonical_formats(QuantConfig(mode="vp"))
    lines, rows = [], []

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # -- vp_quant_packed: bit-exact ------------------------------------------
    F_ = fxp.F
    ks = torch.randint(-2048, 2048, (4096,), generator=gen, device="cuda")
    ties = (ks.to(torch.float64) + 0.5) * 2.0 ** -F_
    sat = torch.linspace(-8.0, 8.0, 4096, device="cuda", dtype=torch.float64)
    special = torch.cat([ties, sat]).to(torch.float32)
    panel = randn(1024, 3072) * 0.3
    fxp6 = FXPFormat(12, 11)
    vp6 = default_vp_format(fxp6, 6, 2)          # int8 words
    for x, f_, v_, what in ((panel, fxp, vp, "panel (1024, 3072) int16"),
                            (special, fxp, vp, "ties/saturation int16"),
                            (special, fxp6, vp6, "ties/saturation int8")):
        got = vp_quant_packed_cuda(x, f_, v_)
        want = ref.vp_quant_packed_ref(x, f_, v_)
        if got.dtype != want.dtype or not torch.equal(got, want):
            n = int((got.to(torch.int32) != want.to(torch.int32)).sum())
            raise AssertionError(f"vp_quant_packed {what}: {n} words differ")
    ms = timer(lambda: vp_quant_packed_cuda(panel, fxp, vp))
    plain_ms = timer(lambda: ref.vp_quant_packed_ref(panel, fxp, vp))
    n = panel.numel()
    bnd = bound(peaks, n * (4 + 2), 0, "f32")
    _print_line("vp_quant_packed", [1024, 3072], 0.0, 0.0, ms, plain_ms,
                bnd, None)
    rows.append(_row("vp_quant_packed", "vp_quant.cu",
                     "src/repro/kernels/vp_quant.py:65", [1024, 3072], 0.0,
                     ms, plain_ms, bnd, None))
    print("[kernel] vp_quant_packed: bit-exact on the panel, ties and "
          "saturation (int16 and int8 words)")

    # -- vp_dequant_matmul -----------------------------------------------------
    def words(K, N):
        return vp_quant_packed_cuda(
            (randn(K, N) * 0.3).clamp(-0.99, 0.99), fxp, vp)

    main_mm = None
    for (M, K, N) in ((4, 1024, 3072), (512, 1024, 1024),
                      (4, 1024, 151936), (33, 96, 24)):
        w = words(K, N)
        x32 = randn(M, K)
        got = vp_dequant_matmul_cuda(x32, w, vp, torch.float32)
        want = ref.vp_dequant_matmul_ref(x32, w, vp, torch.float32)
        compare(torch, got, want, F32_RTOL, f"vp_dequant_matmul f32 {M, K, N}")
        x = x32.to(torch.bfloat16)
        got = vp_dequant_matmul_cuda(x, w, vp, torch.bfloat16)
        want = ref.vp_dequant_matmul_ref(x, w, vp, torch.bfloat16)
        err, rel = compare(torch, got, want, BF16_TOL,
                           f"vp_dequant_matmul bf16 {M, K, N}")
        if M == 33:
            print(f"[kernel] vp_dequant_matmul ragged {[M, K, N]}: "
                  f"within tolerance (f32 and bf16)")
            continue
        w_deq = dequant_words(w, vp).to(torch.bfloat16)
        ms = timer(lambda: vp_dequant_matmul_cuda(x, w, vp, torch.bfloat16))
        plain_ms = timer(
            lambda: ref.vp_dequant_matmul_ref(x, w, vp, torch.bfloat16))
        library_ms = timer(lambda: torch.matmul(x, w_deq))
        bnd = bound(peaks, 2 * (M * K + K * N + M * N), 2 * M * K * N, "bf16")
        _print_line("vp_dequant_matmul", [M, K, N], err, rel, ms, plain_ms,
                    bnd, library_ms)
        lines.append(("vp_dequant_matmul", [M, K, N], ms, plain_ms, bnd,
                      library_ms))
        if main_mm is None:
            main_mm = _row("vp_dequant_matmul", "vp_dequant_matmul.cu",
                           "src/repro/kernels/vp_dequant_matmul.py:50",
                           [M, K, N], err, ms, plain_ms, bnd, library_ms)
        del w, w_deq
    rows.append(main_mm)

    # -- vp_decode_attention --------------------------------------------------
    B, smax, KV, G, dh = 4, 160, 8, 2, 64
    H = KV * G
    k_w = words(B * smax * KV, dh).reshape(B, smax, KV, dh)
    v_w = words(B * smax * KV, dh).reshape(B, smax, KV, dh)
    scales = torch.tensor([2.0 ** -3, 2.0 ** -2, 0.5, 1.0, 2.0],
                          device="cuda")
    k_s = scales[torch.randint(0, 5, (B, smax, 1, 1), generator=gen,
                               device="cuda")]
    v_s = scales[torch.randint(0, 5, (B, smax, 1, 1), generator=gen,
                               device="cuda")]
    q = randn(B, 1, H, dh)
    cases = {"full": ([160, 150, 129, 100], None, False),
             "window": ([160, 150, 129, 40], 64, False),
             "rolling": ([200, 170, 161, 300], 160, True)}
    main_dec = None
    for case, (lens, window, rolling) in cases.items():
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        qr = q.reshape(B, KV, G, dh) * dh ** -0.5

        def kern():
            return vp_decode_attention_cuda(qr, k_w, v_w, k_s, v_s, lengths,
                                            vp, window, rolling)

        def plain():
            return ref.vp_decode_attention_ref(q, k_w, v_w, k_s, v_s, lengths,
                                               vp, window, rolling)

        err, rel = compare(torch, kern().reshape(B, 1, H, dh), plain(),
                           F32_RTOL, f"vp_decode_attention {case}")
        ms, plain_ms = timer(kern), timer(plain)
        spans = []
        for ln in lens:
            hi = min(ln, smax)
            lo = max(ln - window, 0) if window and not rolling else 0
            spans.append(max(hi - lo, 0))
        valid = sum(spans)
        nbytes = valid * KV * dh * 2 * 2 + valid * 2 * 4 + 2 * B * H * dh * 4
        bnd = bound(peaks, nbytes, 4 * valid * KV * G * dh, "f32")
        shape = [B, smax, KV, G, dh, case]
        _print_line("vp_decode_attention", shape, err, rel, ms, plain_ms, bnd,
                    None)
        lines.append(("vp_decode_attention", shape, ms, plain_ms, bnd, None))
        if main_dec is None:
            main_dec = _row("vp_decode_attention", "vp_attention.cu",
                            "src/repro/kernels/vp_attention.py:155", shape,
                            err, ms, plain_ms, bnd, None)
    rows.append(main_dec)

    # -- flash_prefill ----------------------------------------------------------
    B, H, KV, dh = 4, 16, 8, 64
    main_fl = None
    for S in (128, 100):
        for pattern, window in (("causal", None), ("local", 64)):
            q32, k32, v32 = randn(B, S, H, dh), randn(B, S, KV, dh), \
                randn(B, S, KV, dh)
            for dtype, tol in ((torch.float32, F32_RTOL),
                               (torch.bfloat16, BF16_TOL)):
                qd, kd, vd = (t.to(dtype) for t in (q32, k32, v32))
                qs = qd * torch.tensor(dh ** -0.5, dtype=dtype, device="cuda")

                def kern():
                    return flash_prefill_cuda(qs, kd, vd, True, window)

                def plain():
                    return ref.flash_prefill_ref(qd, kd, vd, pattern, window)

                err, rel = compare(torch, kern(), plain(), tol,
                                   f"flash_prefill {S} {pattern} {dtype}")
            # time the model's form: bf16
            ms, plain_ms = timer(kern), timer(plain)
            library_ms = None
            if pattern == "causal":
                qt = qd.transpose(1, 2)
                kt = kd.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                vt = vd.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                library_ms = timer(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True))
            qpos = torch.arange(S)[:, None]
            kpos = torch.arange(S)[None, :]
            mask = kpos <= qpos
            if window:
                mask &= qpos - kpos < window
            pairs = int(mask.sum())
            nbytes = 2 * (2 * B * S * H * dh + 2 * B * S * KV * dh)
            bnd = bound(peaks, nbytes, 4 * B * H * dh * pairs, "bf16")
            shape = [B, S, H, KV, dh, pattern]
            _print_line("flash_prefill", shape, err, rel, ms, plain_ms, bnd,
                        library_ms)
            lines.append(("flash_prefill", shape, ms, plain_ms, bnd,
                          library_ms))
            if main_fl is None:
                main_fl = _row("flash_prefill", "vp_attention.cu",
                               "src/repro/kernels/vp_attention.py:264", shape,
                               err, ms, plain_ms, bnd, library_ms)
    rows.append(main_fl)
    record["kernel_lines"] = [
        dict(name=n, shape=s, ms=m, plain_ms=p, bound_ms=b[0], bound_by=b[1],
             library_ms=lib) for n, s, m, p, b, lib in lines]
    print("kernels: vp_quant_packed, vp_dequant_matmul, "
          "vp_decode_attention, flash_prefill")
    return rows


# ---------------------------------------------------------------------------
# 4. serve
# ---------------------------------------------------------------------------

def serve_phase(torch, record, rows):
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import build
    from repro_torch.launch.serve import run_static
    from repro_torch.models.layers import weight_bytes
    from repro_torch.models.model import (
        decode_step, init_cache, init_params, prefill, quantize_params)

    cfg = registry.get_config(
        ARCH, QuantConfig(mode="vp", quantize_kv_cache=True))
    L = cfg.n_layers
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
    print(f"[serve] {cfg.name}: {L} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}, {cfg.dtype}; exported weights {words / 1e9:.3f} GB")
    print(f"[serve] init {init_s:.3f}s, export {export_s:.3f}s, prefill "
          f"{BATCH}x{PROMPT} {report['prefill_s']:.4f}s, decode {GEN} steps "
          f"{report['decode_s']:.4f}s ({report['tokens_per_s']:.1f} tok/s, "
          f"{report['decode_s'] / GEN * 1e3:.3f} ms/step), peak memory "
          f"{peak / 1e9:.3f} GB")
    expect = {
        "vp_quant_packed": (2 + 7 * L) + 2 * L * (1 + GEN),
        "vp_dequant_matmul": (7 * L + 1) * (1 + GEN),
        "vp_decode_attention": L * GEN,
        "flash_prefill": L,
    }
    print(f"[serve] launches on the main path: {counts}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != expected {expect}")
    for row in rows:
        row["launches"] = counts[row["name"]]
    for lg in logits:
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError("non-finite logits on the kernel path")

    # -- profiler: one prefill and one decode step --------------------------
    caches = init_cache(cfg, BATCH, PROMPT + GEN)
    (_, caches), k_pre = _profile(
        torch, "prefill", lambda: prefill(qparams, prompts, caches, cfg))
    _, k_dec = _profile(
        torch, "decode step",
        lambda: decode_step(qparams, tokens[:, :1], caches, cfg))
    names = [n for n, _ in k_pre + k_dec]
    seen = {k: sum(v in n for n in names) for k, v in KERNEL_NAMES.items()}
    want = {"vp_quant_packed": 4 * L, "vp_dequant_matmul": 2 * (7 * L + 1),
            "vp_decode_attention": L, "flash_prefill": L}
    library = sorted({n for n in names if LIBRARY_KERNELS.search(n)
                      and not any(v in n for v in KERNEL_NAMES.values())})
    print(f"[profile] {len(names)} device kernels in one prefill + one "
          f"decode step; hand kernels {seen}")
    if not names:
        raise AssertionError("the profiler recorded no device kernels")
    if seen != want:
        raise AssertionError(f"profiled launches {seen} != expected {want}")
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
        torch, cfg, qparams, prompts, tokens, f64_matmul=True), plain)
    limit = max(REL_LIMIT, FLOOR_MARGIN * max(floor))
    print("[serve] bf16 kernel vs plain, per step (prefill first): "
          + " ".join(f"{r:.2e}" for r in rels))
    print("[serve] bf16 plain (f64 matmul) vs plain, per step: "
          + " ".join(f"{r:.2e}" for r in floor))
    print(f"[serve] bf16 kernel path vs plain path: max |logit diff| / "
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
    rels32, agree32 = _rel_diffs(
        torch, lg32, _plain_logits(torch, cfg32, qp32, prompts, tok32))
    print("[serve] f32 kernel vs plain, per step (prefill first): "
          + " ".join(f"{r:.2e}" for r in rels32))
    print(f"[serve] f32 kernel path vs plain path: max {max(rels32):.3e} "
          f"(limit {F32_REL_LIMIT}); greedy-token agreement {agree32:.4f}")
    if max(rels32) > F32_REL_LIMIT:
        raise AssertionError(f"f32 kernel path differs from the plain path "
                             f"by {max(rels32):.3e} > {F32_REL_LIMIT}")
    record["serve"] = dict(
        init_s=init_s, export_s=export_s, **report, peak_bytes=peak,
        weight_bytes=words, launches=counts, profiled=seen,
        bf16_rel_logit_diff=rels, bf16_plain_floor=floor, bf16_limit=limit,
        bf16_token_agreement=agree, f32_rel_logit_diff=rels32,
        f32_token_agreement=agree32)


def _profile(torch, what, fn):
    """Run fn() once under torch.profiler; print its wall time (profiler
    on), device busy time, idle share and the kernels taking the most
    device time.  Returns (fn's result, [(kernel name, device us)])."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(us for _, us in kernels)
    by_name = {}
    for name, us in kernels:
        key = next((k for k, v in KERNEL_NAMES.items() if v in name),
                   name.split("<")[0].split("(")[0][-60:])
        by_name[key] = by_name.get(key, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile] {what}: wall {wall_us / 1e3:.3f} ms (profiler on), "
          f"device busy {busy / 1e3:.3f} ms in {len(kernels)} kernels, idle "
          f"share {max(0.0, 1 - busy / wall_us):.3f}; top: "
          + "; ".join(f"{k} {us / 1e3:.3f} ms ({us / busy:.1%})"
                      for k, us in top))
    return out, kernels


def _plain_logits(torch, cfg, params, prompts, tokens, f64_matmul=False):
    """Logits of prefill + one decode step per column of `tokens` on the
    plain path (teacher-forced).  `f64_matmul` sums the plain matmul in
    f64 instead of f32, to measure the path's own rounding floor."""
    from repro_torch.core.packing import dequant_words
    from repro_torch.kernels import ops, ref
    from repro_torch.models.model import decode_step, init_cache, prefill

    def matmul64(x, w, fmt, out_dtype=torch.float32):
        return (x.double() @ dequant_words(w, fmt).double()).to(out_dtype)

    plain_matmul = ref.vp_dequant_matmul_ref
    if f64_matmul:
        ref.vp_dequant_matmul_ref = matmul64
    try:
        with ops.force_backend("ref"):
            caches = init_cache(cfg, BATCH, PROMPT + GEN)
            lg, caches = prefill(params, prompts, caches, cfg)
            out = [lg]
            for i in range(tokens.shape[1]):
                lg, caches = decode_step(params, tokens[:, i:i + 1], caches,
                                         cfg)
                out.append(lg)
    finally:
        ref.vp_dequant_matmul_ref = plain_matmul
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
