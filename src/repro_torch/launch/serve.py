"""Serving CLI of the port (counterpart of `repro.launch.serve`): the
static path prefills one batch, then decodes; `--engine` serves the
requests through the paged continuous-batching engine instead.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --quant vp --kv-quant --batch 4 --prompt-len 128 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --quant vp --kv-quant --engine --batch 8 --max-slots 4 \\
        --page-size 16 --prompt-len 128 --gen 32 --ragged-gen \\
        --lookahead 4

Runs on the card by default and raises when CUDA is absent; `--device
cpu` runs the plain PyTorch versions of the kernels.  Weights are random
from `--seed` (torch generator), prompts from a numpy generator with the
same seed.  With `--quant vp` every weight matmul reads packed VP words
through the `vp_dequant_matmul` kernel; with `--quant vp_block` (index
block `--block`) it block-quantizes its activations and runs the int8
`block_vp_matmul` kernel; `--quant fxp` serves int8 fixed-point weights.
`--kv-quant` keeps the KV cache as packed words read by the
`vp_decode_attention` kernel (`--kv-layout planes`: significands, int8 to
M 8 and int16 past it, and packed indices, dequantized by the planes
kernel before plain attention).  `--layout planes` stores VP weights the
same way, dequantized by the planes kernel before a plain matmul.  `--M`
and `--E` pick the VP format of weights and KV cache (VP(M, E) on
FXP(12, 11)): M + E <= 8 packs each weight into an int8 word.
`--temperature` samples (Gumbel-max, noise from a torch generator seeded
with `--seed`) where 0 decodes greedily.  The engine runs on a virtual
clock charged with each step's measured wall time; on the card each
decode bucket is one CUDA graph.  `--arch` takes the dense configs
(qwen2-0.5b, qwen3-0.6b, stablelm-12b, gemma3-27b), the MoE configs
(qwen3-moe-30b-a3b, mixtral-8x22b), the SSM config rwkv6-3b and the
hybrid zamba2-7b, whose shared attention block is exported once; on the
engine their state rows live per slot beside the pages.  whisper-tiny
(encoder-decoder): frames (B, encoder_seq, d_model) drawn from the run's
torch generator in the model dtype (the reference's CLI encodes f32
frames), encoded and turned into the decoder's cross K/V once before the
static path (`encode_s`); the engine refuses it, as the reference's
does.  internvl2-1b (VLM): the static path prefills zero patch
embeddings (n_patches of them, as the reference's CLI) before the
prompt, its caches sized to n_patches + prompt + generation; the engine
serves it text-only, as the reference's.  `--tune-decode` first times the
decode kernels' launch plans at this model's shapes (the skinny
`vp_dequant_matmul` body over every packed weight panel, the split
decode-attention body over every cache geometry of the run) and keeps
the fastest in the plan cache (`$REPRO_TORCH_AUTOTUNE_CACHE`, else
`~/.cache/repro-vp-torch/autotune.json`), which every later launch reads;
entries already there are not timed again, and on the CPU nothing is
timed.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
        --quant vp --kv-quant --batch 4 --prompt-len 128 --gen 16
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import QuantConfig
from repro_torch.models.layers import weight_bytes
from repro_torch.models.model import (
    cross_kv, decode_step, encoder_forward, init_cache, init_params,
    model_dtype, prefill, quantize_params, resolve_device,
)
from repro_torch.serving.profile import tune_decode_profile
from repro_torch.serving.runner import gumbel_noise, sample


def _require_finite(logits: torch.Tensor, what: str) -> None:
    """Raise (not assert: it must survive `python -O`) on NaN/inf."""
    if not bool(torch.isfinite(logits).all()):
        raise FloatingPointError(f"non-finite {what} logits")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_static(params, cfg, prompts: torch.Tensor, gen: int,
               report: Optional[dict] = None, temperature: float = 0.0,
               generator: Optional[torch.Generator] = None,
               frames: Optional[torch.Tensor] = None,
               patches: Optional[torch.Tensor] = None):
    """Prefill `prompts` (B, S), then `gen` decode steps: greedy, or
    sampled at `temperature` > 0 with noise from `generator`.  An
    encoder-decoder first encodes `frames` (B, S_enc, d) into the
    decoder's cross K/V (`encode_s`); a VLM prefills `patches` (B, P, d)
    before the prompt, into caches of P + S + gen positions.

    Returns (tokens (B, gen), logits of every step [(B, V)] with the
    prefill's first).  Fills `report` with the timings when given.
    """
    device = prompts.device
    B, S = prompts.shape
    P = 0 if patches is None else patches.shape[1]
    caches = init_cache(cfg, B, P + S + gen, device=device)
    ckv, encode_s = None, 0.0
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError("an encoder-decoder serves from frames")
        _sync(device)
        t0 = time.perf_counter()
        with torch.no_grad():
            ckv = cross_kv(params, encoder_forward(params, frames, cfg), cfg)
        _sync(device)
        encode_s = time.perf_counter() - t0
    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(params, prompts, caches, cfg, patches=patches,
                             cross_kv=ckv)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    _require_finite(logits, "prefill")
    all_logits = [logits]

    def draw(lg):
        noise = (gumbel_noise(generator, lg.shape, device)
                 if temperature > 0 else None)
        return sample(lg, noise, temperature)

    tok = draw(logits)
    out_tokens: List[torch.Tensor] = []
    t0 = time.perf_counter()
    for _ in range(gen):
        out_tokens.append(tok)
        logits, caches = decode_step(params, tok, caches, cfg, cross_kv=ckv)
        all_logits.append(logits)
        tok = draw(logits)
    _sync(device)
    decode_s = time.perf_counter() - t0
    _require_finite(logits, "decode")
    if report is not None:
        report.update(prefill_s=prefill_s, decode_s=decode_s,
                      tokens_per_s=B * gen / max(decode_s, 1e-12),
                      encode_s=encode_s, patches=P)
    return torch.cat(out_tokens, dim=1), all_logits


def _percentile(xs, p: float) -> float:
    """Nearest-rank percentile of a small latency list."""
    ys = sorted(xs)
    i = min(len(ys) - 1, max(0, int(round(p / 100 * (len(ys) - 1)))))
    return ys[i]


def _ragged_gens(gen: int, n: int) -> List[int]:
    """Deterministic ragged generation lengths in [gen/2, gen]."""
    span = max(1, gen // 2)
    return [max(1, gen - (i * 7) % (span + 1)) for i in range(n)]


def _run_engine(args, params, cfg, report: dict) -> None:
    """Serve --batch requests through the paged continuous-batching
    engine (virtual clock charged with each step's measured time)."""
    from repro_torch.serving import SLO_CLASSES, ServingEngine, VirtualClock

    n_req = args.batch
    gens = (_ragged_gens(args.gen, n_req) if args.ragged_gen
            else [args.gen] * n_req)
    arrivals = [i * args.arrival_gap for i in range(n_req)]
    ps = args.page_size
    capacity = _cache_len(args, cfg)
    max_slots = args.max_slots or min(n_req, 4)
    engine = ServingEngine(
        params, cfg, max_slots=max_slots, capacity=capacity, page_size=ps,
        prefill_chunk=args.prefill_chunk, temperature=args.temperature,
        seed=args.seed, decode_lookahead=args.lookahead,
        clock=VirtualClock(), check_finite=args.smoke,
        hbm_budget_bytes=args.hbm_budget or None,
        policy=args.policy, preempt=args.preempt,
        max_queue=args.max_queue or None,
        on_nonfinite=args.on_nonfinite, degrade=args.degrade)
    slo = SLO_CLASSES[args.slo] if args.slo != "none" else None
    rng = np.random.default_rng(args.seed)
    for i in range(n_req):
        prompt = rng.integers(0, cfg.vocab, args.prompt_len)
        engine.submit(
            [int(t) for t in prompt], gens[i], arrivals[i],
            deadline=(arrivals[i] + args.deadline) if args.deadline else None,
            slo=slo)
    recs = engine.run()
    done = [r for r in recs if r["outcome"] in ("ok", "retried", "degraded")]
    total_tokens = sum(len(r["tokens"]) for r in done)
    ends = [r["finish_time"] for r in done if r["finish_time"] is not None]
    makespan = (max(ends) - min(r["arrival_time"] for r in recs)) \
        if ends else 0.0
    lats = [r["finish_time"] - r["arrival_time"] for r in done
            if r["finish_time"] is not None]
    tok_s = total_tokens / max(makespan, 1e-9)
    outcomes: dict = {}
    for r in recs:
        outcomes[r["outcome"]] = outcomes.get(r["outcome"], 0) + 1
    report.update({
        "mode": "engine", "n_requests": n_req, "max_slots": max_slots,
        "page_size": ps, "capacity": capacity,
        "prefill_chunk": args.prefill_chunk,
        "decode_lookahead": args.lookahead,
        "hbm_cache_bytes": engine.kv.hbm_bytes(),
        "total_tokens": total_tokens, "makespan_s": makespan,
        "tokens_per_s": tok_s,
        "p50_latency_s": _percentile(lats, 50) if lats else None,
        "p99_latency_s": _percentile(lats, 99) if lats else None,
        "policy": args.policy, "outcomes": outcomes,
        "slo_met": sum(1 for r in recs if r.get("slo_met")),
        "stats": dict(engine.stats),
        "decode_graphs": len(engine.runner.graph_log),
        "tokens": [r["tokens"] for r in recs],
    })
    print(f"[engine] {n_req} requests x {max_slots} slots "
          f"(pages of {ps}): {total_tokens} tokens in {makespan:.4f}s "
          f"({tok_s:.1f} tok/s, p50 {report['p50_latency_s']}s, "
          f"p99 {report['p99_latency_s']}s); "
          f"{report['decode_graphs']} decode graphs captured")
    if set(outcomes) - {"ok"}:
        print(f"[engine] outcomes: {outcomes}")
    print("[sample tokens]", [r["tokens"][:8] for r in recs[:4]])


def _cache_len(args, cfg) -> int:
    """Positions of the decode caches this run makes: the engine's
    capacity (the prompt and the longest generation, `--gen`, in whole
    pages), or the static path's patches, prompt and generation."""
    if args.engine:
        ps = args.page_size
        return -(-(args.prompt_len + args.gen) // ps) * ps
    patches = cfg.n_patches if cfg.family == "vlm" else 0
    return patches + args.prompt_len + args.gen


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=registry.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU tests)")
    ap.add_argument("--layers", type=int, default=0,
                    help="serve the first N layers at full width (0: all; "
                         "the card holds gemma3's or the MoE configs' "
                         "words only cut in depth)")
    ap.add_argument("--dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="model dtype (default: the config's)")
    ap.add_argument("--quant", default="none",
                    choices=["none", "fxp", "vp", "vp_block"])
    ap.add_argument("--layout", default="packed",
                    choices=["packed", "planes"],
                    help="VP weight storage: packed kernel words (default)"
                         " or two planes dequantized whole before a plain "
                         "matmul")
    ap.add_argument("--M", type=int, default=7,
                    help="VP significand bits; M+E <= 8 packs weights "
                         "into int8 words (half the bytes of bf16)")
    ap.add_argument("--E", type=int, default=2,
                    help="VP exponent-index bits (2^E exponent options)")
    ap.add_argument("--block", type=int, default=256,
                    help="vp_block index granularity; a weight whose "
                         "contraction dim it does not divide falls back to "
                         "per-element packed VP")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--kv-layout", default="packed",
                    choices=["packed", "planes"],
                    help="VP KV-cache storage: packed kernel words "
                         "(default) or two planes dequantized whole")
    ap.add_argument("--tune-decode", action="store_true",
                    help="time the decode kernels' launch plans at this "
                         "model's shapes first and keep the fastest in the "
                         "plan cache")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--batch", type=int, default=4,
                    help="batch size; with --engine the number of requests")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, metavar="FILE",
                    help="write a serving report to FILE")
    ap.add_argument("--device", default="cuda")
    # Continuous-batching engine mode
    ap.add_argument("--engine", action="store_true",
                    help="serve --batch requests through the paged "
                         "continuous-batching engine instead of one "
                         "static batch")
    ap.add_argument("--max-slots", type=int, default=0,
                    help="concurrent requests resident in the paged "
                         "cache (default min(batch, 4))")
    ap.add_argument("--page-size", type=int, default=16,
                    help="cache positions per page")
    ap.add_argument("--lookahead", type=int, default=1,
                    help="fused decode run-ahead: this many tokens per "
                         "decode step (one gather and one scatter over the "
                         "steps; tokens identical to --lookahead 1)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="split prompt prefill into chunks of this many "
                         "tokens interleaved with decode steps")
    ap.add_argument("--ragged-gen", action="store_true",
                    help="engine: vary per-request generation lengths")
    ap.add_argument("--arrival-gap", type=float, default=0.0,
                    help="engine: stagger request arrivals by this many "
                         "virtual seconds")
    ap.add_argument("--hbm-budget", type=int, default=0,
                    help="engine: device byte budget sizing the page pool "
                         "(0 = fully committed)")
    ap.add_argument("--policy", default="fifo", choices=["fifo", "edf"],
                    help="engine admission: FIFO head-of-line or "
                         "earliest-deadline-first")
    ap.add_argument("--preempt", action="store_true",
                    help="EDF: allow preemption-by-eviction of later-"
                         "deadline running requests")
    ap.add_argument("--slo", default="none",
                    choices=["none", "interactive", "standard", "batch"],
                    help="attach this SLO class to every request")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request completion deadline, seconds after "
                         "arrival (0 = none)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded submit queue: arrivals beyond this many "
                         "waiting requests are shed (0 = unbounded)")
    ap.add_argument("--on-nonfinite", default="raise",
                    choices=["raise", "quarantine"],
                    help="smoke finite-check action: hard stop (default) "
                         "or per-request quarantine")
    ap.add_argument("--degrade", action="store_true",
                    help="re-run repeatedly-quarantined requests on the "
                         "static plain path instead of dropping them")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    quant = QuantConfig(mode=args.quant, M=args.M, E=args.E,
                        block=args.block,
                        quantize_kv_cache=args.kv_quant,
                        kv_layout=args.kv_layout)
    cfg = (registry.get_smoke_config(args.arch, quant) if args.smoke
           else registry.get_config(args.arch, quant))
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    params = init_params(cfg, seed=args.seed, device=device)
    report = {"arch": args.arch, "layers": cfg.n_layers, "dtype": cfg.dtype,
              "quant": args.quant, "layout": args.layout,
              "M": args.M, "E": args.E, "block": args.block,
              "kv_quant": args.kv_quant, "kv_layout": args.kv_layout,
              "temperature": args.temperature, "smoke": args.smoke,
              "batch": args.batch, "prompt_len": args.prompt_len,
              "gen": args.gen, "device": str(device)}
    if args.quant != "none":
        t0 = time.perf_counter()
        params = quantize_params(params, cfg, layout=args.layout)
        _sync(device)
        report["export_s"] = time.perf_counter() - t0
    report["weight_bytes"] = weight_bytes(params)
    print(f"[serve] {cfg.name} on {device}: weights "
          f"{report['weight_bytes'] / 1e6:.2f} MB ({args.quant})")
    # Tunable decode launches: packed-word weight panels (vp, packed
    # layout) and the packed VP KV cache's decode attention.
    tunable = (args.quant == "vp" and args.layout == "packed") or \
        (args.kv_quant and args.kv_layout == "packed")
    if args.tune_decode and tunable:
        t0 = time.perf_counter()
        prof = tune_decode_profile(params, cfg, args.batch,
                                   max_len=_cache_len(args, cfg),
                                   seed=args.seed)
        report["tune_decode"] = {"entries": len(prof),
                                 "s": time.perf_counter() - t0}
        if prof:
            print(f"[serve] decode autotune profile: {len(prof)} entries "
                  f"over {len(prof)} shapes in "
                  f"{report['tune_decode']['s']:.1f}s")

    if args.engine:
        _run_engine(args, params, cfg, report)
    else:
        rng = np.random.default_rng(args.seed)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int64)
        ).to(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        frames = patches = None
        if cfg.family == "encdec":
            frames = torch.randn((args.batch, cfg.encoder_seq, cfg.d_model),
                                 generator=gen, device=device).to(
                                     model_dtype(cfg))
        if cfg.family == "vlm":
            patches = torch.zeros((args.batch, cfg.n_patches, cfg.d_model),
                                  device=device)
        tokens, _ = run_static(params, cfg, prompts, args.gen, report,
                               args.temperature, gen, frames=frames,
                               patches=patches)
        if frames is not None:
            print(f"[encode] {args.batch}x{cfg.encoder_seq} frames in "
                  f"{report['encode_s']:.4f}s")
        print(f"[prefill] {args.batch}x{args.prompt_len}"
              + (f" + {report['patches']} patches" if patches is not None
                 else "") + f" in {report['prefill_s']:.4f}s")
        print(f"[decode] {args.gen} steps x batch {args.batch}: "
              f"{report['decode_s']:.4f}s "
              f"({report['tokens_per_s']:.1f} tok/s)")
        report["tokens"] = tokens.tolist()
        print("[sample tokens]", tokens[:, :12].tolist())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
