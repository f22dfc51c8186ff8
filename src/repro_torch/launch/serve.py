"""Static serving CLI of the port (counterpart of the static path of
`repro.launch.serve`): prefill one batch, then decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --quant vp --kv-quant --batch 4 --prompt-len 128 --gen 32

Runs on the card by default and raises when CUDA is absent; `--device
cpu` runs the plain PyTorch versions of the kernels.  Weights are random
from `--seed` (torch generator), prompts from a numpy generator with the
same seed.  With `--quant vp` every weight matmul reads packed VP words
through the `vp_dequant_matmul` kernel; with `--quant vp_block` (index
block `--block`) it block-quantizes its activations and runs the int8
`block_vp_matmul` kernel; `--quant fxp` serves int8 fixed-point weights.
`--kv-quant` keeps the KV cache as packed words read by the
`vp_decode_attention` kernel.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import QuantConfig
from repro_torch.models.layers import weight_bytes
from repro_torch.models.model import (
    decode_step, init_cache, init_params, prefill, quantize_params,
    resolve_device,
)


def _require_finite(logits: torch.Tensor, what: str) -> None:
    """Raise (not assert: it must survive `python -O`) on NaN/inf."""
    if not bool(torch.isfinite(logits).all()):
        raise FloatingPointError(f"non-finite {what} logits")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_static(params, cfg, prompts: torch.Tensor, gen: int,
               report: Optional[dict] = None):
    """Prefill `prompts` (B, S), then `gen` greedy decode steps.

    Returns (tokens (B, gen), logits of every step [(B, V)] with the
    prefill's first).  Fills `report` with the timings when given.
    """
    device = prompts.device
    B, S = prompts.shape
    caches = init_cache(cfg, B, S + gen, device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(params, prompts, caches, cfg)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    _require_finite(logits, "prefill")
    all_logits = [logits]
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    out_tokens: List[torch.Tensor] = []
    t0 = time.perf_counter()
    for _ in range(gen):
        out_tokens.append(tok)
        logits, caches = decode_step(params, tok, caches, cfg)
        all_logits.append(logits)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    _sync(device)
    decode_s = time.perf_counter() - t0
    _require_finite(logits, "decode")
    if report is not None:
        report.update(prefill_s=prefill_s, decode_s=decode_s,
                      tokens_per_s=B * gen / max(decode_s, 1e-12))
    return torch.cat(out_tokens, dim=1), all_logits


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=registry.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU tests)")
    ap.add_argument("--quant", default="none",
                    choices=["none", "fxp", "vp", "vp_block"])
    ap.add_argument("--block", type=int, default=256,
                    help="vp_block index granularity; a weight whose "
                         "contraction dim it does not divide falls back to "
                         "per-element packed VP")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, metavar="FILE",
                    help="write a serving report to FILE")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    quant = QuantConfig(mode=args.quant, block=args.block,
                        quantize_kv_cache=args.kv_quant)
    cfg = (registry.get_smoke_config(args.arch, quant) if args.smoke
           else registry.get_config(args.arch, quant))
    params = init_params(cfg, seed=args.seed, device=device)
    report = {"arch": args.arch, "quant": args.quant, "block": args.block,
              "kv_quant": args.kv_quant, "smoke": args.smoke,
              "batch": args.batch, "prompt_len": args.prompt_len,
              "gen": args.gen, "device": str(device)}
    if args.quant != "none":
        t0 = time.perf_counter()
        params = quantize_params(params, cfg)
        _sync(device)
        report["export_s"] = time.perf_counter() - t0
    report["weight_bytes"] = weight_bytes(params)
    print(f"[serve] {cfg.name} on {device}: weights "
          f"{report['weight_bytes'] / 1e6:.2f} MB ({args.quant})")

    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int64)
    ).to(device)
    tokens, _ = run_static(params, cfg, prompts, args.gen, report)
    print(f"[prefill] {args.batch}x{args.prompt_len} in "
          f"{report['prefill_s']:.4f}s")
    print(f"[decode] {args.gen} steps x batch {args.batch}: "
          f"{report['decode_s']:.4f}s ({report['tokens_per_s']:.1f} tok/s)")
    print("[sample tokens]", tokens[:, :12].tolist())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
