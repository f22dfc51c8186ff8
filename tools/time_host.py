"""Host time per call of the two decode wrappers the plan cache feeds,
for comparing two source trees on one card.

    python tools/time_host.py [--src DIR] [--tag NAME]

`--src` is the `src` directory whose `repro_torch` is timed (default:
this checkout's); the kernels build into that tree's own
`.repro_torch_build/`.  With no plan cache file (the variable
`REPRO_TORCH_AUTOTUNE_CACHE` points at a file that does not exist), it
times the host's side of `vp_dequant_matmul_cuda` on the skinny body at
(4, 1024, 3072) bf16 and of `vp_decode_attention_cuda` at the serve's
decode shape (B 4, smax 160, KV 8, G 2, dh 64, int16 words, bf16 q):
`CALLS` calls on the host clock after a synchronize, the device held by
a spin kernel so the host sets the pace, the median of `REPEATS` such
runs.  Prints the card's name and power limit, then one JSON line.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS, REPEATS = 200, 7


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("time_host: CUDA is not available")
    print(chip_smoke._nvidia_smi())
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(tmp,
                                                                "none.json")
        print(json.dumps(_time(torch, args)))


def _time(torch, args) -> dict:
    from repro_torch.core.formats import FXPFormat, default_vp_format
    from repro_torch.kernels import ops
    from repro_torch.kernels.vp_attention import vp_decode_attention_cuda
    from repro_torch.kernels.vp_dequant_matmul import vp_dequant_matmul_cuda

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    fxp = FXPFormat(12, 11)
    vp = default_vp_format(fxp, 7, 2)
    bf16 = torch.bfloat16
    x = torch.randn((4, 1024), generator=gen, device="cuda").to(bf16)
    w = ops.vp_quant((torch.randn((1024, 3072), generator=gen, device="cuda")
                      * 0.3).clamp(-0.99, 0.99), fxp, vp, packed=True)
    B, smax, KV, G, dh = 4, 160, 8, 2, 64
    kw = ops.vp_quant((torch.randn((B, smax, KV, dh), generator=gen,
                                   device="cuda") * 0.3).clamp(-0.99, 0.99),
                      fxp, vp, packed=True)
    ks = torch.ones((B, smax), device="cuda")
    lens = torch.full((B,), smax, dtype=torch.int32, device="cuda")
    q = torch.randn((B, KV, G, dh), generator=gen, device="cuda").to(bf16)
    calls = {
        "vp_dequant_matmul (4, 1024, 3072)":
            lambda: vp_dequant_matmul_cuda(x, w, vp, bf16),
        "vp_decode_attention (4, 160, 8, 2, 64)":
            lambda: vp_decode_attention_cuda(q, kw, kw, ks, ks, lens, vp,
                                             None, False, dh ** -0.5)}
    out = {"tag": args.tag, "src": str(Path(args.src).resolve())}
    for name, fn in calls.items():
        fn()
        runs = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            torch.cuda._sleep(50_000_000)     # ~25 ms: the device waits
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            runs.append((time.perf_counter() - t0) / CALLS * 1e6)
            torch.cuda.synchronize()
        out[name] = {"host_us_median": statistics.median(runs),
                     "host_us_runs": runs}
    return out


if __name__ == "__main__":
    main()
