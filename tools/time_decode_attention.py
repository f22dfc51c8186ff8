"""Time the split decode-attention kernel of one source tree at the dense
configs' decode shapes, for comparing two trees on one card.

    python tools/time_decode_attention.py [--src DIR] [--tag NAME]

`--src` is the `src` directory whose `repro_torch` is timed (default:
this checkout's); the kernels build into that tree's own
`.repro_torch_build/`.  Each shape is timed as chip_smoke.py times its
kernels (chip_smoke.Timer: median of 20 after an L2 flush), after a
check against the plain version at F32_RTOL.  Prints the card's name and
power limit, then one JSON line per shape.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (B, smax, KV, G, dh, lengths, window, rolling): qwen3's serve shape,
# qwen2's G = 7 at 160 and 4096 positions, gemma3's local ring at dh 168
SHAPES = ((4, 160, 8, 2, 64, [160, 150, 129, 100], None, False),
          (4, 160, 2, 7, 64, [160, 150, 129, 100], None, False),
          (4, 4096, 2, 7, 64, [4096, 3900, 3000, 2048], None, False),
          (2, 1024, 16, 2, 168, [1168, 1100], 1024, True))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    import chip_smoke
    from repro_torch.core.formats import FXPFormat, default_vp_format
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.vp_attention import plan_decode

    if not torch.cuda.is_available():
        raise SystemExit("time_decode_attention: CUDA is not available")
    print(chip_smoke._nvidia_smi())
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    fxp = FXPFormat(12, 11)
    for B, smax, KV, G, dh, lens, window, rolling in SHAPES:
        for M, dtype in ((6, torch.int8), (7, torch.int16)):
            vp = default_vp_format(fxp, M, 2)
            k_w, v_w = (ops.vp_quant((torch.randn(
                B, smax, KV, dh, generator=gen, device="cuda") * 0.3).clamp(
                    -0.99, 0.99), fxp, vp, packed=True) for _ in range(2))
            assert k_w.dtype == dtype
            k_s, v_s = (2.0 ** torch.randint(-3, 2, (B, smax, 1, 1),
                                             generator=gen, device="cuda")
                        for _ in range(2))
            q = torch.randn(B, 1, KV * G, dh, generator=gen, device="cuda")
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            a = (q, k_w, v_w, k_s, v_s, lengths, vp, window, rolling)
            err, rel = chip_smoke.compare(
                torch, ops.vp_decode_attention(*a),
                ref.vp_decode_attention_ref(*a), chip_smoke.F32_RTOL,
                f"{args.tag} {(B, smax, KV, G, dh)} {dtype}")
            ms = timer(lambda: ops.vp_decode_attention(*a))
            print(json.dumps(dict(
                tree=args.tag, shape=[B, smax, KV, G, dh], words=str(dtype),
                plan=str(plan_decode(KV, smax, G, dh, dtype.itemsize)),
                ms=ms, max_rel_err=rel)))


if __name__ == "__main__":
    main()
